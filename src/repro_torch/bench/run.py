"""The port's benchmark driver: one function per paper table plus the
roofline table and the kernel microbench, with the reference driver's
sections, ``--only`` and asserts (``benchmarks/run.py``).

    PYTHONPATH=src python -m repro_torch.bench.run                     # everything, card
    PYTHONPATH=src python -m repro_torch.bench.run --only matrix,gates
    PYTHONPATH=src python -m repro_torch.bench.run --device cpu --reduced

Prints ``name,value,derived`` CSV lines per table and writes its
artifacts and ``bench-summary.json`` under ``results/torch/`` (or
``--out-dir``).  The model (full-width qwen3-1.7b on the card by default)
is built once, when the first section that needs it runs.
"""
from __future__ import annotations

import json
import time
from pathlib import Path
from typing import Any, Callable, Dict, List, Optional

from repro_torch.bench.common import Model, parse, parser


class Context:
    """The sections' shared inputs: the output directory and the model,
    built on first use."""

    def __init__(self, out_dir: Path, device=None, reduced: bool = False,
                 model: Optional[Model] = None):
        self.out_dir = Path(out_dir)
        self._device, self._reduced, self._model = device, reduced, model

    @property
    def model(self) -> Model:
        if self._model is None:
            self._model = Model(self._device, reduced=self._reduced)
        return self._model


def _section(name: str) -> None:
    print(f"\n== {name} " + "=" * max(0, 60 - len(name)))


def bench_matrix(ctx: Context) -> Dict[str, Any]:
    """Paper §6/§8.1: the lowering matrix, provenance and central table,
    and the independent rc14 audit (14/14)."""
    from repro_torch.core import checker
    from repro_torch.core.independent_audit import run_audit
    from repro_torch.core.native_descriptor import BACKEND

    t0 = time.perf_counter()
    stats = checker.write_outputs(ctx.out_dir)
    dt = (time.perf_counter() - t0) * 1e6
    native = sorted({r.backend for r in checker.generate_matrix() if r.label == "native_sound"})
    _section("lowering matrix (Tables 3/6; §8.1)")
    print(f"lowering_matrix_rows,{stats['rows']},{dt:.0f}us")
    print(f"native_sound_rows,{stats['native_sound']},{BACKEND} only: {native == [BACKEND]}")
    print(f"sound_with_adapter_rows,{stats['sound_with_adapter']},adapter/patch positives")
    audit = run_audit(out_dir=ctx.out_dir)
    print(f"independent_rc14_audit,{audit['agreement']},second-implementation agreement")
    assert audit["agreement"] == "14/14"
    return {**stats, "native_sound_backends": native, "rc14_audit": audit["agreement"]}


def bench_bad_lowering(ctx: Context) -> Dict[str, Any]:
    """Paper §9 Table 9: feature-table counterexamples fail closed."""
    from repro_torch.core import bad_lowering

    t0 = time.perf_counter()
    stats = bad_lowering.write_outputs(ctx.out_dir)
    dt = (time.perf_counter() - t0) * 1e6
    _section("bad-lowering counterexamples (Table 9)")
    print(f"bad_lowering_fail_closed,{stats['fail_closed']}/{stats['total']},{dt:.0f}us")
    assert stats["fail_closed"] == stats["total"]
    return stats


def bench_mutations(ctx: Context) -> Dict[str, Any]:
    """Paper §8.2: 16/16 descriptor/evidence mutation controls fail closed
    (the evidence replays run on the model's engines)."""
    from repro_torch.core import mutations

    t0 = time.perf_counter()
    stats = mutations.write_outputs(ctx.model.engine, ctx.out_dir)
    dt = (time.perf_counter() - t0) * 1e6
    _section("descriptor/evidence mutation controls (§8.2)")
    print(f"mutation_controls_fail_closed,{stats['fail_closed']}/{stats['total']},{dt:.0f}us")
    assert stats["fail_closed"] == stats["total"] == 16
    return stats


def bench_gates(ctx: Context) -> Dict[str, Any]:
    """Paper §8.3 Table 8: the 131-run connector repetition gates."""
    from repro_torch.bench.connector_gates import run_gates

    t0 = time.perf_counter()
    summary = run_gates(ctx.model, ctx.out_dir)
    dt = time.perf_counter() - t0
    _section("connector repetition gates (Table 8)")
    for k, v in summary.items():
        print(f"{k},{v},{dt:.1f}s total")
    assert summary["failure_outcome_passes"] == "30/30"
    assert summary["false_positive_control_passes"] == "0/41"
    return summary


def bench_multi_claim(ctx: Context) -> Dict[str, Any]:
    """Paper §7 path C: 3/3 target-only attribution."""
    from repro_torch.bench.multi_claim import run

    summary = run(ctx.model, ctx.out_dir)
    _section("multi-claim attribution control (path C)")
    for k, v in summary.items():
        print(f"{k},{v},")
    assert summary["target_only_attribution"] == "3/3"
    return summary


def bench_roofline(ctx: Context) -> Dict[str, str]:
    """The roofline table from the port's dry-run artifacts."""
    from repro_torch.bench.roofline import run

    out = run(ctx.out_dir)
    _section("roofline table (from results/torch/dryrun)")
    if not out:
        print("roofline,SKIPPED,run `python -m repro_torch.launch.dryrun --all --mesh both` first")
    for mesh, desc in out.items():
        print(f"roofline_{mesh},{desc},")
    return out


def bench_kernels(ctx: Context) -> List[Dict[str, Any]]:
    """K5, K4 and K3 against their plain versions (device time on the card;
    the plain versions only on the CPU)."""
    from repro_torch.bench.kernels import run

    rows = run(ctx.model.device, ctx.out_dir)
    _section("kernel microbench")
    for r in rows:
        if r["kernel_ms"] is None:
            print(f"{r['name']},{r['cpu_plain_us']:.1f}us host (plain version only: no CUDA "
                  f"kernel on the CPU),max_err=n/a")
        else:
            print(f"{r['name']},{r['kernel_ms']:.4f}ms (plain {r['plain_ms']:.4f}ms),"
                  f"max_err={r['max_err']:.2e}")
    return rows


ALL: Dict[str, Callable[[Context], Any]] = {
    "matrix": bench_matrix,
    "bad_lowering": bench_bad_lowering,
    "mutations": bench_mutations,
    "gates": bench_gates,
    "multi_claim": bench_multi_claim,
    "roofline": bench_roofline,
    "kernels": bench_kernels,
}


def run(names: List[str], ctx: Context) -> Dict[str, Any]:
    """Run the named sections in order; writes ``bench-summary.json``."""
    results = {n: ALL[n](ctx) for n in names}
    if ctx._model is not None:
        results["model"] = ctx.model.describe()
    ctx.out_dir.mkdir(parents=True, exist_ok=True)
    (ctx.out_dir / "bench-summary.json").write_text(json.dumps(results, indent=1, default=str))
    return results


def main(argv: Optional[List[str]] = None) -> None:
    ap = parser(__doc__)
    ap.add_argument("--only", default="", help="comma-separated subset of: " + ",".join(ALL))
    args = parse(ap, argv)
    names = [n.strip() for n in args.only.split(",") if n.strip()] or list(ALL)
    run(names, Context(args.out_dir, args.device, args.reduced))
    print(f"\nall benchmarks complete; artifacts in {args.out_dir}/")


if __name__ == "__main__":
    main()

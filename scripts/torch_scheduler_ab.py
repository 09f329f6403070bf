"""The scheduler bench (``python -m repro_torch.bench.scheduler``) on two
trees in turns, in one call on one card: the parent's tree (a checkout
unpacked with ``git archive``) and this one, each run a process of its own
from its tree's root, so each builds and loads its own kernels.

Writes ``<out>/mixed_scheduler_ab.json``: the order of the runs, each
run's exit code (1 when the ITL gate fails), its ``mixed_scheduler``
summary (the traced steps one by one only in the run's own
``<out>/<run>/BENCH_serving.json``) and the card, and prints one line a run (ratio, best p99s, p50s,
the traced contended steps' p50 by stage).

    python3 scripts/torch_scheduler_ab.py --parent build/parent [--order PCCPCP] [--fast]
        [--out chiprun_out/ab] [-- BENCH_ARGS]     # e.g. -- --device cpu --reduced
"""
import argparse
import json
import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def run(tree: Path, out: Path, fast: bool, extra) -> dict:
    cmd = [sys.executable, "-m", "repro_torch.bench.scheduler", "--out-dir", str(out), *extra]
    if fast:
        cmd.append("--fast")
    env = {**os.environ, "PYTHONPATH": str(tree / "src")}
    out.mkdir(parents=True, exist_ok=True)
    proc = subprocess.run(cmd, cwd=tree, env=env, capture_output=True, text=True, timeout=1800)
    (out / "log.txt").write_text(proc.stdout[-20000:] + proc.stderr[-20000:])
    summary = json.loads((out / "BENCH_serving.json").read_text())["mixed_scheduler"]
    summary["step_trace"].pop("steps", None)  # kept in the run's own BENCH_serving.json
    return {"rc": proc.returncode, "summary": summary}


def line(name: str, r: dict) -> str:
    s = r["summary"]
    bd = s["step_trace"]["breakdown"]
    traced = {route: {k: bd[route]["p50"][k] for k in ("gap_ms", "mixed_step_ms", "decode_step_ms",
                                                        "prefill_chunk_ms", "other_ms")
                      if k in bd[route]["p50"]}
              for route in ("fused", "split") if route in bd}
    if not traced and "p50" in bd:  # a tree whose trace has no routes
        traced = {"all": bd["p50"]}
    return (f"{name}: rc {r['rc']} ratio {s['itl_ratio_p99']} best p99 ms "
            f"{json.dumps(s['itl_p99_best_ms'])} p50 ms isolated {s['isolated_itl_ms']['p50']} "
            f"contended {s['burst_itl_contended_ms']['p50']}; traced contended p50 "
            f"{json.dumps(traced)}")


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", required=True, help="the parent's unpacked tree")
    ap.add_argument("--order", default="PCCPCP", help="P: parent, C: this tree")
    ap.add_argument("--fast", action="store_true")
    ap.add_argument("--out", default=str(ROOT / "chiprun_out" / "ab"))
    ap.add_argument("bench_args", nargs="*", help="passed on to the bench")
    args = ap.parse_args()
    trees = {"P": ("parent", Path(args.parent).resolve()), "C": ("change", ROOT)}
    out = Path(args.out).resolve()
    result = {"order": [], "runs": {}}
    seen = {"P": 0, "C": 0}
    for t in args.order:
        seen[t] += 1
        name = f"{trees[t][0]}{seen[t]}"
        r = run(trees[t][1], out / name, args.fast, args.bench_args)
        result["order"].append(name)
        result["runs"][name] = r
        result["card"] = r["summary"]["model"]["card"]
        print(line(name, r), flush=True)
    (out / "mixed_scheduler_ab.json").write_text(json.dumps(result, indent=1))


if __name__ == "__main__":
    main()

"""Roofline table of the port: per (arch x shape x mesh) the three-term
roofline (compute, memory, collective seconds) from the port's dry-run
artifacts in ``results/torch/dryrun/`` (``python -m
repro_torch.launch.dryrun``).

The counterpart of ``benchmarks/bench_roofline.py``.  Beside the
reference's peak per device, which the port's dry run takes as the
argument bytes plus the most bytes the eager step's tensors held at once
(``roofline.analysis.LiveBytes``; no compiled buffer assignment exists),
the table keeps the argument bytes per device.  Writes
``<out-dir>/roofline-{single,multi}.{md,json}``; reads files only (no
model, no device).

    PYTHONPATH=src python -m repro_torch.bench.roofline
"""
from __future__ import annotations

import json
from pathlib import Path
from typing import Any, Dict, List, Optional

from repro_torch.bench.common import RESULTS_DIR, parse, parser

DRYRUN_DIR = RESULTS_DIR / "dryrun"


def build_table(dryrun_dir: Path = DRYRUN_DIR, mesh: str = "single") -> List[Dict[str, Any]]:
    rows = []
    for p in sorted((Path(dryrun_dir) / mesh).glob("*.json")):
        d = json.loads(p.read_text())
        arch, shape = d["arch"], d["shape"]
        if d.get("status") != "ok":
            rows.append({"arch": arch, "shape": shape, "status": d.get("status"),
                         "reason": d.get("reason")})
            continue
        r = d["roofline"]
        rows.append({
            "arch": arch,
            "shape": shape,
            "status": "ok",
            "compute_s": r["compute_s"],
            "memory_s": r["memory_s"],
            "collective_s": r["collective_s"],
            "dominant": r["dominant"],
            "model_flops": r["model_flops"],
            "useful_flops_ratio": r["useful_flops_ratio"],
            "argument_GB_per_dev": d["memory"]["argument_bytes_per_device"] / 1e9,
            "peak_GB_per_dev": d["memory"]["peak_bytes_per_device"] / 1e9,
            "fits_80GiB": d["memory"]["fits_80GiB"],
            "roofline_fraction": min(
                1.0, max(r["compute_s"], 1e-30)
                / max(r["compute_s"], r["memory_s"], r["collective_s"])),
        })
    return rows


def to_markdown(rows: List[Dict[str, Any]], mesh: str) -> str:
    lines = [
        f"# Roofline table of the port's dry run ({mesh} mesh)",
        "",
        "| arch | shape | compute s | memory s | collective s | dominant | useful-FLOPs ratio "
        "| argument bytes per device (GB) | peak bytes per device (GB) | fits 80 GiB |",
        "|---|---|---|---|---|---|---|---|---|---|",
    ]
    for r in rows:
        if r.get("status") != "ok":
            lines.append(f"| {r['arch']} | {r['shape']} | — | — | — | "
                         f"{r['status']}: {(r.get('reason') or '')[:60]} | — | — | — | — |")
            continue
        lines.append(
            f"| {r['arch']} | {r['shape']} | {r['compute_s']:.3e} | {r['memory_s']:.3e} | "
            f"{r['collective_s']:.3e} | **{r['dominant']}** | {r['useful_flops_ratio']:.2f} | "
            f"{r['argument_GB_per_dev']:.2f} | {r['peak_GB_per_dev']:.2f} | {r['fits_80GiB']} |")
    return "\n".join(lines)


def run(out_dir: Path = RESULTS_DIR, dryrun_dir: Path = DRYRUN_DIR) -> Dict[str, str]:
    out = {}
    for mesh in ("single", "multi"):
        rows = build_table(dryrun_dir, mesh)
        if not rows:
            continue
        Path(out_dir).mkdir(parents=True, exist_ok=True)
        (Path(out_dir) / f"roofline-{mesh}.md").write_text(to_markdown(rows, mesh))
        (Path(out_dir) / f"roofline-{mesh}.json").write_text(json.dumps(rows, indent=1))
        ok = [r for r in rows if r.get("status") == "ok"]
        out[mesh] = f"{len(ok)} cells; dominant: " + ", ".join(
            f"{k}={sum(1 for r in ok if r['dominant'] == k)}"
            for k in ("compute", "memory", "collective"))
    return out


def main(argv: Optional[List[str]] = None) -> None:
    args = parse(parser(__doc__), argv)
    print(json.dumps(run(args.out_dir), indent=1))


if __name__ == "__main__":
    main()

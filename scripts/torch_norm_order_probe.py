"""Hold the norm kernel's order model, and the kernel, against the
row-statistic kernel the norm kernel replaced, on one NVIDIA GPU.

    python3 scripts/torch_norm_order_probe.py ROW_STAT_CU [--out F]

``ROW_STAT_CU`` is ``src/repro_torch/kernels/csrc/row_stat.cu`` from a
checkout that still has it (with its ``common.cuh`` beside it).  The script
builds it with the port's nvcc flags under ``build/`` and checks, on the
card, with seeded inputs:

* ``norm.ordered_stat`` (the order written out in torch f32 ops) bitwise
  against the row-statistic kernel, for the mean, the mean of squares and
  the variance of f32 rows of 8 widths;
* ``norm.norm`` bitwise against the route it replaced, the row-statistic
  kernel followed by torch's elementwise chain (the former
  ``layers.rms_norm`` / ``layers.layer_norm`` on the card), for the RMS and
  the layer norm, bf16 and f32, at 6 widths.

Prints one line a case and a JSON summary last; exits 1 if any case
differs by a bit.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

import torch  # noqa: E402

from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels import norm as nm  # noqa: E402

STATS = {"mean": 0, "mean_square": 1, "var": 2}  # row_stat_forward's codes
STAT_WIDTHS = (2048, 128, 2047, 768, 5120, 6144, 7168, 5)
NORM_WIDTHS = (2048, 128, 2047, 768, 5120, 7168)
EPS = {"rms": 1e-6, "layer": 1e-5}
ROWS = 300


def load_row_stat(source: Path):
    out = build.REPO_ROOT / "build" / "order_probe" / "row_stat.so"
    out.parent.mkdir(parents=True, exist_ok=True)
    proc = subprocess.run([build._nvcc(), *build.NVCC_FLAGS, "-o", str(out), str(source)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise SystemExit(f"nvcc failed for {source}:\n{proc.stderr[-4000:]}")
    fn = ctypes.CDLL(str(out)).row_stat_forward
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64, ctypes.c_int, ctypes.c_int,
                   ctypes.c_void_p]
    fn.restype = ctypes.c_int

    def row_stat(xf: torch.Tensor, stat: str) -> torch.Tensor:
        xf = xf.contiguous()
        d = xf.shape[-1]
        o = torch.empty(xf.shape[:-1] + (1,), dtype=torch.float32, device=xf.device)
        rc = build.launch(fn, xf.device, xf.data_ptr(), o.data_ptr(), o.numel(), d, STATS[stat])
        if rc != 0:
            raise SystemExit(f"row_stat_forward failed (CUDA error {rc})")
        return o

    return row_stat


def old_route(row_stat, x, w, b, kind):
    """The norms as the port ran them on the card before the norm kernel."""
    xf = x.float()
    if kind == "rms":
        out = xf * torch.rsqrt(row_stat(xf, "mean_square") + EPS[kind])
        return (out * w.float()).to(x.dtype)
    out = (xf - row_stat(xf, "mean")) * torch.rsqrt(row_stat(xf, "var") + EPS[kind])
    return (out * w.float() + b.float()).to(x.dtype)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("row_stat_cu", help="row_stat.cu of a checkout that still has it")
    ap.add_argument("--out", default=None, help="write the summary as JSON here too")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_norm_order_probe: no CUDA device", file=sys.stderr)
        raise SystemExit(2)
    row_stat = load_row_stat(Path(args.row_stat_cu).resolve())
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    print(smi.stdout.strip())
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    cases = []
    with torch.no_grad():
        for d in STAT_WIDTHS:
            x = 1.0 + 3.0 * torch.randn((ROWS, d), generator=g, device=dev)
            for stat in STATS:
                model, kernel = nm.ordered_stat(x, stat), row_stat(x, stat)
                torch.cuda.synchronize()
                cases.append({"case": f"ordered_stat {stat} {ROWS} x {d}",
                              "bitwise": bool(torch.equal(model, kernel))})
        for d in NORM_WIDTHS:
            for kind in EPS:
                for dtype in (torch.bfloat16, torch.float32):
                    x = (1.0 + 3.0 * torch.randn((ROWS, d), generator=g, device=dev)).to(dtype)
                    w = (1.0 + 0.5 * torch.randn((d,), generator=g, device=dev)).to(dtype)
                    b = (0.5 * torch.randn((d,), generator=g, device=dev)).to(dtype)
                    b = b if kind == "layer" else None
                    got = nm.norm(x, w, b, kind=kind, eps=EPS[kind])
                    want = old_route(row_stat, x, w, b, kind)
                    torch.cuda.synchronize()
                    cases.append({"case": f"norm {kind} {str(dtype)[6:]} {ROWS} x {d}",
                                  "bitwise": bool(torch.equal(got, want))})
    for c in cases:
        print(f"{c['case']}: {'bitwise' if c['bitwise'] else 'DIFFERS'}")
    summary = {"card": smi.stdout.strip(), "torch": torch.__version__, "cases": len(cases),
               "differing": sum(not c["bitwise"] for c in cases), "results": cases}
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(summary, indent=1) + "\n")
    print(json.dumps({k: summary[k] for k in ("card", "torch", "cases", "differing")}))
    raise SystemExit(1 if summary["differing"] else 0)


if __name__ == "__main__":
    main()

"""The row-invariant GEMM's tile shapes side by side, on one NVIDIA GPU.

    python3 scripts/torch_gemm_tiles.py

Calls ``src/repro_torch/kernels/csrc/gemm.cu``'s entry with each of its
tile configurations forced (``gemm_forward``'s ``tile`` argument: 1 = 64
columns x 64 rows, one consumer warpgroup; 2 = 64 columns x 128 rows, two
warpgroups; 3 = 128 x 128, two warpgroups; 0 = the committed dispatch's
choice), then times each with the profiler's
device time at qwen3-1.7b's projection shapes (q/o 2048 x 2048, the MLP's
2048 x 6144 and 6144 x 2048, the tied LM head 2048 x 151936) and the
widths of a decode step, a prefill chunk and a monolithic prefill (M = 8,
32, 512), beside ``torch.matmul``.  Every configuration must give the
committed dispatch's bits (a tile shape leaves each output element's
k-order unchanged); a difference exits 1.  Prints one line per (shape, M)
with each configuration's ms.
"""
from __future__ import annotations

import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402  (puts src/ on the path)
from repro_torch.kernels import gemm  # noqa: E402

TILES = {0: "dispatch", 1: "64x64", 2: "64x128", 3: "128x128"}
SHAPES = {"q/o": (2048, 2048), "MLP gate/up": (2048, 6144), "MLP down": (6144, 2048),
          "LM head (tied)": (2048, 151936)}
WIDTHS = (8, 32, 512)


def main() -> None:
    if not torch.cuda.is_available():
        print("torch_gemm_tiles: no CUDA device", file=sys.stderr)
        raise SystemExit(2)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True)
    print(smi.stdout.strip())
    fn = gemm._lib().gemm_forward
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    stream = torch.cuda.current_stream().cuda_stream
    bad = 0
    for sname, (K, N) in SHAPES.items():
        tied = sname.startswith("LM head")
        n_w = 1 if tied else max(2, -(-120_000_000 // (2 * K * N)))
        if tied:
            ws = [(torch.randn((N, K), generator=g, device=dev) * 0.02).bfloat16()]
        else:
            ws = [(torch.randn((K, N), generator=g, device=dev) / K ** 0.5).bfloat16()
                  for _ in range(n_w)]
        for M in WIDTHS:
            xs = [(0.5 * torch.randn((M, K), generator=g, device=dev)).bfloat16() for _ in ws]
            outs = [torch.empty((M, N), dtype=torch.bfloat16, device=dev) for _ in ws]
            wt = [w.T if tied else w for w in ws]
            want = gemm.gemm(xs[0], wt[0])
            row = []
            for tile, tname in TILES.items():
                def call(x, w, o, tile=tile):
                    rc = fn(x.data_ptr(), w.data_ptr(), o.data_ptr(), M, N, K, K, K if tied else N,
                            N, 0 if tied else 1, tile, stream)
                    if rc:
                        raise SystemExit(f"launch failed: CUDA error {rc}")
                call(xs[0], ws[0], outs[0])
                torch.cuda.synchronize()
                if not torch.equal(outs[0], want):
                    print(f"  {sname} M={M} tile {tname}: bits differ from the committed dispatch")
                    bad += 1
                ms = cs.time_ms(call, list(zip(xs, ws, outs)), iters=30)
                row.append(f"{tname} {ms:.4f}")
            lib = cs.time_ms(torch.matmul, list(zip(xs, wt)), iters=30)
            print(f"GEMM tiles {sname} {K}x{N} M={M}: " + ", ".join(row)
                  + f"; torch.matmul {lib:.4f} ms")
    if bad:
        raise SystemExit(1)


if __name__ == "__main__":
    main()

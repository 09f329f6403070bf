"""The row-invariant GEMM's tile shapes side by side, on one NVIDIA GPU.

    python3 scripts/torch_gemm_tiles.py

Builds ``src/repro_torch/kernels/csrc/gemm.cu`` once per tile shape, each
copy's ``dispatch`` sending every M to that one shape (text substitution
into ``build/gemm_tiles/``, one nvcc per copy, in parallel), then times
each with the profiler's device time at qwen3-1.7b's projection shapes
(q/o 2048 x 2048, the MLP's 2048 x 6144 and 6144 x 2048, the tied LM head
2048 x 151936) and the widths of a decode step, a prefill chunk and a
monolithic prefill (M = 8, 32, 512), beside ``torch.matmul``.  Every shape
must give the committed kernel's bits (a tile shape leaves each output
element's k-order unchanged); a difference exits 1.  Prints one line per
(shape, M) with each tile's ms and the committed dispatch's choice.
"""
from __future__ import annotations

import ctypes
import re
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402  (puts src/ on the path)
from repro_torch.kernels import build, gemm  # noqa: E402

SOURCE = build.CSRC / "gemm.cu"
OUT = ROOT / "build" / "gemm_tiles"
# (BM, BN, warps along M, warps along N, cp.async stages)
TILES = [(16, 16, 1, 1, 8), (16, 32, 1, 2, 8), (16, 32, 1, 1, 8), (16, 64, 1, 4, 6),
         (32, 32, 2, 2, 6), (32, 64, 2, 2, 4), (64, 64, 2, 2, 4), (64, 128, 2, 4, 3),
         (128, 64, 4, 2, 4), (128, 128, 2, 4, 3)]
SHAPES = {"q/o": (2048, 2048), "MLP gate/up": (2048, 6144), "MLP down": (6144, 2048),
          "LM head (tied)": (2048, 151936)}
WIDTHS = (8, 32, 512)


def variant(tile) -> Path:
    src = SOURCE.read_text()
    body = "  return launch<{}, {}, {}, {}, {}, kKN>(p, s);\n".format(*tile)
    new, n = re.subn(r"(int dispatch\(const GemmParams& p, cudaStream_t s\) \{\n)(.*?)(\n\})",
                     lambda m: m.group(1) + body.rstrip("\n") + m.group(3), src, flags=re.S)
    if n != 1:
        raise SystemExit("torch_gemm_tiles: gemm.cu's dispatch not found")
    name = "x".join(map(str, tile))
    cu = OUT / f"gemm_{name}.cu"
    cu.write_text(new)
    so = OUT / f"gemm_{name}.so"
    cmd = [build._nvcc(), *build.NVCC_FLAGS, "-I", str(build.CSRC), "-o", str(so), str(cu)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode:
        raise SystemExit(f"nvcc failed for {name}:\n{proc.stderr[-3000:]}")
    return so


def main() -> None:
    if not torch.cuda.is_available():
        print("torch_gemm_tiles: no CUDA device", file=sys.stderr)
        raise SystemExit(2)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True)
    print(smi.stdout.strip())
    OUT.mkdir(parents=True, exist_ok=True)
    with ThreadPoolExecutor(max_workers=len(TILES)) as pool:
        libs = list(pool.map(variant, TILES))
    fns = []
    for so in libs:
        fn = ctypes.CDLL(str(so)).gemm_forward
        fn.argtypes, fn.restype = gemm._ARGTYPES, ctypes.c_int
        fns.append(fn)
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
            for tile, fn in zip(TILES, fns):
                def call(x, w, o, fn=fn):
                    rc = fn(x.data_ptr(), w.data_ptr(), o.data_ptr(), M, N, K, K, K if tied else N,
                            N, 0 if tied else 1, stream)
                    if rc:
                        raise SystemExit(f"launch failed: CUDA error {rc}")
                call(xs[0], ws[0], outs[0])
                torch.cuda.synchronize()
                if not torch.equal(outs[0], want):
                    print(f"  {sname} M={M} tile {tile}: bits differ from the committed kernel")
                    bad += 1
                ms = cs.time_ms(call, list(zip(xs, ws, outs)), iters=30)
                row.append(f"{'x'.join(map(str, tile))} {ms:.4f}")
            lib = cs.time_ms(torch.matmul, list(zip(xs, wt)), iters=30)
            print(f"GEMM tiles {sname} {K}x{N} M={M}: " + ", ".join(row)
                  + f"; torch.matmul {lib:.4f} ms")
    if bad:
        raise SystemExit(1)


if __name__ == "__main__":
    main()

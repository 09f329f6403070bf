"""K1's decode layouts at head_dim 160 on one NVIDIA GPU, side by side.

    python3 scripts/torch_k1_layouts.py

Builds ``src/repro_torch/kernels/csrc/paged_decode.cu`` as committed and
two variants of it, made by text substitution into ``build/k1_layouts/``:

  * ``160x4`` (committed): a key over 10 lanes of 2 slices, 4 warps;
  * ``160x8``: the same layout over 8 warps of 8 keys;
  * ``256``: head_dim 160 sent to the 256-column layout (8 warps, a key
    per warp pass over 32 lanes, 12 of them idle), the layout before the
    160-column one.

For each it prints the split kernel's ptxas registers and spills, checks it
against the plain version (bf16 tolerance; G 1-12, head dims 128-160, f32
and batch-position invariance), then times it at stablelm-12b's decode
shape (8 rows, 8 kv heads, G = 4, prefixes 0-512, T = 24) and at 8 x 2048
prefix keys, in the order 160x4, 160x8, 256, then reversed.  Exits 1 on a
disagreement.
"""
from __future__ import annotations

import ctypes
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402  (puts src/ on the path)
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels import paged_attention as pa  # noqa: E402

SOURCE = build.CSRC / "paged_decode.cu"
OUT = ROOT / "build" / "k1_layouts"
# variant -> (text in the committed source, its replacement)
PATCHES = {
    "160x4": None,
    "160x8": ("  static constexpr int kWarps = 4;\n  static constexpr int kLanes = 10;",
              "  static constexpr int kWarps = 8;\n  static constexpr int kLanes = 10;"),
    "256": ("if (p.D <= 160 && p.G <= 4) return dispatch_heads<T, 160>(p, s);",
            "if (false) return dispatch_heads<T, 160>(p, s);"),
}


def compile_variant(name):
    text = SOURCE.read_text()
    if PATCHES[name] is not None:
        old, new = PATCHES[name]
        if text.count(old) != 1:
            raise RuntimeError(f"{name}: the patch no longer applies to {SOURCE.name}")
        text = text.replace(old, new)
    src, lib = OUT / f"paged_decode_{name}.cu", OUT / f"paged_decode_{name}.so"
    src.write_text(text)
    proc = subprocess.run([build._nvcc(), *build.NVCC_FLAGS, "-I", str(build.CSRC), "-o", str(lib),
                           str(src)], capture_output=True, text=True)
    if proc.returncode:
        raise RuntimeError(f"nvcc failed for {name}:\n{proc.stderr[-4000:]}")
    return lib, proc.stdout + proc.stderr


def ptxas_lines(name, log):
    """The bf16 split kernels' registers and spills."""
    entry = None
    for line in log.splitlines():
        if "Compiling entry" in line:
            mangled = line.split("'")[1]
            entry = subprocess.run(["c++filt", mangled], capture_output=True, text=True).stdout.strip()
            entry = entry.replace("(anonymous namespace)::", "").split("(")[0]
        elif entry and "split_kernel<__nv_bfloat16" in entry and ("spill" in line or "registers" in line):
            print(f"  {name} {entry}: {line.split(':', 1)[-1].strip()}")


def main() -> int:
    if not torch.cuda.is_available():
        print("torch_k1_layouts: no CUDA device", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    print(smi.stdout.strip())
    OUT.mkdir(parents=True, exist_ok=True)
    t0 = time.monotonic()
    with ThreadPoolExecutor(len(PATCHES)) as pool:
        built = dict(zip(PATCHES, pool.map(compile_variant, PATCHES)))
    print(f"built {len(built)} variants in {time.monotonic() - t0:.1f} s")
    libs = {}
    for name, (lib, log) in built.items():
        ptxas_lines(name, log)
        libs[name] = ctypes.CDLL(str(lib))

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    rnd_of = lambda dtype: (lambda *s, dtype=dtype: torch.randn(s, generator=g, device=dev).to(dtype))
    ok = True
    for name, lib in libs.items():
        build._libs["paged_decode"] = lib  # the wrapper launches this variant
        for G, D, dtype in [(4, 160, torch.bfloat16), (2, 160, torch.bfloat16), (3, 136, torch.bfloat16),
                            (1, 152, torch.bfloat16), (12, 160, torch.bfloat16),
                            (2, 128, torch.bfloat16), (4, 160, torch.float32)]:
            copies, _ = cs._decode_copies(rnd_of(dtype), dev, 5, 4, G, D, cs.PLEN, cs.T_USED, n=1)
            args = copies[0]
            errs = []
            for kw in cs.BOTH:
                got = pa.paged_decode_attention(*args, **kw)
                want = pa.paged_decode_attention_ref(*args, **kw)
                torch.cuda.synchronize()
                errs.append(cs.max_err(got, want))
                ok &= cs.within(got, want, dtype)
            batch = pa.paged_decode_attention(*args, window=128)
            perm = [(i + 3) % 8 for i in range(8)]
            moved = pa.paged_decode_attention(
                *[a[perm] if a.shape[0] == 8 and i not in (1, 2) else a for i, a in enumerate(args)],
                window=128)
            torch.cuda.synchronize()
            same = all(torch.equal(moved[i], batch[perm[i]]) for i in range(8))
            ok &= same
            print(f"{name} G={G} D={D} {str(dtype)[6:]}: max|d| {max(errs):.3e} over "
                  f"{len(cs.BOTH)} window/softcap variants, batch-position invariant {same}")

    rnd = rnd_of(torch.bfloat16)
    shapes = {"stablelm-12b decode (KV 8, G 4, D 160, prefixes 0-512)": cs.PLEN,
              "8 x 2048 prefix keys (KV 8, G 4, D 160)": [2048] * 8}
    ops = {label: cs._decode_copies(rnd, dev, 7, 8, 4, 160, plen, cs.T_USED, n=3)
           for label, plen in shapes.items()}
    for order in (list(libs), list(libs)[::-1]):
        for name in order:
            build._libs["paged_decode"] = libs[name]
            for label, plen in shapes.items():
                copies, P = ops[label]
                cs.decode_row(f"{name}: {label}", copies, P, plen, cs.T_USED, variants=cs.BOTH[:1])
    print("layouts agree with the plain version" if ok else "FAIL: a layout disagrees")
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())

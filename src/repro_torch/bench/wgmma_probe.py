"""The probe that picks the tensor-core instruction of the bf16 attention
kernels: do ``wgmma`` and ``mma.sync`` give the same bits for the same k16
step?  (``kernels/csrc/wgmma_probe.cu``, built like the kernels by
``kernels/build.py``; only card tests and ``chip_smoke.py`` call it, no
serving path does.)

K1 and K2 run ``mma.sync.m16n8k16`` on 16-row fragments; K5 may run its
products on ``wgmma`` only if a ``wgmma`` k16 step rounds as an
``mma.sync`` k16 step does, else the same query over the same keys would
leave K5 with other bits than K1 and K2.  ``probe`` draws problems D = A B
+ C (A 16 x 16, B 16 x 128 bf16, C f32) of five classes from a seed:
random normals, wide exponent spreads, near-cancelling sums, subnormals,
and C values large enough that the order and the alignment of the 16
products show in the sum.  Each goes through ``mma.sync`` and through four
``wgmma`` routes (A from registers or from shared memory, B K-major or
MN-major from a 128-byte-swizzled tile), and the results are compared
bitwise.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from repro_torch.kernels import build

N = 128
ROUTES = ("mma.sync", "wgmma A regs, B K-major", "wgmma A smem, B K-major",
          "wgmma A regs, B MN-major", "wgmma A smem, B MN-major")
CLASSES = ("normal", "exponent spread", "near cancelling", "subnormal", "large C")


def _lib() -> ctypes.CDLL:
    lib = build.load("wgmma_probe")
    fn = lib.wgmma_probe
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return lib


def _bf16(x):
    """float32 numpy -> bf16 values (round to nearest) as float32 numpy."""
    return torch.from_numpy(np.ascontiguousarray(x, np.float32)).bfloat16().float().numpy()


def problems(kind: str, n: int, rng: np.random.Generator):
    """n problems of one class: (a [n, 16, 16], b [n, 16, N], c [n, 16, N]),
    a and b already bf16 values."""
    a = rng.standard_normal((n, 16, 16))
    b = rng.standard_normal((n, 16, N))
    c = rng.standard_normal((n, 16, N))
    if kind == "exponent spread":
        a *= 2.0 ** rng.integers(-24, 25, a.shape)
        b *= 2.0 ** rng.integers(-24, 25, b.shape)
        c *= 2.0 ** rng.integers(-30, 31, c.shape)
    elif kind == "near cancelling":
        # products in pairs k, k + 8 that nearly cancel, and C near minus the sum
        a, b = _bf16(a), _bf16(b)
        b[:, 8:] = -b[:, :8] * (1 + 2.0 ** -7 * rng.standard_normal((n, 8, N)))
        a[:, :, 8:] = a[:, :, :8]
        b = _bf16(b)
        c = -np.einsum("nik,nkj->nij", a.astype(np.float64), b) * (1 + 2.0 ** -20)
    elif kind == "subnormal":
        a *= 2.0 ** rng.integers(-70, -55, a.shape)
        b *= 2.0 ** rng.integers(-70, -55, b.shape)
        c *= 2.0 ** -130
    elif kind == "large C":
        c = np.sign(c) * 2.0 ** rng.integers(8, 30, c.shape) * (1 + rng.random(c.shape))
        a *= 2.0 ** rng.integers(-4, 5, a.shape)
    return _bf16(a), _bf16(b), np.asarray(c, np.float32)


def run(a, b, c, device) -> torch.Tensor:
    """[n, 5, 16, N] f32: each problem through the five routes."""
    t = lambda x, dt: torch.from_numpy(np.ascontiguousarray(x, np.float32)).to(dt).to(device)
    ta, tb, tc = t(a, torch.bfloat16), t(b, torch.bfloat16), t(c, torch.float32)
    out = torch.empty((a.shape[0], len(ROUTES), 16, N), dtype=torch.float32, device=device)
    rc = build.launch(_lib().wgmma_probe, ta.device, ta.data_ptr(), tb.data_ptr(), tc.data_ptr(),
                      out.data_ptr(), a.shape[0])
    if rc != 0:
        raise RuntimeError(f"wgmma_probe: kernel launch failed (CUDA error {rc})")
    torch.cuda.synchronize(ta.device)
    return out


def _sequential_f32(a, b, c):
    """c + a[:, :, 0] b[0] + a[:, :, 1] b[1] + ..., each step rounded to f32."""
    d = c.astype(np.float32).copy()
    for k in range(a.shape[2]):
        d = (d + (a[:, :, k, None] * b[:, None, k, :]).astype(np.float32)).astype(np.float32)
    return d


def probe(device="cuda", n: int = 512, seed: int = 0) -> dict:
    """Per class and wgmma route: elements whose bits differ from
    mma.sync's (of n * 16 * N) and the largest |difference|.  Per class
    also the elements where mma.sync differs from a sequential f32 sum in k
    order (the class shows the tensor cores' own summation), and whether
    mma.sync is within 1e-5 of the float64 product, relative to the sum of
    |terms| (``sane``: the probe computes D = A B + C).  ``equal`` is True
    when no element of any class differs on any route."""
    rng = np.random.default_rng(seed)
    report = {"elements": n * 16 * N, "classes": {}, "sane": True}
    for kind in CLASSES:
        a, b, c = problems(kind, n, rng)
        out = run(a, b, c, device)
        ref = out[:, 0]
        row = {}
        for i, name in enumerate(ROUTES[1:], 1):
            got = out[:, i]
            same = (got.view(torch.int32) == ref.view(torch.int32)) | (got.isnan() & ref.isnan())
            diff = (got.double() - ref.double()).abs().nan_to_num(0.0)
            row[name] = {"differ": int((~same).sum()), "max_abs": float(diff.max())}
        mma = ref.cpu().numpy()
        row["mma.sync vs sequential f32 sum"] = int((mma != _sequential_f32(a, b, c)).sum())
        exact = np.einsum("nik,nkj->nij", a.astype(np.float64), b) + c
        scale = np.einsum("nik,nkj->nij", np.abs(a).astype(np.float64), np.abs(b)) + np.abs(c)
        worst = float((np.abs(mma - exact) / np.maximum(scale, 1e-300)).max())
        row["mma.sync vs float64, relative"] = worst
        report["sane"] &= kind == "subnormal" or worst <= 1e-5
        report["classes"][kind] = row
    report["equal"] = all(r["differ"] == 0 for c in report["classes"].values()
                          for k, r in c.items() if isinstance(r, dict))
    return report

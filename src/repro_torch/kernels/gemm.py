"""The row-invariant bf16 GEMM of the serving path: a hand-written CUDA
kernel (``csrc/gemm.cu``) and its plain version.

``gemm(x, w)`` computes ``x @ w`` for x [..., K] and w [K, N], bf16 in,
f32 sums, bf16 out.  It replaces no TPU kernel.  It exists because the
reference's bitwise reuse gate (a warm prefill over reused pages gives the
cold prefill's logits) needs projections whose rows do not depend on the
rows beside them: the kernel sums every output element's k16 steps from
k = 0 upward into one f32 accumulator, with no split-K, whatever M is, so
a decode step (M = the batch width), a prefill chunk (M = 32) and a
monolithic prefill (M = S) give one activation row the same bits.  A
library GEMM picks its kernel, split-K included, by shape.

``w`` is a [K, N] weight (N contiguous) or the transposed view of an
[N, K] table (K contiguous: qwen3's tied LM head ``embed.T``); both are
read in place, never copied.  A weight of any other layout is made
contiguous first, and a K or N that is not a multiple of 8 (the 16-byte
vector width) is zero-padded before the launch and the output sliced back
(choices made from the shape, not fallbacks: zero columns of K add
nothing).  On the card the kernel runs ``wgmma`` fed by TMA loads from a
producer warp, in persistent CTAs: 64-row tiles of one consumer warpgroup
up to M = 64 (the weight's bytes bound a decode step), 128-row tiles of
two from there (the tensor cores' operations bound a prefill); every tile
shape gives a row the same bits (``csrc/gemm.cu``).  TMA addresses each
operand through a tensor map: an operand past 2^31 rows or columns, or
with a row stride of 2^40 bytes or more, raises.

Dispatch: an operand that requires grad raises on either device
(``guard.refuse_grad``: the kernel has no backward; training keeps
``x @ w``, see ``models.layers.proj``); a CPU tensor goes to the plain
version ``x @ w``; a CUDA tensor goes to the kernel, and anything it does
not take raises.  ``gemm.launches`` counts kernel launches.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.kernels.guard import refuse_grad

_ARGTYPES = ([ctypes.c_void_p] * 3 + [ctypes.c_int] * 3 + [ctypes.c_int64] * 3
             + [ctypes.c_int, ctypes.c_int, ctypes.c_void_p])
_TMA_MAX_STRIDE = 1 << 40  # bytes: what a TMA tensor map can stride


def _lib() -> ctypes.CDLL:
    lib = build.load("gemm")
    fn = lib.gemm_forward
    if fn.argtypes is None:
        fn.argtypes = _ARGTYPES
        fn.restype = ctypes.c_int
    return lib


def gemm_ref(x, w):
    """The plain version: ``x @ w``."""
    return x @ w


def _pad_last(t, n):
    return t if n == 0 else torch.nn.functional.pad(t, (0, n))


def gemm(x, w):
    """``x @ w``.  x: [..., K] bf16; w: [K, N] bf16 (N contiguous, or the
    transpose of a K-contiguous [N, K] table) -> [..., N] bf16."""
    refuse_grad("gemm", x, w)
    if x.device.type == "cpu":
        return gemm_ref(x, w)
    name = "gemm"
    if x.device.type != "cuda" or w.device != x.device:
        raise ValueError(f"{name}: operands must be on one CUDA device, got {x.device} and {w.device}")
    if x.dtype != torch.bfloat16 or w.dtype != torch.bfloat16:
        raise TypeError(f"{name}: bfloat16 operands only, got {x.dtype} and {w.dtype}")
    if w.ndim != 2 or x.shape[-1] != w.shape[0]:
        raise ValueError(f"{name}: shape mismatch {tuple(x.shape)} @ {tuple(w.shape)}")
    K, N = w.shape
    lead = x.shape[:-1]
    a = x.reshape(-1, K)
    M = a.shape[0]
    if M == 0 or N == 0:
        return x.new_zeros((*lead, N))
    if K == 0:
        return x.new_zeros((*lead, N))
    kn = w.stride(1) == 1  # [K, N] row-major; else read w.T, an [N, K] table
    if not kn and w.stride(0) != 1:
        w, kn = w.contiguous(), True
    pk, pn = -K % 8, -N % 8
    if pk or pn:
        a = _pad_last(a, pk)
        w = _pad_last(torch.nn.functional.pad(w, (0, 0, 0, pk)), pn).contiguous()
        kn = True
    Kp, Np = K + pk, N + pn
    # a row stride is read only between rows: one row's stride may be anything
    lda = lambda t: t.stride(0) if t.shape[0] > 1 else t.shape[1]
    if a.stride(-1) != 1 or lda(a) % 8 or a.data_ptr() % 16:
        a = a.contiguous()
    bt = w if kn else w.T  # the memory as laid out: [K, N] or [N, K]
    if bt.stride(-1) != 1 or lda(bt) % 8 or bt.data_ptr() % 16:
        bt = bt.contiguous()
    if max(M, Np, Kp) >= 2 ** 31 or max(lda(a), lda(bt)) * 2 >= _TMA_MAX_STRIDE:
        raise ValueError(f"{name}: operands {tuple(a.shape)} @ {tuple(w.shape)} are past what "
                         "a TMA tensor map addresses")
    out = torch.empty((M, Np), dtype=torch.bfloat16, device=x.device)
    rc = build.launch(
        _lib().gemm_forward, x.device, a.data_ptr(), bt.data_ptr(), out.data_ptr(),
        M, Np, Kp, lda(a), lda(bt), Np, int(kn), 0,
    )
    if rc != 0:
        raise RuntimeError(f"{name}: kernel launch failed (CUDA error {rc})")
    gemm.launches += 1
    if pn:
        out = out[:, :N]
    return out.reshape(*lead, N)


gemm.launches = 0

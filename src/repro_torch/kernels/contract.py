"""The recurrences' f32 contractions, row-invariant: a hand-written CUDA
kernel (``csrc/contract.cu``) and its plain version.

``contract(a, b)`` is ``torch.matmul(a, b)`` for float32 ``a`` [*batch, M,
K] and ``b`` [*wbatch, K, J], where ``wbatch`` is a suffix of ``batch``
(each of a's rows meets one of b's matrices), or ``b`` [K, J] (one matrix
for every row of ``a`` [..., K]).  Flattened, that is ``y[r, j] = sum_k
x[r, k] W[w(r), k, j]`` with ``w(r) = (r // M) % prod(wbatch)``: the
mLSTM's per-row C and n (``models/xlstm.py``: q [B, nh, 1, dh] against C
[B, nh, dh, dh]), the sLSTM's per-head recurrent matrices (h against [nh,
dh, 4 dh]), the SSM's per-batch-row C_t (h [B, d_inner, N] against [B, N,
1]) and its shared dt projection ([B, S, dt_rank] against [dt_rank,
d_inner]).

It replaces no TPU kernel: the reference runs these as ``jnp.einsum`` / ``@``
in XLA.  It exists for the bits contract (``ROADMAP.md``): on cuBLAS a row's
product changed with the number of rows beside it, so a recurrent row's
state and logits depended on the batch width.  The kernel sums every output
element from k = 0 upward in one f32 accumulator, each product and sum
rounded alone, with no split of K, so row r's bits depend on row r alone.
It is bound by bytes where every row has its own matrix (the mLSTM's C) and
by the output's bytes or f32 operations elsewhere (``csrc/contract.cu``).

``ordered_contract`` writes that order out in torch f32 ops (tests only:
the card tests and ``chip_smoke.py`` hold the kernel to it bitwise).
``contract_ref``, the plain version, is ``torch.matmul`` itself: the
expression every call site had before the kernel, so the CPU route keeps
its bits.

Dispatch: an input that requires grad raises on either device
(``guard.refuse_grad``: the kernel has no backward; training keeps
``torch.matmul``, see ``models.layers.f32_contract``); a CPU tensor goes to
``contract_ref``; a CUDA tensor launches the kernel or raises (another
dtype, a geometry the kernel does not take, a failed launch); any other
device raises.  Operands are read in place through their strides where the
rows and b's matrices each fall in at most two and one strided levels, and
copied contiguous otherwise.  ``contract.launches`` counts kernel launches.
"""
from __future__ import annotations

import ctypes
import math
from typing import Dict, Tuple

import torch

from repro_torch.kernels import build
from repro_torch.kernels.guard import refuse_grad

_ARGTYPES = ([ctypes.c_void_p] * 3 + [ctypes.c_int64, ctypes.c_int, ctypes.c_int]
             + [ctypes.c_int64] * 8 + [ctypes.c_void_p])
_PLANS: Dict[tuple, tuple] = {}  # (shapes, strides) -> the launch's geometry


def _lib() -> ctypes.CDLL:
    lib = build.load("contract")
    fn = lib.contract_forward
    if fn.argtypes is None:
        fn.argtypes = _ARGTYPES
        fn.restype = ctypes.c_int
    return lib


def contract_ref(a, b):
    """The plain version: ``torch.matmul(a, b)``."""
    return torch.matmul(a, b)


def ordered_contract(a, b):
    """``torch.matmul(a, b)`` in the kernel's order, in torch f32 ops (tests
    only): from +0, for k ascending, ``acc = acc + a[..., k] * b[..., k, :]``,
    each product and each sum rounded on its own."""
    acc = torch.zeros((), dtype=torch.float32, device=a.device)
    for k in range(a.shape[-1]):
        acc = acc + a[..., :, k : k + 1] * b[..., k : k + 1, :]
    return acc


def sum_bound(a, b):
    """gamma_K sum_k |a_k b_kj| in float64, gamma_K = K 2^-24: how far a
    K-term f32 sum may lie from the exact one, so how far the kernel and
    ``torch.matmul`` may part (tests only)."""
    return a.shape[-1] * 2.0 ** -24 * torch.matmul(a.double().abs(), b.double().abs())


def _levels(shape, stride):
    """(size, stride) levels of the dims, outermost first: size-1 dims
    dropped, neighbours merged where one stride walks both."""
    out = []
    for n, s in zip(shape, stride):
        if n == 1:
            continue
        if out and out[-1][1] == s * n:
            out[-1] = (out[-1][0] * n, s)
        else:
            out.append((n, s))
    return out


def geometry(a, b) -> Tuple[bool, bool, tuple, tuple]:
    """How the kernel reads ``a`` and ``b``: (copy a contiguous first, copy
    b contiguous first, the output's shape, the launch's (R, K, J, div, mod,
    xn0, xs0, xs1, sw, sk, sj)) from the shapes and strides; raises on what
    the kernel does not take.  Rows of x sit at (r // xn0) xs1 + (r % xn0)
    xs0 with k contiguous; element (k, j) of matrix w at w sw + k sk + j sj."""
    if a.ndim < 1 or b.ndim < 2 or a.shape[-1] != b.shape[-2]:
        raise ValueError(f"contract: shapes {tuple(a.shape)} @ {tuple(b.shape)} do not contract")
    K, J = a.shape[-1], b.shape[-1]
    wbatch = tuple(b.shape[:-2])
    div, mod = 1, 1
    if wbatch:
        if len(wbatch) > a.ndim - 2 or tuple(a.shape[a.ndim - 2 - len(wbatch):-2]) != wbatch:
            raise ValueError(f"contract: b's batch {wbatch} is not a suffix of a's batch "
                             f"{tuple(a.shape[:-2])} (the kernel broadcasts b over a's rows only)")
        div, mod = a.shape[-2], math.prod(wbatch)
    R = math.prod(a.shape[:-1])
    rows = _levels(a.shape[:-1], a.stride()[:-1])
    copy_a = (K > 1 and a.stride(-1) != 1) or len(rows) > 2
    if copy_a:
        rows = [(R, K)]
    (xn0, xs0), xs1 = (rows[-1] if rows else (R, 0)), (rows[0][1] if len(rows) == 2 else 0)
    mats = _levels(wbatch, b.stride()[:-2])
    copy_b = len(mats) > 1
    sw = K * J if copy_b else (mats[0][1] if mats else 0)
    sk, sj = (J, 1) if copy_b else (b.stride(-2), b.stride(-1))
    out_shape = tuple(a.shape[:-1]) + (J,)
    return copy_a, copy_b, out_shape, (R, K, J, div, mod, xn0, xs0, xs1, sw, sk, sj)


def contract(a, b):
    """``torch.matmul(a, b)`` for float32 operands, each row's elements in
    one order (see the module note)."""
    refuse_grad("contract", a, b)
    if a.device.type == "cpu":
        return contract_ref(a, b)
    if a.device.type != "cuda" or b.device != a.device:
        raise ValueError(f"contract: operands must be on one CUDA device, got {a.device} and "
                         f"{b.device}")
    if a.dtype != torch.float32 or b.dtype != torch.float32:
        raise TypeError(f"contract: float32 operands only, got {a.dtype} and {b.dtype}")
    key = (a.shape, a.stride(), b.shape, b.stride())
    plan = _PLANS.get(key)
    if plan is None:
        if len(_PLANS) > 4096:
            _PLANS.clear()
        plan = _PLANS[key] = geometry(a, b)
    copy_a, copy_b, out_shape, args = plan
    R, K, J = args[:3]
    if R == 0 or J == 0:
        return a.new_empty(out_shape)
    if K == 0:
        return a.new_zeros(out_shape)
    if copy_a:
        a = a.contiguous()
    if copy_b:
        b = b.contiguous()
    out = torch.empty(out_shape, dtype=torch.float32, device=a.device)
    rc = build.launch(_lib().contract_forward, a.device, a.data_ptr(), b.data_ptr(),
                      out.data_ptr(), *args)
    if rc != 0:
        raise RuntimeError(f"contract: kernel launch failed (CUDA error {rc})")
    contract.launches += 1
    return out


contract.launches = 0

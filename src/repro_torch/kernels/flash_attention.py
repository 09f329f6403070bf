"""Flash attention for full-length prefill: a hand-written CUDA kernel
(``csrc/flash_attention.cu``) and its plain PyTorch version.

``flash_attention`` replaces the TPU kernel
``kernels/flash_attention.py:flash_attention_pallas``: tiled forward
attention with GQA, causal alignment (top-left, or with the query rows
starting at position ``q_offset``), a sliding window, tanh soft-capping and
f32 accumulation.  It runs once per layer in every full-length prefill of
the serving engine (the dense mode's ``prefill`` and the monolithic
``prefill_collect``), where the model hands it its [B, S, H, D] activations
as [B, H, S, D] views, without a copy, and in each rank's body of a
sequence-sharded prefill, whose query slice starts at ``q_offset``.

What bounds it on the card: at the serving shapes its roofline bound is
bytes (about 170 FLOPs per byte, under the bf16 ridge).  A bfloat16 call up
to head dim 256 runs the tensor-core kernel: the key order and the body of
the paged kernels (splits of 64 keys by position, ``paged_attention``'s
docstring), each split's partial folded into the row's running sums as the
split-KV merge folds it, so a prefill row gets the bits of the same row
served by the paged kernels.  A float32 call up to 256 runs the SIMT tile
kernel of f32 FMAs, which the 1e-5 checks need; past 256 both dtypes run
the split-KV SIMT kernel and the merge, any head dim.  The kernels load
16-byte vectors, so a head dim that is not a multiple of the vector width
(8 in bfloat16, 4 in float32) is zero-padded on the head axis before the
launch (``paged_attention.pad_heads``), the kernel gets the scale
``1 / sqrt(D)`` of the unpadded D, and the output is sliced back.  A query
row with no valid key (Sq > Sk under a causal window) gets the plain mean
of the Sk value rows, as the plain version gives it, in a branch that only
such rows take.

Dispatch: an input that requires grad raises on either device
(``guard.refuse_grad``: the kernel has no backward; training runs the
plain attention); a CPU tensor goes to the plain version (a port of the
JAX package's naive oracle, ``kernels/ref.py:flash_attention_ref``); a
CUDA tensor goes to the kernel of its dtype, and anything the kernels do
not take raises.  ``flash_attention.launches`` counts kernel launches.
``flash_attention_split_ref`` repeats the kernels' split structure and
``flash_attention_tiled_ref`` an online softmax over key tiles in plain
PyTorch for the tests; nothing on the card path calls them.
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import build
from repro_torch.kernels.guard import refuse_grad
from repro_torch.kernels.paged_attention import SPLIT_KEYS, merge_split_partials, pad_heads, split_partials

NEG_INF = -1e30

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_ARGTYPES = (
    [ctypes.c_int]
    + [ctypes.c_void_p] * 4
    + [ctypes.c_int64] * 12
    + [ctypes.c_int] * 9
    + [ctypes.c_float, ctypes.c_float, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p]
)


def _lib() -> ctypes.CDLL:
    lib = build.load("flash_attention")
    fn = lib.flash_attention_forward
    if fn.argtypes is None:
        fn.argtypes = _ARGTYPES
        fn.restype = ctypes.c_int
    return lib


def flash_attention_ref(q, k, v, *, causal: bool = True, window: int = 0, softcap: float = 0.0,
                        q_offset: int = 0):
    """Naive quadratic attention.  q: [B, H, Sq, D]; k, v: [B, KV, Sk, D]
    -> [B, H, Sq, D].  Query row i sits at position ``q_offset + i`` and key
    j at j (``q_offset = 0``: top-left causal)."""
    B, H, Sq, D = q.shape
    KV, Sk = k.shape[1], k.shape[2]
    G = H // KV
    qf = q.float().reshape(B, KV, G, Sq, D)
    s = torch.einsum("bkgqd,bksd->bkgqs", qf, k.float()) / math.sqrt(D)
    if softcap:
        s = softcap * torch.tanh(s / softcap)
    q_pos = q_offset + torch.arange(Sq, device=q.device)[:, None]
    k_pos = torch.arange(Sk, device=q.device)[None, :]
    mask = torch.ones((Sq, Sk), dtype=torch.bool, device=q.device)
    if causal:
        mask &= q_pos >= k_pos
    if window:
        mask &= q_pos - k_pos < window
    s = torch.where(mask, s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bkgqs,bksd->bkgqd", p, v.float())
    return out.reshape(B, H, Sq, D).to(q.dtype)


def flash_attention_tiled_ref(q, k, v, *, causal: bool = True, window: int = 0,
                              softcap: float = 0.0, q_offset: int = 0, block_k: int = 64,
                              p_dtype=torch.float32):
    """An f32 online softmax over key tiles of ``block_k``, the running sum
    l over the f32 weights, and the weights rounded to ``p_dtype`` before
    they multiply V (f32 sums; float32: the reference's weights).  A row
    with no valid key (its sum l still 0) gives the plain mean of the Sk
    value rows, as the kernels do.  Shapes and positions as
    ``flash_attention_ref``."""
    B, H, Sq, D = q.shape
    KV, Sk = k.shape[1], k.shape[2]
    G = H // KV
    qf = q.float().reshape(B, KV, G, Sq, D)
    kf, vf = k.float(), v.float()
    q_pos = q_offset + torch.arange(Sq, device=q.device)[:, None]
    m = torch.full((B, KV, G, Sq, 1), -math.inf, device=q.device)
    l = torch.zeros((B, KV, G, Sq, 1), device=q.device)
    acc = torch.zeros((B, KV, G, Sq, D), device=q.device)
    for k0 in range(0, Sk, block_k):
        kt, vt = kf[:, :, k0 : k0 + block_k], vf[:, :, k0 : k0 + block_k]
        s = torch.einsum("bkgqd,bksd->bkgqs", qf, kt) / math.sqrt(D)
        if softcap:
            s = softcap * torch.tanh(s / softcap)
        k_pos = torch.arange(k0, k0 + kt.shape[2], device=q.device)[None, :]
        mask = torch.ones((Sq, kt.shape[2]), dtype=torch.bool, device=q.device)
        if causal:
            mask &= q_pos >= k_pos
        if window:
            mask &= q_pos - k_pos < window
        s = s.masked_fill(~mask, -math.inf)
        m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
        base = torch.where(torch.isinf(m_new), 0.0, m_new)
        corr = torch.exp(m - base)
        w = torch.exp(s - base)
        l = l * corr + w.sum(dim=-1, keepdim=True)
        acc = acc * corr + torch.einsum("bkgqs,bksd->bkgqd", w.to(p_dtype).float(), vt)
        m = m_new
    out = acc / l.clamp_min(1e-30)
    if Sk:
        out = torch.where(l == 0, vf.mean(dim=2)[:, :, None, None], out)
    return out.reshape(B, H, Sq, D).to(q.dtype)


def flash_split_partials(q, k, v, *, causal: bool = True, window: int = 0,
                         softcap: float = 0.0, q_offset: int = 0, split: int = SPLIT_KEYS):
    """The kernels' per-split partials of ``flash_attention``, in plain
    PyTorch (``paged_attention.split_partials``): key j in slot j % split of
    split j // split, ``ceil(Sk / split)`` splits (at least one).  Returns
    f32 (m, l, acc) of shapes [B, KV, n, G, Sq], the same and
    [B, KV, n, G, Sq, D] (row g * Sq + i: query head kv * G + g at row i)."""
    B, H, Sq, D = q.shape
    KV, Sk = k.shape[1], k.shape[2]
    G = H // KV
    n = max(1, -(-Sk // split))
    pad = n * split - Sk
    kk = torch.cat([k.float(), k.new_zeros((B, KV, pad, D)).float()], dim=2)
    vv = torch.cat([v.float(), v.new_zeros((B, KV, pad, D)).float()], dim=2)
    x = torch.arange(n * split, device=q.device)
    kpos = x.reshape(1, n, split).expand(B * KV, n, split)
    qpos = (q_offset + torch.arange(Sq, device=q.device)).repeat(G)[None].expand(B * KV, G * Sq)
    m, l, acc = split_partials(
        q.reshape(B * KV, G * Sq, D), qpos, kk.reshape(B * KV, n, split, D),
        vv.reshape(B * KV, n, split, D), kpos, (x < Sk).reshape(1, n, split).expand(B * KV, n, split),
        causal=causal, window=window, softcap=softcap)
    return (m.reshape(B, KV, n, G, Sq), l.reshape(B, KV, n, G, Sq), acc.reshape(B, KV, n, G, Sq, D))


def flash_attention_split_ref(q, k, v, *, causal: bool = True, window: int = 0,
                              softcap: float = 0.0, q_offset: int = 0, split: int = SPLIT_KEYS):
    """``flash_attention`` as the kernels compute it: the split partials
    folded in order (``paged_attention.merge_split_partials``), a row with no
    valid key the plain mean of the Sk value rows."""
    B, H, Sq, D = q.shape
    m, l, acc = flash_split_partials(q, k, v, causal=causal, window=window, softcap=softcap,
                                     q_offset=q_offset, split=split)
    out = merge_split_partials(m, l, acc)  # [B, KV, G, Sq, D]
    if k.shape[2]:
        empty = torch.isinf(m).all(dim=2)[..., None]
        out = torch.where(empty, v.float().mean(dim=2)[:, :, None, None], out)
    return out.reshape(B, H, Sq, D).to(q.dtype)


def flash_attention(q, k, v, *, causal: bool = True, window: int = 0, softcap: float = 0.0,
                    q_offset: int = 0):
    """Forward attention.  q: [B, H, Sq, D]; k, v: [B, KV, Sk, D], any
    strides with D contiguous -> [B, H, Sq, D] (a view of a [B, Sq, H, D]
    buffer on the card, so ``out.transpose(1, 2)`` is contiguous).  Query
    row i sits at position ``q_offset + i``, key j at j."""
    refuse_grad("flash_attention", q, k, v)
    if q.device.type == "cpu":
        return flash_attention_ref(q, k, v, causal=causal, window=window, softcap=softcap,
                                   q_offset=q_offset)
    name = "flash_attention"
    if q_offset < 0:
        raise ValueError(f"{name}: q_offset {q_offset} must be >= 0")
    B, H, Sq, D = q.shape
    KV, Sk = k.shape[1], k.shape[2]
    if tuple(k.shape) != (B, KV, Sk, D) or v.shape != k.shape or KV == 0 or H % KV:
        raise ValueError(f"{name}: shape mismatch q {tuple(q.shape)} k {tuple(k.shape)} v {tuple(v.shape)}")
    d_true, (q, k, v) = pad_heads(name, q, k, v)
    D = q.shape[-1]
    vec = 16 // q.element_size()  # elements per 16-byte vector load
    for t in (k, v):
        if t.device != q.device or t.dtype != q.dtype:
            raise ValueError(f"{name}: every operand must be {q.dtype} on {q.device}")
    for t in (q, k, v):
        if t.stride(-1) != 1:
            raise ValueError(f"{name}: the head dimension must be contiguous")
        if t.data_ptr() % 16 or any(s % vec for s, n in zip(t.stride()[:-1], t.shape) if n > 1):
            raise ValueError(f"{name}: operands must be 16-byte aligned for vector loads")
    out = torch.empty((B, Sq, H, D), dtype=q.dtype, device=q.device).transpose(1, 2)
    if B == 0 or Sq == 0 or H == 0:
        return _unpad(out, d_true)
    if B > 65535 or H > 65535:
        raise ValueError(f"{name}: batch {B} and heads {H} must be <= 65535")
    # past head dim 256 the split-KV SIMT kernel's partials (f32 (m, l, acc)
    # per split and row) for the merge
    n_split, part = max(1, -(-Sk // SPLIT_KEYS)), None
    if D > 256:
        part = torch.empty(B * H * n_split * Sq * (D + 2), dtype=torch.float32, device=q.device)
    qs, ks, vs, os_ = q.stride(), k.stride(), v.stride(), out.stride()
    rc = build.launch(
        _lib().flash_attention_forward, q.device,
        _DTYPE_CODES[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        qs[0], qs[1], qs[2], ks[0], ks[1], ks[2], vs[0], vs[1], vs[2], os_[0], os_[1], os_[2],
        B, H, KV, Sq, Sk, D, int(bool(causal)), int(window), int(q_offset),
        1.0 / math.sqrt(d_true), float(softcap), None if part is None else part.data_ptr(), n_split,
    )
    if rc != 0:
        raise RuntimeError(f"{name}: kernel launch failed (CUDA error {rc})")
    flash_attention.launches += 1
    return _unpad(out, d_true)


def _unpad(out, d):
    """The first ``d`` head columns of [B, H, Sq, Dp], again a view of a
    [B, Sq, H, d] buffer (one copy, only for a padded head dim)."""
    if out.shape[-1] == d:
        return out
    return out[..., :d].transpose(1, 2).contiguous().transpose(1, 2)


flash_attention.launches = 0

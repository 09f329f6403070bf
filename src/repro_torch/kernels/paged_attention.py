"""Paged attention for the serving path: hand-written CUDA kernels and their
plain PyTorch versions.

Three entry points, one CUDA kernel body (``csrc/paged_attention.cu``):

* ``paged_decode_attention`` replaces the TPU kernel
  ``kernels/paged_attention.py:paged_decode_attention_pallas`` — the G grouped
  queries of each (sequence, kv head) attend the block-table prefix pages
  and then the dense in-flight tail.  It runs once per layer on every mixed
  decode+feed step.
* ``paged_prefill_attention`` replaces
  ``kernels/paged_attention.py:paged_prefill_attention_pallas`` — one chunk of
  queries at positions ``prefix_len + c`` attends the prefix pages and then
  its own keys causally.  It runs once per layer on every prefill chunk.
* ``paged_attention`` replaces ``kernels/paged_attention.py:paged_attention_pallas``
  — the G grouped queries of each (sequence, kv head) attend the first
  ``lengths[b]`` keys of the block-table pages: no tail, no causal cut, no
  window.  The kernel body runs it with no in-flight keys (T = 0) and the
  query at position ``lengths[b]``.  As in the JAX package, no model path
  calls it; it is held against the dense decode mode's ``attention_decode``.

What bounds all three on the card is bytes: every key/value element is used
for 4*G FLOPs at decode (G = 2 on qwen3-1.7b) and 4*G*C at prefill, far below
the ~295 FLOPs per byte where the H100's tensor cores would bound it.  The
kernel reads each page once per CTA with 16-byte vector loads, looks its page
ids up in the block table itself, and never loads pages past ``prefix_len``
or before the window (see the source for the design and what is left).

Dispatch: a CPU tensor goes to the plain version (a port of the JAX
package's dense-gather oracle, ``kernels/ref.py``); a CUDA tensor goes to the
kernel, and anything the kernel does not take raises.  Each wrapper counts
its launches in ``<wrapper>.launches``.
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import build

NEG_INF = -1e30

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_ARGTYPES = (
    [ctypes.c_int]
    + [ctypes.c_void_p] * 10
    + [ctypes.c_int64] * 7
    + [ctypes.c_int] * 9
    + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
)


def _lib() -> ctypes.CDLL:
    lib = build.load("paged_attention")
    fn = lib.paged_attention_forward
    if fn.argtypes is None:
        fn.argtypes = _ARGTYPES
        fn.restype = ctypes.c_int
    return lib


# ------------------------------------------------------------------ plain


def paged_decode_attention_ref(
    q, k_pages, v_pages, block_tables, prefix_len, k_tail, v_tail, tail_pos,
    cur_pos, *, softcap: float = 0.0, window: int = 0,
):
    """Dense-gather plain version of the batched paged-decode entry point.

    q: [B, KV, G, D]; k/v_pages: [KV, N, page, D]; block_tables: [B, P];
    prefix_len, cur_pos: [B]; k/v_tail: [B, KV, T, D]; tail_pos: [B, T]
    -> [B, KV, G, D].
    """
    B, KV, G, D = q.shape
    page = k_pages.shape[2]
    P = block_tables.shape[1]
    bt = block_tables.long()
    kd = k_pages[:, bt].permute(1, 0, 2, 3, 4).reshape(B, KV, P * page, D)
    vd = v_pages[:, bt].permute(1, 0, 2, 3, 4).reshape(B, KV, P * page, D)
    k_all = torch.cat([kd, k_tail], dim=2).float()
    v_all = torch.cat([vd, v_tail], dim=2).float()
    ppos = torch.arange(P * page, device=q.device).expand(B, P * page)
    ppos = torch.where(ppos < prefix_len[:, None].long(), ppos, -1)
    pos = torch.cat([ppos, tail_pos.long()], dim=1)  # [B, S]
    cur = cur_pos[:, None].long()
    s = torch.einsum("bkgd,bksd->bkgs", q.float(), k_all) / math.sqrt(D)
    if softcap:
        s = softcap * torch.tanh(s / softcap)
    valid = (pos >= 0) & (pos <= cur)
    if window:
        valid &= cur - pos < window
    s = torch.where(valid[:, None, None, :], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bkgs,bksd->bkgd", p, v_all).to(q.dtype)


def paged_prefill_attention_ref(
    q, k_pages, v_pages, block_tables, prefix_len, k_chunk, v_chunk,
    *, softcap: float = 0.0, window: int = 0,
):
    """Dense-gather plain version of the chunked-prefill entry point.

    Queries sit at absolute positions ``prefix_len[b] + c``; they attend the
    prefix pages (every prefix position precedes every chunk query) and the
    chunk's own keys causally.

    q: [B, KV, G, C, D]; k/v_pages: [KV, N, page, D]; block_tables: [B, P];
    prefix_len: [B]; k/v_chunk: [B, KV, C, D] -> [B, KV, G, C, D].
    """
    B, KV, G, C, D = q.shape
    page = k_pages.shape[2]
    P = block_tables.shape[1]
    bt = block_tables.long()
    kd = k_pages[:, bt].permute(1, 0, 2, 3, 4).reshape(B, KV, P * page, D)
    vd = v_pages[:, bt].permute(1, 0, 2, 3, 4).reshape(B, KV, P * page, D)
    k_all = torch.cat([kd, k_chunk], dim=2).float()
    v_all = torch.cat([vd, v_chunk], dim=2).float()
    plen = prefix_len[:, None].long()
    ppos = torch.arange(P * page, device=q.device).expand(B, P * page)
    ppos = torch.where(ppos < plen, ppos, -1)
    cpos = plen + torch.arange(C, device=q.device)[None, :]
    pos = torch.cat([ppos, cpos], dim=1)  # [B, S]
    qpos = cpos  # [B, C]
    s = torch.einsum("bkgcd,bksd->bkgcs", q.float(), k_all) / math.sqrt(D)
    if softcap:
        s = softcap * torch.tanh(s / softcap)
    valid = (pos[:, None, :] >= 0) & (pos[:, None, :] <= qpos[:, :, None])  # [B, C, S]
    if window:
        valid &= qpos[:, :, None] - pos[:, None, :] < window
    s = torch.where(valid[:, None, None], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bkgcs,bksd->bkgcd", p, v_all).to(q.dtype)


def paged_attention_ref(q, k_pages, v_pages, block_tables, lengths, *, softcap: float = 0.0):
    """Dense-gather plain version of the decode entry point over pages only.

    q: [B, KV, G, D]; k/v_pages: [KV, N, page, D]; block_tables: [B, P];
    lengths: [B] -> [B, KV, G, D].  Block-table entries are wrapped and
    clamped into [0, N) as the JAX package's gather does, so entries past
    ``lengths`` may hold anything.  A ``lengths[b] == 0`` row returns the
    plain mean of all P * page gathered value rows (the reference's dense
    softmax over a fully masked row); the kernel returns zeros there.
    """
    B, KV, G, D = q.shape
    N, page = k_pages.shape[1], k_pages.shape[2]
    P = block_tables.shape[1]
    bt = block_tables.long()
    bt = torch.where(bt < 0, bt + N, bt).clamp(0, N - 1)
    kd = k_pages[:, bt].permute(1, 0, 2, 3, 4).reshape(B, KV, P * page, D).float()
    vd = v_pages[:, bt].permute(1, 0, 2, 3, 4).reshape(B, KV, P * page, D).float()
    s = torch.einsum("bkgd,bksd->bkgs", q.float(), kd) / math.sqrt(D)
    if softcap:
        s = softcap * torch.tanh(s / softcap)
    pos = torch.arange(P * page, device=q.device)[None, :]
    s = torch.where((pos < lengths[:, None].long())[:, None, None, :], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bkgs,bksd->bkgd", p, vd).to(q.dtype)


# ----------------------------------------------------------------- kernel


def _check_operands(name, q, k_pages, v_pages, extras, ints):
    dev = q.device
    if dev.type != "cuda":
        raise ValueError(f"{name}: unsupported device {dev}")
    if q.dtype not in _DTYPE_CODES:
        raise TypeError(f"{name}: dtype {q.dtype} not supported (float32, bfloat16)")
    vec = 16 // q.element_size()
    D = q.shape[-1]
    if D > 128 or D % vec:
        raise ValueError(f"{name}: head_dim {D} must be <= 128 and a multiple of {vec}")
    for t in (k_pages, v_pages, *extras):
        if t.device != dev or t.dtype != q.dtype:
            raise ValueError(f"{name}: every operand must be {q.dtype} on {dev}")
    for t in (k_pages, v_pages):
        if not t.is_contiguous():
            raise ValueError(f"{name}: the page pool must be contiguous")
    for t in (q, *extras):
        if t.stride(-1) != 1:
            raise ValueError(f"{name}: the head dimension must be contiguous")
    for t in (k_pages, v_pages, *extras):
        if t.data_ptr() % 16 or any(s % vec for s in t.stride()[:-1]):
            raise ValueError(f"{name}: operands must be 16-byte aligned for vector loads")
    for t in ints:
        if t.device != dev or t.dtype != torch.int32 or not t.is_contiguous():
            raise ValueError(f"{name}: index operands must be contiguous int32 on {dev}")


def paged_decode_attention(
    q, k_pages, v_pages, block_tables, prefix_len, k_tail, v_tail, tail_pos,
    cur_pos, *, softcap: float = 0.0, window: int = 0,
):
    """Batched decode-step attention over paged prefix KV plus a dense tail.

    q: [B, KV, G, D]; k/v_pages: [KV, N, page, D]; block_tables: [B, P]
    int32; prefix_len, cur_pos: [B] int32; k/v_tail: [B, KV, T, D] (any
    strides with D contiguous, the same for k and v); tail_pos: [B, T] int32
    (-1 = empty) -> [B, KV, G, D].
    """
    if q.device.type == "cpu":
        return paged_decode_attention_ref(
            q, k_pages, v_pages, block_tables, prefix_len, k_tail, v_tail,
            tail_pos, cur_pos, softcap=softcap, window=window,
        )
    B, KV, G, D = q.shape
    KVp, N, page, Dp = k_pages.shape
    T = k_tail.shape[2]
    _check_operands(
        "paged_decode_attention", q, k_pages, v_pages, (k_tail, v_tail),
        (block_tables, prefix_len, tail_pos, cur_pos),
    )
    if (KVp, Dp) != (KV, D) or tuple(k_tail.shape) != (B, KV, T, D):
        raise ValueError("paged_decode_attention: shape mismatch")
    if k_tail.stride() != v_tail.stride() or tuple(tail_pos.shape) != (B, T):
        raise ValueError("paged_decode_attention: tail layout mismatch")
    out = torch.empty((B, KV, G, D), dtype=q.dtype, device=q.device)
    if B == 0:
        return out
    qs = q.stride()
    es = k_tail.stride()
    stream = torch.cuda.current_stream(q.device).cuda_stream
    rc = _lib().paged_attention_forward(
        _DTYPE_CODES[q.dtype], q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
        block_tables.data_ptr(), prefix_len.data_ptr(), k_tail.data_ptr(),
        v_tail.data_ptr(), tail_pos.data_ptr(), cur_pos.data_ptr(), out.data_ptr(),
        qs[0], qs[1], qs[2], 0, es[0], es[1], es[2],
        B, KV, G, 1, D, N, page, block_tables.shape[1], T,
        float(softcap), int(window), stream,
    )
    if rc != 0:
        raise RuntimeError(f"paged_decode_attention: kernel launch failed (CUDA error {rc})")
    paged_decode_attention.launches += 1
    return out


paged_decode_attention.launches = 0


def paged_prefill_attention(
    q, k_pages, v_pages, block_tables, prefix_len, k_chunk, v_chunk,
    *, softcap: float = 0.0, window: int = 0,
):
    """Chunked-prefill attention over paged prefix KV plus the chunk itself.

    q: [B, KV, G, C, D] (any strides with D contiguous); k/v_pages:
    [KV, N, page, D]; block_tables: [B, P] int32; prefix_len: [B] int32;
    k/v_chunk: [B, KV, C, D] (same strides for k and v) -> [B, KV, G, C, D].
    """
    if q.device.type == "cpu":
        return paged_prefill_attention_ref(
            q, k_pages, v_pages, block_tables, prefix_len, k_chunk, v_chunk,
            softcap=softcap, window=window,
        )
    B, KV, G, C, D = q.shape
    KVp, N, page, Dp = k_pages.shape
    _check_operands(
        "paged_prefill_attention", q, k_pages, v_pages, (k_chunk, v_chunk),
        (block_tables, prefix_len),
    )
    if (KVp, Dp) != (KV, D) or tuple(k_chunk.shape) != (B, KV, C, D):
        raise ValueError("paged_prefill_attention: shape mismatch")
    if k_chunk.stride() != v_chunk.stride():
        raise ValueError("paged_prefill_attention: chunk layout mismatch")
    out = torch.empty((B, KV, G, C, D), dtype=q.dtype, device=q.device)
    if B == 0 or C == 0:
        return out
    qs = q.stride()
    es = k_chunk.stride()
    stream = torch.cuda.current_stream(q.device).cuda_stream
    rc = _lib().paged_attention_forward(
        _DTYPE_CODES[q.dtype], q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
        block_tables.data_ptr(), prefix_len.data_ptr(), k_chunk.data_ptr(),
        v_chunk.data_ptr(), None, None, out.data_ptr(),
        qs[0], qs[1], qs[2], qs[3], es[0], es[1], es[2],
        B, KV, G, C, D, N, page, block_tables.shape[1], C,
        float(softcap), int(window), stream,
    )
    if rc != 0:
        raise RuntimeError(f"paged_prefill_attention: kernel launch failed (CUDA error {rc})")
    paged_prefill_attention.launches += 1
    return out


paged_prefill_attention.launches = 0


def paged_attention(q, k_pages, v_pages, block_tables, lengths, *, softcap: float = 0.0):
    """Decode attention over the first ``lengths[b]`` keys of each
    sequence's block-table pages.

    q: [B, KV, G, D] (any strides with D contiguous); k/v_pages:
    [KV, N, page, D]; block_tables: [B, P] int32 (entries at or past page
    ``ceil(lengths[b] / page)`` are never read); lengths: [B] int32
    -> [B, KV, G, D].
    """
    if q.device.type == "cpu":
        return paged_attention_ref(q, k_pages, v_pages, block_tables, lengths, softcap=softcap)
    B, KV, G, D = q.shape
    KVp, N, page, Dp = k_pages.shape
    _check_operands(
        "paged_attention", q, k_pages, v_pages, (), (block_tables, lengths),
    )
    if (KVp, Dp) != (KV, D) or tuple(lengths.shape) != (B,) or block_tables.shape[0] != B:
        raise ValueError("paged_attention: shape mismatch")
    out = torch.empty((B, KV, G, D), dtype=q.dtype, device=q.device)
    if B == 0:
        return out
    qs = q.stride()
    stream = torch.cuda.current_stream(q.device).cuda_stream
    # no in-flight keys (T = 0, null tail) and no cur_pos: the query sits at
    # position lengths[b], so the kernel's mask is k_pos < lengths[b]
    rc = _lib().paged_attention_forward(
        _DTYPE_CODES[q.dtype], q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
        block_tables.data_ptr(), lengths.data_ptr(), None, None, None, None, out.data_ptr(),
        qs[0], qs[1], qs[2], 0, 0, 0, 0,
        B, KV, G, 1, D, N, page, block_tables.shape[1], 0,
        float(softcap), 0, stream,
    )
    if rc != 0:
        raise RuntimeError(f"paged_attention: kernel launch failed (CUDA error {rc})")
    paged_attention.launches += 1
    return out


paged_attention.launches = 0

"""Paged attention for the serving path: hand-written CUDA kernels and their
plain PyTorch versions.

Three entry points over two CUDA sources:

* ``paged_decode_attention`` replaces the TPU kernel
  ``kernels/paged_attention.py:paged_decode_attention_pallas`` — the G grouped
  queries of each (sequence, kv head) attend the block-table prefix pages
  and then the dense in-flight tail.  It runs once per layer on every mixed
  decode+feed step, as a split-KV kernel (``csrc/paged_decode.cu``): the
  keys are cut into splits of ``SPLIT_KEYS`` by key index, one CTA per
  (sequence, kv head, split) writes an f32 partial, and a second kernel
  launched by the same C call merges the partials in split order.
* ``paged_prefill_attention`` replaces
  ``kernels/paged_attention.py:paged_prefill_attention_pallas`` — one chunk of
  queries at positions ``prefix_len + c`` attends the prefix pages and then
  its own keys causally.  It runs once per layer on every prefill chunk
  (``csrc/paged_attention.cu``).
* ``paged_attention`` replaces ``kernels/paged_attention.py:paged_attention_pallas``
  — the G grouped queries of each (sequence, kv head) attend the first
  ``lengths[b]`` keys of the block-table pages: no tail, no causal cut, no
  window.  It runs the split-KV kernel with no in-flight keys (T = 0) and
  the query at position ``lengths[b]``.  As in the JAX package, no model
  path calls it; it is held against the dense decode mode's
  ``attention_decode``.

What bounds all three on the card is bytes: every key/value element is used
for 4*G FLOPs at decode (G = 2 on qwen3-1.7b) and 4*G*C at prefill, far below
the ~295 FLOPs per byte where the H100's tensor cores would bound it.  The
kernels look page ids up in the block table themselves and never load pages
past ``prefix_len`` or before the window (see the sources for the designs).

Dispatch: a CPU tensor goes to the plain version (a port of the JAX
package's dense-gather oracle, ``kernels/ref.py``); a CUDA tensor goes to the
kernel, and anything the kernel does not take raises.  Each wrapper counts
its launches in ``<wrapper>.launches``.  ``paged_decode_split_partials`` and
``merge_split_partials`` repeat the split-KV kernel's arithmetic in plain
PyTorch for the tests; nothing on the card path calls them.
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


_DECODE_ARGTYPES = (
    [ctypes.c_int]
    + [ctypes.c_void_p] * 11
    + [ctypes.c_int64] * 6
    + [ctypes.c_int] * 11
    + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
)
SPLIT_KEYS = 64  # keys per split of the split-KV decode kernel (csrc/paged_decode.cu)


def _lib() -> ctypes.CDLL:
    lib = build.load("paged_attention")
    fn = lib.paged_attention_forward
    if fn.argtypes is None:
        fn.argtypes = _ARGTYPES
        fn.restype = ctypes.c_int
    return lib


def _decode_lib() -> ctypes.CDLL:
    lib = build.load("paged_decode")
    fn = lib.paged_decode_forward
    if fn.argtypes is None:
        fn.argtypes = _DECODE_ARGTYPES
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


def _pad_keys(x, n, dim, value=0):
    """``x`` with ``n`` more entries of ``value`` along ``dim``."""
    if n == 0:
        return x
    shape = list(x.shape)
    shape[dim] = n
    return torch.cat([x, torch.full(shape, value, dtype=x.dtype, device=x.device)], dim=dim)


def paged_decode_split_partials(
    q, k_pages, v_pages, block_tables, prefix_len, k_tail, v_tail, tail_pos,
    cur_pos, *, softcap: float = 0.0, window: int = 0, split: int = SPLIT_KEYS,
):
    """The split-KV decode kernel's per-split partials, in plain PyTorch.

    Prefix split i holds prefix keys [i*split, (i+1)*split); the tail is cut
    the same way after the ``ceil(P*page / split)`` prefix splits (at least
    one split in all).  A key is attended as in ``paged_decode_attention_ref``,
    except that a block-table entry outside [0, N) is no key (the kernel's
    rule).  ``cur_pos=None`` puts the query at ``prefix_len`` (the T = 0 entry
    of ``paged_attention``).  Returns f32 (m, l, acc) of shapes
    [B, KV, n_split, G], [B, KV, n_split, G] and [B, KV, n_split, G, D]; an
    empty split has m = -inf, l = 0, acc = 0.
    """
    B, KV, G, D = q.shape
    N, page = k_pages.shape[1], k_pages.shape[2]
    P, T = block_tables.shape[1], k_tail.shape[2]
    n_pre, n_tail = -(-P * page // split), -(-T // split)
    n = max(1, n_pre + n_tail)
    bt = block_tables.long()
    safe = bt.clamp(0, N - 1)
    kd = k_pages[:, safe].permute(1, 0, 2, 3, 4).reshape(B, KV, P * page, D)
    vd = v_pages[:, safe].permute(1, 0, 2, 3, 4).reshape(B, KV, P * page, D)
    cur = (prefix_len if cur_pos is None else cur_pos).long()[:, None]
    kidx = torch.arange(P * page, device=q.device)[None]
    pre_ok = ((bt >= 0) & (bt < N)).repeat_interleave(page, dim=1)
    pre_ok &= (kidx < prefix_len.long()[:, None]) & (kidx <= cur)
    tpos = tail_pos.long()
    tail_ok = (tpos >= 0) & (tpos <= cur)
    if window:
        pre_ok &= cur - kidx < window
        tail_ok &= cur - tpos < window
    fill_pre, fill_tail = n_pre * split - P * page, n_tail * split - T
    fill_end = (n - n_pre - n_tail) * split
    keys = lambda a, b, d, v=0: _pad_keys(
        torch.cat([_pad_keys(a, fill_pre, d, v), _pad_keys(b, fill_tail, d, v)], dim=d), fill_end, d, v)
    k_all = keys(kd, k_tail, 2).float().reshape(B, KV, n, split, D)
    v_all = keys(vd, v_tail, 2).float().reshape(B, KV, n, split, D)
    valid = keys(pre_ok, tail_ok, 1, False).reshape(B, 1, n, 1, split)
    s = torch.einsum("bkgd,bknsd->bkngs", q.float(), k_all) / math.sqrt(D)
    if softcap:
        s = softcap * torch.tanh(s / softcap)
    s = s.masked_fill(~valid, -math.inf)
    m = s.amax(dim=-1)
    w = torch.exp(s - torch.where(torch.isinf(m), 0.0, m)[..., None])
    return m, w.sum(dim=-1), torch.einsum("bkngs,bknsd->bkngd", w, v_all)


def merge_split_partials(m, l, acc):
    """The combine kernel's merge: M = max m_i, out = sum acc_i exp(m_i - M)
    / max(sum l_i exp(m_i - M), 1e-30), empty splits skipped.  m, l:
    [B, KV, n_split, G]; acc: [B, KV, n_split, G, D] -> [B, KV, G, D] f32."""
    M = m.amax(dim=2, keepdim=True)
    w = torch.where(torch.isinf(m), 0.0, torch.exp(m - torch.where(torch.isinf(M), 0.0, M)))
    L = (l * w).sum(dim=2)
    return (acc * w[..., None]).sum(dim=2) / L.clamp_min(1e-30)[..., None]


def paged_decode_attention_split_ref(*args, softcap: float = 0.0, window: int = 0,
                                     split: int = SPLIT_KEYS):
    """``paged_decode_attention`` as the split-KV kernel computes it (a row
    with no valid key gives zeros)."""
    out = merge_split_partials(*paged_decode_split_partials(
        *args, softcap=softcap, window=window, split=split))
    return out.to(args[0].dtype)


def paged_attention_split_ref(q, k_pages, v_pages, block_tables, lengths, *,
                              softcap: float = 0.0, split: int = SPLIT_KEYS):
    """``paged_attention`` as the split-KV kernel computes it: T = 0, the
    query at ``lengths[b]``."""
    B, KV, G, D = q.shape
    tail = q.new_zeros((B, KV, 0, D))
    tpos = torch.zeros((B, 0), dtype=torch.int32, device=q.device)
    out = merge_split_partials(*paged_decode_split_partials(
        q, k_pages, v_pages, block_tables, lengths, tail, tail, tpos, None,
        softcap=softcap, split=split))
    return out.to(q.dtype)


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


def _split_decode(name, q, k_pages, v_pages, block_tables, prefix_len, k_tail, v_tail,
                  tail_pos, cur_pos, softcap, window):
    """One call of ``paged_decode_forward``: the split kernel and the merge."""
    B, KV, G, D = q.shape
    N, page = k_pages.shape[1], k_pages.shape[2]
    P = block_tables.shape[1]
    T = 0 if k_tail is None else k_tail.shape[2]
    if D % 8 or G > 8 or block_tables.shape[0] != B or tuple(prefix_len.shape) != (B,):
        raise ValueError(f"{name}: head_dim {D} must be a multiple of 8, G {G} <= 8, "
                         "one block-table row and one length per sequence")
    out = torch.empty((B, KV, G, D), dtype=q.dtype, device=q.device)
    if B == 0:
        return out
    n_pre = -(-P * page // SPLIT_KEYS)
    n_split = max(1, n_pre + -(-T // SPLIT_KEYS))
    part = torch.empty(B * KV * n_split * G * (D + 2), dtype=torch.float32, device=q.device)
    qs = q.stride()
    es = (0, 0, 0) if k_tail is None else k_tail.stride()
    ptr = lambda t: None if t is None else t.data_ptr()
    stream = torch.cuda.current_stream(q.device).cuda_stream
    rc = _decode_lib().paged_decode_forward(
        _DTYPE_CODES[q.dtype], q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
        block_tables.data_ptr(), prefix_len.data_ptr(), ptr(k_tail), ptr(v_tail),
        ptr(tail_pos), ptr(cur_pos), out.data_ptr(), part.data_ptr(),
        qs[0], qs[1], qs[2], es[0], es[1], es[2],
        B, KV, G, D, N, page, P, T, SPLIT_KEYS, n_pre, n_split,
        float(softcap), int(window), stream,
    )
    if rc != 0:
        raise RuntimeError(f"{name}: kernel launch failed (CUDA error {rc})")
    return out


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
    out = _split_decode(
        "paged_decode_attention", q, k_pages, v_pages, block_tables, prefix_len,
        k_tail, v_tail, tail_pos, cur_pos, softcap, window,
    )
    if B:
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
    # no in-flight keys (T = 0, null tail) and no cur_pos: the query sits at
    # position lengths[b], so the kernel's mask is k_pos < lengths[b]
    out = _split_decode(
        "paged_attention", q, k_pages, v_pages, block_tables, lengths, None, None, None, None,
        softcap, 0,
    )
    if B:
        paged_attention.launches += 1
    return out


paged_attention.launches = 0

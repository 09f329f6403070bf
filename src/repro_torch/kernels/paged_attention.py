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
  (``csrc/paged_attention.cu``).  In bfloat16 it is a split-KV kernel on the
  tensor cores: the prefix keys are cut into splits of
  ``PREFILL_SPLIT_KEYS`` by key index and the chunk's own keys form one
  more split, one CTA per (sequence, kv head, 64 stacked (chunk position,
  head) rows, split) writes an f32 partial, and the merge of the decode
  kernel (``csrc/split_merge.cuh``), launched by the same C call, merges the
  partials in split order.  In float32 (the card tests' 1e-5 path) it is a
  SIMT kernel of f32 FMAs.
* ``paged_attention`` replaces ``kernels/paged_attention.py:paged_attention_pallas``
  — the G grouped queries of each (sequence, kv head) attend the first
  ``lengths[b]`` keys of the block-table pages: no tail, no causal cut, no
  window.  It runs the split-KV kernel with no in-flight keys (T = 0) and
  the query at position ``lengths[b]``.  As in the JAX package, no model
  path calls it; it is held against the dense decode mode's
  ``attention_decode``.

All three take head dims up to ``MAX_HEAD_DIM`` (512) and any number G of
query heads per kv head; the sources say how (padded tile widths 160 and
256; at decode a CTA per 8 heads, and in bfloat16 up to D = 160 and G = 4 a
key over 10 lanes of 16 elements; past 256, in both dtypes, plain SIMT
kernels whose scores sum every column in f32: ``wide_split_kernel`` at
decode, feeding the same merge, and the f32 prefill kernel's 512-column
instantiation at prefill).  A head dim past 512 raises.  The kernels load
16-byte vectors, so a head dim that is not a multiple of the vector width
(8 in bfloat16, 4 in float32) is zero-padded on the head axis to the next
multiple before the launch (``pad_heads``, a
choice made from the shape, not a fallback), the kernel is told the scale
``1 / sqrt(D)`` of the unpadded D, and the output is sliced back to D: zero
columns add nothing to a score.  A decode
row with no valid key gets what the JAX reference's dense softmax gives
it: the plain mean of every gathered value row.

What bounds all three on the card is bytes: every key/value element is used
for 4*G FLOPs at decode (G = 2 on qwen3-1.7b) and 4*G*C at prefill (256 at
G*C = 64), below the ~295 FLOPs per byte where the H100's bf16 tensor cores
would bound it; the prefill kernel reaches that regime only because its
bfloat16 products run on the tensor cores (on the CUDA cores in f32 the same
prefill work would be bound by operations).  The kernels look page ids up in
the block table themselves and never load pages past ``prefix_len`` or
before the window (see the sources for the designs).

Dispatch: an input that requires grad raises on either device
(``guard.refuse_grad``: the kernels have no backward); a CPU tensor goes
to the plain version (a port of the JAX package's dense-gather oracle,
``kernels/ref.py``); a CUDA tensor goes to the kernel, and anything the
kernel does not take raises.  Each wrapper counts
its launches in ``<wrapper>.launches``.  ``paged_decode_split_partials``,
``paged_prefill_split_partials`` and ``merge_split_partials`` repeat the
split-KV kernels' arithmetic in plain PyTorch for the tests; nothing on the
card path calls them.
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import build
from repro_torch.kernels.guard import refuse_grad

NEG_INF = -1e30
MAX_HEAD_DIM = 512  # the kernels' widest head dim (the SIMT routes past 256)

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_ARGTYPES = (
    [ctypes.c_int]
    + [ctypes.c_void_p] * 9
    + [ctypes.c_int64] * 7
    + [ctypes.c_int] * 11
    + [ctypes.c_float, ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
)


_DECODE_ARGTYPES = (
    [ctypes.c_int]
    + [ctypes.c_void_p] * 11
    + [ctypes.c_int64] * 6
    + [ctypes.c_int] * 11
    + [ctypes.c_float, ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
)
SPLIT_KEYS = 64  # keys per split of the split-KV decode kernel (csrc/paged_decode.cu)
PREFILL_SPLIT_KEYS = 128  # prefix keys per split of the bf16 prefill kernel (csrc/paged_attention.cu)


def _gather_ids(block_tables, n_pages):
    """Block-table entries as the JAX reference's gather reads them: a
    negative entry wraps once (numpy indexing), then every entry is clamped
    into [0, n_pages)."""
    bt = block_tables.long()
    return torch.where(bt < 0, bt + n_pages, bt).clamp(0, n_pages - 1)


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
    -> [B, KV, G, D].  Block-table entries are wrapped and clamped as the
    JAX package's gather does.  A row with no valid key gets the plain mean
    of all ``P * page + T`` value rows (the reference's dense softmax over a
    fully masked row).
    """
    B, KV, G, D = q.shape
    page = k_pages.shape[2]
    P = block_tables.shape[1]
    bt = _gather_ids(block_tables, k_pages.shape[1])
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
    Block-table entries are wrapped and clamped as in
    ``paged_decode_attention_ref``.
    """
    B, KV, G, C, D = q.shape
    page = k_pages.shape[2]
    P = block_tables.shape[1]
    bt = _gather_ids(block_tables, k_pages.shape[1])
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
    softmax over a fully masked row), as the kernel does.
    """
    B, KV, G, D = q.shape
    page = k_pages.shape[2]
    P = block_tables.shape[1]
    bt = _gather_ids(block_tables, k_pages.shape[1])
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
    rule).  A row with no valid key by index (no prefix key under
    ``prefix_len``, ``cur_pos`` and the window, no valid tail position)
    weights every key of every split equally, page ids wrapped and clamped
    as the reference's gather does: each split gives m = 0, l = its key
    count, acc = the sum of its value rows, and the merge gives their mean.
    ``cur_pos=None`` puts the query at ``prefix_len`` (the T = 0 entry of
    ``paged_attention``).  Heads are independent, so the kernel's CTAs of
    at most 8 heads (G > 8) change nothing here.  Returns f32 (m, l, acc)
    of shapes [B, KV, n_split, G], [B, KV, n_split, G] and
    [B, KV, n_split, G, D]; an empty split has m = -inf, l = 0, acc = 0.
    """
    B, KV, G, D = q.shape
    N, page = k_pages.shape[1], k_pages.shape[2]
    P, T = block_tables.shape[1], k_tail.shape[2]
    n_pre, n_tail = -(-P * page // split), -(-T // split)
    n = max(1, n_pre + n_tail)
    bt = block_tables.long()
    ids = _gather_ids(bt, N)
    kd = k_pages[:, ids].permute(1, 0, 2, 3, 4).reshape(B, KV, P * page, D)
    vd = v_pages[:, ids].permute(1, 0, 2, 3, 4).reshape(B, KV, P * page, D)
    cur = (prefix_len if cur_pos is None else cur_pos).long()[:, None]
    kidx = torch.arange(P * page, device=q.device)[None]
    pre_ok = (kidx < prefix_len.long()[:, None]) & (kidx <= cur)
    tpos = tail_pos.long()
    tail_ok = (tpos >= 0) & (tpos <= cur)
    if window:
        pre_ok &= cur - kidx < window
        tail_ok &= cur - tpos < window
    none = ~(pre_ok.any(dim=1) | tail_ok.any(dim=1))  # [B]: no valid key by index
    pre_ok = (pre_ok & ((bt >= 0) & (bt < N)).repeat_interleave(page, dim=1)) | none[:, None]
    tail_ok = tail_ok | none[:, None]
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
    s = torch.where(none[:, None, None, None, None], 0.0, s)
    s = s.masked_fill(~valid, -math.inf)
    m = s.amax(dim=-1)
    w = torch.exp(s - torch.where(torch.isinf(m), 0.0, m)[..., None])
    return m, w.sum(dim=-1), torch.einsum("bkngs,bknsd->bkngd", w, v_all)


def _tiled_partials(q, k, v, valid, softcap, block_k, p_dtype):
    """Per-split (m, l, acc) of q [B, KV, G, C, D] over k, v
    [B, KV, n, S, D] with valid [B, n, C, S]: an f32 online softmax over
    tiles of ``block_k`` keys (0: one tile), the weights rounded to
    ``p_dtype`` before they multiply V."""
    B, KV, G, C, D = q.shape
    n, S = k.shape[2], k.shape[3]
    m = torch.full((B, KV, n, G, C), -math.inf, device=q.device)
    l = torch.zeros((B, KV, n, G, C), device=q.device)
    acc = torch.zeros((B, KV, n, G, C, D), device=q.device)
    step = block_k or max(S, 1)
    for k0 in range(0, S, step):
        kt, vt = k[:, :, :, k0 : k0 + step], v[:, :, :, k0 : k0 + step]
        s = torch.einsum("bkgcd,bknsd->bkngcs", q, kt) / math.sqrt(D)
        if softcap:
            s = softcap * torch.tanh(s / softcap)
        s = s.masked_fill(~valid[:, None, :, None, :, k0 : k0 + step], -math.inf)
        m_new = torch.maximum(m, s.amax(dim=-1))
        base = torch.where(torch.isinf(m_new), 0.0, m_new)
        corr = torch.exp(m - base)
        w = torch.exp(s - base[..., None])
        l = l * corr + w.sum(dim=-1)
        acc = acc * corr[..., None] + torch.einsum("bkngcs,bknsd->bkngcd", w.to(p_dtype).float(), vt)
        m = m_new
    return m, l, acc


def paged_prefill_split_partials(
    q, k_pages, v_pages, block_tables, prefix_len, k_chunk, v_chunk,
    *, softcap: float = 0.0, window: int = 0, split: int = PREFILL_SPLIT_KEYS,
    block_k: int = 0, p_dtype=torch.float32,
):
    """The bf16 chunked-prefill kernel's per-split partials, in plain PyTorch.

    Prefix split i holds prefix keys [i*split, (i+1)*split) for the
    ``ceil(P*page / split)`` prefix splits; the chunk's C keys form the last
    split.  Row (g, c) sits at position ``prefix_len + c`` and attends as in
    ``paged_prefill_attention_ref``, except that a block-table entry outside
    [0, N) is no key (the kernel's rule).  Within a split the keys are
    walked in tiles of ``block_k`` (0: all at once) by an f32 online softmax
    whose weights are rounded to ``p_dtype`` before they multiply V (the
    kernel: 64-key tiles and bf16 weights; its two warpgroups take alternate
    tiles and merge, which moves only the f32 rounding).  Returns f32
    (m, l, acc) of shapes [B, KV, n_split, G, C], the same and
    [B, KV, n_split, G, C, D]; an empty split has m = -inf, l = 0, acc = 0.
    """
    B, KV, G, C, D = q.shape
    N, page = k_pages.shape[1], k_pages.shape[2]
    P = block_tables.shape[1]
    n_pre = -(-P * page // split)
    bt = block_tables.long()
    safe = bt.clamp(0, N - 1)
    kd = k_pages[:, safe].permute(1, 0, 2, 3, 4).reshape(B, KV, P * page, D)
    vd = v_pages[:, safe].permute(1, 0, 2, 3, 4).reshape(B, KV, P * page, D)
    plen = prefix_len.long()[:, None, None]
    c = torch.arange(C, device=q.device)
    kidx = torch.arange(P * page, device=q.device)
    pre_ok = ((bt >= 0) & (bt < N)).repeat_interleave(page, dim=1)[:, None, :] & (kidx < plen)
    chunk_ok = (c[None, :] <= c[:, None])[None]  # [1, C, C]: key t <= row c
    if window:
        pre_ok = pre_ok & (plen + c[:, None] - kidx < window)
        chunk_ok = chunk_ok & (c[:, None] - c[None, :] < window)
    fill = n_pre * split - P * page
    k_pre = _pad_keys(kd, fill, 2).float().reshape(B, KV, n_pre, split, D)
    v_pre = _pad_keys(vd, fill, 2).float().reshape(B, KV, n_pre, split, D)
    ok_pre = _pad_keys(pre_ok.expand(B, C, P * page), fill, 2, False).reshape(B, C, n_pre, split)
    qf = q.float()
    pre = _tiled_partials(qf, k_pre, v_pre, ok_pre.transpose(1, 2), softcap, block_k, p_dtype)
    own = _tiled_partials(qf, k_chunk[:, :, None].float(), v_chunk[:, :, None].float(),
                          chunk_ok.expand(B, C, C)[:, None], softcap, block_k, p_dtype)
    return tuple(torch.cat([a, b], dim=2) for a, b in zip(pre, own))


def paged_prefill_attention_split_ref(*args, softcap: float = 0.0, window: int = 0,
                                      split: int = PREFILL_SPLIT_KEYS, block_k: int = 0,
                                      p_dtype=torch.float32):
    """``paged_prefill_attention`` as the bf16 split-KV kernel computes it
    (a row with no valid key gives zeros); ``block_k=64`` with bf16
    ``p_dtype`` models its tensor-core arithmetic."""
    out = merge_split_partials(*paged_prefill_split_partials(
        *args, softcap=softcap, window=window, split=split, block_k=block_k, p_dtype=p_dtype))
    return out.to(args[0].dtype)


def merge_split_partials(m, l, acc):
    """The split merge (``csrc/split_merge.cuh``): M = max m_i, out =
    sum acc_i exp(m_i - M) / max(sum l_i exp(m_i - M), 1e-30), empty splits
    skipped (the kernel folds the splits in one pass with a running max,
    which moves only the f32 rounding).  m, l: [B, KV, n_split, *rows];
    acc: [B, KV, n_split, *rows, D] -> [B, KV, *rows, D] f32 (rows: G at
    decode, G, C at prefill)."""
    M = m.amax(dim=2, keepdim=True)
    w = torch.where(torch.isinf(m), 0.0, torch.exp(m - torch.where(torch.isinf(M), 0.0, M)))
    L = (l * w).sum(dim=2)
    return (acc * w[..., None]).sum(dim=2) / L.clamp_min(1e-30)[..., None]


def paged_decode_attention_split_ref(*args, softcap: float = 0.0, window: int = 0,
                                     split: int = SPLIT_KEYS):
    """``paged_decode_attention`` as the split-KV kernel computes it."""
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


def pad_heads(name, q, *others):
    """Check that ``q`` is a kernel operand (a CUDA tensor of a kernel's
    dtype, head dim <= ``MAX_HEAD_DIM``), then zero-pad ``q`` and ``others`` (None
    passes through) on the last axis to the next multiple of the 16-byte
    vector width.  Returns (unpadded D, the padded tensors)."""
    if q.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {q.device}")
    if q.dtype not in _DTYPE_CODES:
        raise TypeError(f"{name}: dtype {q.dtype} not supported (float32, bfloat16)")
    D = q.shape[-1]
    if D > MAX_HEAD_DIM:
        raise ValueError(f"{name}: head_dim {D} must be <= {MAX_HEAD_DIM}")
    vec = 16 // q.element_size()  # elements per 16-byte vector load
    pad = -D % vec
    if pad:
        fix = lambda t: None if t is None else torch.nn.functional.pad(t, (0, pad))
        return D, (fix(q), *(fix(t) for t in others))
    return D, (q, *others)


def _check_operands(name, q, k_pages, v_pages, extras, ints):
    dev = q.device
    if dev.type != "cuda":
        raise ValueError(f"{name}: unsupported device {dev}")
    if q.dtype not in _DTYPE_CODES:
        raise TypeError(f"{name}: dtype {q.dtype} not supported (float32, bfloat16)")
    vec = 16 // q.element_size()  # elements per 16-byte vector load
    D = q.shape[-1]
    if D > MAX_HEAD_DIM or D % vec:
        raise ValueError(f"{name}: head_dim {D} must be <= {MAX_HEAD_DIM} and a multiple of "
                         f"{vec} for {q.dtype}")
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
                  tail_pos, cur_pos, softcap, window, d_true):
    """One call of ``paged_decode_forward``: the split kernel and the merge
    (``d_true``: the head dim before padding, which sets the scale)."""
    B, KV, G, D = q.shape
    N, page = k_pages.shape[1], k_pages.shape[2]
    P = block_tables.shape[1]
    T = 0 if k_tail is None else k_tail.shape[2]
    if block_tables.shape[0] != B or tuple(prefix_len.shape) != (B,):
        raise ValueError(f"{name}: one block-table row and one length per sequence")
    out = torch.empty((B, KV, G, D), dtype=q.dtype, device=q.device)
    if B == 0:
        return out
    n_pre = -(-P * page // SPLIT_KEYS)
    n_split = max(1, n_pre + -(-T // SPLIT_KEYS))
    part = torch.empty(B * KV * n_split * G * (D + 2), dtype=torch.float32, device=q.device)
    qs = q.stride()
    es = (0, 0, 0) if k_tail is None else k_tail.stride()
    ptr = lambda t: None if t is None else t.data_ptr()
    rc = build.launch(
        _decode_lib().paged_decode_forward, q.device,
        _DTYPE_CODES[q.dtype], q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
        block_tables.data_ptr(), prefix_len.data_ptr(), ptr(k_tail), ptr(v_tail),
        ptr(tail_pos), ptr(cur_pos), out.data_ptr(), part.data_ptr(),
        qs[0], qs[1], qs[2], es[0], es[1], es[2],
        B, KV, G, D, N, page, P, T, SPLIT_KEYS, n_pre, n_split,
        1.0 / math.sqrt(d_true), float(softcap), int(window),
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
    refuse_grad("paged_decode_attention", q, k_pages, v_pages, k_tail, v_tail)
    if q.device.type == "cpu":
        return paged_decode_attention_ref(
            q, k_pages, v_pages, block_tables, prefix_len, k_tail, v_tail,
            tail_pos, cur_pos, softcap=softcap, window=window,
        )
    B, KV, G, D = q.shape
    KVp, N, page, Dp = k_pages.shape
    T = k_tail.shape[2]
    if (KVp, Dp) != (KV, D) or tuple(k_tail.shape) != (B, KV, T, D):
        raise ValueError("paged_decode_attention: shape mismatch")
    if k_tail.stride() != v_tail.stride() or tuple(tail_pos.shape) != (B, T):
        raise ValueError("paged_decode_attention: tail layout mismatch")
    D, (q, k_pages, v_pages, k_tail, v_tail) = pad_heads(
        "paged_decode_attention", q, k_pages, v_pages, k_tail, v_tail)
    _check_operands(
        "paged_decode_attention", q, k_pages, v_pages, (k_tail, v_tail),
        (block_tables, prefix_len, tail_pos, cur_pos),
    )
    out = _split_decode(
        "paged_decode_attention", q, k_pages, v_pages, block_tables, prefix_len,
        k_tail, v_tail, tail_pos, cur_pos, softcap, window, D,
    )
    if B:
        paged_decode_attention.launches += 1
    return out[..., :D]


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
    refuse_grad("paged_prefill_attention", q, k_pages, v_pages, k_chunk, v_chunk)
    if q.device.type == "cpu":
        return paged_prefill_attention_ref(
            q, k_pages, v_pages, block_tables, prefix_len, k_chunk, v_chunk,
            softcap=softcap, window=window,
        )
    name = "paged_prefill_attention"
    B, KV, G, C, D = q.shape
    KVp, N, page, Dp = k_pages.shape
    P = block_tables.shape[1]
    if (KVp, Dp) != (KV, D) or tuple(k_chunk.shape) != (B, KV, C, D):
        raise ValueError(f"{name}: shape mismatch")
    if block_tables.shape[0] != B or tuple(prefix_len.shape) != (B,):
        raise ValueError(f"{name}: one block-table row and one prefix length per sequence")
    if k_chunk.stride() != v_chunk.stride():
        raise ValueError(f"{name}: chunk layout mismatch")
    d_true, (q, k_pages, v_pages, k_chunk, v_chunk) = pad_heads(
        name, q, k_pages, v_pages, k_chunk, v_chunk)
    _check_operands(name, q, k_pages, v_pages, (k_chunk, v_chunk), (block_tables, prefix_len))
    D = q.shape[-1]
    out = torch.empty((B, KV, G, C, D), dtype=q.dtype, device=q.device)
    if B == 0 or C == 0:
        return out
    # bfloat16 up to D = 256 (the tensor cores): the prefix splits over the
    # table's width, then the chunk's split; f32 (m, l, acc) per split and
    # row for the merge.  The SIMT kernel (f32, or D past 256) needs none.
    n_pre = -(-P * page // PREFILL_SPLIT_KEYS)
    n_split = n_pre + 1
    part = None
    if q.dtype == torch.bfloat16 and D <= 256:
        part = torch.empty(B * KV * n_split * G * C * (D + 2), dtype=torch.float32, device=q.device)
    qs = q.stride()
    es = k_chunk.stride()
    rc = build.launch(
        _lib().paged_attention_forward, q.device,
        _DTYPE_CODES[q.dtype], q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
        block_tables.data_ptr(), prefix_len.data_ptr(), k_chunk.data_ptr(),
        v_chunk.data_ptr(), out.data_ptr(), None if part is None else part.data_ptr(),
        qs[0], qs[1], qs[2], qs[3], es[0], es[1], es[2],
        B, KV, G, C, D, N, page, P, PREFILL_SPLIT_KEYS, n_pre, n_split,
        1.0 / math.sqrt(d_true), float(softcap), int(window),
    )
    if rc != 0:
        raise RuntimeError(f"{name}: kernel launch failed (CUDA error {rc})")
    paged_prefill_attention.launches += 1
    return out[..., :d_true]


paged_prefill_attention.launches = 0


def paged_attention(q, k_pages, v_pages, block_tables, lengths, *, softcap: float = 0.0):
    """Decode attention over the first ``lengths[b]`` keys of each
    sequence's block-table pages.

    q: [B, KV, G, D] (any strides with D contiguous); k/v_pages:
    [KV, N, page, D]; block_tables: [B, P] int32 (entries at or past page
    ``ceil(lengths[b] / page)`` are never read); lengths: [B] int32
    -> [B, KV, G, D].
    """
    refuse_grad("paged_attention", q, k_pages, v_pages)
    if q.device.type == "cpu":
        return paged_attention_ref(q, k_pages, v_pages, block_tables, lengths, softcap=softcap)
    B, KV, G, D = q.shape
    KVp, N, page, Dp = k_pages.shape
    if (KVp, Dp) != (KV, D) or tuple(lengths.shape) != (B,) or block_tables.shape[0] != B:
        raise ValueError("paged_attention: shape mismatch")
    D, (q, k_pages, v_pages) = pad_heads("paged_attention", q, k_pages, v_pages)
    _check_operands(
        "paged_attention", q, k_pages, v_pages, (), (block_tables, lengths),
    )
    # no in-flight keys (T = 0, null tail) and no cur_pos: the query sits at
    # position lengths[b], so the kernel's mask is k_pos < lengths[b]
    out = _split_decode(
        "paged_attention", q, k_pages, v_pages, block_tables, lengths, None, None, None, None,
        softcap, 0, D,
    )
    if B:
        paged_attention.launches += 1
    return out[..., :D]


paged_attention.launches = 0

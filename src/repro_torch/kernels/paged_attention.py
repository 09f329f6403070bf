"""Paged attention for the serving path: hand-written CUDA kernels and their
plain PyTorch versions.

Three entry points over two CUDA sources, both front ends of the split-KV
kernels of ``csrc/attention_split.cuh``:

* ``paged_decode_attention`` replaces the TPU kernel
  ``kernels/paged_attention.py:paged_decode_attention_pallas`` — the G grouped
  queries of each (sequence, kv head) attend the block-table prefix pages
  and then the dense in-flight tail.  It runs once per layer on every mixed
  decode+feed step (``csrc/paged_decode.cu``).
* ``paged_prefill_attention`` replaces
  ``kernels/paged_attention.py:paged_prefill_attention_pallas`` — one chunk of
  queries at positions ``prefix_len + c`` attends the prefix pages and then
  its own keys causally.  It runs once per layer on every prefill chunk
  (``csrc/paged_attention.cu``).
* ``paged_attention`` replaces ``kernels/paged_attention.py:paged_attention_pallas``
  — the G grouped queries of each (sequence, kv head) attend the first
  ``lengths[b]`` keys of the block-table pages: no tail, no causal cut, no
  window.  It runs the decode kernels with no in-flight keys (T = 0) and
  the query at position ``lengths[b]``.  As in the JAX package, no model
  path calls it; it is held against the dense decode mode's
  ``attention_decode``.

One key order for every route.  The keys of a query row are cut into
splits of ``SPLIT_KEYS`` (64) by absolute position, wherever they are
stored (pool pages, the decode tail, the prefill chunk, and
``flash_attention``'s contiguous K/V), one CTA per (sequence, kv head, row
tile, split) writes the split's f32 partial from one body, and a merge
launched by the same C call folds the splits in ascending order.  So the
same query over the same keys gives the same bits in a decode step, in a
prefill chunk that starts anywhere and in a flash prefill: a reused page
serves what a cold run serves.  In bfloat16 up to head dim 256 the body
runs on the tensor cores (QK^T and P V on mma.sync, P split into two bf16
terms, about 16 of its bits); float32 (the card tests' 1e-5 path) and head
dims past 256 run a SIMT body of f32 FMAs whose head dim is walked in
slices of 512 columns, so any head dim runs.

All three take any head dim and any number G of query heads per kv head.
The kernels load 16-byte vectors, so a head dim that is not a multiple of
the vector width (8 in bfloat16, 4 in float32) is zero-padded on the head
axis to the next multiple before the launch (``pad_heads``, a choice made
from the shape, not a fallback), the kernel is told the scale
``1 / sqrt(D)`` of the unpadded D, and the output is sliced back to D:
zero columns add nothing to a score.  A decode row with no valid key gets
what the JAX reference's dense softmax gives it: the plain mean of every
gathered value row.

What bounds all three on the card is bytes: every key/value element is used
for 4*G FLOPs at decode (G = 2 on qwen3-1.7b) and 4*G*C at prefill (256 at
G*C = 64), below the ~295 FLOPs per byte where the H100's bf16 tensor cores
would bound it.  The kernels look page ids up in the block table themselves
and never load pages past ``prefix_len`` (see the sources for the designs).

Dispatch: an input that requires grad raises on either device
(``guard.refuse_grad``: the kernels have no backward); a CPU tensor goes to
the plain version (a port of the JAX package's dense-gather oracle,
``kernels/ref.py``); a CUDA tensor goes to the kernel, and anything the
kernel does not take raises.  Each wrapper counts its launches in
``<wrapper>.launches``.  ``split_partials``, ``paged_decode_split_partials``,
``paged_prefill_split_partials`` and ``merge_split_partials`` repeat the
split-KV kernels' structure in plain PyTorch for the tests, one row
independent of every other (so the three routes' plain models give a row
the same bits on the CPU); nothing on the card path calls them.
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import build
from repro_torch.kernels.guard import refuse_grad

NEG_INF = -1e30

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
SPLIT_KEYS = 64  # key positions per split of every attention kernel (csrc/attention_split.cuh)


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


def _exp(x):
    """``exp`` in float64, rounded once to float32: the f32 exp of ATen's
    vectorised loop body and of its scalar tail differ in the last bit, so
    an f32 exp would depend on an element's place in its tensor."""
    return torch.exp(x.double()).float()


def split_partials(q, qpos, k, v, kpos, present, *, causal=True, window=0, softcap=0.0,
                   uniform=None, block_k=0, p_dtype=torch.float32):
    """The split-KV kernels' per-split partials, in plain PyTorch, one row
    independent of every other: every reduction is a loop of elementwise
    ops in a fixed order (q.k over the head dim, then each split's keys in
    slot order) and exp and tanh run in float64, so a row's partials depend
    only on its query, its position and its splits' keys, whatever the
    tensors' shapes.  That is the property the kernels keep on the card.

    q: [L, R, D] rows, qpos: [L, R] their positions; k, v: [L, n, S, D]
    split key slots, kpos, present: [L, n, S] their positions and whether
    the slot holds a key; uniform: [L] bool or None, rows with no valid key
    (every present key scores 0).  Scores are q.k / sqrt(D), soft-capped,
    masked (a slot without a key; with ``causal`` a key past the row; with
    ``window`` a key at or past ``window`` before it).  Within a split the
    keys are walked in tiles of ``block_k`` (0: one tile) by an online
    softmax whose weights are rounded to ``p_dtype`` before they multiply V
    (float32: the reference's f32 weights; the kernels keep about 16 bits
    of them).  Returns f32 (m, l, acc) of shapes [L, n, R], [L, n, R] and
    [L, n, R, D]; a split the row attends nothing of has m = -inf, l = 0,
    acc = 0.
    """
    L, R, D = q.shape
    n, S = k.shape[1], k.shape[2]
    qf, kf, vf = q.float()[:, None, :, None, :], k.float()[:, :, None, :, :], v.float()
    s = torch.zeros((L, n, R, S), device=q.device)
    for d in range(D):
        s = s + qf[..., d] * kf[..., d]
    s = s / math.sqrt(D)
    if softcap:
        s = softcap * torch.tanh((s / softcap).double()).float()
    qp, kp = qpos.long()[:, None, :, None], kpos.long()[:, :, None, :]
    has = present[:, :, None, :].expand(L, n, R, S)
    valid = has
    if causal:
        valid = valid & (kp <= qp)
    if window:
        valid = valid & (qp - kp < window)
    if uniform is not None:
        u = uniform[:, None, None, None]
        valid = torch.where(u, has, valid)
        s = torch.where(u, 0.0, s)
    s = s.masked_fill(~valid, -math.inf)
    m = torch.full((L, n, R), -math.inf, device=q.device)
    l = torch.zeros((L, n, R), device=q.device)
    acc = torch.zeros((L, n, R, D), device=q.device)
    step = block_k or max(S, 1)
    for k0 in range(0, S, step):
        st = s[..., k0 : k0 + step]
        m_new = torch.maximum(m, st.amax(dim=-1))
        base = torch.where(torch.isinf(m_new), 0.0, m_new)
        corr = _exp(m - base)
        w = _exp(st - base[..., None])
        lsum = torch.zeros_like(l)
        asum = torch.zeros_like(acc)
        for j in range(w.shape[-1]):
            lsum = lsum + w[..., j]
            asum = asum + w[..., j, None].to(p_dtype).float() * vf[:, :, None, k0 + j]
        l = l * corr + lsum
        acc = acc * corr[..., None] + asum
        m = m_new
    return m, l, acc


def merge_split_partials(m, l, acc):
    """The split merge (``csrc/split_merge.cuh``): the splits folded in
    ascending order into a running (M, L, O), empty splits (m = -inf)
    skipped: M' = max(M, m_i), c = exp(M - M'), w = exp(m_i - M'),
    L' = l_i w + L c, O' = acc_i w + O c; out = O / max(L, 1e-30).
    m, l: [B, KV, n_split, *rows]; acc: [B, KV, n_split, *rows, D]
    -> [B, KV, *rows, D] f32 (rows: G at decode, G, C at prefill)."""
    M = torch.full_like(m[:, :, 0], -math.inf)
    Ls = torch.zeros_like(l[:, :, 0])
    O = torch.zeros_like(acc[:, :, 0])
    for i in range(m.shape[2]):
        mi = m[:, :, i]
        ok = ~torch.isinf(mi)
        mn = torch.where(ok, torch.maximum(M, mi), M)
        c = _exp(M - mn)
        w = _exp(mi - mn)
        Ls = torch.where(ok, l[:, :, i] * w + Ls * c, Ls)
        O = torch.where(ok[..., None], acc[:, :, i] * w[..., None] + O * c[..., None], O)
        M = mn
    return O / Ls.clamp_min(1e-30)[..., None]


def _slots(x, n, split, src, fill=0):
    """[B, KV, X, ...] or [B, X] tensors cut into n splits of ``split``."""
    pad = n * split - x.shape[src]
    if pad:
        shape = list(x.shape)
        shape[src] = pad
        x = torch.cat([x, torch.full(shape, fill, dtype=x.dtype, device=x.device)], dim=src)
    return x.unflatten(src, (n, split))


def _take(x, idx):
    """x [B, KV, T, D] at per-sequence slot indices idx [B, X] -> [B, KV, X, D]."""
    B, KV, _, D = x.shape
    return torch.gather(x, 2, idx[:, None, :, None].expand(B, KV, idx.shape[1], D))


def paged_decode_split_partials(
    q, k_pages, v_pages, block_tables, prefix_len, k_tail, v_tail, tail_pos,
    cur_pos, *, softcap: float = 0.0, window: int = 0, split: int = SPLIT_KEYS,
):
    """The split-KV decode kernel's per-split partials, in plain PyTorch
    (``split_partials`` on the kernel's key slots).

    The first ``n_pos = max(1, ceil((P*page + T) / split))`` splits hold
    positions [i*split, (i+1)*split): position x is the prefix page key when
    x < min(prefix_len, P*page) (no key when its table entry is outside
    [0, N)), else the tail slot t = x - prefix_len when tail_pos[t] == x
    (and 0 <= prefix_len <= P*page).  A tail slot at any other valid
    position takes one of ``ceil(T / split)`` more splits by slot index.  A
    row with no valid key by index (no prefix key under ``prefix_len``,
    ``cur_pos`` and the window, no valid tail position) instead weights
    every key of its gathered window equally: position splits by gathered
    index (every table column, page ids wrapped and clamped as the
    reference's gather does, then every tail slot), each key scoring 0, so
    the merge gives their mean.  ``cur_pos=None`` puts the query at
    ``prefix_len`` (the T = 0 entry of ``paged_attention``).  Returns f32
    (m, l, acc) of shapes [B, KV, n_split, G], [B, KV, n_split, G] and
    [B, KV, n_split, G, D].
    """
    B, KV, G, D = q.shape
    N, page = k_pages.shape[1], k_pages.shape[2]
    P, T = block_tables.shape[1], k_tail.shape[2]
    PP = P * page
    n_pos, n_irr = max(1, -(-(PP + T) // split)), -(-T // split)
    X = n_pos * split
    dev = q.device
    bt = block_tables.long()
    ids = _gather_ids(bt, N)
    kd = k_pages[:, ids].permute(1, 0, 2, 3, 4).reshape(B, KV, PP, D)
    vd = v_pages[:, ids].permute(1, 0, 2, 3, 4).reshape(B, KV, PP, D)
    plen = prefix_len.long()[:, None]
    cur = (prefix_len if cur_pos is None else cur_pos).long()[:, None]
    n_prefix = plen.clamp(0, PP)
    regular = (plen >= 0) & (plen <= PP)
    tpos = tail_pos.long()
    kidx = torch.arange(PP, device=dev)[None]
    pre_ok = (kidx < plen) & (kidx <= cur)
    tail_ok = (tpos >= 0) & (tpos <= cur)
    if window:
        pre_ok &= cur - kidx < window
        tail_ok &= cur - tpos < window
    none = ~(pre_ok.any(dim=1) | tail_ok.any(dim=1))  # [B]: no valid key by index
    x = torch.arange(X, device=dev)[None].expand(B, X)
    page_id_ok = ((bt >= 0) & (bt < N)).repeat_interleave(page, dim=1)  # [B, PP]
    on_page = (x < n_prefix) & torch.cat(
        [page_id_ok, torch.zeros((B, X - PP), dtype=torch.bool, device=dev)], dim=1)[:, :X]
    t = (x - plen).clamp(0, max(T - 1, 0))
    on_tail = regular & (x >= plen) & (x - plen < T)
    if T:
        on_tail &= torch.gather(tpos, 1, t) == x
    # the gathered window of a row with no valid key: table columns, then tail slots
    g_page, g_tail = x < PP, (x >= PP) & (x - PP < T)
    tg = (x - PP).clamp(0, max(T - 1, 0))
    on_page = torch.where(none[:, None], g_page, on_page)
    on_tail = torch.where(none[:, None], g_tail, on_tail)
    t = torch.where(none[:, None], tg, t)

    def keys(pages, tail):
        pg = _slots(pages, n_pos, split, 2)
        tl = _take(tail, t) if T else torch.zeros_like(pg.flatten(2, 3))
        tl = _slots(tl, n_pos, split, 2)
        return torch.where(_slots(on_page, n_pos, split, 1)[:, None, ..., None], pg,
                           torch.where(_slots(on_tail, n_pos, split, 1)[:, None, ..., None], tl, 0))

    k_all, v_all = keys(kd, k_tail), keys(vd, v_tail)
    present = _slots(on_page | on_tail, n_pos, split, 1)
    kpos = _slots(x, n_pos, split, 1)
    if n_irr:  # tail slots at other positions, by slot index
        ti = torch.arange(n_irr * split, device=dev)[None].expand(B, -1)
        tp = torch.gather(tpos, 1, ti.clamp(max=T - 1))
        irr = (ti < T) & (tp >= 0) & ~(regular & (tp == plen + ti)) & ~none[:, None]
        ki = _slots(torch.where(irr[:, None, :, None], _take(k_tail, ti.clamp(max=T - 1)), 0), n_irr, split, 2)
        vi = _slots(torch.where(irr[:, None, :, None], _take(v_tail, ti.clamp(max=T - 1)), 0), n_irr, split, 2)
        k_all, v_all = torch.cat([k_all, ki], dim=2), torch.cat([v_all, vi], dim=2)
        present = torch.cat([present, _slots(irr, n_irr, split, 1)], dim=1)
        kpos = torch.cat([kpos, _slots(tp, n_irr, split, 1)], dim=1)
    n = n_pos + n_irr
    flat = lambda a: a.flatten(0, 1)
    rep = lambda a: a[:, None].expand(B, KV, *a.shape[1:])
    m, l, acc = split_partials(
        flat(q), flat(cur[:, None].expand(B, KV, G)), flat(k_all), flat(v_all),
        flat(rep(kpos)), flat(rep(present)), causal=True, window=window, softcap=softcap,
        uniform=flat(none[:, None].expand(B, KV)))
    return (m.reshape(B, KV, n, G), l.reshape(B, KV, n, G), acc.reshape(B, KV, n, G, D))


def paged_prefill_split_partials(
    q, k_pages, v_pages, block_tables, prefix_len, k_chunk, v_chunk,
    *, softcap: float = 0.0, window: int = 0, split: int = SPLIT_KEYS,
    block_k: int = 0, p_dtype=torch.float32,
):
    """The chunked-prefill kernel's per-split partials, in plain PyTorch
    (``split_partials`` on the kernel's key slots).

    The first ``n_pos = ceil((P*page + C) / split)`` splits hold positions
    [i*split, (i+1)*split): position x is the prefix page key when
    x < min(prefix_len, P*page) (no key when its table entry is outside
    [0, N)), else chunk key x - prefix_len (when 0 <= prefix_len <=
    P*page).  The chunk is not a split of its own: its keys join the
    splits their positions fall in, so a chunk's start moves no key to
    another split.  (With prefix_len past P*page the chunk takes
    ``ceil(C / split)`` more splits by chunk index.)  Row (g, c) sits at
    position ``prefix_len + c`` and attends causally.  Returns f32
    (m, l, acc) of shapes [B, KV, n_split, G, C], the same and
    [B, KV, n_split, G, C, D].
    """
    B, KV, G, C, D = q.shape
    N, page = k_pages.shape[1], k_pages.shape[2]
    P = block_tables.shape[1]
    PP = P * page
    n_pos, n_irr = -(-(PP + C) // split), -(-C // split)
    X = n_pos * split
    dev = q.device
    bt = block_tables.long()
    safe = bt.clamp(0, N - 1)
    kd = k_pages[:, safe].permute(1, 0, 2, 3, 4).reshape(B, KV, PP, D)
    vd = v_pages[:, safe].permute(1, 0, 2, 3, 4).reshape(B, KV, PP, D)
    plen = prefix_len.long()[:, None]
    n_prefix = plen.clamp(0, PP)
    regular = (plen >= 0) & (plen <= PP)
    x = torch.arange(X, device=dev)[None].expand(B, X)
    page_id_ok = ((bt >= 0) & (bt < N)).repeat_interleave(page, dim=1)
    on_page = (x < n_prefix) & torch.cat(
        [page_id_ok, torch.zeros((B, X - PP), dtype=torch.bool, device=dev)], dim=1)[:, :X]
    on_chunk = regular & (x >= plen) & (x - plen < C)
    t = (x - plen).clamp(0, C - 1)

    def keys(pages, chunk):
        pg = _slots(pages, n_pos, split, 2)
        ch = _slots(_take(chunk, t), n_pos, split, 2)
        return torch.where(_slots(on_page, n_pos, split, 1)[:, None, ..., None], pg,
                           torch.where(_slots(on_chunk, n_pos, split, 1)[:, None, ..., None], ch, 0))

    k_all, v_all = keys(kd, k_chunk), keys(vd, v_chunk)
    present = _slots(on_page | on_chunk, n_pos, split, 1)
    kpos = _slots(x, n_pos, split, 1)
    # the chunk by chunk index, for a prefix_len past the table
    ti = torch.arange(n_irr * split, device=dev)[None].expand(B, -1)
    irr = ~regular & (ti < C)
    tc = ti.clamp(max=C - 1)
    k_all = torch.cat([k_all, _slots(torch.where(irr[:, None, :, None], _take(k_chunk, tc), 0), n_irr, split, 2)], dim=2)
    v_all = torch.cat([v_all, _slots(torch.where(irr[:, None, :, None], _take(v_chunk, tc), 0), n_irr, split, 2)], dim=2)
    present = torch.cat([present, _slots(irr, n_irr, split, 1)], dim=1)
    kpos = torch.cat([kpos, _slots(plen + ti, n_irr, split, 1)], dim=1)
    n = n_pos + n_irr
    rows = q.reshape(B * KV, G * C, D)  # row g * C + c
    qpos = (plen + torch.arange(C, device=dev)[None])[:, None, None, :].expand(B, KV, G, C)
    rep = lambda a: a[:, None].expand(B, KV, *a.shape[1:]).flatten(0, 1)
    m, l, acc = split_partials(
        rows, qpos.reshape(B * KV, G * C), k_all.flatten(0, 1), v_all.flatten(0, 1), rep(kpos),
        rep(present), causal=True, window=window, softcap=softcap, block_k=block_k,
        p_dtype=p_dtype)
    return (m.reshape(B, KV, n, G, C), l.reshape(B, KV, n, G, C), acc.reshape(B, KV, n, G, C, D))


def paged_prefill_attention_split_ref(*args, softcap: float = 0.0, window: int = 0,
                                      split: int = SPLIT_KEYS, block_k: int = 0,
                                      p_dtype=torch.float32):
    """``paged_prefill_attention`` as the split-KV kernel computes it (a row
    with no valid key gives zeros); ``block_k`` and ``p_dtype`` as in
    ``split_partials``."""
    out = merge_split_partials(*paged_prefill_split_partials(
        *args, softcap=softcap, window=window, split=split, block_k=block_k, p_dtype=p_dtype))
    return out.to(args[0].dtype)


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
    dtype), then zero-pad ``q`` and ``others`` (None passes through) on the
    last axis to the next multiple of the 16-byte vector width.  Returns
    (unpadded D, the padded tensors)."""
    if q.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {q.device}")
    if q.dtype not in _DTYPE_CODES:
        raise TypeError(f"{name}: dtype {q.dtype} not supported (float32, bfloat16)")
    D = q.shape[-1]
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
    if D % vec:
        raise ValueError(f"{name}: head_dim {D} must be a multiple of {vec} for {q.dtype}")
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
        if t.data_ptr() % 16 or any(s % vec for s, n in zip(t.stride()[:-1], t.shape) if n > 1):
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
    n_pos = max(1, -(-(P * page + T) // SPLIT_KEYS))
    n_split = n_pos + -(-T // SPLIT_KEYS)
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
        B, KV, G, D, N, page, P, T, SPLIT_KEYS, n_pos, n_split,
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
    # the position splits over the table's width and the chunk, then the
    # splits a prefix_len past the table would send the chunk to; f32
    # (m, l, acc) per split and row for the merge
    n_pos = -(-(P * page + C) // SPLIT_KEYS)
    n_split = n_pos + -(-C // SPLIT_KEYS)
    part = torch.empty(B * KV * n_split * G * C * (D + 2), dtype=torch.float32, device=q.device)
    qs = q.stride()
    es = k_chunk.stride()
    rc = build.launch(
        _lib().paged_attention_forward, q.device,
        _DTYPE_CODES[q.dtype], q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
        block_tables.data_ptr(), prefix_len.data_ptr(), k_chunk.data_ptr(),
        v_chunk.data_ptr(), out.data_ptr(), part.data_ptr(),
        qs[0], qs[1], qs[2], qs[3], es[0], es[1], es[2],
        B, KV, G, C, D, N, page, P, SPLIT_KEYS, n_pos, n_split,
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

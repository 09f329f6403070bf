"""Model building blocks on the serving and training paths (PyTorch).

Counterparts of the JAX package's ``models/layers.py`` functions, with the
same names, argument orders and tensor layouts.  Parameters are nested
dicts of tensors; activations are bf16 with f32 normalisation and softmax
statistics.  The paged attention functions hand their operands to the
kernel wrappers in ``repro_torch.kernels.paged_attention``, and a full-length
prefill on the card (causal self-attention, or whisper's non-causal encoder
and cross attention) hands its attention to ``kernels.flash_attention``: a
CUDA tensor launches the hand-written kernel, a CPU tensor takes the plain
version.  Dense-cache decode attention (``attention_decode``) is plain
PyTorch on either device, as the JAX package leaves it outside any kernel.

Training (``remat=True``) follows the reference's training formulation,
which runs no Pallas kernel: attention is the plain chunked
``attention_prefill`` on every device, one checkpointed call per query
block (the reference's ``jax.checkpoint`` "flash backward: recompute"), the
loss is ``chunked_cross_entropy`` with each chunk's logits checkpointed,
and ``chunked_recurrent_scan`` checkpoints each chunk of tokens.  None of
the kernels has a backward in either package; their wrappers refuse an
input that requires grad (``kernels/guard.py``).
"""
from __future__ import annotations

import math
from functools import partial

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import paged_attention as pa

DEFAULT_DTYPE = torch.bfloat16
NEG_INF = -1e30  # large-negative instead of -inf: keeps masked softmax NaN-free


# ---------------------------------------------------------------------------
# init helpers
# ---------------------------------------------------------------------------


def dense_init(gen: torch.Generator, in_dim: int, out_dim: int, *, lead=(), dtype=DEFAULT_DTYPE):
    """N(0, 1/in_dim) weights [*lead, in_dim, out_dim], drawn in f32 and
    scaled in place (one f32 copy at a time: 11.3 GB for stablelm-12b's
    stacked MLP matrices)."""
    w = torch.randn((*lead, in_dim, out_dim), generator=gen, device=gen.device)
    return w.mul_(1.0 / math.sqrt(in_dim)).to(dtype)


def embed_init(gen: torch.Generator, vocab: int, dim: int, dtype=DEFAULT_DTYPE):
    w = torch.randn((vocab, dim), generator=gen, device=gen.device)
    return w.mul_(0.02).to(dtype)


# ---------------------------------------------------------------------------
# normalization
# ---------------------------------------------------------------------------


def rms_norm(x, weight, eps: float = 1e-6):
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps)
    return (out * weight.float()).to(x.dtype)


def layer_norm(x, weight, bias, eps: float = 1e-5):
    xf = x.float()
    mu = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.var(xf, dim=-1, keepdim=True, unbiased=False)
    out = (xf - mu) * torch.rsqrt(var + eps)
    return (out * weight.float() + bias.float()).to(x.dtype)


def make_norm(cfg_norm: str, dim: int, *, lead=(), device=None):
    w = torch.ones((*lead, dim), dtype=DEFAULT_DTYPE, device=device)
    if cfg_norm == "rmsnorm":
        return {"w": w}
    return {"w": w, "b": torch.zeros_like(w)}


def apply_norm(cfg_norm: str, p, x):
    if cfg_norm == "rmsnorm":
        return rms_norm(x, p["w"])
    return layer_norm(x, p["w"], p["b"])


# ---------------------------------------------------------------------------
# rotary embeddings (split-half, f32 angles)
# ---------------------------------------------------------------------------


def rope_freqs(head_dim: int, theta: float, device=None):
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32, device=device) / head_dim
    return 1.0 / (theta ** exps)


def apply_rope(x, positions, theta: float):
    """x: [..., S, H, D]; positions: [..., S] (int)."""
    d = x.shape[-1]
    freqs = rope_freqs(d, theta, device=x.device)  # [D/2]
    angles = positions[..., :, None, None].float() * freqs  # [..., S, 1, D/2]
    sin, cos = torch.sin(angles), torch.cos(angles)
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def sinusoidal_positions(length: int, dim: int, device=None):
    """Absolute sinusoidal positions [length, dim] (whisper): f32 angles,
    ``[sin, cos]`` concatenated on the last axis, cast to bf16."""
    pos = torch.arange(length, dtype=torch.float32, device=device)[:, None]
    inv = torch.exp(
        -math.log(10000.0) * torch.arange(0, dim, 2, dtype=torch.float32, device=device) / dim
    )
    ang = pos * inv[None, :]
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1).to(DEFAULT_DTYPE)


# ---------------------------------------------------------------------------
# rematerialization (jax.checkpoint)
# ---------------------------------------------------------------------------


def remat_call(fn, *args):
    """``fn(*args)``, saving only its inputs for the backward, which runs
    ``fn`` again (``jax.checkpoint``).  Without grad it is a plain call.
    Nothing rematerialized here draws random numbers, so no RNG state is
    stashed."""
    if not torch.is_grad_enabled():
        return fn(*args)
    return checkpoint(fn, *args, use_reentrant=False, preserve_rng_state=False)


# ---------------------------------------------------------------------------
# recurrent scan (SSM and xLSTM blocks)
# ---------------------------------------------------------------------------


def pick_chunk(S: int, target: int = 128) -> int:
    """Largest divisor of S that is <= target (for two-level scans)."""
    if S <= target:
        return S
    for c in range(target, 0, -1):
        if S % c == 0:
            return c
    return 1


def tree_map(fn, *trees):
    """``fn`` over the leaves of nested dicts, tuples and lists."""
    first = trees[0]
    if isinstance(first, dict):
        return {k: tree_map(fn, *(t[k] for t in trees)) for k in first}
    if isinstance(first, (tuple, list)):
        return type(first)(tree_map(fn, *nodes) for nodes in zip(*trees))
    return fn(*trees)


def chunked_recurrent_scan(step, init, xs, *, chunk: int = 128):
    """``lax.scan`` over the token axis: ``step(carry, x_t) -> (carry, y_t)``
    for t = 0..S-1 in order; returns (carry, ys stacked on a leading S).

    xs is a tuple of tensors with leading dim S; ys may be any tree.  The
    tokens are walked one by one in plain PyTorch, one small launch group
    per token, which is what the card runs (not a kernel: the JAX package
    runs this scan outside any Pallas kernel too).  With grad enabled each
    chunk of ``pick_chunk(S, chunk)`` tokens is one ``remat_call``, as the
    JAX package runs each chunk under ``jax.checkpoint`` to bound training
    memory: the backward keeps the carries at chunk boundaries only.
    """
    S = xs[0].shape[0]
    if torch.is_grad_enabled():
        c = pick_chunk(S, chunk)
        carry, parts = init, []
        for t0 in range(0, S, c):
            carry, ys = remat_call(partial(_scan_tokens, step), carry,
                                   *(a[t0 : t0 + c] for a in xs))
            parts.append(ys)
        return carry, tree_map(lambda *ts: torch.cat(ts), *parts)
    return _scan_tokens(step, init, *xs)


def _scan_tokens(step, carry, *xs):
    """``step`` over every token of xs in order; ys stacked on a leading S."""
    per_token = [a.unbind(0) for a in xs]  # one split each, not S index ops
    ys = []
    for t in range(xs[0].shape[0]):
        carry, y = step(carry, tuple(a[t] for a in per_token))
        ys.append(y)
    return carry, tree_map(lambda *ts: torch.stack(ts), *ys)


# ---------------------------------------------------------------------------
# attention core
# ---------------------------------------------------------------------------


def attention_prefill(
    q, k, v, *, q_positions, kv_positions, causal: bool = True, window: int = 0,
    softcap: float = 0.0, q_chunk: int = 512, kv_chunk: int = 1024, remat: bool = False,
):
    """Chunked online-softmax attention (plain PyTorch).

    q: [B, Sq, H, D]; k, v: [B, Sk, KV, D]; positions: [B, S*] (kv position
    -1 = padding).  GQA without repeating KV.  Returns [B, Sq, H, D].
    ``remat`` runs each query block as one ``remat_call``: the backward
    recomputes the block's scores and never holds [Sq, Sk] of them.
    """
    B, Sq, H, D = q.shape
    KV = k.shape[2]
    G = H // KV
    qg = q.reshape(B, Sq, KV, G, D).permute(0, 2, 3, 1, 4)  # [B, KV, G, Sq, D]
    kb = k.permute(0, 2, 1, 3)  # [B, KV, Sk, D]
    vb = v.permute(0, 2, 1, 3)
    block = partial(_attend_q_block, causal=causal, window=window, softcap=softcap,
                    kv_chunk=kv_chunk)
    outs = []
    for q0 in range(0, Sq, q_chunk):
        args = (qg[:, :, :, q0 : q0 + q_chunk], q_positions[:, q0 : q0 + q_chunk],
                kb, vb, kv_positions)
        outs.append(remat_call(block, *args) if remat else block(*args))
    out = torch.cat(outs, dim=3)  # [B, KV, G, Sq, D]
    return out.permute(0, 3, 1, 2, 4).reshape(B, Sq, H, D).to(q.dtype)


def _attend_q_block(qb, qp, kb, vb, kv_positions, *, causal, window, softcap, kv_chunk):
    """One query block qb [B, KV, G, cq, D] at positions qp [B, cq] over
    every key chunk of kb, vb [B, KV, Sk, D]: f32 [B, KV, G, cq, D]."""
    B, KV, G, cq, D = qb.shape
    scale = 1.0 / math.sqrt(D)
    m = torch.full((B, KV, G, cq), NEG_INF, dtype=torch.float32, device=qb.device)
    l = torch.zeros_like(m)
    acc = torch.zeros((B, KV, G, cq, D), dtype=torch.float32, device=qb.device)
    for k0 in range(0, kb.shape[2], kv_chunk):
        kc, vc = kb[:, :, k0 : k0 + kv_chunk], vb[:, :, k0 : k0 + kv_chunk]
        kp = kv_positions[:, k0 : k0 + kv_chunk]
        s = torch.einsum("bkgqd,bksd->bkgqs", qb, kc).float() * scale
        if softcap:
            s = softcap * torch.tanh(s / softcap)
        mask = (kp >= 0)[:, None, None, None, :]
        if causal:
            mask = mask & (qp[:, None, None, :, None] >= kp[:, None, None, None, :])
        if window:
            mask = mask & (qp[:, None, None, :, None] - kp[:, None, None, None, :] < window)
        s = torch.where(mask, s, NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(dim=-1)
        pv = torch.einsum("bkgqs,bksd->bkgqd", p.to(vc.dtype), vc)
        acc = acc * corr[..., None] + pv.float()
        m = m_new
    return acc / torch.clamp(l, min=1e-30)[..., None]


def attention_contiguous(q, k, v, *, causal: bool = True, window: int = 0, softcap: float = 0.0):
    """Attention whose query positions are ``arange(Sq)`` and key positions
    ``arange(Sk)`` in every row (top-left causal alignment): a full-length
    prefill's self-attention, whisper's encoder, and cross attention over
    encoder states.  q: [B, Sq, H, D]; k, v: [B, Sk, KV, D] -> [B, Sq, H, D].

    A CUDA tensor runs in the flash-attention kernel, which takes exactly
    these positions, with the [B, S, H, D] operands handed over as
    [B, H, S, D] views (no copies); a CPU tensor runs the plain
    ``attention_prefill`` over the same positions."""
    if q.device.type == "cpu":
        B, Sq, Sk = q.shape[0], q.shape[1], k.shape[1]
        return attention_prefill(
            q, k, v,
            q_positions=torch.arange(Sq).expand(B, Sq),
            kv_positions=torch.arange(Sk).expand(B, Sk),
            causal=causal, window=window, softcap=softcap,
        )
    return fa.flash_attention(
        q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
        causal=causal, window=window, softcap=softcap,
    ).transpose(1, 2)


def attention_decode(q, k_cache, v_cache, *, kv_positions, cur_pos, window: int = 0, softcap: float = 0.0):
    """Single-step decode attention against a dense (or ring) KV cache.

    q: [B, 1, H, D]; caches: [B, S_cache, KV, D]; kv_positions: [B, S_cache]
    absolute positions of cache entries (-1 for unwritten slots);
    cur_pos: [B] current absolute position of the query token.  The QK
    product runs in the promoted operand type (an f32 query against the
    bf16 cache runs in f32) and PV with the weights cast to the cache type,
    as the JAX package's ``attention_decode`` does.
    """
    B, _, H, D = q.shape
    KV = k_cache.shape[2]
    G = H // KV
    scale = 1.0 / math.sqrt(D)
    dt = torch.promote_types(q.dtype, k_cache.dtype)
    qg = q.reshape(B, 1, KV, G, D).permute(0, 2, 3, 1, 4)  # [B, KV, G, 1, D]
    kb = k_cache.permute(0, 2, 1, 3)  # [B, KV, S, D]
    vb = v_cache.permute(0, 2, 1, 3)
    s = torch.einsum("bkgqd,bksd->bkgqs", qg.to(dt), kb.to(dt)).float() * scale
    if softcap:
        s = softcap * torch.tanh(s / softcap)
    cur = cur_pos[:, None]
    valid = (kv_positions >= 0) & (kv_positions <= cur)
    if window:
        valid &= cur - kv_positions < window
    s = torch.where(valid[:, None, None, None, :], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bkgqs,bksd->bkgqd", p.to(vb.dtype), vb)
    return out.permute(0, 3, 1, 2, 4).reshape(B, 1, H, D).to(q.dtype)


def paged_attention_decode(
    q, k_pages, v_pages, block_tables, prefix_len, k_tail, v_tail, tail_pos,
    cur_pos, *, window: int = 0, softcap: float = 0.0,
):
    """Single-step decode attention over PAGED prefix KV plus a dense tail.

    q:            [B, 1, H, D]
    k/v_pages:    [KV, N, page, D]   (this layer's slice of the pool)
    block_tables: [B, P] int32       page ids per request (padding masked
                                     by prefix_len)
    prefix_len:   [B] int32          tokens addressed via the block table
    k/v_tail:     [B, T, KV, D]      in-flight tail (this layer)
    tail_pos:     [B, T] int32       absolute tail positions (-1 = empty)
    cur_pos:      [B] int32          query token position
    Returns [B, 1, H, D].  The pool is read in place through the block
    table (kernels/paged_attention.paged_decode_attention).
    """
    B, _, H, D = q.shape
    KV = k_pages.shape[0]
    out = pa.paged_decode_attention(
        q[:, 0].reshape(B, KV, H // KV, D),
        k_pages, v_pages, block_tables, prefix_len,
        k_tail.transpose(1, 2), v_tail.transpose(1, 2),
        tail_pos, cur_pos, softcap=softcap, window=window,
    )
    return out.reshape(B, 1, H, D)


def paged_attention_prefill(
    q, k_pages, v_pages, block_tables, prefix_len, k_chunk, v_chunk, q_positions,
    *, window: int = 0, softcap: float = 0.0,
):
    """Chunk-of-queries prefill attention over PAGED prefix KV plus the
    chunk itself (causal within the chunk).

    q:            [B, C, H, D]       chunk queries
    k/v_pages:    [KV, N, page, D]   (this layer's slice of the pool)
    block_tables: [B, P] int32       page ids per request
    prefix_len:   [B] int32          tokens addressed via the block table
    k/v_chunk:    [B, C, KV, D]      the chunk's own keys/values
    q_positions:  [B, C] int32       absolute chunk positions; must equal
                                     prefix_len + arange(C) (the kernel
                                     derives positions from prefix_len)
    Returns [B, C, H, D].
    """
    B, C, H, D = q.shape
    KV = k_pages.shape[0]
    G = H // KV
    qg = q.reshape(B, C, KV, G, D).permute(0, 2, 3, 1, 4)  # [B, KV, G, C, D]
    out = pa.paged_prefill_attention(
        qg, k_pages, v_pages, block_tables, prefix_len,
        k_chunk.transpose(1, 2), v_chunk.transpose(1, 2),
        softcap=softcap, window=window,
    )
    return out.permute(0, 3, 1, 2, 4).reshape(B, C, H, D)


# ---------------------------------------------------------------------------
# attention layer (projections + qk-norm + rope + cache plumbing)
# ---------------------------------------------------------------------------


def attn_init(gen: torch.Generator, cfg, *, lead=()):
    d, H, KV, Dh = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    p = {
        "wq": dense_init(gen, d, H * Dh, lead=lead),
        "wk": dense_init(gen, d, KV * Dh, lead=lead),
        "wv": dense_init(gen, d, KV * Dh, lead=lead),
        "wo": dense_init(gen, H * Dh, d, lead=lead),
    }
    if cfg.qk_norm:
        p["q_norm"] = torch.ones((*lead, Dh), dtype=DEFAULT_DTYPE, device=gen.device)
        p["k_norm"] = torch.ones((*lead, Dh), dtype=DEFAULT_DTYPE, device=gen.device)
    return p


def attn_qkv(p, cfg, x, positions, *, use_rope: bool = True):
    """Projections, then qk-norm, then RoPE.  x: [B, S, d]."""
    B, S, _ = x.shape
    H, KV, Dh = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    q = (x @ p["wq"]).reshape(B, S, H, Dh)
    k = (x @ p["wk"]).reshape(B, S, KV, Dh)
    v = (x @ p["wv"]).reshape(B, S, KV, Dh)
    if cfg.qk_norm:
        q = rms_norm(q, p["q_norm"])
        k = rms_norm(k, p["k_norm"])
    if use_rope:
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def attn_prefill_layer(p, cfg, x, positions, *, causal=True, use_rope=True, contiguous=False,
                       remat=False):
    """Full attention layer at prefill; returns (out, (k, v)).

    ``causal=False`` lets every query see every key (whisper's encoder).
    ``contiguous=True`` is the caller's statement that every row's
    positions are ``arange(S)`` for queries and keys alike, as both
    full-length prefills (``prefill``, ``prefill_collect``) and whisper
    build them.  On the card the attention runs in the flash-attention
    kernel, which assumes exactly that, so a CUDA tensor needs
    ``contiguous=True`` and is not checked (reading the positions back
    would wait for the device).  A CPU tensor runs the plain
    ``attention_prefill`` over ``positions``, and raises if it was told
    they are contiguous and they are not.

    ``remat=True`` is the training route, on either device: the plain
    ``attention_prefill`` over ``positions`` with each query block
    rematerialized, the reference's training attention (the kernel has no
    backward).
    """
    q, k, v = attn_qkv(p, cfg, x, positions, use_rope=use_rope)
    kwargs = dict(causal=causal, window=cfg.sliding_window, softcap=cfg.attn_logit_softcap)
    if remat:
        out = attention_prefill(q, k, v, q_positions=positions, kv_positions=positions,
                                remat=True, **kwargs)
    elif q.device.type == "cpu":
        if contiguous and not torch.equal(
            positions, torch.arange(x.shape[1]).expand_as(positions).to(positions.dtype)
        ):
            raise ValueError("contiguous=True, but the positions are not arange(S)")
        out = attention_prefill(q, k, v, q_positions=positions, kv_positions=positions, **kwargs)
    elif not contiguous:
        raise ValueError("the flash-attention kernel takes positions arange(S) only")
    else:
        out = attention_contiguous(q, k, v, **kwargs)
    out = out.reshape(x.shape[0], x.shape[1], -1) @ p["wo"]
    return out, (k, v)


def decode_slot(cfg, S_cache: int, cur_pos):
    """Cache slot written by the current decode step (ring for SWA)."""
    if cfg.sliding_window and S_cache <= cfg.sliding_window:
        return cur_pos % S_cache  # ring buffer
    return torch.clamp(cur_pos, max=S_cache - 1)


def slot_update(cache, value, slot):
    """Write ``value`` [B, 1, ...] at per-row ``slot`` into [B, S, ...]
    (a broadcast select: rows whose slot is out of range stay unchanged)."""
    S = cache.shape[1]
    hit = torch.arange(S, device=cache.device)[None, :] == slot[:, None]  # [B, S]
    hit = hit.reshape(hit.shape + (1,) * (cache.ndim - 2))
    return torch.where(hit, value.to(cache.dtype), cache)


def attn_decode_layer(p, cfg, x, cache_k, cache_v, kv_positions, cur_pos, slot, *, use_rope=True):
    """One-token decode; writes (k, v) at ``slot`` and attends over the cache.

    x: [B, 1, d]; cache_*: [B, S_cache, KV, Dh]; kv_positions: [B, S_cache]
    (already updated with cur_pos at slot); cur_pos, slot: [B].
    Returns (out [B, 1, d], new_k, new_v); the input caches are unchanged.
    """
    B = x.shape[0]
    q, k, v = attn_qkv(p, cfg, x, cur_pos[:, None], use_rope=use_rope)
    new_k = slot_update(cache_k, k, slot)
    new_v = slot_update(cache_v, v, slot)
    out = attention_decode(
        q, new_k, new_v, kv_positions=kv_positions, cur_pos=cur_pos,
        window=cfg.sliding_window, softcap=cfg.attn_logit_softcap,
    )
    out = out.reshape(B, 1, -1) @ p["wo"]
    return out, new_k, new_v


def attn_paged_prefill_layer(p, cfg, x, k_pages, v_pages, block_tables, prefix_len, positions, *, use_rope=True):
    """One chunk of paged prefill: the chunk's (k, v) plus attention over the
    prefix pages (in place, via the block table) and the chunk causally.

    x: [B, C, d]; k/v_pages: [KV, N, page, Dh]; positions: [B, C] absolute
    chunk positions (= prefix_len + arange(C)).
    Returns (out [B, C, d], (k, v) [B, C, KV, Dh]).
    """
    B, C, _ = x.shape
    q, k, v = attn_qkv(p, cfg, x, positions, use_rope=use_rope)
    out = paged_attention_prefill(
        q, k_pages, v_pages, block_tables, prefix_len, k, v, positions,
        window=cfg.sliding_window, softcap=cfg.attn_logit_softcap,
    )
    out = out.reshape(B, C, -1) @ p["wo"]
    return out, (k, v)


def attn_paged_decode_layer(
    p, cfg, x, k_pages, v_pages, block_tables, prefix_len,
    tail_k, tail_v, tail_pos, cur_pos, tail_slot, *, use_rope=True
):
    """One-token decode over paged prefix KV: writes the new (k, v) into the
    tail at ``tail_slot`` and attends pages + tail in place.

    x: [B, 1, d]; k/v_pages: [KV, N, page, Dh]; tail_k/v: [B, T, KV, Dh];
    tail_pos: [B, T] (already updated with cur_pos at tail_slot).
    Returns (out [B, 1, d], new_tail_k, new_tail_v).
    """
    B = x.shape[0]
    q, k, v = attn_qkv(p, cfg, x, cur_pos[:, None], use_rope=use_rope)
    new_tk = slot_update(tail_k, k, tail_slot)
    new_tv = slot_update(tail_v, v, tail_slot)
    out = paged_attention_decode(
        q, k_pages, v_pages, block_tables, prefix_len,
        new_tk, new_tv, tail_pos, cur_pos,
        window=cfg.sliding_window, softcap=cfg.attn_logit_softcap,
    )
    out = out.reshape(B, 1, -1) @ p["wo"]
    return out, new_tk, new_tv


# ---------------------------------------------------------------------------
# MLP
# ---------------------------------------------------------------------------


def mlp_init(gen: torch.Generator, d: int, ff: int, activation: str, *, lead=()):
    if activation == "silu":  # SwiGLU
        return {
            "w_gate": dense_init(gen, d, ff, lead=lead),
            "w_up": dense_init(gen, d, ff, lead=lead),
            "w_down": dense_init(gen, ff, d, lead=lead),
        }
    return {"w_up": dense_init(gen, d, ff, lead=lead), "w_down": dense_init(gen, ff, d, lead=lead)}


def mlp_apply(p, x, activation: str):
    if activation == "silu":
        return (F.silu(x @ p["w_gate"]) * (x @ p["w_up"])) @ p["w_down"]
    return F.gelu(x @ p["w_up"], approximate="tanh") @ p["w_down"]


# ---------------------------------------------------------------------------
# losses (seq-chunked)
# ---------------------------------------------------------------------------


def chunked_cross_entropy(x, w_unembed, labels, *, chunk: int = 512):
    """Mean token cross-entropy without materializing [B, S, V] at once.

    x: [B, S, d] final hidden states; w_unembed: [d, V]; labels: [B, S]
    (-1 = no label).  Each chunk of ``chunk`` positions is one
    ``remat_call``, so its f32 logits [B, chunk, V] are never saved for the
    backward.  A label outside [0, V) picks no logit, as the reference's
    one-hot does.  Returns a 0-d f32 tensor.
    """
    S = x.shape[1]
    c = min(chunk, S)
    tot = torch.zeros((), dtype=torch.float32, device=x.device)
    cnt = torch.zeros((), dtype=torch.float32, device=x.device)
    for s0 in range(0, S, c):
        t, n = remat_call(_ce_chunk, x[:, s0 : s0 + c], w_unembed, labels[:, s0 : s0 + c])
        tot, cnt = tot + t, cnt + n
    return tot / torch.clamp(cnt, min=1.0)


def _ce_chunk(xc, w_unembed, lc):
    """Summed cross-entropy of one chunk and its count of labelled positions."""
    logits = (xc @ w_unembed).float()  # [B, c, V]
    m = logits.amax(dim=-1)
    lse = m + torch.log(torch.exp(logits - m[..., None]).sum(dim=-1))
    V = logits.shape[-1]
    hit = (lc >= 0) & (lc < V)
    picked = logits.gather(-1, lc.long().clamp(0, V - 1)[..., None])[..., 0]
    correct = torch.where(hit, picked, 0.0)
    valid = (lc >= 0).float()
    return ((lse - correct) * valid).sum(), valid.sum()

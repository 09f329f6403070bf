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

Distribution (``mesh=``, a ``DeviceMesh``; the tensors are DTensors): the
reference's ``with_sharding_constraint`` calls become ``DTensor.redistribute``
(``constrain_activations``, ``constrain_attention_qkv``), and its
``shard_map`` attention body becomes a ``local_map`` body
(``attention_prefill_sharded``): K/V gathered once per layer, each rank
attending its own query slice.  Without a mesh every function here is what
it was.  Meta tensors (the dry run's shapes-only step) take the plain
routes, as CPU tensors do; they never reach a kernel.
"""
from __future__ import annotations

import math
from functools import partial

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import paged_attention as pa
from repro_torch.sharding.rules import as_replicated, placements, split_dim

DEFAULT_DTYPE = torch.bfloat16
NEG_INF = -1e30  # large-negative instead of -inf: keeps masked softmax NaN-free


def plain_route(t) -> bool:
    """True where the plain PyTorch versions run: CPU tensors, and meta
    tensors (shapes only).  A CUDA tensor takes the kernels."""
    return t.device.type in ("cpu", "meta")


# ---------------------------------------------------------------------------
# activation sharding (SP: sequence over 'model' between layers)
# ---------------------------------------------------------------------------


# Attention sharding mode, as in the reference:
#   "chunked_seq" — activations stay sequence-sharded through attention;
#       DTensor gathers what each op needs;
#   "gather_kv"   — K/V gathered ONCE per layer; q stays sequence-sharded
#       and each rank attends its slice in a local body (the default);
#   "heads"       — Q/K/V head-sharded over 'model' (requires
#       num_kv_heads % model == 0, else gather_kv).
# Only "gather_kv" runs on the card (its body hands the rank's slice to the
# flash-attention kernel); the others run the plain attention on DTensors.
_ATTN_SHARDING = "gather_kv"


def set_attn_sharding(mode: str) -> None:
    global _ATTN_SHARDING
    if mode not in ("chunked_seq", "gather_kv", "heads"):
        raise ValueError(f"attention sharding mode {mode!r}")
    _ATTN_SHARDING = mode


def get_attn_sharding() -> str:
    return _ATTN_SHARDING


def mesh_axes(mesh):
    """(data axes, model axis or None) of a mesh, in the mesh's order."""
    names = mesh.mesh_dim_names
    dp = tuple(a for a in ("pod", "data") if a in names)
    return dp, ("model" if "model" in names else None)


def _axes_size(mesh, axes) -> int:
    n = 1
    for a in axes:
        n *= mesh.size(mesh.mesh_dim_names.index(a))
    return n


def constrain(x, mesh, spec):
    """``with_sharding_constraint``: ``x`` (a DTensor, or a plain tensor
    every rank holds whole) redistributed to the layout of ``spec`` (one
    entry per dim: None, an axis or a tuple of axes)."""
    return as_replicated(x, mesh).redistribute(mesh, placements(spec, mesh))


def constrain_attention_qkv(q, k, v, mesh):
    """Apply the selected attention sharding layout (no-op without mesh).

    q: [B, Sq, H, D]; k, v: [B, Skv, KV, D].
    """
    if mesh is None or _ATTN_SHARDING == "chunked_seq":
        return q, k, v
    dp, tp = mesh_axes(mesh)
    if tp is None:
        return q, k, v
    tp_n = _axes_size(mesh, (tp,))
    bspec = dp if q.shape[0] % _axes_size(mesh, dp) == 0 else None
    mode = _ATTN_SHARDING
    if mode == "heads" and k.shape[2] % tp_n != 0:
        mode = "gather_kv"
    if mode == "heads":
        spec = (bspec, None, tp, None)
        return constrain(q, mesh, spec), constrain(k, mesh, spec), constrain(v, mesh, spec)
    # gather_kv: one K/V gather per layer, q stays seq-sharded
    seq_ok = q.shape[1] % tp_n == 0 and q.shape[1] > 1
    kv = (bspec, None, None, None)
    return (constrain(q, mesh, (bspec, tp if seq_ok else None, None, None)),
            constrain(k, mesh, kv), constrain(v, mesh, kv))


def constrain_activations(x, mesh, *, seq_dim=1):
    """Layer-boundary layout for [B, S, d]-like activations: batch over
    the data axes, sequence over 'model' (Megatron-style sequence
    parallelism).  Dims that do not divide stay replicated.  No-op without
    a mesh."""
    if mesh is None:
        return x
    dp, tp = mesh_axes(mesh)
    spec = [None] * x.ndim
    if dp and x.shape[0] % _axes_size(mesh, dp) == 0:
        spec[0] = dp
    if (seq_dim is not None and seq_dim < x.ndim and tp
            and x.shape[seq_dim] % _axes_size(mesh, (tp,)) == 0 and x.shape[seq_dim] > 1):
        spec[seq_dim] = tp
    return constrain(x, mesh, tuple(spec))


def is_dtensor(t) -> bool:
    from torch.distributed.tensor import DTensor

    return isinstance(t, DTensor)


def unshard_dims(t, dims):
    """A DTensor with the mesh axes that shard any of ``dims`` replicated
    (a plain tensor as it is).  DTensor before torch 2.13 flattens dims
    only where no dim but the first of them is sharded."""
    if not is_dtensor(t):
        return t
    from torch.distributed.tensor import Replicate

    hit = [p.is_shard() and p.dim % t.ndim in dims for p in t.placements]
    if not any(hit):
        return t
    return t.redistribute(t.device_mesh, [Replicate() if h else p
                                          for h, p in zip(hit, t.placements)])


def hold_grad_layout(t):
    """``t`` as it is, but its grad is laid out like ``t`` before it flows
    back (a DTensor's identity redistribution): the backward of the op that
    made ``t`` then sees the layout its forward saw."""
    return t.redistribute(t.device_mesh, t.placements) if is_dtensor(t) else t


def proj(x, w):
    """``x @ w``.  A DTensor ``x`` sharded on a dim between its first and
    its last (the sequence of sequence-parallel activations) is gathered on
    that dim first, as a sequence-parallel layer gathers the sequence
    before its projections (Megatron's SP -> TP transition), and the
    product's grad is held to the product's layout: the product flattens
    [B, S], which DTensor before torch 2.13 refuses with S sharded.  A
    plain tensor is multiplied as it is."""
    if not is_dtensor(x) or x.ndim <= 2:
        return x @ w
    return hold_grad_layout(unshard_dims(x, range(1, x.ndim - 1)) @ w)


def merge_heads(t, keep: int):
    """``t`` with every dim after the first ``keep`` merged into one (the
    heads and head dims of an attention output).  On a DTensor the grad is
    held to the merged output's layout before the backward splits it into
    heads again: DTensor has no rule for splitting a dim that is sharded
    over more ranks than there are heads (56 heads over 16)."""
    if not is_dtensor(t):
        return t.reshape(*t.shape[:keep], -1)
    t = unshard_dims(t, range(keep + 1, t.ndim))  # only the first merged dim may stay sharded
    return hold_grad_layout(t.reshape(*t.shape[:keep], -1))


def pad_to(t, size: int, dim: int, value):
    """``t`` extended along ``dim`` to ``size`` with ``value`` (a cache's
    unwritten slots), by concatenation: a sharded step builds its cache
    this way, not by writes into slices of a fresh one."""
    n = size - t.shape[dim]
    if not n:
        return t
    shape = list(t.shape)
    shape[dim] = n
    return torch.cat([t, torch.full(shape, value, dtype=t.dtype, device=t.device)], dim=dim)


def grad_placements(in_placements, split):
    """A local body's input-grad placements (``local_map``'s
    ``in_grad_placements``), JAX ``shard_map``'s transpose: an input
    replicated over a mesh axis across which the body splits its work
    (``split[i]`` for mesh dim i) gets a partial grad there, summed over
    that axis; over an axis where every rank repeats the same work the grad
    stays replicated."""
    from torch.distributed.tensor import Partial, Replicate

    return tuple(
        None if pl is None else tuple(
            Partial() if isinstance(p, Replicate) and sp else p for p, sp in zip(pl, split))
        for pl in in_placements)


def full_local(t, mesh, split):
    """A DTensor's full value as every rank's local tensor, for use inside a
    local body (a recurrence's weights); the grad comes back partial over
    the mesh dims in ``split`` (where the body's work is split), replicated
    elsewhere (``grad_placements``)."""
    from torch.distributed.tensor import Partial, Replicate

    rep = [Replicate()] * mesh.ndim
    return as_replicated(t, mesh).redistribute(mesh, rep).to_local(
        grad_placements=[Partial() if sp else Replicate() for sp in split])


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


def sharded_recurrent_scan(step, init, xs, *, mesh, init_specs, xs_specs, ys_spec,
                           chunk: int = 128):
    """``chunked_recurrent_scan`` over DTensors, in a ``local_map`` body.

    A recurrence is sequential over tokens, so the reference keeps the
    token axis replicated and shards batch and channel dims (its
    ``_constrain_channels`` / ``_seq_replicated``); every token's step is
    then local to a rank.  Here ``init`` (a dict of DTensors or plain
    tensors), each of ``xs`` and the stacked ys are laid out by
    ``init_specs`` (a dict of specs), ``xs_specs`` and ``ys_spec``, and the
    scan runs on the local shards: no per-token collective, and no
    DTensor dispatch per token.  ``step`` must act elementwise along every
    sharded dim.  An input replicated over an axis the others split the
    work over gets a partial grad there (``grad_placements``); weights the
    step closes over come in through ``full_local``.  On meta shards (the
    dry run) one step stands for the loop: the shapes are the loop's, and
    the body issues no collective either way."""
    from torch.distributed.tensor.experimental import local_map

    keys = sorted(init)
    n_x = len(xs)
    in_specs = tuple(xs_specs) + tuple(init_specs[k] for k in keys)
    # the work splits over every axis some input or ys shards a dim on
    used = {a for sp in in_specs + (ys_spec,) for e in sp if e
            for a in ((e,) if isinstance(e, str) else e)}
    split = [a in used for a in mesh.mesh_dim_names]

    def body(*flat):
        carry = dict(zip(keys, flat[n_x:]))
        if flat[0].device.type == "meta":
            # shapes only (the dry run): one token's step gives the carry's
            # and ys' shapes; the loop holds no collective to count
            carry, y = step(carry, tuple(a[0] for a in flat[:n_x]))
            ys = y.unsqueeze(0).expand(flat[0].shape[0], *y.shape)
        else:
            carry, ys = chunked_recurrent_scan(step, carry, flat[:n_x], chunk=chunk)
        return tuple(carry[k] for k in keys) + (ys,)

    pl = lambda spec: placements(spec, mesh)
    in_pl = tuple(pl(sp) for sp in in_specs)
    fn = local_map(
        body,
        out_placements=tuple(pl(init_specs[k]) for k in keys) + (pl(ys_spec),),
        in_placements=in_pl,
        in_grad_placements=grad_placements(in_pl, split),
        device_mesh=mesh,
        redistribute_inputs=True,
    )
    out = fn(*(as_replicated(t, mesh) for t in xs),
             *(as_replicated(init[k], mesh) for k in keys))
    return dict(zip(keys, out[:-1])), out[-1]


def shard_if(mesh, size: int, axes):
    """``axes`` (an axis name or a tuple of them; None or () for none) when
    ``size`` divides over them, else None."""
    if not axes:
        return None
    names = (axes,) if isinstance(axes, str) else tuple(axes)
    return axes if size % _axes_size(mesh, names) == 0 else None


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


def attention_contiguous(q, k, v, *, causal: bool = True, window: int = 0, softcap: float = 0.0,
                         q_offset: int = 0):
    """Attention whose query positions are ``q_offset + arange(Sq)`` and key
    positions ``arange(Sk)`` in every row: a full-length prefill's
    self-attention (``q_offset`` 0: top-left causal alignment), whisper's
    encoder, cross attention over encoder states, and one rank's query
    slice of a sequence-sharded prefill (``q_offset``: where the slice
    starts).  q: [B, Sq, H, D]; k, v: [B, Sk, KV, D] -> [B, Sq, H, D].

    A CUDA tensor runs in the flash-attention kernel, which takes exactly
    these positions, with the [B, S, H, D] operands handed over as
    [B, H, S, D] views (no copies); a CPU tensor runs the plain
    ``attention_prefill`` over the same positions."""
    if plain_route(q):
        B, Sq, Sk = q.shape[0], q.shape[1], k.shape[1]
        return attention_prefill(
            q, k, v,
            q_positions=(q_offset + torch.arange(Sq, device=q.device)).expand(B, Sq),
            kv_positions=torch.arange(Sk, device=q.device).expand(B, Sk),
            causal=causal, window=window, softcap=softcap,
        )
    return fa.flash_attention(
        q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
        causal=causal, window=window, softcap=softcap, q_offset=q_offset,
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
    # the einsums flatten (b, k): keep the heads whole
    q, k_cache, v_cache = (unshard_dims(t, (2,)) for t in (q, k_cache, v_cache))
    qg = split_dim(q, 2, (KV, G)).permute(0, 2, 3, 1, 4)  # [B, KV, G, 1, D]
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
    q = split_dim(proj(x, p["wq"]), 2, (H, Dh))
    k = split_dim(proj(x, p["wk"]), 2, (KV, Dh))
    v = split_dim(proj(x, p["wv"]), 2, (KV, Dh))
    if cfg.qk_norm:
        q = rms_norm(q, p["q_norm"])
        k = rms_norm(k, p["k_norm"])
    if use_rope:
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def kernel_slice_check(q0: int, *, causal: bool, window: int, contiguous: bool) -> None:
    """Raise unless the flash-attention kernel computes a rank's query slice
    starting at position ``q0`` right: it takes contiguous positions only
    (keys at ``arange(Sk)``, queries at ``q0 + arange(Sq)``: ``q0`` is its
    ``q_offset``), causal, windowed or neither.  Nothing falls back to the
    plain route."""
    if not contiguous:
        raise ValueError("the flash-attention kernel takes positions arange(S) only")


def attention_prefill_sharded(q, k, v, *, q_positions, kv_positions, mesh, causal=True,
                              window: int = 0, softcap: float = 0.0, contiguous: bool = False,
                              remat: bool = False):
    """Sequence-parallel attention in a ``local_map`` body (the reference's
    ``shard_map``).

    q stays sequence-sharded over 'model'; k/v are gathered ONCE per layer
    (the in-placements force exactly one gather); the body attends the
    rank's query slice over the whole K/V on local tensors.  On the CPU
    (and on meta tensors) the body is the plain ``attention_prefill`` over
    the rank's positions, as in the reference.  On the card, with
    ``contiguous=True`` (every row's positions ``arange(S)``), the body
    hands the slice to the flash-attention kernel with the position the
    slice starts at as its ``q_offset``, so every 'model' rank computes its
    rows, as the reference's plain body does.  ``remat`` (training) runs
    the plain attention with each query block rematerialized, on either
    device.
    """
    from torch.distributed.tensor.experimental import local_map

    dp, tp = mesh_axes(mesh)
    tp_n = _axes_size(mesh, (tp,))
    bspec = dp if q.shape[0] % _axes_size(mesh, dp) == 0 else None
    sspec = tp if q.shape[1] % tp_n == 0 and q.shape[1] > 1 else None
    q0 = mesh.get_local_rank(tp) * (q.shape[1] // tp_n) if sspec else 0
    kw = dict(causal=causal, window=window, softcap=softcap)

    def body(q_loc, k_rep, v_rep, qp_loc, kp_rep):
        if remat or plain_route(q_loc):
            return attention_prefill(q_loc, k_rep, v_rep, q_positions=qp_loc,
                                     kv_positions=kp_rep, remat=remat, **kw)
        kernel_slice_check(q0, causal=causal, window=window, contiguous=contiguous)
        return attention_contiguous(q_loc, k_rep, v_rep, q_offset=q0, **kw)

    q_pl = placements((bspec, sspec, None, None), mesh)
    kv_pl = placements((bspec, None, None, None), mesh)
    in_pl = (q_pl, kv_pl, kv_pl, placements((bspec, sspec), mesh), placements((bspec, None), mesh))
    # the work splits over the batch's axes and, with q sequence-sharded, over
    # 'model': K/V's grads are partial there (each rank's query slice)
    split = [bool(bspec) and a in bspec or (a == tp and sspec is not None)
             for a in mesh.mesh_dim_names]
    fn = local_map(
        body,
        out_placements=list(q_pl),
        in_placements=in_pl,
        in_grad_placements=grad_placements(in_pl, split),
        device_mesh=mesh,
        redistribute_inputs=True,
    )
    return fn(q, k, v, as_replicated(q_positions, mesh), as_replicated(kv_positions, mesh))


def attn_prefill_layer(p, cfg, x, positions, *, causal=True, use_rope=True, contiguous=False,
                       remat=False, mesh=None):
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

    ``mesh``: q, k, v take the attention sharding layout, and in the
    default "gather_kv" mode the attention runs in
    ``attention_prefill_sharded``'s body.
    """
    q, k, v = attn_qkv(p, cfg, x, positions, use_rope=use_rope)
    q, k, v = constrain_attention_qkv(q, k, v, mesh)
    kwargs = dict(causal=causal, window=cfg.sliding_window, softcap=cfg.attn_logit_softcap)
    if mesh is not None and get_attn_sharding() == "gather_kv" and "model" in mesh.mesh_dim_names:
        out = attention_prefill_sharded(q, k, v, q_positions=positions, kv_positions=positions,
                                        mesh=mesh, contiguous=contiguous, remat=remat, **kwargs)
    elif remat:
        out = attention_prefill(q, k, v, q_positions=positions, kv_positions=positions,
                                remat=True, **kwargs)
    elif plain_route(q):
        if contiguous and q.device.type == "cpu" and mesh is None and not torch.equal(
            positions, torch.arange(x.shape[1]).expand_as(positions).to(positions.dtype)
        ):
            raise ValueError("contiguous=True, but the positions are not arange(S)")
        out = attention_prefill(q, k, v, q_positions=positions, kv_positions=positions, **kwargs)
    elif mesh is not None:
        raise NotImplementedError(
            f"attention sharding {get_attn_sharding()!r} on the card: only 'gather_kv' "
            "hands the kernel local tensors")
    elif not contiguous:
        raise ValueError("the flash-attention kernel takes positions arange(S) only")
    else:
        out = attention_contiguous(q, k, v, **kwargs)
    out = proj(merge_heads(out, 2), p["wo"])
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
    out = proj(merge_heads(out, 2), p["wo"])
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
        return proj(F.silu(proj(x, p["w_gate"])) * proj(x, p["w_up"]), p["w_down"])
    return proj(F.gelu(proj(x, p["w_up"]), approximate="tanh"), p["w_down"])


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
    logits = proj(xc, w_unembed).float()  # [B, c, V]
    m = logits.amax(dim=-1)
    lse = m + torch.log(torch.exp(logits - m[..., None]).sum(dim=-1))
    V = logits.shape[-1]
    hit = (lc >= 0) & (lc < V)
    if is_dtensor(logits):
        # DTensor's rule for gather over a vocab-sharded dim fails (its
        # masked-partial buffer assumes a 2-D index): pick by a one-hot
        # product over the sharded vocab instead, the reference's form
        onehot = lc.long()[..., None] == torch.arange(V, device=lc.device)
        picked = (logits * onehot).sum(dim=-1)
    else:
        picked = logits.gather(-1, lc.long().clamp(0, V - 1)[..., None])[..., 0]
    correct = torch.where(hit, picked, 0.0)
    valid = (lc >= 0).float()
    return ((lse - correct) * valid).sum(), valid.sum()

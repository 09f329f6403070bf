"""xLSTM LM — mLSTM (matrix-memory) + sLSTM (scalar-memory) blocks (PyTorch).

Counterpart of the JAX package's ``models/xlstm.py`` (Beck et al.,
arXiv:2405.04517), with the same names, parameter tree and state layout.
The 350M config is stacked as xLSTM[7:1]: groups of (7 mLSTM + 1 sLSTM).
Parameters and states keep the JAX package's ``[G, n_blocks, ...]``
stacking (G groups, n blocks of a type per group; states ``[G, n, B,
...]``), and the stack runs as Python loops over groups and blocks.

Both block types are the stabilized-exponential-gating recurrent form
(log-space max-stabilizer m, which starts at -1e30), walked token by token
(``chunked_recurrent_scan``).  Decode is O(1) in context length.  A
ResidentClaim on an xLSTM context covers the (C, n, m) matrix-memory
snapshot rather than KV blocks: predicate ``state_at_token(k)``.

``loss_fn`` trains it as the reference does: no per-layer remat, the
recurrences checkpointed per chunk of ``xlstm.chunk_size`` tokens
(``layers.chunked_recurrent_scan``), the embedding as the unembedding.

``mesh=`` keeps the token axis replicated through each recurrence
(``_seq_replicated``, the mLSTM's value and C-state channels sharded over
'model') and runs the token loop on local shards
(``layers.sharded_recurrent_scan``).
"""
from __future__ import annotations

import math
from typing import Any, Dict, List, Tuple

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor, Replicate

from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models.layers import (
    DEFAULT_DTYPE,
    apply_norm,
    chunked_cross_entropy,
    chunked_recurrent_scan,
    constrain,
    constrain_activations,
    dense_init,
    embed_init,
    full_local,
    is_dtensor,
    make_norm,
    merge_heads,
    mesh_axes,
    proj,
    rms_norm,
    shard_if,
    sharded_recurrent_scan,
    split_dim,
    tree_map,
)
from repro_torch.models.transformer import _device_generator, embed_tokens, shifted_labels

# ---------------------------------------------------------------------------
# mLSTM block
# ---------------------------------------------------------------------------


def mlstm_init(gen: torch.Generator, cfg, *, lead=()):
    d, nh = cfg.d_model, cfg.num_heads
    dev = gen.device
    return {
        "ln": make_norm(cfg.norm, d, lead=lead, device=dev),
        "wq": dense_init(gen, d, d, lead=lead),
        "wk": dense_init(gen, d, d, lead=lead),
        "wv": dense_init(gen, d, d, lead=lead),
        "wi": dense_init(gen, d, nh, lead=lead),
        "wf": dense_init(gen, d, nh, lead=lead),
        "wg": dense_init(gen, d, d, lead=lead),
        "wo": dense_init(gen, d, d, lead=lead),
        "hnorm": torch.ones((*lead, nh, d // nh), dtype=DEFAULT_DTYPE, device=dev),
        "fb": torch.full((*lead, nh), 3.0, dtype=torch.float32, device=dev),  # open forget gate
    }


def mlstm_state(cfg, batch: int, *, lead=(), device=None):
    nh, dh = cfg.num_heads, cfg.d_model // cfg.num_heads
    f32 = dict(dtype=torch.float32, device=device)
    return {
        "C": torch.zeros((*lead, batch, nh, dh, dh), **f32),
        "n": torch.zeros((*lead, batch, nh, dh), **f32),
        "m": torch.full((*lead, batch, nh), -1e30, **f32),
    }


def _mlstm_step(state, q, k, v, log_i, log_f):
    """One recurrent step.  q, k, v: [B, nh, dh]; gates: [B, nh]."""
    C, n, m = state["C"], state["n"], state["m"]
    f_m = log_f + m
    m_new = torch.maximum(f_m, log_i)
    decay = torch.exp(f_m - m_new)
    inp = torch.exp(log_i - m_new)
    kv = k[..., :, None] * v[..., None, :]  # [B, nh, dh, dh]
    C = decay[..., None, None] * C + inp[..., None, None] * kv
    n = decay[..., None] * n + inp[..., None] * k
    qr = q[..., None, :]  # the two contractions as batched products (einsum's, less host work)
    num = torch.matmul(qr, C)[..., 0, :]
    den = torch.maximum(torch.abs(torch.matmul(qr, n[..., :, None])[..., 0, 0]), torch.exp(-m_new))
    h = num / den[..., None]
    return {"C": C, "n": n, "m": m_new}, h


def _mlstm_qkvif(p, cfg, x):
    B, S, d = x.shape
    nh, dh = cfg.num_heads, d // cfg.num_heads
    xn = apply_norm(cfg.norm, p["ln"], x)
    q = split_dim(proj(xn, p["wq"]), 2, (nh, dh)).float()
    k = split_dim(proj(xn, p["wk"]), 2, (nh, dh)).float() / math.sqrt(dh)
    v = split_dim(proj(xn, p["wv"]), 2, (nh, dh)).float()
    log_i = proj(xn, p["wi"]).float()
    f_pre = proj(xn, p["wf"]).float() + p["fb"]
    if is_dtensor(f_pre):
        # DTensor has no sharding rule for aten.log_sigmoid_backward:
        # replicate the input (the dry run counts the gather) and apply the
        # op to every rank's full local copy
        mesh, rep = f_pre.device_mesh, [Replicate()] * f_pre.device_mesh.ndim
        log_f = DTensor.from_local(F.logsigmoid(f_pre.redistribute(mesh, rep).to_local()), mesh,
                                   rep, run_check=False)
    else:
        log_f = F.logsigmoid(f_pre)
    gate = F.silu(proj(xn, p["wg"]))
    return q, k, v, log_i, log_f, gate


def _seq_replicated(t, mesh, *, shard_last=False):
    """The recurrence's layout: the token axis replicated, batch over the
    data axes, and (``shard_last``) the value/state channel dim over
    'model' where it divides (the reference's)."""
    if mesh is None or "model" not in mesh.mesh_dim_names:
        return t
    dp, _ = mesh_axes(mesh)
    spec = [None] * t.ndim
    spec[0] = shard_if(mesh, t.shape[0], dp)
    if shard_last:
        spec[-1] = shard_if(mesh, t.shape[-1], "model")
    return constrain(t, mesh, tuple(spec))


def _scan(step, state, xs, cfg, mesh, x_shards_last):
    """The token recurrence, on local shards with a mesh.  ``xs`` are
    [S, B, ...]; ``x_shards_last`` says which of them (and so the state
    leaves and ys that share their last dim) shard it over 'model'."""
    if mesh is None:
        return chunked_recurrent_scan(step, state, xs, chunk=cfg.xlstm.chunk_size)
    dp, _ = mesh_axes(mesh)
    b = shard_if(mesh, xs[0].shape[1], dp)

    def spec(t, lead, last):
        out = [None] * t.ndim
        out[lead] = b
        if last:
            out[-1] = shard_if(mesh, t.shape[-1], "model")
        return tuple(out)

    any_last = any(x_shards_last)
    init_specs = {k: spec(v, 0, any_last and k == "C") for k, v in state.items()}
    xs_specs = tuple(spec(t, 1, last) for t, last in zip(xs, x_shards_last))
    ys_spec = (None, b) + (None,) * (xs[0].ndim - 3) + (
        shard_if(mesh, xs[0].shape[-1], "model") if any_last else None,)
    return sharded_recurrent_scan(step, state, xs, mesh=mesh, init_specs=init_specs,
                                  xs_specs=xs_specs, ys_spec=ys_spec,
                                  chunk=cfg.xlstm.chunk_size)


def mlstm_forward(p, cfg, x, state, mesh=None):
    """Sequence forward (the recurrence token by token).  x: [B, S, d]."""
    B, S, d = x.shape
    q, k, v, log_i, log_f, gate = _mlstm_qkvif(p, cfg, x)
    q, k, log_i, log_f = (_seq_replicated(t, mesh) for t in (q, k, log_i, log_f))
    v = _seq_replicated(v, mesh, shard_last=True)  # the C state shards over dv
    to_s = lambda a: a.movedim(1, 0)  # [B, S, ...] -> [S, B, ...]
    state, hs = _scan(lambda st, inp: _mlstm_step(st, *inp), state,
                      (to_s(q), to_s(k), to_s(v), to_s(log_i), to_s(log_f)), cfg, mesh,
                      (False, False, True, False, False))
    h = hs.transpose(0, 1)  # [B, S, nh, dh]
    h = merge_heads(rms_norm(h, p["hnorm"]), 2).to(x.dtype)
    return x + proj(h * gate, p["wo"]), state


def mlstm_decode(p, cfg, x, state, mesh=None):
    """Single-token step.  x: [B, 1, d]."""
    return mlstm_forward(p, cfg, x, state, mesh=mesh)


# ---------------------------------------------------------------------------
# sLSTM block
# ---------------------------------------------------------------------------


def slstm_init(gen: torch.Generator, cfg, *, lead=()):
    d, nh = cfg.d_model, cfg.num_heads
    dh = d // nh
    dev = gen.device

    def r():
        w = torch.randn((*lead, nh, dh, dh), generator=gen, device=dev)
        return w.mul_(1.0 / math.sqrt(dh)).to(DEFAULT_DTYPE)

    return {
        "ln": make_norm(cfg.norm, d, lead=lead, device=dev),
        "wi": dense_init(gen, d, d, lead=lead),
        "wf": dense_init(gen, d, d, lead=lead),
        "wz": dense_init(gen, d, d, lead=lead),
        "wo": dense_init(gen, d, d, lead=lead),
        "ri": r(),
        "rf": r(),
        "rz": r(),
        "ro": r(),
        "hnorm": torch.ones((*lead, nh, dh), dtype=DEFAULT_DTYPE, device=dev),
        "wproj": dense_init(gen, d, d, lead=lead),
        "fb": torch.full((*lead, d), 3.0, dtype=torch.float32, device=dev),
    }


def slstm_state(cfg, batch: int, *, lead=(), device=None):
    d = cfg.d_model
    f32 = dict(dtype=torch.float32, device=device)
    return {
        "h": torch.zeros((*lead, batch, d), **f32),
        "c": torch.zeros((*lead, batch, d), **f32),
        "n": torch.zeros((*lead, batch, d), **f32),
        "m": torch.full((*lead, batch, d), -1e30, **f32),
    }


def _slstm_step(R, fb, nh, st, xi, xf, xz, xo):
    """xi/xf/xz/xo: [B, d] pre-activations from the input projections;
    R: the four recurrent matrices [nh, dh, dh] in float32."""
    B, d = xi.shape
    h = st["h"].reshape(B, nh, 1, d // nh)
    rec = lambda w: torch.matmul(h, w).reshape(B, d)  # einsum("bhd,hde->bhe")
    i_raw = xi + rec(R["ri"])
    f_raw = xf + rec(R["rf"]) + fb
    z = torch.tanh(xz + rec(R["rz"]))
    o = torch.sigmoid(xo + rec(R["ro"]))
    log_i, log_f = i_raw, F.logsigmoid(f_raw)
    f_m = log_f + st["m"]
    m_new = torch.maximum(f_m, log_i)
    decay = torch.exp(f_m - m_new)
    inp = torch.exp(log_i - m_new)
    c = decay * st["c"] + inp * z
    n = decay * st["n"] + inp
    h_new = o * c / torch.clamp(n, min=1e-6)
    return {"h": h_new, "c": c, "n": n, "m": m_new}, h_new


def slstm_forward(p, cfg, x, state, mesh=None):
    B, S, d = x.shape
    nh = cfg.num_heads
    xn = apply_norm(cfg.norm, p["ln"], x)
    pre = [_seq_replicated(proj(xn, p[w]).float(), mesh).movedim(1, 0)
           for w in ("wi", "wf", "wz", "wo")]
    R = {w: p[w].float() for w in ("ri", "rf", "rz", "ro")}  # the per-step casts, hoisted
    if mesh is not None:  # the step's weights, as every rank's full local copies
        dp, _ = mesh_axes(mesh)
        split = [a in dp and shard_if(mesh, B, dp) is not None for a in mesh.mesh_dim_names]
        R = {w: full_local(t, mesh, split) for w, t in R.items()}
        fb = full_local(p["fb"], mesh, split)
    else:
        fb = p["fb"]
    state, hs = _scan(lambda st, inp: _slstm_step(R, fb, nh, st, *inp), state, tuple(pre),
                      cfg, mesh, (False,) * 4)
    h = hs.transpose(0, 1).reshape(B, S, nh, d // nh)
    h = merge_heads(rms_norm(h, p["hnorm"]), 2).to(x.dtype)
    return x + proj(h, p["wproj"]), state


# ---------------------------------------------------------------------------
# full model
# ---------------------------------------------------------------------------


def _group_counts(cfg) -> Tuple[int, int, int]:
    per_group = cfg.xlstm.mlstm_per_group + cfg.xlstm.slstm_per_group
    assert cfg.num_layers % per_group == 0, "num_layers must tile into xLSTM groups"
    return cfg.num_layers // per_group, cfg.xlstm.mlstm_per_group, cfg.xlstm.slstm_per_group


def init_params(cfg, generator: torch.Generator, device: DeviceLike = None) -> Dict[str, Any]:
    """The JAX package's parameter tree (names, ``[G, n, ...]`` stacking,
    shapes, dtypes, init scales) drawn from ``generator`` on ``device``.
    The numbers differ from JAX's."""
    G, nm, ns = _group_counts(cfg)
    dev = resolve_device(device)
    gen = _device_generator(generator, dev)
    return {
        "embed": embed_init(gen, cfg.vocab_size, cfg.d_model),
        "mlstm": mlstm_init(gen, cfg, lead=(G, nm)),
        "slstm": slstm_init(gen, cfg, lead=(G, ns)),
        "final_norm": make_norm(cfg.norm, cfg.d_model, device=dev),
    }


def init_state(cfg, batch: int, device: DeviceLike = None):
    """Zero recurrent state, ``[G, n, B, ...]`` per leaf (``device="meta"``
    gives the shapes without memory)."""
    G, nm, ns = _group_counts(cfg)
    dev = resolve_device(device, allow_meta=True)
    return {
        "mlstm": mlstm_state(cfg, batch, lead=(G, nm), device=dev),
        "slstm": slstm_state(cfg, batch, lead=(G, ns), device=dev),
    }


def _stack(states: List[List[Dict[str, torch.Tensor]]]):
    """[G][n] per-block states -> one tree of [G, n, ...] leaves."""
    return {
        k: torch.stack([torch.stack([blk[k] for blk in grp]) for grp in states])
        for k in states[0][0]
    }


def _stack_forward(params, cfg, x, state, mesh=None):
    """The groups in order; inside each, its mLSTM blocks, then its sLSTM
    blocks."""
    G, nm, ns = _group_counts(cfg)
    x = constrain_activations(x, mesh)
    new_m, new_s = [], []
    for g in range(G):
        row = []
        for j in range(nm):
            pick = lambda t: t[g, j]
            x, nst = mlstm_forward(tree_map(pick, params["mlstm"]), cfg, x,
                                   tree_map(pick, state["mlstm"]), mesh=mesh)
            x = constrain_activations(x, mesh)
            row.append(nst)
        new_m.append(row)
        row = []
        for j in range(ns):
            pick = lambda t: t[g, j]
            x, nst = slstm_forward(tree_map(pick, params["slstm"]), cfg, x,
                                   tree_map(pick, state["slstm"]), mesh=mesh)
            x = constrain_activations(x, mesh)
            row.append(nst)
        new_s.append(row)
    return x, {"mlstm": _stack(new_m), "slstm": _stack(new_s)}


def loss_fn(params, cfg, batch, mesh=None):
    """Next-token LM loss (0-d f32) over ``batch["tokens"]`` [B, S], from
    zero states."""
    tokens = batch["tokens"]
    x = embed_tokens(params, cfg, tokens)
    x, _ = _stack_forward(params, cfg, x, init_state(cfg, tokens.shape[0], device=tokens.device),
                          mesh=mesh)
    x = apply_norm(cfg.norm, params["final_norm"], x)
    return chunked_cross_entropy(x, params["embed"].T, shifted_labels(tokens))


def prefill(params, cfg, batch, cache_len: int = 0, mesh=None):
    """Returns (last-position logits [B, V] f32, recurrent state)."""
    tokens = batch["tokens"]
    B = tokens.shape[0]
    x = embed_tokens(params, cfg, tokens)
    x, state = _stack_forward(params, cfg, x, init_state(cfg, B, device=tokens.device), mesh=mesh)
    x = apply_norm(cfg.norm, params["final_norm"], x)
    logits = (x[:, -1] @ params["embed"].T).float()
    return logits, state


def decode_step(params, cfg, state, tokens, cur_pos, mesh=None):
    """One token per row.  tokens: [B]; returns (logits [B, V] f32, new
    state); the input state is unchanged."""
    x = embed_tokens(params, cfg, tokens)[:, None, :]
    x, state = _stack_forward(params, cfg, x, state, mesh=mesh)
    x = apply_norm(cfg.norm, params["final_norm"], x)
    logits = (x[:, 0] @ params["embed"].T).float()
    return logits, state

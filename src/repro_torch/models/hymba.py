"""Hymba — parallel attention + mamba heads per layer (PyTorch).

Counterpart of the JAX package's ``models/hymba.py`` (arXiv:2411.13676),
with the same names, parameter tree and cache layout.  Each layer:
pre-norm -> [sliding-window attention || selective SSM] fused by averaging
the two paths' outputs -> residual; then pre-norm -> MLP -> residual.  The
hybrid cache is the *pair* (attention ring KV, SSM state): a ResidentClaim
over a hymba context must restore both halves or fail closed.

On the card every prefill's attention half runs the flash-attention kernel
(``attn_prefill_layer(..., contiguous=True)``: positions are ``arange(S)``)
under the model's window; decode attends the ring with the plain
``attention_decode``, as the port's dense mode does.  The ring keeps the
JAX package's layout after a prefill longer than it: the trailing
``Sc`` positions land in slots ``0..Sc-1``, where decode then writes
position p at slot ``p % Sc``.

``loss_fn`` trains it as the reference does: each layer rematerialized,
the attention half the plain chunked ``attention_prefill``
(``remat=True``; no kernel), the SSM scan checkpointed per chunk of
tokens (``layers.chunked_recurrent_scan``).

``mesh=`` threads the reference's layouts through ``loss_fn``, ``prefill``
and ``decode_step``: activations constrained at each layer's boundaries,
the attention half in ``layers.attention_prefill_sharded``'s body, the SSM
half channel-sharded (``ssm.ssm_forward``).
"""
from __future__ import annotations

from functools import partial
from typing import Any, Dict, List

import torch

from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models import ssm as ssm_lib
from repro_torch.models.layers import (
    DEFAULT_DTYPE,
    apply_norm,
    attn_decode_layer,
    attn_init,
    attn_prefill_layer,
    chunked_cross_entropy,
    constrain_activations,
    decode_slot,
    embed_init,
    make_norm,
    mlp_apply,
    mlp_init,
    proj,
    remat_call,
    slot_update,
)
from repro_torch.models.transformer import _sharded_prefill_cache as tf_sharded_prefill_cache
from repro_torch.models.transformer import (
    _device_generator,
    embed_tokens,
    layer_params,
    shifted_labels,
    unembed,
)


def init_params(cfg, generator: torch.Generator, device: DeviceLike = None) -> Dict[str, Any]:
    """The JAX package's parameter tree (a leading ``L`` axis on every
    layer leaf; names, shapes, dtypes, init scales) drawn from
    ``generator`` on ``device``.  The numbers differ from JAX's."""
    dev = resolve_device(device)
    gen = _device_generator(generator, dev)
    L, d = cfg.num_layers, cfg.d_model
    params = {
        "embed": embed_init(gen, cfg.vocab_size, d),
        "layers": {
            "ln1": make_norm(cfg.norm, d, lead=(L,), device=dev),
            "attn": attn_init(gen, cfg, lead=(L,)),
            "ssm": ssm_lib.ssm_init(gen, cfg, lead=(L,)),
            "ln2": make_norm(cfg.norm, d, lead=(L,), device=dev),
            "mlp": mlp_init(gen, d, cfg.d_ff, cfg.activation, lead=(L,)),
        },
        "final_norm": make_norm(cfg.norm, d, device=dev),
    }
    if not cfg.tie_embeddings:
        w = torch.randn((d, cfg.vocab_size), generator=gen, device=dev)
        params["lm_head"] = w.mul_(0.02).to(DEFAULT_DTYPE)
    return params


def make_cache(cfg, batch: int, cache_len: int, device: DeviceLike = None):
    """The ring ``k``/``v`` [L, B, Sc, KV, Dh] bf16 with ``Sc = min(cache_len,
    window)``, ``pos`` [B, Sc] (-1 = unwritten) and the SSM state ``ssm``
    (``h`` [L, B, di, N] f32, ``conv`` [L, B, K-1, di] bf16).  On the card
    unless ``device`` names the CPU (``"meta"``: shapes only)."""
    dev = resolve_device(device, allow_meta=True)
    L, KV, Dh = cfg.num_layers, cfg.num_kv_heads, cfg.resolved_head_dim
    Sc = min(cache_len, cfg.sliding_window) if cfg.sliding_window else cache_len
    return {
        "k": torch.zeros((L, batch, Sc, KV, Dh), dtype=torch.bfloat16, device=dev),
        "v": torch.zeros((L, batch, Sc, KV, Dh), dtype=torch.bfloat16, device=dev),
        "pos": torch.full((batch, Sc), -1, dtype=torch.int32, device=dev),
        "ssm": ssm_lib.ssm_state_init(cfg, batch, lead=(L,), device=dev),
    }


def _layer_state(states, i):
    return {k: v[i] for k, v in states.items()}


def _stack_states(states: List[Dict[str, torch.Tensor]]):
    return {k: torch.stack([s[k] for s in states]) for k in states[0]}


def _layer(lp, st, x, cfg, positions, remat: bool = False, mesh=None):
    """One layer: (x out, (k, v), new SSM state)."""
    x = constrain_activations(x, mesh)
    h = apply_norm(cfg.norm, lp["ln1"], x)
    a, kv = attn_prefill_layer(lp["attn"], cfg, h, positions, contiguous=True, remat=remat,
                               mesh=mesh)
    s, nst = ssm_lib.ssm_forward(lp["ssm"], cfg, h, st, mesh=mesh)
    x = x + 0.5 * (a + s)
    h = apply_norm(cfg.norm, lp["ln2"], x)
    return constrain_activations(x + mlp_apply(lp["mlp"], h, cfg.activation), mesh), kv, nst


def forward_hidden(params, cfg, x, positions, ssm_states, *, collect_cache: bool = False,
                   remat: bool = False, mesh=None):
    """The layer stack over a full-length prefill.  x: [B, S, d];
    ``positions`` must be ``arange(S)`` in every row (the flash-attention
    kernel's contract, ``attn_prefill_layer``).  ``remat`` (training) runs
    each layer as one ``remat_call`` over the plain attention.  Returns
    (hidden, ys) with ys = (k, v [L, B, S, KV, Dh], ssm states) or (ssm
    states,)."""
    ks, vs, states = [], [], []
    for i, lp in enumerate(layer_params(params["layers"], cfg.num_layers)):
        st = _layer_state(ssm_states, i)
        if remat:
            x, _, nst = remat_call(partial(_layer, cfg=cfg, positions=positions, remat=True,
                                           mesh=mesh), lp, st, x)
        else:
            x, (k_, v_), nst = _layer(lp, st, x, cfg, positions, mesh=mesh)
            if collect_cache:
                ks.append(k_)
                vs.append(v_)
        states.append(nst)
    nst = _stack_states(states)
    if collect_cache:
        return x, (torch.stack(ks), torch.stack(vs), nst)
    return x, (nst,)


def loss_fn(params, cfg, batch, mesh=None):
    """Next-token LM loss (0-d f32) over ``batch["tokens"]`` [B, S], from
    zero SSM states."""
    tokens = batch["tokens"]
    B, S = tokens.shape
    x = embed_tokens(params, cfg, tokens)
    positions = torch.arange(S, device=tokens.device)[None].expand(B, S)
    states = ssm_lib.ssm_state_init(cfg, B, lead=(cfg.num_layers,), device=tokens.device)
    x, _ = forward_hidden(params, cfg, x, positions, states, remat=True, mesh=mesh)
    x = apply_norm(cfg.norm, params["final_norm"], x)
    return chunked_cross_entropy(x, unembed(cfg, params), shifted_labels(tokens))


def prefill(params, cfg, batch, cache_len: int, mesh=None):
    """Returns (last-position logits [B, V] f32, cache)."""
    tokens = batch["tokens"]
    B, S = tokens.shape
    x = embed_tokens(params, cfg, tokens)
    positions = torch.arange(S, device=tokens.device)[None].expand(B, S)
    cache = make_cache(cfg, B, cache_len, device=tokens.device)
    x, (ck, cv, nst) = forward_hidden(params, cfg, x, positions, cache["ssm"], collect_cache=True,
                                      mesh=mesh)
    x = apply_norm(cfg.norm, params["final_norm"], x)
    logits = proj(x[:, -1], unembed(cfg, params)).float()
    if mesh is not None:
        cache = tf_sharded_prefill_cache(cfg, ck, cv, positions, cache_len)
        cache["ssm"] = nst
        return logits, cache
    keep = min(cache["k"].shape[2], S)
    cache["k"][:, :, :keep] = ck[:, :, S - keep :]
    cache["v"][:, :, :keep] = cv[:, :, S - keep :]
    cache["pos"][:, :keep] = positions[:, S - keep :]
    cache["ssm"] = nst
    return logits, cache


def decode_step(params, cfg, cache, tokens, cur_pos, mesh=None):
    """One token per row.  tokens, cur_pos: [B] int.  Returns (logits
    [B, V] f32, new cache); the input cache is unchanged."""
    x = embed_tokens(params, cfg, tokens)[:, None, :]
    Sc = cache["k"].shape[2]
    slot = decode_slot(cfg, Sc, cur_pos)
    new_pos = slot_update(cache["pos"][..., None], cur_pos[:, None, None], slot)[..., 0]
    ks, vs, states = [], [], []
    for i, lp in enumerate(layer_params(params["layers"], cfg.num_layers)):
        x = constrain_activations(x, mesh, seq_dim=None)
        h = apply_norm(cfg.norm, lp["ln1"], x)
        a, nk, nv = attn_decode_layer(
            lp["attn"], cfg, h, cache["k"][i], cache["v"][i], new_pos, cur_pos, slot
        )
        if mesh is not None:
            nk, nv = constrain_activations(nk, mesh), constrain_activations(nv, mesh)
        s, nst = ssm_lib.ssm_decode(lp["ssm"], cfg, h, _layer_state(cache["ssm"], i), mesh=mesh)
        x = x + 0.5 * (a + s)
        h = apply_norm(cfg.norm, lp["ln2"], x)
        x = x + mlp_apply(lp["mlp"], h, cfg.activation)
        ks.append(nk)
        vs.append(nv)
        states.append(nst)
    x = apply_norm(cfg.norm, params["final_norm"], x)
    logits = proj(x[:, 0], unembed(cfg, params)).float()
    return logits, {"k": torch.stack(ks), "v": torch.stack(vs), "pos": new_pos,
                    "ssm": _stack_states(states)}

"""Whisper-small — encoder-decoder transformer backbone (PyTorch).

Counterpart of the JAX package's ``models/whisper.py`` (arXiv:2212.04356),
with the same names, parameter tree (``enc_layers`` and ``dec_layers``
stacked on a leading axis) and cache layout.  The conv audio frontend is a
STUB: the caller supplies precomputed frame embeddings [B, frames, d].
Absolute sinusoidal positions (no RoPE), LayerNorm, tanh-approximated GELU
MLPs, the token embedding tied as the output projection.

On the card every attention of a prefill runs the flash-attention kernel:
the encoder non-causal over the frames, the decoder causal over the
tokens, and cross attention non-causal from the tokens over the encoder
states (Sq != Sk) — one launch each per layer, so a prefill launches it
``encoder_layers + 2 * num_layers`` times.  Decode attends its self cache
and its cross cache with the plain ``attention_decode``, as the port's
dense mode does.

Kept from the reference as it is: the decode position table has
``Sc + 1`` rows and is read at ``min(cur_pos, Sc)``; decode writes slot
``min(cur_pos, Sc - 1)``; the cross cache has ``cross_attend_len`` rows, of
which a prefill fills ``min(cross_attend_len, frames)``; and decode attends
all ``cross_attend_len`` rows, zero-filled ones included (with fewer
frames than ``cross_attend_len`` a decode step therefore differs from a
prefill of the same tokens: ROADMAP Queue 3).  No engine serves whisper;
the bundle's ``prefill_fn``/``decode_fn`` are its entry points.

``loss_fn`` trains it as the reference does: ``encode(remat=True)`` and
``decode_prefill(remat=True)`` rematerialize each layer, and every
attention, cross attention included, runs the plain chunked
``attention_prefill`` (no kernel: K5 has no backward).

``mesh=`` threads the reference's layouts through ``encode`` and
``decode_prefill`` (so ``loss_fn`` and ``prefill``): activations
constrained at each layer's boundaries, self and cross attention in
``layers.attention_prefill_sharded``'s body.
"""
from __future__ import annotations

from functools import partial
from typing import Any, Dict

import torch

from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models.layers import (
    apply_norm,
    attention_contiguous,
    attention_decode,
    attention_prefill,
    attn_decode_layer,
    attn_init,
    attn_prefill_layer,
    attention_prefill_sharded,
    chunked_cross_entropy,
    constrain_activations,
    decode_slot,
    dense_init,
    is_dtensor,
    embed_init,
    make_norm,
    merge_heads,
    mlp_apply,
    mlp_init,
    pad_to,
    proj,
    remat_call,
    sinusoidal_positions,
    slot_update,
    split_dim,
)
from repro_torch.models.transformer import (
    _device_generator,
    embed_tokens,
    layer_params,
    shifted_labels,
)

DEC_LEN = 448  # whisper's longest decoder sequence


def _xattn_init(gen: torch.Generator, cfg, *, lead=()):
    d, H, KV, Dh = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    return {
        "wq": dense_init(gen, d, H * Dh, lead=lead),
        "wk": dense_init(gen, d, KV * Dh, lead=lead),
        "wv": dense_init(gen, d, KV * Dh, lead=lead),
        "wo": dense_init(gen, H * Dh, d, lead=lead),
    }


def init_params(cfg, generator: torch.Generator, device: DeviceLike = None) -> Dict[str, Any]:
    """The JAX package's parameter tree (names, shapes, dtypes, init scales)
    drawn from ``generator`` on ``device``.  The numbers differ from JAX's."""
    dev = resolve_device(device)
    gen = _device_generator(generator, dev)
    d, Le, Ld = cfg.d_model, cfg.encoder_layers, cfg.num_layers
    return {
        "embed": embed_init(gen, cfg.vocab_size, d),
        "enc_layers": {
            "ln1": make_norm(cfg.norm, d, lead=(Le,), device=dev),
            "attn": attn_init(gen, cfg, lead=(Le,)),
            "ln2": make_norm(cfg.norm, d, lead=(Le,), device=dev),
            "mlp": mlp_init(gen, d, cfg.d_ff, cfg.activation, lead=(Le,)),
        },
        "enc_norm": make_norm(cfg.norm, d, device=dev),
        "dec_layers": {
            "ln1": make_norm(cfg.norm, d, lead=(Ld,), device=dev),
            "attn": attn_init(gen, cfg, lead=(Ld,)),
            "lnx": make_norm(cfg.norm, d, lead=(Ld,), device=dev),
            "xattn": _xattn_init(gen, cfg, lead=(Ld,)),
            "ln2": make_norm(cfg.norm, d, lead=(Ld,), device=dev),
            "mlp": mlp_init(gen, d, cfg.d_ff, cfg.activation, lead=(Ld,)),
        },
        "final_norm": make_norm(cfg.norm, d, device=dev),
    }


def _arange_rows(B: int, S: int, device) -> torch.Tensor:
    return torch.arange(S, device=device)[None].expand(B, S)


def _enc_layer(lp, x, cfg, positions, remat: bool = False, mesh=None):
    x = constrain_activations(x, mesh)
    h = apply_norm(cfg.norm, lp["ln1"], x)
    a, _ = attn_prefill_layer(
        lp["attn"], cfg, h, positions, causal=False, use_rope=False, contiguous=True, remat=remat,
        mesh=mesh,
    )
    x = x + a
    h = apply_norm(cfg.norm, lp["ln2"], x)
    return constrain_activations(x + mlp_apply(lp["mlp"], h, cfg.activation), mesh)


def encode(params, cfg, frames, *, remat: bool = False, mesh=None):
    """frames: [B, S, d] stub embeddings -> encoder states [B, S, d].
    ``remat`` (training): each layer one ``remat_call`` over the plain
    attention."""
    B, S, d = frames.shape
    x = frames + sinusoidal_positions(S, d, device=frames.device)[None]
    positions = _arange_rows(B, S, frames.device)
    layer = partial(_enc_layer, cfg=cfg, positions=positions, remat=remat, mesh=mesh)
    for lp in layer_params(params["enc_layers"], cfg.encoder_layers):
        x = remat_call(layer, lp, x) if remat else layer(lp, x)
    return apply_norm(cfg.norm, params["enc_norm"], x)


def _cross_kv(lp, cfg, enc_states):
    """The layer's cross keys and values [B, T, KV, Dh] over the encoder
    states (views of the projections, no copies)."""
    B, T, _ = enc_states.shape
    KV, Dh = cfg.num_kv_heads, cfg.resolved_head_dim
    k = split_dim(proj(enc_states, lp["xattn"]["wk"]), 2, (KV, Dh))
    v = split_dim(proj(enc_states, lp["xattn"]["wv"]), 2, (KV, Dh))
    return k, v


def _cross_attend(lp, cfg, x, xk, xv, remat: bool = False, mesh=None):
    """Non-causal attention from x [B, S, d] over xk, xv [B, T, KV, Dh];
    ``remat``: the plain attention with each query block rematerialized.
    ``mesh``: in ``attention_prefill_sharded``'s body (the cross K/V
    gathered once, each rank's query slice)."""
    B, S, _ = x.shape
    H, Dh = cfg.num_heads, cfg.resolved_head_dim
    q = split_dim(proj(x, lp["xattn"]["wq"]), 2, (H, Dh))
    if mesh is not None:
        T = xk.shape[1]
        out = attention_prefill_sharded(
            q, xk, xv, q_positions=_arange_rows(B, S, x.device),
            kv_positions=_arange_rows(B, T, x.device), mesh=mesh, causal=False,
            contiguous=True, remat=remat)
    elif remat:
        T = xk.shape[1]
        out = attention_prefill(q, xk, xv, q_positions=_arange_rows(B, S, x.device),
                                kv_positions=_arange_rows(B, T, x.device), causal=False,
                                remat=True)
    else:
        out = attention_contiguous(q, xk, xv, causal=False)
    return proj(merge_heads(out, 2), lp["xattn"]["wo"])


def _dec_layer(lp, x, enc_states, cfg, positions, remat: bool = False, mesh=None):
    """One decoder layer: (x out, (k, v, xk, xv))."""
    x = constrain_activations(x, mesh)
    h = apply_norm(cfg.norm, lp["ln1"], x)
    a, (k_, v_) = attn_prefill_layer(lp["attn"], cfg, h, positions, use_rope=False,
                                     contiguous=True, remat=remat, mesh=mesh)
    x = x + a
    h = apply_norm(cfg.norm, lp["lnx"], x)
    xk, xv = _cross_kv(lp, cfg, enc_states)
    x = x + _cross_attend(lp, cfg, h, xk, xv, remat=remat, mesh=mesh)
    h = apply_norm(cfg.norm, lp["ln2"], x)
    return x + mlp_apply(lp["mlp"], h, cfg.activation), (k_, v_, xk, xv)


def decode_prefill(params, cfg, tokens, enc_states, *, collect_cache: bool = False,
                   remat: bool = False, mesh=None):
    """Decoder forward over a token prefix.  Returns (hidden [B, S, d],
    (k, v, xk, xv) stacked on a leading L, or None).  ``remat``
    (training): each layer one ``remat_call`` over the plain attention."""
    B, S = tokens.shape
    d = cfg.d_model
    x = embed_tokens(params, cfg, tokens) + sinusoidal_positions(S, d, device=tokens.device)[None]
    positions = _arange_rows(B, S, tokens.device)
    ys = []
    for lp in layer_params(params["dec_layers"], cfg.num_layers):
        if remat:
            x, _ = remat_call(partial(_dec_layer, cfg=cfg, positions=positions, remat=True,
                                      mesh=mesh), lp, x, enc_states)
        else:
            x, kv = _dec_layer(lp, x, enc_states, cfg, positions, mesh=mesh)
            if collect_cache:
                ys.append(kv)
    cache = tuple(torch.stack(t) for t in zip(*ys)) if collect_cache else None
    return apply_norm(cfg.norm, params["final_norm"], x), cache


def loss_fn(params, cfg, batch, mesh=None):
    """Next-token LM loss (0-d f32).  batch: ``frames`` [B, T, d] (the stub
    frontend's embeddings) and ``tokens`` [B, S]."""
    enc_states = encode(params, cfg, batch["frames"], remat=True, mesh=mesh)
    x, _ = decode_prefill(params, cfg, batch["tokens"], enc_states, remat=True, mesh=mesh)
    return chunked_cross_entropy(x, params["embed"].T, shifted_labels(batch["tokens"]))


def make_cache(cfg, batch: int, cache_len: int, device: DeviceLike = None):
    """Self cache ``k``/``v`` [L, B, cache_len, KV, Dh] bf16 with ``pos``
    [B, cache_len] (-1 = unwritten), and the cross cache ``xk``/``xv``
    [L, B, cross_attend_len, KV, Dh] bf16.  On the card unless ``device``
    names the CPU (``"meta"``: shapes only)."""
    dev = resolve_device(device, allow_meta=True)
    L, KV, Dh = cfg.num_layers, cfg.num_kv_heads, cfg.resolved_head_dim
    zeros = lambda n: torch.zeros((L, batch, n, KV, Dh), dtype=torch.bfloat16, device=dev)
    return {
        "k": zeros(cache_len),
        "v": zeros(cache_len),
        "pos": torch.full((batch, cache_len), -1, dtype=torch.int32, device=dev),
        "xk": zeros(cfg.cross_attend_len),
        "xv": zeros(cfg.cross_attend_len),
    }


def prefill(params, cfg, batch, cache_len: int, mesh=None):
    """batch: ``frames`` [B, T, d], ``tokens`` [B, S].  Returns (last-position
    logits [B, V] f32, cache)."""
    frames, tokens = batch["frames"], batch["tokens"]
    B, S = tokens.shape
    enc_states = encode(params, cfg, frames, mesh=mesh)
    x, (ck, cv, xk, xv) = decode_prefill(params, cfg, tokens, enc_states, collect_cache=True,
                                         mesh=mesh)
    logits = (x[:, -1] @ params["embed"].T).float()
    if mesh is not None:  # the same slots, by concatenation (``layers.pad_to``)
        keep, Tc = min(cache_len, S), min(cfg.cross_attend_len, xk.shape[2])
        return logits, {
            "k": pad_to(ck[:, :, S - keep :], cache_len, 2, 0),
            "v": pad_to(cv[:, :, S - keep :], cache_len, 2, 0),
            "pos": pad_to(_arange_rows(B, S, x.device)[:, S - keep :].to(torch.int32),
                          cache_len, 1, -1),
            "xk": pad_to(xk[:, :, :Tc], cfg.cross_attend_len, 2, 0),
            "xv": pad_to(xv[:, :, :Tc], cfg.cross_attend_len, 2, 0),
        }
    cache = make_cache(cfg, B, cache_len, device=x.device)
    keep = min(cache_len, S)
    cache["k"][:, :, :keep] = ck[:, :, S - keep :]
    cache["v"][:, :, :keep] = cv[:, :, S - keep :]
    cache["pos"][:, :keep] = _arange_rows(B, S, x.device)[:, S - keep :]
    Tc = min(cfg.cross_attend_len, xk.shape[2])
    cache["xk"][:, :, :Tc] = xk[:, :, :Tc]
    cache["xv"][:, :, :Tc] = xv[:, :, :Tc]
    return logits, cache


def decode_step(params, cfg, cache, tokens, cur_pos, mesh=None):
    """One decode step.  tokens, cur_pos: [B] int.  Returns (logits [B, V]
    f32, new cache); the input cache is unchanged.  ``mesh`` is taken and
    unused: the reference's whisper decode constrains nothing."""
    B = tokens.shape[0]
    d = cfg.d_model
    H, Dh = cfg.num_heads, cfg.resolved_head_dim
    Sc = cache["k"].shape[2]
    pos_table = sinusoidal_positions(Sc + 1, d, device=tokens.device)
    row = torch.clamp(cur_pos.long(), max=Sc)
    pos_rows = (torch.nn.functional.embedding(row, pos_table) if is_dtensor(row)  # as embed_tokens
                else pos_table[row])
    x = embed_tokens(params, cfg, tokens)[:, None, :] + pos_rows[:, None, :]
    slot = decode_slot(cfg, Sc, cur_pos)
    new_pos = slot_update(cache["pos"][..., None], cur_pos[:, None, None], slot)[..., 0]
    Tc = cache["xk"].shape[2]
    xpos = _arange_rows(B, Tc, tokens.device)
    x_cur = torch.full((B,), Tc, dtype=torch.int32, device=tokens.device)
    ks, vs = [], []
    for i, lp in enumerate(layer_params(params["dec_layers"], cfg.num_layers)):
        h = apply_norm(cfg.norm, lp["ln1"], x)
        a, nk, nv = attn_decode_layer(
            lp["attn"], cfg, h, cache["k"][i], cache["v"][i], new_pos, cur_pos, slot, use_rope=False
        )
        x = x + a
        h = apply_norm(cfg.norm, lp["lnx"], x)
        q = split_dim(proj(h, lp["xattn"]["wq"]), 2, (H, Dh))
        xa = attention_decode(q, cache["xk"][i], cache["xv"][i], kv_positions=xpos, cur_pos=x_cur)
        x = x + proj(merge_heads(xa, 2), lp["xattn"]["wo"])
        h = apply_norm(cfg.norm, lp["ln2"], x)
        x = x + mlp_apply(lp["mlp"], h, cfg.activation)
        ks.append(nk)
        vs.append(nv)
    x = apply_norm(cfg.norm, params["final_norm"], x)
    logits = (x[:, 0] @ params["embed"].T).float()
    new_cache = dict(cache)
    new_cache.update(k=torch.stack(ks), v=torch.stack(vs), pos=new_pos)
    return logits, new_cache

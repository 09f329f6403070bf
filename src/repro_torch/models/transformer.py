"""Decoder-only transformer LM on the serving paths (PyTorch).

Counterpart of the JAX package's ``models/transformer.py`` for the dense
family (qwen3-1.7b, h2o-danube-1.8b, stablelm-12b, deepseek-7b), the MoE
family (grok-1-314b, arctic-480b with its dense residual MLP: the MLP is
``models/moe.py``'s capacity-bounded top-k experts) and the VLM family
(phi-3-vision-4.2b: stub patch embeddings prepended at prefill): the paged
entry points (``prefill_collect``, ``prefill_chunk``, ``paged_decode_step``) and the
dense-cache ones (``make_cache``, ``prefill``, ``decode_step``).  The layer stack keeps a leading ``L``
axis on every parameter and runs as a Python loop over layers (the JAX
package's ``lax.scan``).  A batch runs as one batched computation per layer:
the paged attention kernels compute every row independently of the batch
width, while ``torch.matmul`` may pick other kernels per width, so results
across different widths agree within a tolerance, not bitwise.

Token ids outside ``[0, vocab)`` are clamped at the embedding, as the JAX
package's gather clamps them.

``kv_cache_dtype="int8"`` keeps the dense cache as int8 values with a bf16
per-token scale per kv head (``quantize_kv``); a decode step dequantizes
each layer's slice, runs the layer, and requantizes the slice with the new
token written.  Dequantization is plain PyTorch on either device, as it is
plain XLA in the JAX package: an int8 bundle has no paged entry points
(``models/registry.py``), so no kernel reads int8 pages.

An MoE layer's capacity depends on the tokens of its call, so MoE logits
depend on the batch and chunk a request shares (``models/moe.py``).  The
paged decode step dispatches each row on its own, as the reference does on
every backend but the TPU (its ``lax.map`` over rows); a prefill, a prefill
chunk and a dense decode step dispatch the whole batch together, as the
reference does everywhere.

``loss_fn`` is the training objective, the reference's: the layer stack
with each layer rematerialized and the plain chunked attention
(``attn_prefill_layer(..., remat=True)``; no kernel), then
``chunked_cross_entropy`` plus ``aux_coef`` times the MoE layers' GShard
aux loss.

``mesh=`` (a ``DeviceMesh``, with DTensor parameters and inputs; the
sharded steps of ``launch/steps.py``) threads the reference's layouts
through ``loss_fn``, ``prefill`` and ``decode_step``: activations are
constrained at each layer's boundaries (``constrain_activations``), the
attention runs in the sharded body of ``layers.attention_prefill_sharded``,
and an MoE layer runs ``moe.moe_apply_sharded`` with ``moe_strategy``.
Without a mesh each entry point is what it was.
"""
from __future__ import annotations

from functools import partial
from typing import Any, Dict, List

import torch

from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models import moe as moe_lib
from repro_torch.models.layers import (
    DEFAULT_DTYPE,
    apply_norm,
    attn_decode_layer,
    attn_init,
    attn_paged_decode_layer,
    attn_paged_prefill_layer,
    attn_prefill_layer,
    chunked_cross_entropy,
    constrain_activations,
    decode_slot,
    embed_init,
    hold_grad_layout,
    make_norm,
    mlp_apply,
    mlp_init,
    pad_to,
    remat_call,
    slot_update,
    unshard_dims,
)


TRANSFORMER_FAMILIES = ("dense", "moe", "vlm")


def check_supported(cfg) -> None:
    """The port serves the transformer families here (dense, MoE, and VLM
    with its ``image_patches`` stub frontend), the recurrent families
    (``hybrid``: hymba, ``ssm``: xLSTM) and the audio family (``audio``:
    whisper, with its ``audio_frames`` stub frontend) in their own modules.
    The other families ignore ``kv_cache_dtype``, as in the JAX package."""
    if cfg.family not in TRANSFORMER_FAMILIES + ("hybrid", "ssm", "audio"):
        raise NotImplementedError(f"{cfg.name}: family={cfg.family} is not ported")
    if cfg.family in TRANSFORMER_FAMILIES and cfg.kv_cache_dtype not in ("bf16", "int8"):
        raise NotImplementedError(f"{cfg.name}: kv_cache_dtype={cfg.kv_cache_dtype} is not ported")


# ---------------------------------------------------------------------------
# params
# ---------------------------------------------------------------------------


def _device_generator(generator: torch.Generator, device: torch.device) -> torch.Generator:
    """Draw on ``device``: the caller's generator when it lives there, else a
    generator on the device seeded from one draw of the caller's."""
    if generator.device.type == device.type:
        return generator
    # lint: allow[device-path-purity] one seed draw when the parameters are made, before any step
    seed = int(torch.randint(0, 2**62, (1,), generator=generator))
    return torch.Generator(device=device).manual_seed(seed)


def init_params(cfg, generator: torch.Generator, device: DeviceLike = None) -> Dict[str, Any]:
    """The JAX package's parameter tree (names, shapes, init scales) drawn
    from ``generator`` on ``device``.  The numbers differ from JAX's."""
    if cfg.family not in TRANSFORMER_FAMILIES:
        raise NotImplementedError(f"{cfg.name}: family={cfg.family} is not a transformer")
    check_supported(cfg)
    dev = resolve_device(device)
    gen = _device_generator(generator, dev)
    L, d = cfg.num_layers, cfg.d_model
    layers = {
        "ln1": make_norm(cfg.norm, d, lead=(L,), device=dev),
        "attn": attn_init(gen, cfg, lead=(L,)),
        "ln2": make_norm(cfg.norm, d, lead=(L,), device=dev),
    }
    if cfg.moe.num_experts:
        layers["moe"] = moe_lib.moe_init(gen, cfg, lead=(L,))
    if not cfg.moe.num_experts or cfg.moe.dense_residual:
        layers["mlp"] = mlp_init(gen, d, cfg.d_ff, cfg.activation, lead=(L,))
    params = {
        "embed": embed_init(gen, cfg.vocab_size, d),
        "layers": layers,
        "final_norm": make_norm(cfg.norm, d, device=dev),
    }
    if not cfg.tie_embeddings:
        w = torch.randn((d, cfg.vocab_size), generator=gen, device=dev)
        params["lm_head"] = w.mul_(0.02).to(DEFAULT_DTYPE)
    return params


def unembed(cfg, params):
    if cfg.tie_embeddings:
        return params["embed"].T
    return params["lm_head"]


def layer_params(layers: Dict[str, Any], num_layers: int) -> List[Dict[str, Any]]:
    """Per-layer views of a stacked-L parameter dict, the first
    ``num_layers`` of them.  Each leaf is split by one ``unbind``, whose
    backward stacks every layer's grad in one op (indexing the leaf once
    per layer would add a full-size zero grad per layer)."""

    def split(tree):
        if isinstance(tree, dict):
            return {k: split(v) for k, v in tree.items()}
        return tree.unbind(0)

    def pick(tree, i):
        if isinstance(tree, dict):
            return {k: pick(v, i) for k, v in tree.items()}
        return tree[i]

    parts = split(layers)
    return [pick(parts, i) for i in range(num_layers)]


def embed_tokens(params, cfg, tokens, extra_embeds=None):
    """Token embedding; ids are clamped to [0, vocab - 1].  VLM configs
    prepend the stub frontend's embeddings ``extra_embeds`` [B, P, d]."""
    ids = tokens.long().clamp(0, cfg.vocab_size - 1)
    # F.embedding, not indexing, on every route: on the card its backward
    # sums a table row's duplicate tokens in f32, where indexing's (an
    # index_put_ with accumulate) rounds a bf16 row after each duplicate;
    # and DTensor before torch 2.13 has no rule for the indexing with ids
    # sharded over two mesh axes, nor for its backward on a sharded table
    x = torch.nn.functional.embedding(ids, params["embed"])
    if extra_embeds is not None:
        x = torch.cat([extra_embeds.to(x.dtype), x], dim=1)
    return x


def _mlp_block(lp, cfg, h, *, per_row: bool = False, mesh=None, moe_strategy: str = "auto"):
    """The layer's MLP on h [B, S, d]: the dense MLP, or the MoE over all
    B * S tokens as one dispatch (``per_row``: one dispatch per row), plus
    Arctic's dense residual MLP beside the experts.  Returns (out, aux):
    the MoE's GShard aux loss summed over its dispatches (one without
    ``per_row``), None for a dense MLP.  With a mesh the MoE is
    ``moe_apply_sharded`` over the B * S tokens (the reference's
    ``_moe_block``)."""
    if not cfg.moe.num_experts:
        return mlp_apply(lp["mlp"], h, cfg.activation), None
    B, S, d = h.shape
    if mesh is not None:
        dp = tuple(a for a in ("pod", "data") if a in mesh.mesh_dim_names)
        tokens = hold_grad_layout(unshard_dims(h, (1,))).reshape(B * S, d)  # [B, S] flattened
        m, aux = moe_lib.moe_apply_sharded(lp["moe"], tokens, cfg, mesh,
                                           dp_axes=dp, tp_axis="model", strategy=moe_strategy)
    else:
        groups = h if per_row else h.reshape(1, B * S, d)
        m, aux = moe_lib.moe_apply_grouped(lp["moe"], groups, cfg)
        aux = aux.sum()
    m = hold_grad_layout(m.reshape(B, S, d))  # its backward flattens [B, S] again
    if cfg.moe.dense_residual:
        m = m + mlp_apply(lp["mlp"], h, cfg.activation)
    return m, aux


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------


def _layer(lp, x, cfg, positions, *, contiguous: bool = False, remat: bool = False, mesh=None,
           moe_strategy: str = "auto"):
    """One layer: (x out, MoE aux or None, (k, v))."""
    x = constrain_activations(x, mesh)
    h = apply_norm(cfg.norm, lp["ln1"], x)
    a, kv = attn_prefill_layer(lp["attn"], cfg, h, positions, contiguous=contiguous, remat=remat,
                               mesh=mesh)
    x = x + a
    h = apply_norm(cfg.norm, lp["ln2"], x)
    m, aux = _mlp_block(lp, cfg, h, mesh=mesh, moe_strategy=moe_strategy)
    x = constrain_activations(x + m, mesh)
    if mesh is not None:
        kv = tuple(constrain_activations(t, mesh) for t in kv)
    return x, aux, kv


def forward_hidden(params, cfg, x, positions, *, collect_cache: bool = False,
                   contiguous: bool = False, remat: bool = False, mesh=None,
                   moe_strategy: str = "auto"):
    """Run the layer stack.  x: [B, S, d] embedded inputs.  ``contiguous``
    states that ``positions`` are ``arange(S)`` in every row, which the
    card's flash-attention kernel requires (``attn_prefill_layer``).
    ``remat`` (training) runs each layer as one ``remat_call`` over the
    plain attention, as the reference's ``jax.checkpoint``-ed scan body.

    Returns (hidden [B, S, d], aux, cache_kv or None): aux is the MoE
    layers' aux loss summed (f32 0 for a dense stack); cache_kv is (k, v)
    stacked [L, B, S, KV, Dh].  ``mesh``: the sharded layer (see the module
    docstring).
    """
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    ks, vs = [], []
    sharding = dict(mesh=mesh, moe_strategy=moe_strategy)
    for lp in layer_params(params["layers"], cfg.num_layers):
        if remat:
            x, aux_l, _ = remat_call(partial(_layer, cfg=cfg, positions=positions, remat=True,
                                             **sharding), lp, x)
        else:
            x, aux_l, (k_, v_) = _layer(lp, x, cfg, positions, contiguous=contiguous, **sharding)
            if collect_cache:
                ks.append(k_)
                vs.append(v_)
        if aux_l is not None:
            aux = aux + aux_l
    cache = (torch.stack(ks), torch.stack(vs)) if collect_cache else None
    return x, aux, cache


def loss_fn(params, cfg, batch, *, aux_coef: float = 0.01, mesh=None, moe_strategy: str = "auto"):
    """Next-token LM loss (0-d f32).  batch: ``tokens`` [B, S], and for the
    VLM ``patch_embeds`` [B, P, d] in front of them (positions
    ``arange(P + S)``; the P frontend positions carry no label)."""
    tokens = batch["tokens"]
    B, S = tokens.shape
    x, positions = _embed_prompt(params, cfg, batch)
    P = x.shape[1] - S
    x, aux, _ = forward_hidden(params, cfg, x, positions, remat=True, mesh=mesh,
                               moe_strategy=moe_strategy)
    x = apply_norm(cfg.norm, params["final_norm"], x)
    labels = shifted_labels(tokens, P)
    return chunked_cross_entropy(x, unembed(cfg, params), labels) + aux_coef * aux


def shifted_labels(tokens, n_front: int = 0):
    """Labels [B, n_front + S]: position t predicts token t + 1; the last
    position and ``n_front`` frontend positions in front carry -1."""
    B = tokens.shape[0]
    labels = torch.cat([tokens[:, 1:], tokens.new_full((B, 1), -1)], dim=1)
    if n_front:
        labels = torch.cat([tokens.new_full((B, n_front), -1), labels], dim=1)
    return labels


def quantize_kv(x):
    """Per-token absmax int8 over head_dim.  x: [..., Dh] -> (int8 values
    [..., Dh], bf16 scales [...]): f32 absmax / 127, values rounded half to
    even, as the JAX package's ``quantize_kv``."""
    xf = x.float()
    scale = xf.abs().amax(dim=-1) / 127.0
    q = torch.round(xf / torch.clamp(scale, min=1e-8)[..., None])
    return q.to(torch.int8), scale.to(torch.bfloat16)


def dequantize_kv(q, scale, dtype=DEFAULT_DTYPE):
    """int8 values times their scale, one multiply in ``dtype``."""
    return (q.to(dtype) * scale.to(dtype)[..., None]).to(dtype)


def make_cache(cfg, batch: int, cache_len: int, dtype=DEFAULT_DTYPE, device: DeviceLike = None):
    """Dense decode cache: ``k``/``v`` [L, B, Sc, KV, Dh] and ``pos`` [B, Sc]
    (-1 = unwritten), with ``Sc = min(cache_len, window)`` for sliding-window
    configs (a ring).  bf16 whatever the parameters' type, as in the JAX
    package; ``kv_cache_dtype="int8"`` makes ``k``/``v`` int8 and adds
    ``k_scale``/``v_scale`` [L, B, Sc, KV] in bf16.  On the card unless
    ``device`` names the CPU."""
    device = resolve_device(device, allow_meta=True)
    L, KV, Dh = cfg.num_layers, cfg.num_kv_heads, cfg.resolved_head_dim
    Sc = min(cache_len, cfg.sliding_window) if cfg.sliding_window else cache_len
    cache = {"pos": torch.full((batch, Sc), -1, dtype=torch.int32, device=device)}
    if cfg.kv_cache_dtype == "int8":
        for key in ("k", "v"):
            cache[key] = torch.zeros((L, batch, Sc, KV, Dh), dtype=torch.int8, device=device)
        for key in ("k_scale", "v_scale"):
            cache[key] = torch.zeros((L, batch, Sc, KV), dtype=torch.bfloat16, device=device)
    else:
        for key in ("k", "v"):
            cache[key] = torch.zeros((L, batch, Sc, KV, Dh), dtype=dtype, device=device)
    return cache


def _embed_prompt(params, cfg, batch):
    """The prompt's embeddings [B, P + S, d] with ``batch["patch_embeds"]``
    [B, P, d] (VLM) in front, and their positions ``arange(P + S)``."""
    tokens = batch["tokens"]
    x = embed_tokens(params, cfg, tokens, batch.get("patch_embeds"))
    B, St = x.shape[:2]
    return x, torch.arange(St, device=tokens.device)[None].expand(B, St)


def prefill(params, cfg, batch, cache_len: int, *, mesh=None, moe_strategy: str = "auto"):
    """Prefill for the dense decode mode; returns (last-position logits
    [B, V] f32, cache).  ``batch["patch_embeds"]`` [B, P, d], when given,
    precede the tokens (positions ``0..P-1``).  The trailing ``min(Sc, P + S)``
    positions of the prefill KV land in cache slots ``0..keep-1`` (for a
    prompt longer than a sliding-window ring this is not the ring slot
    ``p % Sc`` that decode later writes; the JAX package does the same)."""
    x, positions = _embed_prompt(params, cfg, batch)
    B, St = positions.shape
    x, _, (ck, cv) = forward_hidden(params, cfg, x, positions, collect_cache=True, contiguous=True,
                                    mesh=mesh, moe_strategy=moe_strategy)
    x = apply_norm(cfg.norm, params["final_norm"], x)
    logits = (x[:, -1] @ unembed(cfg, params)).float()
    if mesh is not None:
        return logits, _sharded_prefill_cache(cfg, ck, cv, positions, cache_len)
    cache = make_cache(cfg, B, cache_len, device=x.device)
    keep = min(cache["k"].shape[2], St)
    # write the trailing `keep` positions of the prefill KV into the cache
    if cfg.kv_cache_dtype == "int8":
        for key, kv in (("k", ck), ("v", cv)):
            qv, sc = quantize_kv(kv[:, :, St - keep :])
            cache[key][:, :, :keep] = qv
            cache[f"{key}_scale"][:, :, :keep] = sc
    else:
        cache["k"][:, :, :keep] = ck[:, :, St - keep :]
        cache["v"][:, :, :keep] = cv[:, :, St - keep :]
    cache["pos"][:, :keep] = positions[:, St - keep :]
    return logits, cache


def decode_step(params, cfg, cache, tokens, cur_pos, *, mesh=None, moe_strategy: str = "auto"):
    """One dense-cache decode step.  tokens, cur_pos: [B] int.  Returns
    (logits [B, V] f32, new cache); the input cache is unchanged.  An int8
    cache is dequantized one layer at a time, and the layer's slice with
    the new token written is requantized, as in the JAX package."""
    x = embed_tokens(params, cfg, tokens)[:, None, :]  # [B, 1, d]
    Sc = cache["k"].shape[2]
    slot = decode_slot(cfg, Sc, cur_pos)
    new_pos = slot_update(cache["pos"][..., None], cur_pos[:, None, None], slot)[..., 0]
    int8_kv = cfg.kv_cache_dtype == "int8"
    out = {key: [] for key in cache if key != "pos"}
    for i, lp in enumerate(layer_params(params["layers"], cfg.num_layers)):
        if int8_kv:
            ck = dequantize_kv(cache["k"][i], cache["k_scale"][i])
            cv = dequantize_kv(cache["v"][i], cache["v_scale"][i])
        else:
            ck, cv = cache["k"][i], cache["v"][i]
        x = constrain_activations(x, mesh, seq_dim=None)
        h = apply_norm(cfg.norm, lp["ln1"], x)
        a, nk, nv = attn_decode_layer(lp["attn"], cfg, h, ck, cv, new_pos, cur_pos, slot)
        x = x + a
        h = apply_norm(cfg.norm, lp["ln2"], x)
        x = x + _mlp_block(lp, cfg, h, mesh=mesh, moe_strategy=moe_strategy)[0]
        if mesh is not None:
            nk, nv = constrain_activations(nk, mesh), constrain_activations(nv, mesh)
        if int8_kv:
            (nk, nks), (nv, nvs) = quantize_kv(nk), quantize_kv(nv)
            out["k_scale"].append(nks)
            out["v_scale"].append(nvs)
        out["k"].append(nk)
        out["v"].append(nv)
    x = apply_norm(cfg.norm, params["final_norm"], x)
    logits = (x[:, 0] @ unembed(cfg, params)).float()
    new_cache = {key: torch.stack(ts) for key, ts in out.items()}
    new_cache["pos"] = new_pos
    return logits, new_cache


def _sharded_prefill_cache(cfg, ck, cv, positions, cache_len: int):
    """``prefill``'s cache from DTensor K/V [L, B, St, KV, Dh]: the trailing
    ``keep`` positions in slots ``0..keep-1`` and the rest unwritten, as
    ``prefill`` writes them (``layers.pad_to``).  bf16 caches only."""
    if cfg.kv_cache_dtype == "int8":
        raise NotImplementedError("a sharded int8 prefill cache is not ported")
    St = ck.shape[2]
    Sc = min(cache_len, cfg.sliding_window) if cfg.sliding_window else cache_len
    keep = min(Sc, St)
    return {
        "k": pad_to(ck[:, :, St - keep :], Sc, 2, 0),
        "v": pad_to(cv[:, :, St - keep :], Sc, 2, 0),
        "pos": pad_to(positions[:, St - keep :].to(torch.int32), Sc, 1, -1),
    }


def prefill_collect(params, cfg, batch):
    """Monolithic batched prefill for the paged serving path
    (``prefill_chunk=0``): returns (last-valid logits [B, V] f32, k, v
    [L, B, P + S, KV, Dh]).  ``batch["valid_len"]`` [B] marks right-padded
    prompts; only the logit gather needs it (causal masking keeps padding
    out of every valid row).  ``batch["patch_embeds"]`` [B, P, d] precede
    the tokens, as in ``prefill``."""
    x, positions = _embed_prompt(params, cfg, batch)
    B, St = positions.shape
    P = St - batch["tokens"].shape[1]
    x, _, (ck, cv) = forward_hidden(params, cfg, x, positions, collect_cache=True, contiguous=True)
    x = apply_norm(cfg.norm, params["final_norm"], x)
    valid_len = batch.get("valid_len")
    if valid_len is None:
        last = torch.full((B,), St - 1, device=x.device, dtype=torch.long)
    else:
        last = valid_len.long() + P - 1
    logits = (x[torch.arange(B, device=x.device), last] @ unembed(cfg, params)).float()
    return logits, ck, cv


def prefill_chunk(params, cfg, state, tokens, positions):
    """One chunk of chunked paged prefill — the O(chunk) serving path.

    ``state``:
      k_pages/v_pages [L, KV, N, page, Dh]  the device page pool (read-only)
      block_tables    [B, P] int32          pages of the already-prefilled prefix
      prefix_len      [B] int32             tokens addressed via the table
    tokens: [B, C] the chunk's token ids; positions: [B, C] absolute
    positions (= prefix_len + arange(C)).

    Returns the chunk's KV ``(ck, cv)`` stacked [L, B, C, KV, Dh] — the only
    KV this launch materializes.
    """
    x = embed_tokens(params, cfg, tokens)  # [B, C, d]
    bt, plen = state["block_tables"], state["prefix_len"]
    ks, vs = [], []
    for i, lp in enumerate(layer_params(params["layers"], cfg.num_layers)):
        h = apply_norm(cfg.norm, lp["ln1"], x)
        a, (k_, v_) = attn_paged_prefill_layer(
            lp["attn"], cfg, h, state["k_pages"][i], state["v_pages"][i], bt, plen, positions
        )
        x = x + a
        h = apply_norm(cfg.norm, lp["ln2"], x)
        x = x + _mlp_block(lp, cfg, h)[0]
        ks.append(k_)
        vs.append(v_)
    return torch.stack(ks), torch.stack(vs)


def paged_decode_step(params, cfg, state, tokens, cur_pos):
    """One decode step over paged prefix KV — the zero-copy serving path.

    ``state``:
      k_pages/v_pages [L, KV, N, page, Dh]  the device page pool (read-only)
      block_tables    [B, P] int32          per-request page ids
      prefix_len      [B] int32             tokens addressed via the table
      k_tail/v_tail   [L, B, T, KV, Dh]     in-flight tail (written here)
      tail_pos        [B, T] int32          absolute tail positions (-1 empty)
    tokens, cur_pos: [B] int32.  Returns (logits [B, V] f32, new state).

    The page pool is never rewritten: a step only appends one (k, v) row to
    the tail at ``cur_pos - prefix_len`` and attends pages + tail in place.
    The returned state holds new tail tensors; the input state is unchanged.
    """
    x = embed_tokens(params, cfg, tokens)[:, None, :]  # [B, 1, d]
    slot = cur_pos - state["prefix_len"]
    tail_pos = slot_update(state["tail_pos"][..., None], cur_pos[:, None, None], slot)[..., 0]
    ks, vs = [], []
    for i, lp in enumerate(layer_params(params["layers"], cfg.num_layers)):
        h = apply_norm(cfg.norm, lp["ln1"], x)
        a, ntk, ntv = attn_paged_decode_layer(
            lp["attn"], cfg, h, state["k_pages"][i], state["v_pages"][i],
            state["block_tables"], state["prefix_len"],
            state["k_tail"][i], state["v_tail"][i], tail_pos, cur_pos, slot,
        )
        x = x + a
        h = apply_norm(cfg.norm, lp["ln2"], x)
        x = x + _mlp_block(lp, cfg, h, per_row=True)[0]
        ks.append(ntk)
        vs.append(ntv)
    x = apply_norm(cfg.norm, params["final_norm"], x)
    logits = (x[:, 0] @ unembed(cfg, params)).float()
    new_state = dict(state, k_tail=torch.stack(ks), v_tail=torch.stack(vs), tail_pos=tail_pos)
    return logits, new_state

"""Model registry for the port: every served family's entry points behind
one bundle.

``build_model(cfg, device=None)`` returns a ``ModelBundle`` exposing:
  - init_params(generator)                         -> params on the device
  - loss_fn(params, batch)                         -> 0-d f32 training loss
    (the only entry point not run under ``torch.no_grad``: it follows the
    caller's grad mode)
  - prefill_fn(params, batch, cache_len)           -> (last logits, cache or state)
  - decode_fn(params, cache, tokens, cur_pos)      -> (logits, cache or state)
  - make_cache(batch, cache_len)                   -> empty cache or state on the
    device (the recurrent families also take ``device="meta"``: shapes only,
    which ``SnapshotEngine`` reads each leaf's batch axis from)
and, for the transformer families with a bf16 KV cache only (``None`` for
the recurrent and audio families and for ``kv_cache_dtype="int8"``, as in
the JAX registry: int8 blocks carry no scale sidecar, so an int8 engine
stays on the dense decode path):
  - prefill_collect_fn(params, batch)              -> (last-valid logits, k, v [L,B,S,KV,Dh])
  - paged_decode_fn(params, state, tokens, cur_pos) -> (logits, state)
  - prefill_chunk_fn(params, state, tokens, positions) -> (ck, cv) [L,B,C,KV,Dh]

Families: ``dense``, ``moe`` (grok-1-314b, arctic-480b) and ``vlm``
(phi-3-vision-4.2b), all three ``transformer``; ``hybrid`` (hymba-1.5b,
``hymba``) and ``ssm`` (xlstm-350m, ``xlstm``), served by
``SnapshotEngine``; ``audio`` (whisper-small, ``whisper``), whose
``prefill_fn`` takes ``{"frames", "tokens"}`` and which no engine serves,
as in the JAX package.  Families other than the transformer ignore
``kv_cache_dtype``.

``analytic_param_count`` is the reference's count (``MODEL_FLOPS = 6 * N *
D`` uses it; ``ModelConfig.param_count`` calls it).
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from functools import partial
from typing import Any, Callable, Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models import hymba as hymba_lib
from repro_torch.models import transformer as tf_lib
from repro_torch.models import whisper as whisper_lib
from repro_torch.models import xlstm as xlstm_lib


# ---------------------------------------------------------------------------
# analytic parameter counts (MODEL_FLOPS = 6 * N * D uses these)
# ---------------------------------------------------------------------------


def analytic_param_count(cfg: ModelConfig, active_only: bool = False) -> int:
    d, ff, V, L = cfg.d_model, cfg.d_ff, cfg.vocab_size, cfg.num_layers
    H, KV, Dh = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    embed = V * d * (1 if cfg.tie_embeddings else 2)

    if cfg.family == "ssm":  # xlstm
        per_m = 5 * d * d + 2 * d * cfg.num_heads  # q,k,v,g,o + i,f
        per_s = 5 * d * d + 4 * cfg.num_heads * (d // cfg.num_heads) ** 2
        G = L // (cfg.xlstm.mlstm_per_group + cfg.xlstm.slstm_per_group)
        return embed + G * (cfg.xlstm.mlstm_per_group * per_m + cfg.xlstm.slstm_per_group * per_s)

    attn = d * H * Dh + 2 * d * KV * Dh + H * Dh * d
    mlp_mats = 3 if cfg.activation == "silu" else 2
    dense_mlp = mlp_mats * d * ff

    if cfg.moe.num_experts:
        E, k = cfg.moe.num_experts, cfg.moe.experts_per_token
        experts = (k if active_only else E) * mlp_mats * d * ff
        per_layer = attn + experts + d * E
        if cfg.moe.dense_residual:
            per_layer += dense_mlp
    else:
        per_layer = attn + dense_mlp

    if cfg.family == "hybrid":
        di = cfg.ssm.expand * d
        dt_rank = cfg.ssm.dt_rank or max(1, math.ceil(d / 16))
        ssm = d * 2 * di + di * (dt_rank + 2 * cfg.ssm.state_dim) + dt_rank * di + di * d
        per_layer = attn + ssm + dense_mlp

    total = embed + L * per_layer
    if cfg.is_encoder_decoder:
        total += cfg.encoder_layers * (attn + dense_mlp)  # encoder stack
        total += L * (attn)  # decoder cross-attention
    return total


# ---------------------------------------------------------------------------
# bundle
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class ModelBundle:
    cfg: ModelConfig
    device: torch.device
    init_params: Callable[[torch.Generator], Any]
    loss_fn: Callable[..., torch.Tensor]
    prefill_fn: Callable[..., Any]
    decode_fn: Callable[..., Any]
    make_cache: Callable[..., Any]
    prefill_collect_fn: Optional[Callable[..., Any]] = None
    paged_decode_fn: Optional[Callable[..., Any]] = None
    prefill_chunk_fn: Optional[Callable[..., Any]] = None


def build_model(cfg: ModelConfig, device: DeviceLike = None) -> ModelBundle:
    """Bundle for ``cfg`` on ``device`` (CUDA unless the caller passes
    ``device="cpu"``).  Families the port does not serve raise."""
    tf_lib.check_supported(cfg)
    dev = resolve_device(device)
    if cfg.family == "ssm":  # xlstm
        return ModelBundle(
            cfg=cfg,
            device=dev,
            init_params=lambda generator: xlstm_lib.init_params(cfg, generator, dev),
            loss_fn=lambda params, batch: xlstm_lib.loss_fn(params, cfg, batch),
            prefill_fn=partial(_call, xlstm_lib.prefill, cfg),
            decode_fn=partial(_call, xlstm_lib.decode_step, cfg),
            make_cache=lambda batch, cache_len, device=dev: xlstm_lib.init_state(cfg, batch, device),
        )
    if cfg.family == "hybrid":  # hymba
        return ModelBundle(
            cfg=cfg,
            device=dev,
            init_params=lambda generator: hymba_lib.init_params(cfg, generator, dev),
            loss_fn=lambda params, batch: hymba_lib.loss_fn(params, cfg, batch),
            prefill_fn=partial(_call, hymba_lib.prefill, cfg),
            decode_fn=partial(_call, hymba_lib.decode_step, cfg),
            make_cache=lambda batch, cache_len, device=dev: hymba_lib.make_cache(
                cfg, batch, cache_len, device),
        )
    if cfg.family == "audio":  # whisper
        return ModelBundle(
            cfg=cfg,
            device=dev,
            init_params=lambda generator: whisper_lib.init_params(cfg, generator, dev),
            loss_fn=lambda params, batch: whisper_lib.loss_fn(params, cfg, batch),
            prefill_fn=partial(_call, whisper_lib.prefill, cfg),
            decode_fn=partial(_call, whisper_lib.decode_step, cfg),
            make_cache=lambda batch, cache_len: whisper_lib.make_cache(cfg, batch, cache_len, dev),
        )
    paged = {}
    if cfg.kv_cache_dtype != "int8":
        paged = dict(
            prefill_collect_fn=partial(_call, tf_lib.prefill_collect, cfg),
            paged_decode_fn=partial(_call, tf_lib.paged_decode_step, cfg),
            prefill_chunk_fn=partial(_call, tf_lib.prefill_chunk, cfg),
        )
    return ModelBundle(
        cfg=cfg,
        device=dev,
        init_params=lambda generator: tf_lib.init_params(cfg, generator, dev),
        loss_fn=lambda params, batch: tf_lib.loss_fn(params, cfg, batch),
        prefill_fn=partial(_call, tf_lib.prefill, cfg),
        decode_fn=partial(_call, tf_lib.decode_step, cfg),
        make_cache=lambda batch, cache_len: tf_lib.make_cache(cfg, batch, cache_len, device=dev),
        **paged,
    )


def _call(fn, cfg, params, *args):
    with torch.no_grad():
        return fn(params, cfg, *args)


"""Model registry for the port: every served family's entry points behind
one bundle.

``build_model(cfg, device=None, mesh=None, moe_strategy="auto")`` returns a
``ModelBundle`` exposing:
  - init_params(generator)                         -> params on the device
  - loss_fn(params, batch)                         -> 0-d f32 training loss
    (the only entry point not run under ``torch.no_grad``: it follows the
    caller's grad mode)
  - prefill_fn(params, batch, cache_len)           -> (last logits, cache or state)
  - decode_fn(params, cache, tokens, cur_pos)      -> (logits, cache or state)
  - make_cache(batch, cache_len)                   -> empty cache or state on the
    device (the recurrent families also take ``device="meta"``: shapes only,
    which ``SnapshotEngine`` reads each leaf's batch axis from)
  - param_shapes()                                 -> the parameter tree as meta
    tensors (shapes and dtypes, no memory)
  - batch_spec(shape) / cache_spec(shape)          -> a ``ShapeSpec`` cell's batch
    and cache (or state) as meta tensors, the reference's shapes and dtypes
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

With ``mesh`` (a ``DeviceMesh``), ``loss_fn``, ``prefill_fn`` and
``decode_fn`` run the sharded forms on DTensor arguments (``launch/steps.py``
builds and runs them), ``moe_strategy`` picking the MoE layers' strategy.
The paged entry points take no mesh, as the reference's sharded steps run
the dense prefill and decode only.

``analytic_param_count`` is the reference's count (``MODEL_FLOPS = 6 * N *
D`` uses it; ``ModelConfig.param_count`` calls it).
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from functools import partial
from typing import Any, Callable, Optional

import torch

from repro_torch.configs.base import ModelConfig, ShapeSpec
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
    param_shapes: Callable[[], Any]
    batch_spec: Callable[[ShapeSpec], Any]
    cache_spec: Callable[[ShapeSpec], Any]
    mesh: Any = None
    moe_strategy: str = "auto"
    prefill_collect_fn: Optional[Callable[..., Any]] = None
    paged_decode_fn: Optional[Callable[..., Any]] = None
    prefill_chunk_fn: Optional[Callable[..., Any]] = None
    mixed_step_fn: Optional[Callable[..., Any]] = None


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def _param_shapes(init_params):
    """``init_params``' tree as meta tensors: drawn under a fake-tensor mode
    (no memory, no numbers) from a CPU generator."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    with FakeTensorMode():
        fake = init_params(torch.Generator().manual_seed(0))

    def meta(tree):
        if isinstance(tree, dict):
            return {k: meta(v) for k, v in tree.items()}
        return _meta(tree.shape, tree.dtype)

    return meta(fake)


def build_model(cfg: ModelConfig, device: DeviceLike = None, mesh=None,
                moe_strategy: str = "auto") -> ModelBundle:
    """Bundle for ``cfg`` on ``device`` (CUDA unless the caller passes
    ``device="cpu"``).  Families the port does not serve raise.  ``mesh``
    makes ``loss_fn``, ``prefill_fn`` and ``decode_fn`` the sharded forms."""
    tf_lib.check_supported(cfg)
    dev = resolve_device(device)
    sharding = {} if mesh is None else {"mesh": mesh}
    if cfg.family == "ssm":  # xlstm
        lib = xlstm_lib
        make_cache = lambda batch, cache_len, device=dev: xlstm_lib.init_state(cfg, batch, device)
        cache_spec = lambda shape: xlstm_lib.init_state(cfg, shape.global_batch, "meta")
    elif cfg.family == "hybrid":  # hymba
        lib = hymba_lib
        make_cache = lambda batch, cache_len, device=dev: hymba_lib.make_cache(
            cfg, batch, cache_len, device)
        cache_spec = lambda shape: hymba_lib.make_cache(cfg, shape.global_batch, shape.seq_len,
                                                        "meta")
    elif cfg.family == "audio":  # whisper
        lib = whisper_lib
        make_cache = lambda batch, cache_len: whisper_lib.make_cache(cfg, batch, cache_len, dev)
        cache_spec = lambda shape: whisper_lib.make_cache(cfg, shape.global_batch, shape.seq_len,
                                                          "meta")
    else:  # dense / moe / vlm -> transformer
        lib = tf_lib
        if mesh is not None:
            sharding["moe_strategy"] = moe_strategy
        make_cache = lambda batch, cache_len: tf_lib.make_cache(cfg, batch, cache_len, device=dev)
        cache_spec = lambda shape: tf_lib.make_cache(cfg, shape.global_batch, shape.seq_len,
                                                     device="meta")
    paged = {}
    if lib is tf_lib and cfg.kv_cache_dtype != "int8":
        paged = dict(
            prefill_collect_fn=partial(_call, tf_lib.prefill_collect, cfg),
            paged_decode_fn=partial(_call, tf_lib.paged_decode_step, cfg),
            prefill_chunk_fn=partial(_call, tf_lib.prefill_chunk, cfg),
            mixed_step_fn=partial(_call, tf_lib.paged_mixed_step, cfg),
        )
    return ModelBundle(
        cfg=cfg,
        device=dev,
        init_params=lambda generator: lib.init_params(cfg, generator, dev),
        loss_fn=lambda params, batch: lib.loss_fn(params, cfg, batch, **sharding),
        prefill_fn=partial(_call, partial(lib.prefill, **sharding), cfg),
        decode_fn=partial(_call, partial(lib.decode_step, **sharding), cfg),
        make_cache=make_cache,
        param_shapes=lambda: _param_shapes(lambda g: lib.init_params(cfg, g, "cpu")),
        batch_spec=partial(batch_spec, cfg),
        cache_spec=cache_spec,
        mesh=mesh,
        moe_strategy=moe_strategy,
        **paged,
    )


def batch_spec(cfg: ModelConfig, shape: ShapeSpec):
    """A cell's batch as meta tensors: ``tokens`` [B, S] int32 ([B] for a
    decode cell), whisper's ``frames`` [B, S, d] with ``tokens`` [B,
    min(448, S)], phi-3-vision's ``patch_embeds`` [B, P, d] in bf16."""
    b = shape.global_batch
    if shape.kind == "decode":
        return {"tokens": _meta((b,), torch.int32)}
    if cfg.family == "audio":
        return {"frames": _meta((b, shape.seq_len, cfg.d_model), torch.bfloat16),
                "tokens": _meta((b, min(whisper_lib.DEC_LEN, shape.seq_len)), torch.int32)}
    out = {"tokens": _meta((b, shape.seq_len), torch.int32)}
    if cfg.family in ("dense", "moe", "vlm") and cfg.frontend == "image_patches":
        out["patch_embeds"] = _meta((b, cfg.frontend_len, cfg.d_model), torch.bfloat16)
    return out


def _call(fn, cfg, params, *args):
    with torch.no_grad():
        return fn(params, cfg, *args)


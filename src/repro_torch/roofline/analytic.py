"""Analytic FLOP / HBM-byte model per (arch x shape): the JAX package's
``roofline/analytic.py``, copied (pure Python over ``ModelConfig`` and
``ShapeSpec``; the numbers are the reference's to the last bit).

Why analytic: the dry run executes each step once on meta tensors, which
counts collectives but no FLOPs or bytes, and every model's math is known
by construction, so the roofline compute and memory terms use this
closed-form model.

Conventions: one MAC = 2 FLOPs; attention context for causal prefill is the
mean (S+1)/2 (capped by the sliding window); decode context is min(cache,
window).  Train total = 4x forward (fwd + 2x bwd + 1x full-remat recompute).
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict

from repro_torch.configs.base import ModelConfig, ShapeSpec

TRAIN_MULT = 4.0  # fwd + bwd(2x) + full-remat recompute(1x)


def _attn_ctx(cfg: ModelConfig, S: int, kind: str) -> float:
    w = cfg.sliding_window
    if kind == "decode":
        ctx = min(S, w) if w else S
    else:
        ctx = (S + 1) / 2 if not w else min(w, (S + 1) / 2)
    return float(ctx)


def _per_token_layer_flops(cfg: ModelConfig, ctx: float) -> float:
    d, ff = cfg.d_model, cfg.d_ff
    H, KV, Dh = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim

    proj = 2 * (d * H * Dh + 2 * d * KV * Dh + H * Dh * d)
    attn = 4 * H * Dh * ctx  # QK^T + PV
    mats = 3 if cfg.activation == "silu" else 2

    if cfg.family == "ssm":  # xlstm blocks (see models/xlstm.py)
        nh = cfg.num_heads
        dh = d // nh
        per_m = 2 * 5 * d * d + 2 * 2 * d * nh + 3 * nh * dh * dh + 4 * nh * dh
        per_s = 2 * 5 * d * d + 2 * 4 * nh * dh * dh + 12 * d
        G = cfg.xlstm.mlstm_per_group + cfg.xlstm.slstm_per_group
        return (cfg.xlstm.mlstm_per_group * per_m + cfg.xlstm.slstm_per_group * per_s) / G

    if cfg.moe.num_experts:
        E, k, cf = cfg.moe.num_experts, cfg.moe.experts_per_token, cfg.moe.capacity_factor
        mlp = 2 * d * E + 2 * mats * d * ff * k * cf
        if cfg.moe.dense_residual:
            mlp += 2 * mats * d * ff
    else:
        mlp = 2 * mats * d * ff

    total = proj + attn + mlp
    if cfg.family == "hybrid":
        di = cfg.ssm.expand * d
        dt_rank = cfg.ssm.dt_rank or max(1, math.ceil(d / 16))
        N = cfg.ssm.state_dim
        ssm = (
            2 * d * 2 * di
            + 2 * cfg.ssm.conv_kernel * di
            + 2 * di * (dt_rank + 2 * N)
            + 2 * dt_rank * di
            + 8 * di * N
            + 2 * di * d
        )
        total += ssm
    return total


def forward_flops(cfg: ModelConfig, shape: ShapeSpec) -> float:
    """Global forward FLOPs for one step of this cell."""
    B, S = shape.global_batch, shape.seq_len
    d, V, L = cfg.d_model, cfg.vocab_size, cfg.num_layers
    ctx = _attn_ctx(cfg, S, shape.kind)

    if cfg.is_encoder_decoder:  # whisper
        from repro_torch.models.whisper import DEC_LEN

        enc_ctx = (S + 1) / 2 if shape.kind != "decode" else 0
        per_tok_enc = _per_token_layer_flops(cfg, S if shape.kind != "decode" else 0)
        dec_len = min(DEC_LEN, S) if shape.kind != "decode" else 1
        Tc = cfg.cross_attend_len if shape.kind == "decode" else S
        H, KV, Dh = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
        cross = 2 * (d * H * Dh + H * Dh * d) + 4 * H * Dh * Tc  # q,o proj + attend
        dec_ctx = _attn_ctx(cfg, S if shape.kind == "decode" else dec_len, shape.kind)
        per_tok_dec = _per_token_layer_flops(cfg, dec_ctx) + cross
        flops = 0.0
        if shape.kind != "decode":
            flops += B * S * cfg.encoder_layers * per_tok_enc
            # cross K/V computed once per encoder state per decoder layer
            flops += B * S * L * 2 * 2 * d * KV * Dh
            flops += B * dec_len * L * per_tok_dec
            head_tokens = B * dec_len if shape.kind == "train" else B
        else:
            flops += B * 1 * L * per_tok_dec
            head_tokens = B
        flops += head_tokens * 2 * d * V
        return flops

    tokens = B * (1 if shape.kind == "decode" else S)
    if cfg.frontend == "image_patches" and shape.kind != "decode":
        tokens += B * cfg.frontend_len
    flops = tokens * L * _per_token_layer_flops(cfg, ctx)
    head_tokens = tokens if shape.kind == "train" else B
    flops += head_tokens * 2 * d * V
    return flops


def cell_flops(cfg: ModelConfig, shape: ShapeSpec) -> Dict[str, float]:
    fwd = forward_flops(cfg, shape)
    total = fwd * (TRAIN_MULT if shape.kind == "train" else 1.0)
    return {"forward": fwd, "total": total}


# ---------------------------------------------------------------------------
# HBM bytes
# ---------------------------------------------------------------------------


def param_bytes(cfg: ModelConfig, dtype_bytes: int = 2) -> float:
    return float(cfg.param_count() * dtype_bytes)


def cache_bytes(cfg: ModelConfig, shape: ShapeSpec) -> float:
    B, S = shape.global_batch, shape.seq_len
    L, KV, Dh = cfg.num_layers, cfg.num_kv_heads, cfg.resolved_head_dim
    if cfg.family == "ssm":
        d = cfg.d_model
        nh = cfg.num_heads
        dh = d // nh
        per_m = (nh * dh * dh + nh * dh + nh) * 4
        per_s = 4 * d * 4
        G = cfg.xlstm.mlstm_per_group + cfg.xlstm.slstm_per_group
        per_layer = (cfg.xlstm.mlstm_per_group * per_m + cfg.xlstm.slstm_per_group * per_s) / G
        return B * cfg.num_layers * per_layer
    Sc = min(S, cfg.sliding_window) if cfg.sliding_window else S
    kv_bytes = 1.0 + 1.0 / cfg.resolved_head_dim if cfg.kv_cache_dtype == "int8" else 2.0
    kv = L * B * Sc * KV * Dh * kv_bytes * 2  # k+v
    if cfg.family == "hybrid":
        di = cfg.ssm.expand * cfg.d_model
        kv += L * B * di * cfg.ssm.state_dim * 4
    if cfg.is_encoder_decoder:
        kv += L * B * cfg.cross_attend_len * KV * Dh * 2 * 2
    return float(kv)


def cell_hbm_bytes(cfg: ModelConfig, shape: ShapeSpec, chips: int) -> Dict[str, float]:
    """Global HBM traffic for one step (activation factor alpha=6 covers
    norm/attention/MLP intermediates per layer)."""
    B, S = shape.global_batch, shape.seq_len
    d, L = cfg.d_model, cfg.num_layers
    tokens = B * (1 if shape.kind == "decode" else S)
    alpha = 6.0

    p_active = float(cfg.active_param_count() if cfg.moe.num_experts else cfg.param_count())
    weights = p_active * 2  # bf16 read once forward
    # MoE: the non-active experts are still *read* by their owning chips
    if cfg.moe.num_experts:
        weights = float(cfg.param_count()) * 2

    acts = tokens * d * L * 2 * alpha
    cache = cache_bytes(cfg, shape)

    if shape.kind == "train":
        p_full = float(cfg.param_count())
        opt = p_full * (4 + 4 + 4)  # fp32 master rw + m + v traffic
        total = weights * 2 + acts * (TRAIN_MULT / 2) + opt + p_full * 4  # + grads
    elif shape.kind == "prefill":
        total = weights + acts + cache  # cache written once
    else:
        total = weights + acts + cache  # cache read per token
    return {
        "total": float(total),
        "weights": float(weights),
        "activations": float(acts),
        "cache": float(cache),
        "per_device": float(total) / chips,
    }

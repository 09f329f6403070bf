"""Model configuration for the port: ``ModelConfig``, the input shapes
(``ShapeSpec``) and ``reduced()``.

The same dataclasses and field names as the JAX package's
``configs/base.py``, so a config built on either side describes the same
model, and the same analytic parameter counts (``param_count``,
``active_param_count``: ``models/registry.analytic_param_count``).
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Tuple

# ---------------------------------------------------------------------------
# Model configuration
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class MoEConfig:
    num_experts: int = 0
    experts_per_token: int = 0
    capacity_factor: float = 1.25
    # Snowflake-Arctic style dense residual MLP that runs in parallel with the
    # MoE experts on every token.
    dense_residual: bool = False
    router_jitter: float = 0.0


@dataclass(frozen=True)
class SSMConfig:
    """Mamba-style selective SSM settings (hymba / hybrid archs)."""

    state_dim: int = 16
    conv_kernel: int = 4
    expand: int = 2
    dt_rank: int = 0  # 0 -> ceil(d_model / 16)


@dataclass(frozen=True)
class XLSTMConfig:
    """xLSTM block-stack settings (Beck et al., arXiv:2405.04517).

    The 350M config is the xLSTM[7:1] stack: groups of (7 mLSTM + 1 sLSTM)
    blocks.  Grouping keeps ``jax.lax.scan`` over groups uniform.
    """

    mlstm_per_group: int = 7
    slstm_per_group: int = 1
    chunk_size: int = 256  # chunkwise-parallel mLSTM chunk length
    proj_factor: float = 2.0  # up-projection factor inside mLSTM blocks


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str  # dense | moe | ssm | hybrid | audio | vlm
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0  # 0 -> d_model // num_heads

    # --- attention options -------------------------------------------------
    qk_norm: bool = False
    sliding_window: int = 0  # 0 -> full attention
    rope_theta: float = 10000.0
    attn_logit_softcap: float = 0.0  # grok-style tanh soft-capping

    # --- sub-configs ---------------------------------------------------------
    moe: MoEConfig = field(default_factory=MoEConfig)
    ssm: SSMConfig = field(default_factory=SSMConfig)
    xlstm: XLSTMConfig = field(default_factory=XLSTMConfig)

    # --- encoder/decoder (whisper) ------------------------------------------
    encoder_layers: int = 0
    is_encoder_decoder: bool = False
    # length of the encoder output consumed by cross attention during decode
    cross_attend_len: int = 1500

    # --- modality frontend stubs ---------------------------------------------
    # "none" | "audio_frames" | "image_patches".  Frontends are STUBS per the
    # assignment: input_specs() supplies precomputed frame/patch embeddings.
    frontend: str = "none"
    frontend_len: int = 0  # patches/frames prepended to the token stream

    # --- norms / activations --------------------------------------------------
    norm: str = "rmsnorm"  # rmsnorm | layernorm
    activation: str = "silu"  # silu (SwiGLU) | gelu
    tie_embeddings: bool = False

    # --- serving options --------------------------------------------------------
    # "bf16" | "int8": int8 halves decode KV-cache bandwidth + capacity
    # (per-token absmax scales over head_dim; EXPERIMENTS.md §Perf cell 3)
    kv_cache_dtype: str = "bf16"

    dtype: str = "bfloat16"

    # ------------------------------------------------------------------
    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.d_model // self.num_heads

    @property
    def q_per_kv(self) -> int:
        return self.num_heads // self.num_kv_heads

    @property
    def is_attention_free(self) -> bool:
        return self.family == "ssm"

    @property
    def is_subquadratic(self) -> bool:
        """True when the arch can serve a 500k-token context.

        Recurrent (xLSTM / SSM), hybrid (bounded attention window + state) and
        sliding-window-attention models qualify; pure full-attention models do
        not (their long_500k cell is skipped, see DESIGN.md).
        """
        if self.family in ("ssm", "hybrid"):
            return True
        return self.sliding_window > 0

    @property
    def has_decoder(self) -> bool:
        return True  # every assigned arch has an autoregressive decoder

    def param_count(self) -> int:
        """Analytic parameter count (used for MODEL_FLOPS = 6*N*D)."""
        from repro_torch.models.registry import analytic_param_count

        return analytic_param_count(self)

    def active_param_count(self) -> int:
        """Parameters active per token (MoE: top-k experts only)."""
        from repro_torch.models.registry import analytic_param_count

        return analytic_param_count(self, active_only=True)

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)


# ---------------------------------------------------------------------------
# Input-shape configuration
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"

    @property
    def tokens_per_step(self) -> int:
        if self.kind == "decode":
            return self.global_batch  # one new token per sequence
        return self.seq_len * self.global_batch


TRAIN_4K = ShapeSpec("train_4k", seq_len=4096, global_batch=256, kind="train")
PREFILL_32K = ShapeSpec("prefill_32k", seq_len=32768, global_batch=32, kind="prefill")
DECODE_32K = ShapeSpec("decode_32k", seq_len=32768, global_batch=128, kind="decode")
LONG_500K = ShapeSpec("long_500k", seq_len=524288, global_batch=1, kind="decode")

ALL_SHAPES: Tuple[ShapeSpec, ...] = (TRAIN_4K, PREFILL_32K, DECODE_32K, LONG_500K)
SHAPES_BY_NAME = {s.name: s for s in ALL_SHAPES}


def shape_applicable(cfg: ModelConfig, shape: ShapeSpec) -> Tuple[bool, str]:
    """Whether a (arch x shape) cell is runnable, and why not if skipped."""
    if shape.name == "long_500k" and not cfg.is_subquadratic:
        return False, "pure full-attention arch: 500k dense KV decode skipped (DESIGN.md)"
    return True, ""


# ---------------------------------------------------------------------------
# Reduced configs for CPU smoke tests
# ---------------------------------------------------------------------------


def reduced(cfg: ModelConfig) -> ModelConfig:
    """A tiny same-family config for single-CPU smoke tests."""
    kw = dict(
        num_layers=2,
        d_model=64,
        num_heads=4,
        num_kv_heads=max(1, min(cfg.num_kv_heads, 2)),
        head_dim=16,
        d_ff=128 if cfg.d_ff else 0,
        # Small vocab ON PURPOSE: greedy argmax over V iid random-init logits
        # has a top-2 gap ~ sigma/V; at V=256 that gap (~1e-3) is inside
        # XLA:CPU's cross-compilation float jitter, which made every
        # token-parity test (batched-vs-sequential, restored-vs-cold)
        # co-location-flaky.  V=64 widens the gap ~4x past the jitter.
        # Test token ids above V deliberately clip in the embedding gather.
        vocab_size=64,
        sliding_window=min(cfg.sliding_window, 16) if cfg.sliding_window else 0,
        cross_attend_len=8,
        frontend_len=4 if cfg.frontend != "none" else 0,
    )
    if cfg.moe.num_experts:
        kw["moe"] = dataclasses.replace(cfg.moe, num_experts=4, experts_per_token=2)
    if cfg.family in ("ssm", "hybrid"):
        kw["ssm"] = dataclasses.replace(cfg.ssm, state_dim=8, expand=2)
    if cfg.family == "hybrid":
        # Wider heads for the reduced hybrid: with 4x16 heads the random-init
        # top-2 logit gap (~5e-3) sits at the prefill-vs-decode bf16
        # divergence (~5e-3), making restored-vs-cold greedy parity a coin
        # flip under cross-compilation jitter; 2x32 heads re-rolls the
        # margin to ~6x (measured on the snapshot parity workload).
        kw.update(num_heads=2, num_kv_heads=1, head_dim=32)
    if cfg.family == "ssm":  # xlstm
        kw["xlstm"] = dataclasses.replace(cfg.xlstm, mlstm_per_group=1, slstm_per_group=1, chunk_size=8)
        kw["num_layers"] = 2  # one group of (1 mLSTM + 1 sLSTM)
    if cfg.is_encoder_decoder:
        kw["encoder_layers"] = 2
    return cfg.replace(**kw)

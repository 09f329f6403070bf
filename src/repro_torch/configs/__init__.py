"""Model configs the port serves.

The dense transformer family: qwen3-1.7b is the first served model;
h2o-danube-1.8b carries the sliding-window attention path; stablelm-12b
carries head_dim 160 (G = 4) and deepseek-7b multi-head attention (G = 1).
The mixture-of-experts family: grok-1-314b (8 experts, top-2, tanh
soft-capped attention logits) and arctic-480b (128 experts, top-2, a dense
residual MLP beside them).  The VLM family: phi-3-vision-4.2b (head_dim 96,
576 stub patch embeddings prepended at prefill).  The recurrent families,
served through ``SnapshotEngine``: hymba-1.5b (the hybrid: windowed
attention beside a selective SSM in every layer) and xlstm-350m (mLSTM and
sLSTM blocks, no attention).  The audio family: whisper-small (an encoder-
decoder over 1500 stub frame embeddings, cross attention, sinusoidal
positions), driven through its bundle's ``prefill_fn``/``decode_fn``.
``get_config`` raises for every other name.
"""
from __future__ import annotations

from repro_torch.configs.base import (
    ALL_SHAPES,
    DECODE_32K,
    LONG_500K,
    PREFILL_32K,
    SHAPES_BY_NAME,
    TRAIN_4K,
    ModelConfig,
    MoEConfig,
    ShapeSpec,
    SSMConfig,
    XLSTMConfig,
    reduced,
    shape_applicable,
)
from repro_torch.configs.arctic_480b import CONFIG as ARCTIC_480B
from repro_torch.configs.deepseek_7b import CONFIG as DEEPSEEK_7B
from repro_torch.configs.grok_1_314b import CONFIG as GROK_1_314B
from repro_torch.configs.h2o_danube_1_8b import CONFIG as H2O_DANUBE_1_8B
from repro_torch.configs.hymba_1_5b import CONFIG as HYMBA_1_5B
from repro_torch.configs.phi_3_vision_4_2b import CONFIG as PHI_3_VISION_4_2B
from repro_torch.configs.qwen3_1_7b import CONFIG as QWEN3_1_7B
from repro_torch.configs.stablelm_12b import CONFIG as STABLELM_12B
from repro_torch.configs.whisper_small import CONFIG as WHISPER_SMALL
from repro_torch.configs.xlstm_350m import CONFIG as XLSTM_350M

ARCHITECTURES = {
    c.name: c
    for c in (
        QWEN3_1_7B, H2O_DANUBE_1_8B, STABLELM_12B, DEEPSEEK_7B, GROK_1_314B, ARCTIC_480B,
        PHI_3_VISION_4_2B, HYMBA_1_5B, XLSTM_350M, WHISPER_SMALL,
    )
}


def get_config(name: str) -> ModelConfig:
    if name not in ARCHITECTURES:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(ARCHITECTURES)}")
    return ARCHITECTURES[name]


__all__ = [
    "ALL_SHAPES",
    "ARCHITECTURES",
    "DECODE_32K",
    "LONG_500K",
    "PREFILL_32K",
    "SHAPES_BY_NAME",
    "TRAIN_4K",
    "ModelConfig",
    "MoEConfig",
    "ShapeSpec",
    "SSMConfig",
    "XLSTMConfig",
    "get_config",
    "reduced",
    "shape_applicable",
]

"""arctic-480b — 128-expert top-2 MoE + dense residual [hf:Snowflake/snowflake-arctic-base; hf].

35L d_model=7168 56H (GQA kv=8) d_ff=4864 vocab=32000, MoE 128e top-2 with a
dense residual MLP running in parallel with the experts (dense-MoE hybrid).
"""
from repro_torch.configs.base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="arctic-480b",
    family="moe",
    num_layers=35,
    d_model=7168,
    num_heads=56,
    num_kv_heads=8,
    d_ff=4864,
    vocab_size=32000,
    head_dim=128,
    moe=MoEConfig(num_experts=128, experts_per_token=2, capacity_factor=1.25, dense_residual=True),
)

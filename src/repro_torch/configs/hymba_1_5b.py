"""hymba-1.5b — parallel attention + mamba heads [arXiv:2411.13676; hf].

32L d_model=1600 25H (GQA kv=5) d_ff=5504 vocab=32001, ssm_state=16.
Each layer runs a sliding-window attention path and a selective-SSM path in
parallel and fuses them (mean of the two paths' outputs).  The serving cache
is the pair (attention ring KV, SSM state), which ``SnapshotEngine`` claims
as one recurrent-state snapshot.
"""
from repro_torch.configs.base import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="hymba-1.5b",
    family="hybrid",
    num_layers=32,
    d_model=1600,
    num_heads=25,
    num_kv_heads=5,
    d_ff=5504,
    vocab_size=32001,
    head_dim=64,
    sliding_window=1024,
    ssm=SSMConfig(state_dim=16, conv_kernel=4, expand=2),
)

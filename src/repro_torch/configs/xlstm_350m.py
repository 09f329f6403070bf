"""xlstm-350m — sLSTM + mLSTM block stack [arXiv:2405.04517; unverified].

24L d_model=1024 4H (GQA kv=4) d_ff=0 vocab=50304.  d_ff=0: xLSTM blocks carry
their own up/down projections instead of a separate FFN.  Stacked as
xLSTM[7:1]: groups of 7 mLSTM + 1 sLSTM blocks (24 layers = 3 groups).
"""
from repro_torch.configs.base import ModelConfig, XLSTMConfig

CONFIG = ModelConfig(
    name="xlstm-350m",
    family="ssm",
    num_layers=24,
    d_model=1024,
    num_heads=4,
    num_kv_heads=4,
    d_ff=0,
    vocab_size=50304,
    head_dim=256,
    xlstm=XLSTMConfig(mlstm_per_group=7, slstm_per_group=1, chunk_size=256, proj_factor=2.0),
    norm="layernorm",
    tie_embeddings=True,
)

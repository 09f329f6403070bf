"""whisper-small — enc-dec, conv frontend (stub) [arXiv:2212.04356; unverified].

12+12L d_model=768 12H (kv=12) head_dim=64 d_ff=3072 vocab=51865.  The conv
audio frontend is a STUB: the caller supplies precomputed frame embeddings
[B, frames, d].  The encoder runs over the frames, the decoder over the
tokens with cross attention to ``cross_attend_len`` encoder states.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="whisper-small",
    family="audio",
    num_layers=12,
    d_model=768,
    num_heads=12,
    num_kv_heads=12,
    d_ff=3072,
    vocab_size=51865,
    head_dim=64,
    encoder_layers=12,
    is_encoder_decoder=True,
    cross_attend_len=1500,
    frontend="audio_frames",
    frontend_len=1500,
    norm="layernorm",
    activation="gelu",
)

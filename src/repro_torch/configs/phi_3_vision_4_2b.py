"""phi-3-vision-4.2b — phi3-mini backbone + CLIP frontend (stub)
[hf:microsoft/Phi-3-vision-128k-instruct; hf].

32L d_model=3072 32H (GQA kv=32) d_ff=8192 vocab=32064.  The CLIP image tower
is a stub: callers hand ``prefill`` precomputed patch embeddings
(``batch["patch_embeds"]``), which are prepended to the token stream.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="phi-3-vision-4.2b",
    family="vlm",
    num_layers=32,
    d_model=3072,
    num_heads=32,
    num_kv_heads=32,
    d_ff=8192,
    vocab_size=32064,
    head_dim=96,
    frontend="image_patches",
    frontend_len=576,  # one 336px CLIP tile -> 576 patch embeddings
)

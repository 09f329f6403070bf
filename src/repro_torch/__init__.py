"""PyTorch/CUDA port of the claim-native paged serving path.

Beside the JAX package ``repro`` (the reference), this package serves
requests under ResidentClaims through the paged, chunked, prefix-sharing
step loop, with hand-written CUDA kernels for paged decode attention,
chunked paged prefill attention and the batched KV block copy
(``repro_torch.kernels``).  It imports nothing from ``repro`` and no JAX.
"""

"""PyTorch/CUDA port of the claim-native paged serving path.

Beside the JAX package ``repro`` (the reference), this package serves
requests under ResidentClaims through the paged, chunked, prefix-sharing
step loop, with hand-written CUDA kernels for paged decode attention,
chunked paged prefill attention and the batched KV block copy
(``repro_torch.kernels``), and judges its own traces: the fail-closed
lowering checker and descriptors (``core.lowering``, ``core.checker``), the
event-order analyzer (``core.analyzer``), Perfetto tracing
(``serving.tracing``) and the native descriptor generated from its
conformance scenarios (``core.native_descriptor``).  It imports nothing
from ``repro`` and no JAX.
"""

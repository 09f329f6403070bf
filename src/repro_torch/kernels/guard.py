"""The kernels have no backward: every wrapper refuses an input that
requires grad.

The CUDA kernels return tensors written through ctypes, with no
``grad_fn``: a training forward that reached one would leave the weights
before it without their share of the gradient and raise nothing.  So each
wrapper calls ``refuse_grad`` first, on either device (the plain version
would differentiate on the CPU, and the two devices must fail alike).  The
training path never needs a kernel: it runs the plain attention under
rematerialization (``models/layers.py``, ``remat=True``), as the JAX
package's training forward runs no Pallas kernel.  The serving paths run
under ``torch.no_grad`` and never trip it.
"""
from __future__ import annotations

import torch


def refuse_grad(name: str, *tensors) -> None:
    """Raise ``RuntimeError`` when grad is enabled and any tensor among
    ``tensors`` requires it (non-tensors are skipped)."""
    if not torch.is_grad_enabled():
        return
    if any(isinstance(t, torch.Tensor) and t.requires_grad for t in tensors):
        raise RuntimeError(
            f"{name}: the kernel has no backward, and an input requires grad "
            "(train through the plain attention: remat=True)"
        )

"""Parameter trees as torch tensors: the bridge from numpy pytrees.

``params_from_jax`` takes the JAX package's parameter pytree after it was
turned into numpy (``jax.tree.map(np.asarray, params)``) and returns the
same nested dict of torch tensors.  bfloat16 leaves arrive as numpy arrays
of the ``ml_dtypes`` bfloat16 type, which torch cannot read directly: they
are reinterpreted bit for bit through ``uint16``.  Nothing here imports
``ml_dtypes``; the dtype is recognised by name.
"""
from __future__ import annotations

from typing import Any, Mapping

import numpy as np
import torch

from repro_torch.device import DeviceLike, resolve_device


def tensor_from_numpy(a: np.ndarray, device: DeviceLike = None) -> torch.Tensor:
    """One numpy leaf -> torch tensor with the same bytes (bf16 included)."""
    a = np.ascontiguousarray(a)
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16)
    else:
        t = torch.from_numpy(a.copy())
    return t.to(resolve_device(device))


def params_from_jax(tree: Any, device: DeviceLike = None) -> Any:
    """Nested dict of numpy leaves -> the same nesting of torch tensors."""
    if isinstance(tree, Mapping):
        return {k: params_from_jax(v, device) for k, v in tree.items()}
    return tensor_from_numpy(np.asarray(tree), device)

"""The port's one device rule: CUDA unless the caller asks for the CPU.

Every entry point (``ServingEngine``, ``build_model``, ``init_params``)
takes ``device=``.  ``None`` means the card; a machine without one raises
instead of quietly running the plain PyTorch versions on the host.  The
CPU runs only when the caller names it (the CPU test suite does).
"""
from __future__ import annotations

from typing import Optional, Union

import torch

DeviceLike = Optional[Union[str, torch.device]]


def resolve_device(device: DeviceLike = None, *, allow_meta: bool = False) -> torch.device:
    """``None`` -> ``cuda`` (raises without a card); otherwise the named
    device.  ``allow_meta`` lets a function that only makes shapes (a state
    or cache built to read its shapes) take ``"meta"``, which holds no memory."""
    dev = torch.device("cuda" if device is None else device)
    if allow_meta and dev.type == "meta":
        return dev
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: the port runs on the GPU unless device='cpu' is passed"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev

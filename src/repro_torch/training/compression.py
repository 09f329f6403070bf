"""Gradient compression: blockwise-int8 quantization with error feedback
(the JAX package's ``training/compression.py`` in PyTorch).

Quantization rounds half to even, as ``jnp.round`` does, so the int8
values and scales equal the reference's bit for bit.  Error feedback
carries the quantization residual into the next step's gradient, so the
bias does not accumulate.  ``compressed_psum`` (the int8 all-gather across
pods) waits for the port's distribution module.
"""
from __future__ import annotations

import math
from typing import Tuple

import torch
import torch.nn.functional as F

from repro_torch.training.tree import map_tree

CBLOCK = 256


def quantize(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (any shape) -> (int8 values [blocks, 256], f32 scales [blocks])."""
    flat = x.float().reshape(-1)
    flat = F.pad(flat, (0, (-flat.shape[0]) % CBLOCK))
    blocks = flat.reshape(-1, CBLOCK)
    scale = blocks.abs().amax(dim=-1, keepdim=True) / 127.0
    q = torch.round(blocks / torch.clamp(scale, min=1e-12)).to(torch.int8)
    return q, scale[:, 0]


def dequantize(q: torch.Tensor, scale: torch.Tensor, shape) -> torch.Tensor:
    flat = (q.float() * scale[:, None]).reshape(-1)
    return flat[: math.prod(shape)].reshape(shape)


def compress_roundtrip(x: torch.Tensor) -> torch.Tensor:
    q, s = quantize(x)
    return dequantize(q, s, x.shape)


class ErrorFeedback:
    """Carry the quantization residual into the next step's gradient."""

    @staticmethod
    def init(grads):
        return map_tree(lambda g: torch.zeros_like(g, dtype=torch.float32), grads)

    @staticmethod
    def apply(grads, residual):
        """Returns (compressed-corrected grads, new residual)."""

        def one(g, r):
            corrected = g.float() + r
            sent = compress_roundtrip(corrected)
            return sent.to(g.dtype), corrected - sent

        pairs = map_tree(one, grads, residual)
        return (map_tree(lambda g, t: t[0], grads, pairs),
                map_tree(lambda g, t: t[1], grads, pairs))

"""Gradient compression: blockwise-int8 quantization with error feedback
(the JAX package's ``training/compression.py`` in PyTorch).

Quantization rounds half to even, as ``jnp.round`` does, so the int8
values and scales equal the reference's bit for bit.  Error feedback
carries the quantization residual into the next step's gradient, so the
bias does not accumulate.  ``compressed_psum`` sums a tensor over a
process group at about a quarter of bf16's bytes: an int8 all-gather and an
f32 scale all-gather, then each rank dequantizes and sums the shards in
rank order, the reference's arithmetic.
"""
from __future__ import annotations

import math
from typing import TYPE_CHECKING, Tuple

import torch
import torch.nn.functional as F

from repro_torch.training.tree import map_tree

if TYPE_CHECKING:
    from torch.distributed import ProcessGroup

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


def compressed_psum(x: torch.Tensor, group: "ProcessGroup") -> torch.Tensor:
    """int8 all-gather + local dequant-sum == psum at ~0.25x the bf16 bytes.

    Per-shard scales make a direct int8 all-reduce ill-defined, so every
    rank gathers each rank's (int8 values, f32 scales) pair and sums the
    dequantized shards itself, in rank order (the reference's
    ``compressed_psum`` inside ``shard_map`` over ``axis_name``).  ``group``
    is the process group of the mesh axis (``mesh.get_group(axis)``).  On a
    one-rank group the result is ``compress_roundtrip(x)`` bit for bit."""
    from torch.distributed import _functional_collectives as funcol

    q, s = quantize(x)
    n = torch.distributed.get_world_size(group)
    qg = funcol.all_gather_tensor(q, 0, group).reshape(n, *q.shape)  # [n, blocks, 256] int8
    sg = funcol.all_gather_tensor(s, 0, group).reshape(n, *s.shape)  # [n, blocks] f32
    total = qg[0].float() * sg[0][:, None]
    for r in range(1, n):
        total = total + qg[r].float() * sg[r][:, None]
    return total.reshape(-1)[: math.prod(x.shape)].reshape(x.shape).to(x.dtype)


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

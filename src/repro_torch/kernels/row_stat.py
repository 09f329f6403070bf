"""Row statistics of the norms in one fixed order: a hand-written CUDA
kernel (``csrc/row_stat.cu``) and its plain PyTorch version.

``row_stat(x, stat)`` reduces the last dim of an f32 tensor to its mean
(``"mean"``), mean of squares (``"mean_square"``, the RMS norm's
statistic) or population variance (``"var"``, the layer norm's), shape
``[..., 1]``.  It replaces no TPU kernel: the reference's ``rms_norm`` and
``layer_norm`` reduce with ``jnp.mean`` / ``jnp.var``.  It exists for the
bits contract of the serving path: a library reduction on the card takes
another order for a row when fewer rows ride with it, so a warm turn,
whose continuation tokens run through decode steps of a few rows, left
the bits of the cold prefill that normed the same rows in a chunk of
hundreds (qwen3-1.7b at 32,768 tokens: layer 8's key at one fed position,
then the logits by 0.047).  The kernel reduces each row in one warp in
one order, whatever the number of rows, so a row's statistic has one set
of bits on every route.  It is bound by bytes: each element read once.

Dispatch: an input that requires grad raises on either device
(``guard.refuse_grad``: no backward; training keeps the plain reduction,
see ``models.layers``); a CPU tensor goes to the plain version; a CUDA
tensor goes to the kernel (f32 only; a non-contiguous input is copied
contiguous first), and anything else raises.  ``row_stat.launches``
counts kernel launches.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.kernels.guard import refuse_grad

STATS = {"mean": 0, "mean_square": 1, "var": 2}


def _lib() -> ctypes.CDLL:
    lib = build.load("row_stat")
    fn = lib.row_stat_forward
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64, ctypes.c_int,
                       ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return lib


def row_stat_ref(x: torch.Tensor, stat: str) -> torch.Tensor:
    """The plain version: ``torch.mean`` / ``torch.var`` over the last dim."""
    if stat == "mean":
        return torch.mean(x, dim=-1, keepdim=True)
    if stat == "mean_square":
        return torch.mean(x * x, dim=-1, keepdim=True)
    if stat == "var":
        return torch.var(x, dim=-1, keepdim=True, unbiased=False)
    raise ValueError(f"row_stat: unknown statistic {stat!r}")


def row_stat(x: torch.Tensor, stat: str) -> torch.Tensor:
    """``stat`` of each row of ``x`` [..., d] -> [..., 1] f32."""
    refuse_grad("row_stat", x)
    if stat not in STATS:
        raise ValueError(f"row_stat: unknown statistic {stat!r}")
    if x.device.type == "cpu":
        return row_stat_ref(x, stat)
    if x.device.type != "cuda":
        raise ValueError(f"row_stat: unsupported device {x.device}")
    if x.dtype != torch.float32:
        raise TypeError(f"row_stat: dtype {x.dtype} not supported (float32)")
    d = x.shape[-1]
    out = torch.empty(x.shape[:-1] + (1,), dtype=torch.float32, device=x.device)
    R = out.numel()
    if R == 0:
        return out
    if d == 0:
        raise ValueError("row_stat: rows of width 0 have no statistic")
    x = x.contiguous()
    rc = build.launch(_lib().row_stat_forward, x.device, x.data_ptr(), out.data_ptr(), R, d,
                      STATS[stat])
    if rc != 0:
        raise RuntimeError(f"row_stat: kernel launch failed (CUDA error {rc})")
    row_stat.launches += 1
    return out


row_stat.launches = 0

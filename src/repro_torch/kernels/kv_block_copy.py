"""Batched KV page gather for claim offload and restore: a hand-written CUDA
kernel (``csrc/kv_block_copy.cu``) and its plain PyTorch version.

``kv_block_copy`` replaces the TPU kernel
``kernels/kv_block_copy.py:kv_block_copy_pallas`` (dst[m] = src[idx[m]] for
whole pages).  Every offload and restore job moves its block payloads
through ``gather_payloads``: two launches (k and v) per job.  It is bound by
bytes — each byte is read once and written once with no arithmetic — so the
kernel copies 16-byte vectors and spreads every page over a row of CTAs.

Dispatch: a source that requires grad raises on either device
(``guard.refuse_grad``: the kernel has no backward); a CPU tensor goes to
the plain version (``index_select``); a CUDA tensor goes to the kernel, and
anything the kernel does not take raises.
``kv_block_copy.launches`` counts kernel launches.  ``gather_payloads``
takes the per-array copy only for payloads whose shapes cannot form one
uniform page layout — a choice made from the shapes before any launch and
counted in ``gather_payloads.plain_copies``; a kernel error propagates.
"""
from __future__ import annotations

import ctypes
import math
from typing import List, Sequence

import torch

from repro_torch.device import DeviceLike, resolve_device
from repro_torch.kernels import build
from repro_torch.kernels.guard import refuse_grad


def _lib() -> ctypes.CDLL:
    lib = build.load("kv_block_copy")
    fn = lib.kv_block_copy
    if fn.argtypes is None:
        fn.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_int64, ctypes.c_int, ctypes.c_void_p,
        ]
        fn.restype = ctypes.c_int
    return lib


def kv_block_copy_ref(src_pages: torch.Tensor, indices: torch.Tensor) -> torch.Tensor:
    """Plain version: src_pages [N, ...] gathered by indices [M] -> [M, ...]."""
    return src_pages.index_select(0, indices.to(src_pages.device).long())


def kv_block_copy(src_pages: torch.Tensor, indices) -> torch.Tensor:
    """Gather pages: dst[m] = src[indices[m]].

    src_pages: [N, page, KV, D] (any trailing shape; f32, bf16, int32 — the
    kernel copies bytes); indices: [M] host ints (a CUDA tensor raises),
    validated against N on the host before the launch -> [M, page, KV, D].
    """
    refuse_grad("kv_block_copy", src_pages)
    if src_pages.device.type == "cpu":
        return kv_block_copy_ref(src_pages, torch.as_tensor(indices))
    if src_pages.device.type != "cuda":
        raise ValueError(f"kv_block_copy: unsupported device {src_pages.device}")
    if not src_pages.is_contiguous():
        raise ValueError("kv_block_copy: source pages must be contiguous")
    idx = torch.as_tensor(indices)
    if idx.device.type != "cpu":  # reading device indices back would wait for the card
        raise ValueError("kv_block_copy: indices must be host ints (a CPU tensor or a sequence)")
    idx = idx.to(torch.int32).contiguous()
    if idx.dim() != 1:
        raise ValueError("kv_block_copy: indices must be one-dimensional")
    N = src_pages.shape[0]
    # lint: allow[device-path-purity] idx is a host tensor (a CUDA one raised above): no device read
    if idx.numel() and (int(idx.min()) < 0 or int(idx.max()) >= N):
        raise IndexError(f"kv_block_copy: index out of range for {N} pages")
    M = idx.numel()
    out = torch.empty((M,) + tuple(src_pages.shape[1:]), dtype=src_pages.dtype,
                      device=src_pages.device)
    page_bytes = math.prod(src_pages.shape[1:]) * src_pages.element_size()
    if M == 0 or page_bytes == 0:
        return out
    d_idx = idx.to(src_pages.device, non_blocking=False)
    stream = torch.cuda.current_stream(src_pages.device).cuda_stream
    rc = _lib().kv_block_copy(
        src_pages.data_ptr(), d_idx.data_ptr(), out.data_ptr(), page_bytes, M, stream
    )
    if rc != 0:
        raise RuntimeError(f"kv_block_copy: kernel launch failed (CUDA error {rc})")
    kv_block_copy.launches += 1
    return out


kv_block_copy.launches = 0


def gather_payloads(arrays: Sequence[torch.Tensor], device: DeviceLike = None) -> List[torch.Tensor]:
    """Move N same-shape block payloads through ONE batched page gather on
    ``device``.

    The payloads are stacked into a [N, page, KV, D] slab on the device,
    gathered in a single ``kv_block_copy`` launch, and come back as fresh
    tensors on the payloads' own device, in input order.  Payloads whose
    shapes cannot form a uniform page layout (mixed shapes or dtypes, empty
    payloads) take a plain per-array copy instead — chosen from the shapes,
    before any launch.
    """
    if not arrays:
        return []
    dev = resolve_device(device)
    first = arrays[0]
    shapes = {(tuple(a.shape), a.dtype) for a in arrays}
    if len(shapes) != 1 or first.numel() == 0:
        gather_payloads.plain_copies += 1
        return [a.clone(memory_format=torch.contiguous_format) for a in arrays]
    if first.dim() >= 3:
        page_shape = (math.prod(first.shape[:-2]), first.shape[-2], first.shape[-1])
    else:
        page_shape = (first.numel(), 1, 1)
    src = torch.stack([a.reshape(page_shape) for a in arrays]).to(dev)
    out = kv_block_copy(src, torch.arange(len(arrays), dtype=torch.int32))
    out = out.to(first.device)
    return [out[i].reshape(arrays[i].shape) for i in range(len(arrays))]


gather_payloads.plain_copies = 0

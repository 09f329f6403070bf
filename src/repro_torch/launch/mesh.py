"""Meshes of the port: the JAX package's ``launch/mesh.py`` over
``torch.distributed.device_mesh``.

A JAX ``Mesh`` becomes a ``DeviceMesh`` with the same axis names
(``data``, ``model``, and ``pod`` for multi-pod).  A mesh needs a default
process group of the mesh's size; ``init_group`` starts one with the rank,
world size and ``tcp://localhost:<port>`` address the caller passes
(nothing is read from a launcher's environment variables): ``gloo`` for
ranks on the CPU, ``nccl`` for ranks on cards.  The dry run's 256- and
512-rank groups use the ``fake`` backend (``launch/dryrun.py``).

The mesh's device type is explicit, as everywhere in the port: CUDA unless
the caller passes ``device="cpu"`` (``repro_torch.device.resolve_device``).
"""
from __future__ import annotations

import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from repro_torch.device import DeviceLike, resolve_device


def init_group(backend: str, *, rank: int, world_size: int, port: int) -> None:
    """The default process group over ``tcp://localhost:<port>``."""
    if backend not in ("gloo", "nccl"):
        raise ValueError(f"backend {backend!r}: use gloo (CPU) or nccl (cards)")
    dist.init_process_group(backend, init_method=f"tcp://localhost:{port}", rank=rank,
                            world_size=world_size)


def make_mesh(shape, axes, *, device: DeviceLike = None) -> DeviceMesh:
    """A mesh of ``shape`` with axis names ``axes`` over the default group,
    whose size must be the mesh's."""
    if not dist.is_initialized():
        raise RuntimeError("no process group: call init_group (or the dry run's fake group) first")
    size = 1
    for n in shape:
        size *= n
    if dist.get_world_size() != size:
        raise ValueError(f"a {tuple(shape)} mesh needs {size} ranks, the group has "
                         f"{dist.get_world_size()}")
    return init_device_mesh(resolve_device(device).type, tuple(shape), mesh_dim_names=tuple(axes))


def make_production_mesh(*, multi_pod: bool = False, device: DeviceLike = None) -> DeviceMesh:
    """16x16 = 256 ranks per pod; 2 pods = 512 ranks multi-pod."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes, device=device)


def make_debug_mesh(data: int = 1, model: int = 1, *, device: DeviceLike = None) -> DeviceMesh:
    """A small (data, model) mesh over the ranks of the default group."""
    return make_mesh((data, model), ("data", "model"), device=device)

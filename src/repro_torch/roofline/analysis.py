"""Three-term roofline model and the collective counter of the dry run.

  compute term    = FLOPs per device / peak FLOP/s
  memory term     = HBM bytes per device / HBM bandwidth
  collective term = collective bytes per device / link bandwidth

``RooflineTerms``, ``model_flops_for`` and ``roofline_report`` are the JAX
package's ``roofline/analysis.py``; ``roofline_report`` takes the hardware
constants as ``hw=`` (default ``HW``, the H100's).

The reference reads its collective bytes from the compiled HLO text, which
torch does not have.  ``CollectiveCounter`` takes that place: a
``TorchDispatchMode`` that sees every functional collective
(``torch.ops._c10d_functional``) that DTensor's redistributions and the
explicit collectives of the sharded bodies issue, and records per kind the
count and the bytes of each result (the reference's convention: result-shape
bytes per device).  Eager torch runs every layer and every micro-batch as it
goes, so these counts are already what the reference's trip-count-aware
parser (``collective_bytes_with_trip_counts``) reconstructs from its loops.
The counter sees the same ops on meta tensors (the dry run's fake process
group), on gloo and on NCCL.

``LiveBytes`` stands in for the compiled program's buffer assignment, the
source of the reference's peak (arguments + outputs + temps): another
``TorchDispatchMode``, which counts the storage of every tensor an op
returns once, while that storage lives (a storage's Python object lives
exactly as long as the storage, views and tensors autograd saves included),
so ``peak`` is the most bytes the step held at once beside its arguments.
"""
from __future__ import annotations

import weakref
from dataclasses import dataclass
from typing import Dict, Optional, Set

import torch
from torch.utils._python_dispatch import TorchDispatchMode

# NVIDIA H100 SXM5 80GB, data-sheet values (not measurements):
HW = {
    "peak_flops": 989e12,  # dense bf16 tensor-core FLOP/s per GPU
    "hbm_bw": 3.35e12,  # HBM3 bytes/s per GPU
    # NVLink 4: 18 links x 25 GB/s per direction = 450 GB/s per GPU in one
    # direction (the data sheet's 900 GB/s counts both directions)
    "link_bw": 450e9,
}

COLLECTIVES = (
    "all-gather",
    "all-reduce",
    "reduce-scatter",
    "all-to-all",
    "collective-permute",
)

# functional collective op name -> the reference's HLO kind
_KINDS = {
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "all_reduce": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_to_all_single": "all-to-all",
}


def _result_bytes(out) -> int:
    if isinstance(out, torch.Tensor):
        return out.numel() * out.element_size()
    if isinstance(out, (list, tuple)):
        return sum(_result_bytes(o) for o in out)
    return 0


class CollectiveCounter(TorchDispatchMode):
    """Counts and sizes the functional collectives run inside its ``with``.

    ``counts[kind]`` and ``bytes[kind]`` per kind of ``COLLECTIVES``;
    ``summary()`` gives ``{kind: {"count", "bytes"}}`` plus ``total_bytes``."""

    def __init__(self) -> None:
        super().__init__()
        self.counts: Dict[str, int] = {k: 0 for k in COLLECTIVES}
        self.bytes: Dict[str, int] = {k: 0 for k in COLLECTIVES}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if func.namespace == "_c10d_functional":
            kind = _KINDS.get(func.__name__.split(".")[0])
            if kind is not None:
                self.counts[kind] += 1
                self.bytes[kind] += _result_bytes(out)
        return out

    def total_bytes(self) -> int:
        return sum(self.bytes.values())

    def summary(self) -> Dict[str, object]:
        out: Dict[str, object] = {k: {"count": self.counts[k], "bytes": self.bytes[k]}
                                  for k in COLLECTIVES}
        out["total_bytes"] = self.total_bytes()
        return out


class LiveBytes(TorchDispatchMode):
    """The bytes of the storages that ops return inside its ``with``, each
    counted once from the op that first returns it until it is freed:
    ``live`` now, ``peak`` the most at once.  Storages of ``keep`` (the
    step's arguments; a DTensor counts by its local shard) are never
    counted: a view of an argument, or an in-place update of one, adds
    nothing."""

    def __init__(self, keep=()) -> None:
        super().__init__()
        self.live = 0
        self.peak = 0
        self._keep: Set[int] = set()
        self._counted: Set[int] = set()
        for t in keep:
            self._keep.add(self._storage(t)._cdata)

    @staticmethod
    def _storage(t: torch.Tensor):
        return getattr(t, "_local_tensor", t).untyped_storage()

    def _track(self, t: torch.Tensor) -> None:
        st = self._storage(t)
        key = st._cdata
        if key in self._keep or key in self._counted:
            return
        n = st.nbytes()
        self._counted.add(key)
        self.live += n
        self.peak = max(self.peak, self.live)
        weakref.finalize(st, self._free, key, n)

    def _free(self, key: int, n: int) -> None:
        self._counted.discard(key)
        self.live -= n

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.utils._pytree import tree_leaves

        out = func(*args, **(kwargs or {}))
        for t in tree_leaves(out):
            if isinstance(t, torch.Tensor):
                self._track(t)
        return out


@dataclass
class RooflineTerms:
    compute_s: float
    memory_s: float
    collective_s: float
    dominant: str
    flops_per_device: float
    bytes_per_device: float
    collective_bytes_per_device: float
    model_flops: float
    useful_flops_ratio: float
    chips: int

    def to_dict(self) -> Dict[str, float]:
        return dict(
            compute_s=self.compute_s,
            memory_s=self.memory_s,
            collective_s=self.collective_s,
            dominant=self.dominant,
            flops_per_device=self.flops_per_device,
            bytes_per_device=self.bytes_per_device,
            collective_bytes_per_device=self.collective_bytes_per_device,
            model_flops=self.model_flops,
            useful_flops_ratio=self.useful_flops_ratio,
            chips=self.chips,
        )


def model_flops_for(cfg, shape) -> float:
    """MODEL_FLOPS = 6*N*D (dense) or 6*N_active*D (MoE), D = tokens/step."""
    n = cfg.active_param_count() if cfg.moe.num_experts else cfg.param_count()
    tokens = shape.tokens_per_step
    factor = 6.0 if shape.kind == "train" else 2.0  # fwd-only for serving
    return factor * n * tokens


def roofline_report(
    *,
    flops_per_device: float,
    bytes_per_device: float,
    collective_bytes_per_device: float,
    chips: int,
    model_flops: float,
    hw: Optional[Dict[str, float]] = None,
) -> RooflineTerms:
    hw = HW if hw is None else hw
    compute = flops_per_device / hw["peak_flops"]
    memory = bytes_per_device / hw["hbm_bw"]
    coll = collective_bytes_per_device / hw["link_bw"]
    terms = {"compute": compute, "memory": memory, "collective": coll}
    dominant = max(terms, key=terms.get)
    total_flops = flops_per_device * chips
    ratio = model_flops / total_flops if total_flops else 0.0
    return RooflineTerms(
        compute_s=compute,
        memory_s=memory,
        collective_s=coll,
        dominant=dominant,
        flops_per_device=flops_per_device,
        bytes_per_device=bytes_per_device,
        collective_bytes_per_device=collective_bytes_per_device,
        model_flops=model_flops,
        useful_flops_ratio=ratio,
        chips=chips,
    )

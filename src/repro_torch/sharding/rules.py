"""Per-architecture sharding rules (DP / FSDP / TP / EP / SP), the JAX
package's ``sharding/rules.py`` over DTensor.

Baseline layout, as in the reference:
  - batch over the data axes ("pod" x "data" in the multi-pod mesh);
  - parameter matrices FSDP-sharded over 'data' on one dim and TP-sharded
    over 'model' on the other (DTensor inserts the gathers where an op
    needs them);
  - MoE experts: EP over 'model' when E % model == 0 (arctic), else TP over
    d_ff (grok) — matching models/moe.py's sharded bodies;
  - train/prefill activations sequence-sharded over 'model' between layers;
  - decode KV caches: batch over data axes, *sequence* over 'model'.
Dims that cannot shard meaningfully (size < axis) fall back to replication
rather than padding.

A spec is plain data: a tuple with one entry per tensor dim, each ``None``
(replicated), an axis name, or a tuple of axis names (the dim split over
several axes, major first), as a JAX ``PartitionSpec`` holds them.  Spec
trees are nested dicts beside the parameter, batch or cache trees, so they
compare with the reference's leaf by leaf (a spec is a leaf of
``training.tree.map_tree``).  ``placements`` turns one spec
into DTensor placements: ``Shard(dim)`` on every mesh axis the spec names
for that dim, ``Replicate()`` on the others.

The rules read only the mesh's axis sizes and names.  ``MeshShape`` holds
those two, taken from a ``DeviceMesh``, a dict of axis sizes, or any object
with a ``shape`` mapping and ``axis_names`` (a JAX mesh), so the rules run
without a process group.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Dict, Optional, Tuple

Spec = Tuple[Any, ...]


@dataclass(frozen=True)
class MeshShape:
    """The axis sizes (``shape[name]``) and names of a mesh, in order."""

    shape: Dict[str, int]
    axis_names: Tuple[str, ...]


def mesh_shape(mesh) -> MeshShape:
    if isinstance(mesh, MeshShape):
        return mesh
    if isinstance(mesh, dict):
        return MeshShape(dict(mesh), tuple(mesh))
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:  # a torch DeviceMesh
        return MeshShape(dict(zip(names, mesh.shape)), tuple(names))
    return MeshShape(dict(mesh.shape), tuple(mesh.axis_names))


@dataclass(frozen=True)
class ShardingRules:
    dp_axes: Tuple[str, ...] = ("data",)  # ("pod", "data") for multi-pod
    tp_axis: str = "model"
    # parameter FSDP axis (within one pod); None = TP-only params, replicated
    # over data: the serving layout for models whose per-model-rank weights
    # fit (re-gathering FSDP shards every decode step costs a gather a step)
    fsdp_axis: Optional[str] = "data"

    @staticmethod
    def for_mesh(mesh, *, serving: bool = False, param_bytes: float = 0.0) -> "ShardingRules":
        m = mesh_shape(mesh)
        dp = ("pod", "data") if "pod" in m.axis_names else ("data",)
        fsdp: Optional[str] = "data"
        if serving:
            per_rank = param_bytes / m.shape["model"]
            if per_rank < 4e9:  # replicating over data costs < 4 GB per rank
                fsdp = None
        return ShardingRules(dp_axes=dp, fsdp_axis=fsdp)


def _axis_size(m: MeshShape, axis) -> int:
    if axis is None:
        return 1
    if isinstance(axis, tuple):
        return math.prod(m.shape[a] for a in axis)
    return m.shape[axis]


def _maybe(m: MeshShape, axis, dim: int):
    """Use the axis only when the dim divides exactly."""
    return axis if dim % _axis_size(m, axis) == 0 else None


def map_with_path(fn, tree, path: Tuple[str, ...] = ()):
    """``fn(key path, leaf)`` at every leaf of a nested dict."""
    if isinstance(tree, dict):
        return {k: map_with_path(fn, v, path + (str(k),)) for k, v in tree.items()}
    return fn(path, tree)


# ---------------------------------------------------------------------------
# parameters
# ---------------------------------------------------------------------------

_REPLICATED_NAMES = {
    "w", "b", "fb", "hnorm", "q_norm", "k_norm", "dt_bias", "D", "ri", "rf",
    "rz", "ro", "conv_w", "router",
}


def _param_rule(cfg, names: Tuple[str, ...], shape: Tuple[int, ...], m: MeshShape,
                rules: ShardingRules) -> Spec:
    """Spec for the *trailing* (per-layer) dims of one weight."""
    name = names[-1]
    fsdp, tp = rules.fsdp_axis, rules.tp_axis
    d2 = shape[-2] if len(shape) >= 2 else 0
    d1 = shape[-1]

    if name in _REPLICATED_NAMES or len(shape) < 2:
        return ()

    in_moe = any(n == "moe" for n in names)
    if in_moe:
        # experts stacked [E, d, ff] / [E, ff, d]
        E = shape[-3]
        ep = E % _axis_size(m, tp) == 0
        if name in ("w_gate", "w_up"):
            if ep:
                return (tp, _maybe(m, fsdp, d2), None)
            return (None, _maybe(m, fsdp, d2), _maybe(m, tp, d1))
        if name == "w_down":
            if ep:
                return (tp, None, _maybe(m, fsdp, d1))
            return (None, _maybe(m, tp, d2), _maybe(m, fsdp, d1))

    if name == "embed":  # [V, d]: gathers pull a d-slice per rank
        return (None, _maybe(m, tp, d1))
    if name == "lm_head":  # [d, V]: vocab-sharded logits for the chunked loss
        return (None, _maybe(m, tp, d1))
    if name in ("wq", "wk", "wv", "wg", "w_gate", "w_up", "w_in", "wi", "wf", "wz"):
        return (_maybe(m, fsdp, d2), _maybe(m, tp, d1))
    if name in ("wo", "w_down", "w_out", "wproj", "w_dt"):
        return (_maybe(m, tp, d2), _maybe(m, fsdp, d1))
    if name in ("w_xproj", "A_log"):
        return (_maybe(m, tp, d2), None)
    return tuple(None for _ in shape)


def param_pspecs(cfg, param_shapes, mesh, rules: Optional[ShardingRules] = None):
    """Spec tree matching a parameter tree (tensors, meta tensors or any
    leaves with ``.shape``)."""
    m = mesh_shape(mesh)
    rules = rules or ShardingRules.for_mesh(m)

    def rule(path, leaf):
        shape = tuple(leaf.shape)
        trailing = _param_rule(cfg, path, shape, m, rules)
        return (None,) * (len(shape) - len(trailing)) + tuple(trailing)

    return map_with_path(rule, param_shapes)


# ---------------------------------------------------------------------------
# batches and caches
# ---------------------------------------------------------------------------


def batch_pspecs(cfg, batch_shapes, mesh, rules: Optional[ShardingRules] = None):
    m = mesh_shape(mesh)
    rules = rules or ShardingRules.for_mesh(m)
    dp = rules.dp_axes

    def rule(path, leaf):
        shape = tuple(leaf.shape)
        lead = dp if shape[0] % _axis_size(m, dp) == 0 else None
        return (lead,) + (None,) * (len(shape) - 1)

    return map_with_path(rule, batch_shapes)


def cache_pspecs(cfg, cache_shapes, mesh, rules: Optional[ShardingRules] = None):
    """Decode-cache specs: batch over dp, sequence over 'model'."""
    m = mesh_shape(mesh)
    rules = rules or ShardingRules.for_mesh(m)
    dp, tp = rules.dp_axes, rules.tp_axis
    dp_n = _axis_size(m, dp)
    tp_n = _axis_size(m, tp)

    def rule(path, leaf):
        name = path[-1] if path else ""
        shape = tuple(leaf.shape)
        if name in ("k", "v", "xk", "xv") and len(shape) == 5:  # [L, B, S, KV, Dh]
            _, B, S, _, _ = shape
            return (None, dp if B % dp_n == 0 else None, tp if S % tp_n == 0 else None,
                    None, None)
        if name == "pos" and len(shape) == 2:
            B, S = shape
            return (dp if B % dp_n == 0 else None, tp if S % tp_n == 0 else None)
        if name in ("k_scale", "v_scale") and len(shape) == 4:  # [L, B, S, KV]
            _, B, S, _ = shape
            return (None, dp if B % dp_n == 0 else None, tp if S % tp_n == 0 else None, None)
        if cfg.family == "ssm":  # xlstm grouped states [G, n_blocks, B, ...]
            if len(shape) >= 3:
                B = shape[2]
                rest = [None] * (len(shape) - 3)
                if name == "C" and len(shape) == 6:  # [..., nh, dk, dv]
                    rest = [None, None, tp if shape[-1] % tp_n == 0 else None]
                return (None, None, dp if B % dp_n == 0 else None, *rest)
            return (None,) * len(shape)
        if cfg.family == "hybrid":
            if name == "h" and len(shape) == 4:  # ssm state [L, B, di, N]
                _, B, di, _ = shape
                return (None, dp if B % dp_n == 0 else None, tp if di % tp_n == 0 else None,
                        None)
            if name == "conv" and len(shape) == 4:  # [L, B, K-1, di]
                _, B, _, di = shape
                return (None, dp if B % dp_n == 0 else None, None,
                        tp if di % tp_n == 0 else None)
        # generic: batch on dim 0
        lead = dp if shape and shape[0] % dp_n == 0 else None
        return (lead,) + (None,) * (len(shape) - 1)

    return map_with_path(rule, cache_shapes)


# ---------------------------------------------------------------------------
# DTensor placements
# ---------------------------------------------------------------------------


def spec_axes(spec: Spec) -> Tuple[Tuple[str, ...], ...]:
    """Per tensor dim, the tuple of mesh axes it is split over."""
    return tuple(() if e is None else ((e,) if isinstance(e, str) else tuple(e)) for e in spec)


def placements(spec: Spec, mesh) -> tuple:
    """DTensor placements of ``spec`` on ``mesh`` (one per mesh axis).  An
    axis of one rank shards too, as a ``PartitionSpec`` naming it does: its
    shard is the whole tensor, but DTensor still picks each op's strategy
    for the sharded layout, so a one-rank mesh runs the sharded code."""
    from torch.distributed.tensor import Replicate, Shard

    axes = spec_axes(spec)
    out = []
    for name in mesh_shape(mesh).axis_names:
        dims = [d for d, names in enumerate(axes) if name in names]
        out.append(Shard(dims[0]) if dims else Replicate())
    return tuple(out)


def local_shape(shape, spec: Spec, mesh) -> Tuple[int, ...]:
    """One rank's shard shape of a tensor of ``shape`` laid out by ``spec``
    (the rules shard only dims that divide)."""
    m = mesh_shape(mesh)
    out = []
    for n, names in zip(shape, spec_axes(spec) + ((),) * (len(shape) - len(spec))):
        k = math.prod(m.shape[a] for a in names)
        if n % k:
            raise ValueError(f"dim {n} does not divide over {names} ({k})")
        out.append(n // k)
    return tuple(out)


def as_replicated(t, mesh):
    """A plain tensor that every rank holds in full, as a replicated
    DTensor (a DTensor is returned as it is)."""
    from torch.distributed.tensor import DTensor, Replicate

    if isinstance(t, DTensor):
        return t
    return DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim, run_check=False)


def distribute(t, spec: Spec, mesh):
    """A full tensor every rank holds, as a DTensor laid out by ``spec``:
    each rank keeps its own shard (no communication)."""
    from torch.distributed.tensor import distribute_tensor

    return distribute_tensor(t, mesh, placements(spec, mesh), src_data_rank=None)


def redistribute_tree(tree, spec_tree, mesh):
    """Each leaf laid out by its spec; a plain tensor (an ``arange`` of
    positions made inside a step) is every rank's full copy."""
    from repro_torch.training.tree import map_tree

    return map_tree(lambda s, t: as_replicated(t, mesh).redistribute(mesh, placements(s, mesh)),
                    spec_tree, tree)


def full(t):
    """A DTensor's full value on every rank (a plain tensor as it is)."""
    return t.full_tensor() if hasattr(t, "full_tensor") else t


def split_dim(t, dim: int, sizes):
    """``t`` with dim ``dim`` reshaped into ``sizes`` (a heads split).  A
    DTensor sharded on that dim over mesh axes whose size does not divide
    ``sizes[0]`` (8 KV heads over a 16-rank 'model' axis) cannot be split
    in place: DTensor has no rule for an uneven unflatten, so those axes
    are replicated first (the dry run counts the gather)."""
    dim = dim % t.ndim
    if hasattr(t, "device_mesh"):
        from torch.distributed.tensor import Replicate

        mesh = t.device_mesh
        on = [i for i, p in enumerate(t.placements) if p.is_shard(dim)]
        if sizes[0] % math.prod(mesh.size(i) for i in on):
            t = t.redistribute(mesh, [Replicate() if i in on else p
                                      for i, p in enumerate(t.placements)])
    return t.reshape(*t.shape[:dim], *sizes, *t.shape[dim + 1 :])


def named(mesh, spec_tree):
    """The placements tree of a spec tree (the reference's ``named``)."""
    from repro_torch.training.tree import map_tree

    return map_tree(lambda s: placements(s, mesh), spec_tree)

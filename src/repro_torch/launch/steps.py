"""Sharded train/serve steps for every (arch x shape x mesh) cell: the JAX
package's ``launch/steps.py`` over DTensor.

``build_cell`` returns the cell's step function and its argument layout:
the spec trees of the parameters, the optimizer state, the batch and the
cache (``sharding/rules.py``), and the global shapes and dtypes of each
argument.  ``cell_arguments`` makes the arguments as DTensors, either as
meta tensors (the dry run: no memory) or from full tensors every rank
holds (``sharding.rules.distribute``: each rank keeps its own shard, no communication);
``run_cell`` runs the step once.

The train step is ``training/step.make_train_step`` over DTensors (the
reference's order; one implementation with ``Trainer``).
Prefill and decode: the bundle's ``prefill_fn`` / ``decode_fn``.  Each
output is redistributed to the reference's out-sharding, as ``jit``'s
``out_shardings`` does.  A step runs under DTensor's
``implicit_replication``: a plain tensor made inside the model (an
``arange`` of positions, RoPE's frequencies) counts as replicated on every
rank, which it is.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Optional

import torch

from repro_torch.configs import SHAPES_BY_NAME, get_config, shape_applicable
from repro_torch.models.registry import build_model
from repro_torch.sharding.rules import (
    ShardingRules,
    batch_pspecs,
    cache_pspecs,
    distribute,
    local_shape,
    param_pspecs,
    placements,
    redistribute_tree,
)
from repro_torch.training.optimizer import AdamWConfig, opt_state_pspecs
from repro_torch.training.step import make_train_step
from repro_torch.training.tree import map_tree


class CellSkipped(Exception):
    pass


@dataclass
class Cell:
    arch: str
    shape_name: str
    kind: str  # train | prefill | decode
    cfg: Any
    mesh: Any
    bundle: Any
    step_fn: Callable
    # (name, spec tree, meta tree) of each positional argument of step_fn
    arg_layout: tuple
    out_specs: Any
    opt_cfg: Optional[AdamWConfig] = None
    n_micro: int = 1


def optimizer_for(cfg) -> AdamWConfig:
    # int8 moments for the >100B MoE archs (the reference's memory budget)
    if cfg.moe.num_experts and cfg.param_count() > 50e9:
        return AdamWConfig(state_dtype="int8")
    return AdamWConfig(state_dtype="fp32")


def microbatches_for(cfg) -> int:
    """Gradient-accumulation factor (divides the remat stash + transients),
    the reference's choice."""
    if cfg.param_count() > 50e9:
        return 8
    if cfg.family in ("ssm", "hybrid"):
        return 4
    if cfg.param_count() > 3e9:
        return 2
    return 1


def _f32(t):
    return torch.empty(t.shape, dtype=torch.float32, device="meta") if t.is_floating_point() else t


def _opt_meta(params_meta, opt_cfg: AdamWConfig):
    """The optimizer state's shapes and dtypes beside f32 masters."""
    from repro_torch.training.optimizer import _role_dtype

    def moment(role):
        def fn(p):
            sd = _role_dtype(opt_cfg.state_dtype, role)
            if sd == "int8":
                n = p.shape[-1] if p.ndim else 1
                padded = n + (-n) % 256
                lead = tuple(p.shape[:-1]) if p.ndim else ()
                return {"q": torch.empty(lead + (padded,), dtype=torch.int8, device="meta"),
                        "scale": torch.empty(lead + (padded // 256,), dtype=torch.float32,
                                             device="meta")}
            dt = torch.float32 if sd == "fp32" else torch.bfloat16
            return torch.empty(p.shape, dtype=dt, device="meta")
        return fn

    return {"m": map_tree(moment("m"), params_meta), "v": map_tree(moment("v"), params_meta),
            "step": torch.empty((), dtype=torch.int32, device="meta")}


def build_cell(arch: str, shape_name: str, mesh, *, moe_strategy: str = "auto",
               kv_cache_dtype: str = "bf16", cfg=None, shape=None,
               opt_cfg: Optional[AdamWConfig] = None) -> Cell:
    """The cell's step and argument layout.  ``cfg`` / ``shape`` override
    the named config and shape (a reduced config, a cut batch), ``opt_cfg``
    the optimizer (default ``optimizer_for(cfg)``)."""
    cfg = cfg or get_config(arch)
    if kv_cache_dtype != "bf16":
        cfg = cfg.replace(kv_cache_dtype=kv_cache_dtype)
    shape = shape or SHAPES_BY_NAME[shape_name]
    ok, why = shape_applicable(cfg, shape)
    if not ok:
        raise CellSkipped(why)

    rules = ShardingRules.for_mesh(
        mesh,
        serving=shape.kind != "train",
        param_bytes=cfg.param_count() * 2.0,  # bf16 serving weights
    )
    device = mesh.device_type
    bundle = build_model(cfg, device=device, mesh=mesh, moe_strategy=moe_strategy)
    param_meta = bundle.param_shapes()
    p_specs = param_pspecs(cfg, param_meta, mesh, rules)
    batch_meta = bundle.batch_spec(shape)
    b_specs = batch_pspecs(cfg, batch_meta, mesh, rules)
    dp = rules.dp_axes
    tp = rules.tp_axis
    msize = dict(zip(mesh.mesh_dim_names, mesh.shape))

    if shape.kind == "train":
        master_meta = map_tree(_f32, param_meta)
        opt_cfg = opt_cfg or optimizer_for(cfg)
        o_specs = opt_state_pspecs(p_specs, master_meta, opt_cfg, mesh)
        n_micro = microbatches_for(cfg)
        train_step = make_train_step(bundle, opt_cfg, n_micro=n_micro, mesh=mesh,
                                     p_specs=p_specs, o_specs=o_specs)
        layout = (("params", p_specs, master_meta),
                  ("opt_state", o_specs, _opt_meta(master_meta, opt_cfg)),
                  ("batch", b_specs, batch_meta))
        return Cell(arch, shape.name, "train", cfg, mesh, bundle, train_step, layout,
                    (p_specs, o_specs), opt_cfg, n_micro)

    V = cfg.vocab_size
    cache_meta = bundle.cache_spec(shape)
    c_specs = cache_pspecs(cfg, cache_meta, mesh, rules)
    dp_n = 1
    for a in dp:
        dp_n *= msize[a]

    if shape.kind == "prefill":
        logits_spec = (dp, tp if V % msize[tp] == 0 else None)

        def prefill_step(params, batch):
            logits, cache = bundle.prefill_fn(params, batch, shape.seq_len)
            return (logits.redistribute(mesh, placements(logits_spec, mesh)),
                    redistribute_tree(cache, c_specs, mesh))

        layout = (("params", p_specs, param_meta), ("batch", b_specs, batch_meta))
        return Cell(arch, shape.name, "prefill", cfg, mesh, bundle, prefill_step, layout,
                    (logits_spec, c_specs))

    # decode: one new token against a seq_len cache
    B = shape.global_batch
    dp_ok = B % dp_n == 0
    vec_spec = (dp,) if dp_ok else (None,)
    logits_spec = (dp if dp_ok else None, tp if V % msize[tp] == 0 else None)

    def serve_step(params, cache, tokens, cur_pos):
        logits, cache = bundle.decode_fn(params, cache, tokens, cur_pos)
        return (logits.redistribute(mesh, placements(logits_spec, mesh)),
                redistribute_tree(cache, c_specs, mesh))

    vec = torch.empty((B,), dtype=torch.int32, device="meta")
    layout = (("params", p_specs, param_meta), ("cache", c_specs, cache_meta),
              ("tokens", vec_spec, vec), ("cur_pos", vec_spec, vec))
    return Cell(arch, shape.name, "decode", cfg, mesh, bundle, serve_step, layout,
                (logits_spec, c_specs))


def meta_dtensor(like: torch.Tensor, spec, mesh):
    """A DTensor of ``like``'s global shape and dtype laid out by ``spec``,
    whose shards are meta tensors."""
    from torch.distributed.tensor import DTensor

    loc = torch.empty(local_shape(tuple(like.shape), spec, mesh), dtype=like.dtype,
                      device="meta")
    return DTensor.from_local(loc, mesh, placements(spec, mesh), run_check=False,
                              shape=like.shape, stride=like.stride())


def cell_arguments(cell: Cell):
    """The step's positional arguments as DTensors of meta shards."""
    return tuple(map_tree(lambda s, m: meta_dtensor(m, s, cell.mesh), specs, meta)
                 for _, specs, meta in cell.arg_layout)


def distribute_argument(cell: Cell, name: str, tree):
    """The step's argument ``name`` (``params``, ``opt_state``, ``batch``,
    ``cache``, ``tokens``, ``cur_pos``) from full tensors on the mesh's
    device, laid out by its specs."""
    for arg, specs, _ in cell.arg_layout:
        if arg == name:
            return map_tree(lambda s, t: distribute(t, s, cell.mesh), specs, tree)
    raise KeyError(f"{cell.kind} cell has no argument {name!r}")


def run_cell(cell: Cell, args):
    """Run the cell's step once on DTensor ``args``."""
    from torch.distributed.tensor.experimental import implicit_replication

    with implicit_replication():
        return cell.step_fn(*args)


def argument_bytes_per_device(args) -> int:
    """Bytes of this rank's shards of every argument."""
    from repro_torch.training.tree import leaves

    total = 0
    for tree in args:
        for t in leaves(tree):
            loc = t.to_local() if hasattr(t, "to_local") else t
            total += loc.numel() * loc.element_size()
    return total

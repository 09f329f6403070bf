"""The train step, the reference's order: the f32 masters cast to bf16
compute leaves, the bundle's ``loss_fn`` and its backward over each
micro-batch, the grads as f32, then ``adamw_update`` on the masters in
place.  One implementation serves ``Trainer`` on one device and the
sharded cells of ``launch/steps.py``.

The reference's ``lax.scan`` over micro-batches is a loop that accumulates
f32 grads; a micro-batch is a slice of the rows (of a DTensor's local rows,
so no rows move).  With a mesh the arguments are DTensors: the grads are
laid out like the parameters before the update, and the optimizer state
keeps its layout after it (``sharding/rules.py``'s spec trees), as the
reference's ``out_shardings`` do.  The caller runs the step under DTensor's
``implicit_replication`` (a plain tensor made inside the model counts as
replicated on every rank, which it is).
"""
from __future__ import annotations

from typing import Dict

import torch

from repro_torch.sharding.rules import redistribute_tree
from repro_torch.training.optimizer import AdamWConfig, adamw_update
from repro_torch.training.tree import map_tree

# the compute leaves' type, the reference's
COMPUTE_DTYPE = torch.bfloat16


def _compute_leaf(p: torch.Tensor) -> torch.Tensor:
    if not p.is_floating_point():
        return p
    return p.detach().to(COMPUTE_DTYPE).requires_grad_()


def _take_grad(leaf: torch.Tensor) -> torch.Tensor:
    """The leaf's grad as f32, releasing the compute-type grad (zeros if
    unused)."""
    g, leaf.grad = leaf.grad, None
    if g is None:
        return torch.zeros_like(leaf, dtype=torch.float32)
    return g.float()


def _add_grad(acc: torch.Tensor, leaf: torch.Tensor) -> None:
    """``acc += leaf.grad`` in f32 (the sum ``acc + grad.float()`` rounds
    to), releasing the compute-type grad."""
    g, leaf.grad = leaf.grad, None
    if g is not None:
        acc.add_(g)


def _micro(t: torch.Tensor, i: int, n: int) -> torch.Tensor:
    """Micro-batch ``i`` of ``n``: rows ``[i*b/n, (i+1)*b/n)`` of ``t``'s
    rows (a DTensor's local rows, as a DTensor of the same placements)."""
    if not hasattr(t, "device_mesh"):
        b = t.shape[0] // n
        return t[i * b : (i + 1) * b]
    from torch.distributed.tensor import DTensor

    loc = t.to_local()
    if loc.shape[0] % n:
        raise ValueError(f"{loc.shape[0]} local rows do not split into {n} micro-batches")
    b = loc.shape[0] // n
    shape = (t.shape[0] // n,) + tuple(t.shape[1:])
    return DTensor.from_local(loc[i * b : (i + 1) * b], t.device_mesh, t.placements,
                              run_check=False, shape=torch.Size(shape),
                              stride=torch.empty(shape, device="meta").stride())


def loss_and_grads(bundle, params, batch: Dict[str, torch.Tensor], n_micro: int = 1):
    """The step's first half: the loss of the compute casts of the masters
    ``params`` (the mean over ``n_micro`` micro-batches), and its grads as
    f32 in the masters' tree."""
    compute = map_tree(_compute_leaf, params)
    if n_micro == 1:
        loss = bundle.loss_fn(compute, batch)
        loss.backward()
        return loss.detach(), map_tree(_take_grad, compute)
    loss_sum = grads = None
    for i in range(n_micro):
        loss = bundle.loss_fn(compute, map_tree(lambda t, i=i: _micro(t, i, n_micro), batch))
        loss.backward()
        loss_sum = loss.detach() if loss_sum is None else loss_sum + loss.detach()
        if grads is None:
            grads = map_tree(_take_grad, compute)
        else:  # in place, leaf by leaf: one f32 tree beside the compute-type grads
            map_tree(_add_grad, grads, compute)
    return loss_sum / n_micro, map_tree(lambda t: t.div_(n_micro), grads)


def apply_grads(grads, params, opt_state, opt_cfg: AdamWConfig, *, mesh=None, p_specs=None,
                o_specs=None):
    """The step's second half: AdamW on the masters, in place; with a mesh
    the grads are laid out by ``p_specs`` first and the new state by
    ``o_specs``.  Returns (params, opt_state, metrics)."""
    if mesh is not None:
        grads = redistribute_tree(grads, p_specs, mesh)
    params, opt_state, metrics = adamw_update(grads, opt_state, params, opt_cfg)
    if mesh is not None:
        opt_state = redistribute_tree(opt_state, o_specs, mesh)
    return params, opt_state, metrics


def make_train_step(bundle, opt_cfg: AdamWConfig, *, n_micro: int = 1, mesh=None, p_specs=None,
                    o_specs=None):
    """The step ``(params, opt_state, batch) -> (params, opt_state,
    metrics)``; ``metrics`` holds 0-d ``loss``, ``grad_norm`` and ``lr``.
    With ``mesh`` the arguments are DTensors laid out by ``p_specs`` and
    ``o_specs`` (see the module docstring)."""

    def train_step(params, opt_state, batch):
        loss, grads = loss_and_grads(bundle, params, batch, n_micro)
        params, opt_state, metrics = apply_grads(grads, params, opt_state, opt_cfg, mesh=mesh,
                                                 p_specs=p_specs, o_specs=o_specs)
        return params, opt_state, {"loss": loss, **metrics}

    return train_step

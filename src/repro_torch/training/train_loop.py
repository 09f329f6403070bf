"""Fault-tolerant training loop: checkpoint/restart, straggler monitoring,
elastic re-mesh (the JAX package's ``training/train_loop.py`` in PyTorch).

  - deterministic resume: (step, data cursor) live in the checkpoint; the
    synthetic pipeline replays exactly from the cursor, and the step is
    deterministic on the CPU, so a resumed run repeats the uninterrupted
    one's losses bit for bit there;
  - atomic checkpoints + async serialization (training never blocks on
    disk), in the reference's format;
  - straggler monitor: per-step wall-time EWMA with a pluggable
    mitigation callback;
  - ``remesh(mesh)``: the state is pulled whole to the host and laid out
    on a new mesh (checkpoints are unsharded, so mesh-agnostic);
    ``remesh(device)`` moves a one-device trainer's state to a device.

A step casts the f32 masters to bf16 compute leaves that require grad,
runs the bundle's ``loss_fn`` and ``backward``, takes the grads as f32 and
applies ``adamw_update`` to the masters in place.  The forward is the
reference's training formulation (plain attention under remat): no CUDA
kernel runs in it, and every kernel wrapper refuses a grad-requiring
input.

The step is ``training/step.make_train_step``.  ``mesh=`` (a
``DeviceMesh``) makes the state DTensors laid out by the training rules
(``sharding/rules.py``) and runs the same step on them, the reference's
``build_cell`` train step; each batch is laid out over the data axes.  Checkpoints store the
state whole and restore onto the trainer's placements.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Callable, Dict, List, Optional

import torch

from repro_torch.device import resolve_device
from repro_torch.training.checkpoint import (
    AsyncCheckpointer,
    _host_copy,
    latest_checkpoint,
    restore_checkpoint,
    save_checkpoint,
)
from repro_torch.training.data import DataConfig, SyntheticLM
from repro_torch.training.optimizer import AdamWConfig, init_opt_state
from repro_torch.training.step import apply_grads, loss_and_grads, make_train_step
from repro_torch.training.tree import map_tree


@dataclass
class StragglerMonitor:
    """Flags steps slower than max(abs_floor, factor x EWMA)."""

    factor: float = 3.0
    abs_floor_s: float = 0.5
    ewma: float = 0.0
    alpha: float = 0.1
    events: List[Dict[str, float]] = field(default_factory=list)
    mitigate: Optional[Callable[[int, float], None]] = None

    def observe(self, step: int, dt: float) -> bool:
        is_straggler = self.ewma > 0 and dt > max(self.abs_floor_s, self.factor * self.ewma)
        self.ewma = dt if self.ewma == 0 else (1 - self.alpha) * self.ewma + self.alpha * dt
        if is_straggler:
            self.events.append({"step": step, "dt": dt, "ewma": self.ewma})
            if self.mitigate is not None:
                self.mitigate(step, dt)
        return is_straggler


class Trainer:
    def __init__(
        self,
        bundle,
        *,
        data_cfg: DataConfig,
        opt_cfg: Optional[AdamWConfig] = None,
        ckpt_dir: Optional[Path] = None,
        ckpt_every: int = 50,
        async_ckpt: bool = True,
        seed: int = 0,
        mesh=None,
    ):
        self.bundle = bundle
        self.cfg = bundle.cfg
        self.device = bundle.device
        self.opt_cfg = opt_cfg or AdamWConfig()
        self.data = SyntheticLM(data_cfg)
        self.ckpt_dir = Path(ckpt_dir) if ckpt_dir else None
        self.ckpt_every = ckpt_every
        self.ckpt = AsyncCheckpointer() if async_ckpt else None
        self.monitor = StragglerMonitor()
        self.step = 0
        self.metrics: List[Dict[str, float]] = []

        params = bundle.init_params(torch.Generator().manual_seed(seed))
        self.params = map_tree(lambda p: p.float() if p.is_floating_point() else p, params)
        del params
        self.opt_state = init_opt_state(self.params, self.opt_cfg)
        self.mesh = None
        self._step = make_train_step(bundle, self.opt_cfg)
        if mesh is not None:
            self._lay_out(mesh)

    # -- sharding ----------------------------------------------------------------
    def _lay_out(self, mesh) -> None:
        """Lay the (whole) state out on ``mesh`` and build the sharded step."""
        from repro_torch.models.registry import build_model
        from repro_torch.sharding.rules import ShardingRules, param_pspecs
        from repro_torch.training.optimizer import opt_state_pspecs

        self.mesh = mesh
        self._rules = ShardingRules.for_mesh(mesh)
        self._p_specs = param_pspecs(self.cfg, self.params, mesh, self._rules)
        self._o_specs = opt_state_pspecs(self._p_specs, self.params, self.opt_cfg, mesh)
        self.params = self._distribute(self.params, self._p_specs)
        self.opt_state = self._distribute(self.opt_state, self._o_specs)
        if self.bundle.mesh is not mesh:
            self.bundle = build_model(self.cfg, device=self.device, mesh=mesh,
                                      moe_strategy=self.bundle.moe_strategy)
        self._step = make_train_step(self.bundle, self.opt_cfg, mesh=mesh,
                                     p_specs=self._p_specs, o_specs=self._o_specs)

    def _distribute(self, tree, specs):
        from repro_torch.sharding.rules import distribute

        return map_tree(lambda sp, t: distribute(t, sp, self.mesh), specs, tree)

    def _sharded_step(self, batch):
        from torch.distributed.tensor.experimental import implicit_replication

        from repro_torch.sharding.rules import batch_pspecs, full

        batch = self._distribute(batch, batch_pspecs(self.cfg, batch, self.mesh, self._rules))
        with implicit_replication():
            self.params, self.opt_state, m = self._step(self.params, self.opt_state, batch)
        return {k: full(v) for k, v in m.items()}

    # -- step ------------------------------------------------------------------
    def train_step(self, batch: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """One optimizer step on ``batch`` (tensors on the trainer's
        device; ``frames`` or ``patch_embeds`` beside ``tokens`` for the
        families with a frontend).  Returns 0-d tensors ``loss``,
        ``grad_norm``, ``lr``; nothing waits for the device.  With a mesh,
        the sharded step (the metrics gathered whole on every rank)."""
        if self.mesh is not None:
            return self._sharded_step(batch)
        self.params, self.opt_state, m = self._step(self.params, self.opt_state, batch)
        return m

    def loss_and_grads(self, batch: Dict[str, torch.Tensor]):
        """The step's first half: the loss of the bf16 casts of the
        masters, and its grads as f32 in the masters' tree."""
        return loss_and_grads(self.bundle, self.params, batch)

    def apply_grads(self, grads) -> Dict[str, torch.Tensor]:
        """The step's second half: AdamW on the masters, in place."""
        self.params, self.opt_state, m = apply_grads(grads, self.params, self.opt_state,
                                                     self.opt_cfg)
        return m

    def batch_at(self, step: int) -> Dict[str, torch.Tensor]:
        return {k: torch.from_numpy(v).to(self.device)
                for k, v in self.data.batch_at(step).items()}

    def run(self, num_steps: int, log_every: int = 10) -> List[Dict[str, float]]:
        while self.step < num_steps:
            batch = self.batch_at(self.step)
            t0 = time.perf_counter()
            m = self.train_step(batch)
            loss = float(m["loss"])  # waits for the step
            dt = time.perf_counter() - t0
            self.monitor.observe(self.step, dt)
            self.step += 1
            rec = {"step": self.step, "loss": loss, "dt_s": dt,
                   "grad_norm": float(m["grad_norm"])}
            self.metrics.append(rec)
            if log_every and self.step % log_every == 0:
                print(f"[train] step {self.step} loss {loss:.4f} ({dt*1e3:.0f} ms)")
            if self.ckpt_dir and self.step % self.ckpt_every == 0:
                self.save()
        if self.ckpt:
            self.ckpt.wait()
        return self.metrics

    # -- checkpoint/restart -----------------------------------------------------
    def save(self) -> None:
        """Write the state whole.  With a mesh every rank gathers it (a
        collective) and rank 0 writes."""
        state = {"params": self.params, "opt": self.opt_state}
        if self.mesh is not None:
            state = _host_copy(state)
            if torch.distributed.get_rank() != 0:
                return
        meta = {"arch": self.cfg.name, "data_seed": self.data.cfg.seed}
        if self.ckpt:
            self.ckpt.save(self.ckpt_dir, self.step, state, meta)
        else:
            save_checkpoint(self.ckpt_dir, self.step, state, meta)

    def resume(self) -> bool:
        """Restore the latest checkpoint; returns True if one was loaded."""
        if self.ckpt:
            self.ckpt.wait()
        if self.mesh is not None:
            torch.distributed.barrier()  # rank 0's write is done for every rank
        path = latest_checkpoint(self.ckpt_dir) if self.ckpt_dir else None
        if path is None:
            return False
        template = {"params": self.params, "opt": self.opt_state}
        specs = None if self.mesh is None else {"params": self._p_specs, "opt": self._o_specs}
        step, state, _ = restore_checkpoint(path, template, self.device, mesh=self.mesh,
                                            specs=specs)
        self.params, self.opt_state = state["params"], state["opt"]
        self.step = step
        return True

    # -- elastic ----------------------------------------------------------------
    def remesh(self, target) -> None:
        """Move training onto a different mesh (elastic scale up/down): the
        live state is gathered whole (checkpoint state is mesh-agnostic)
        and laid out on ``target``, a ``DeviceMesh`` over this process's
        group.  A device instead moves a one-device trainer's state there.
        Later steps run where the state is."""
        if hasattr(target, "mesh_dim_names"):
            from repro_torch.sharding.rules import full

            self.params = map_tree(lambda t: full(t).detach(), self.params)
            self.opt_state = map_tree(lambda t: full(t).detach(), self.opt_state)
            self._lay_out(target)
            return
        if self.mesh is not None:
            raise ValueError("a sharded trainer moves to a mesh, not a device")
        dev = resolve_device(target)
        self.params = map_tree(lambda t: t.to(dev), self.params)
        self.opt_state = map_tree(lambda t: t.to(dev), self.opt_state)
        self.device = dev

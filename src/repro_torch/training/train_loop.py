"""Fault-tolerant training loop on one device: checkpoint/restart,
straggler monitoring, moving the state to another device (the JAX
package's ``training/train_loop.py`` in PyTorch).

  - deterministic resume: (step, data cursor) live in the checkpoint; the
    synthetic pipeline replays exactly from the cursor, and the step is
    deterministic on the CPU, so a resumed run repeats the uninterrupted
    one's losses bit for bit there;
  - atomic checkpoints + async serialization (training never blocks on
    disk), in the reference's format;
  - straggler monitor: per-step wall-time EWMA with a pluggable
    mitigation callback;
  - ``remesh(device)``: the one-device counterpart of the reference's
    re-mesh, which moves the live state onto another device.

A step casts the f32 masters to bf16 compute leaves that require grad,
runs the bundle's ``loss_fn`` and ``backward``, takes the grads as f32 and
applies ``adamw_update`` to the masters in place.  The forward is the
reference's training formulation (plain attention under remat): no CUDA
kernel runs in it, and every kernel wrapper refuses a grad-requiring
input.  Mesh-sharded steps wait for the port's distribution module.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Callable, Dict, List, Optional

import torch

from repro_torch.device import DeviceLike, resolve_device
from repro_torch.training.checkpoint import (
    AsyncCheckpointer,
    latest_checkpoint,
    restore_checkpoint,
    save_checkpoint,
)
from repro_torch.training.data import DataConfig, SyntheticLM
from repro_torch.training.optimizer import AdamWConfig, adamw_update, init_opt_state
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


def _take_grad(leaf: torch.Tensor) -> torch.Tensor:
    """The leaf's grad as f32, releasing the bf16 grad (zeros if unused)."""
    g, leaf.grad = leaf.grad, None
    if g is None:
        return torch.zeros(leaf.shape, dtype=torch.float32, device=leaf.device)
    return g.float()


def _compute_leaf(p: torch.Tensor) -> torch.Tensor:
    if not p.is_floating_point():
        return p
    return p.to(torch.bfloat16).requires_grad_()


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

    # -- step ------------------------------------------------------------------
    def train_step(self, batch: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """One optimizer step on ``batch`` (tensors on the trainer's
        device; ``frames`` or ``patch_embeds`` beside ``tokens`` for the
        families with a frontend).  Returns 0-d tensors ``loss``,
        ``grad_norm``, ``lr``; nothing waits for the device."""
        loss, grads = self.loss_and_grads(batch)
        return {"loss": loss, **self.apply_grads(grads)}

    def loss_and_grads(self, batch: Dict[str, torch.Tensor]):
        """The step's first half: the loss of the bf16 casts of the
        masters, and its grads as f32 in the masters' tree."""
        compute = map_tree(_compute_leaf, self.params)
        loss = self.bundle.loss_fn(compute, batch)
        loss.backward()
        return loss.detach(), map_tree(_take_grad, compute)

    def apply_grads(self, grads) -> Dict[str, torch.Tensor]:
        """The step's second half: AdamW on the masters, in place."""
        self.params, self.opt_state, m = adamw_update(grads, self.opt_state, self.params,
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
        state = {"params": self.params, "opt": self.opt_state}
        meta = {"arch": self.cfg.name, "data_seed": self.data.cfg.seed}
        if self.ckpt:
            self.ckpt.save(self.ckpt_dir, self.step, state, meta)
        else:
            save_checkpoint(self.ckpt_dir, self.step, state, meta)

    def resume(self) -> bool:
        """Restore the latest checkpoint; returns True if one was loaded."""
        if self.ckpt:
            self.ckpt.wait()
        path = latest_checkpoint(self.ckpt_dir) if self.ckpt_dir else None
        if path is None:
            return False
        template = {"params": self.params, "opt": self.opt_state}
        step, state, _ = restore_checkpoint(path, template, self.device)
        self.params, self.opt_state = state["params"], state["opt"]
        self.step = step
        return True

    # -- elastic ----------------------------------------------------------------
    def remesh(self, device: DeviceLike) -> None:
        """Move training onto another device (the one-device counterpart of
        the reference's re-mesh: the state is device-agnostic, the live
        tensors are copied over).  Later steps run where the state is."""
        dev = resolve_device(device)
        self.params = map_tree(lambda t: t.to(dev), self.params)
        self.opt_state = map_tree(lambda t: t.to(dev), self.opt_state)
        self.device = dev

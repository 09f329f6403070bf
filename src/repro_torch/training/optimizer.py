"""AdamW with global-norm clipping and selectable moment precision
(the JAX package's ``training/optimizer.py`` in PyTorch).

State dtype options:
  - "fp32": standard Adam moments;
  - "bf16": both moments bf16;
  - "int8": first moment blockwise-int8 (per-256-element absmax scales
    along the last dim) + second moment bf16 — linear int8 cannot represent
    the dynamic range of v (tiny g^2 entries round to zero and the update
    explodes), so v keeps a float format.

Params are f32 masters; the model computes in bf16 casts of them.  The
update follows the reference op for op in f32 (``b1 ** step`` and the
warm-up included), under ``torch.no_grad``, and writes the new params and
moments into the given tensors (the reference donates its buffers to the
jitted step the same way).  Leaves of rank 3 or more update one slice of
the leading (layer) axis at a time, as the reference's ``jax.lax.map``
does, to bound the f32 temporaries to one layer's worth.
``opt_state_pspecs`` lays the moments out like their parameters (an int8
moment's ``q`` keeps the parameter's spec, its ``scale`` drops the last
dim's axis), as spec trees of ``repro_torch.sharding.rules``.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict

import torch
import torch.nn.functional as F

from repro_torch.sharding.rules import split_dim
from repro_torch.training.tree import leaves, map_tree

QBLOCK = 256


@dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    state_dtype: str = "fp32"  # fp32 | bf16 | int8
    warmup_steps: int = 100


# ---------------------------------------------------------------------------
# blockwise int8 quantization for moments
# ---------------------------------------------------------------------------


def _pad_to(x, mult):
    pad = (-x.shape[-1]) % mult
    if pad and hasattr(x, "device_mesh"):
        # a DTensor pads by concatenation: torch 2.11's rule for F.pad
        # returns a layout of the wrong rank on a multi-axis mesh
        x = torch.cat([x, x.new_zeros((*x.shape[:-1], pad))], dim=-1)
    elif pad:
        x = F.pad(x, (0, pad))
    return x, pad


def quantize_blockwise(x: torch.Tensor) -> Dict[str, torch.Tensor]:
    """x [..., n] -> {"q": int8 [..., n padded to 256], "scale": f32
    [..., blocks]}: absmax / 127 per block, values rounded half to even."""
    xp, _ = _pad_to(x.float(), QBLOCK)
    blocks = split_dim(xp, -1, (xp.shape[-1] // QBLOCK, QBLOCK))
    scale = blocks.abs().amax(dim=-1, keepdim=True) / 127.0
    q = torch.round(blocks / torch.clamp(scale, min=1e-12)).to(torch.int8)
    return {"q": q.reshape(xp.shape), "scale": scale[..., 0]}


def dequantize_blockwise(state: Dict[str, torch.Tensor], orig_last: int) -> torch.Tensor:
    q = state["q"].float()
    blocks = split_dim(q, -1, (q.shape[-1] // QBLOCK, QBLOCK))
    x = (blocks * state["scale"][..., None]).reshape(q.shape)
    return x[..., :orig_last]


# ---------------------------------------------------------------------------
# optimizer
# ---------------------------------------------------------------------------


def _role_dtype(state_dtype: str, role: str) -> str:
    """int8 applies to the first moment only; v falls back to bf16."""
    if state_dtype == "int8" and role == "v":
        return "bf16"
    return state_dtype


def _moment_init(p, state_dtype: str, role: str):
    sd = _role_dtype(state_dtype, role)
    if sd == "int8":
        return quantize_blockwise(torch.zeros(p.shape, dtype=torch.float32, device=p.device))
    dt = torch.float32 if sd == "fp32" else torch.bfloat16
    return torch.zeros(p.shape, dtype=dt, device=p.device)


def init_opt_state(params, config: AdamWConfig):
    device = leaves(params)[0].device
    return {
        "m": map_tree(lambda p: _moment_init(p, config.state_dtype, "m"), params),
        "v": map_tree(lambda p: _moment_init(p, config.state_dtype, "v"), params),
        "step": torch.zeros((), dtype=torch.int32, device=device),
    }


def _read_moment(mom, p, state_dtype: str, role: str):
    if _role_dtype(state_dtype, role) == "int8":
        return dequantize_blockwise(mom, p.shape[-1] if p.ndim else 1)
    return mom.float()


def _write_moment(dst, x, state_dtype: str, role: str) -> None:
    """Store the f32 moment x into ``dst`` in its format, in place."""
    if _role_dtype(state_dtype, role) == "int8":
        new = quantize_blockwise(x)
        dst["q"].copy_(new["q"])
        dst["scale"].copy_(new["scale"])
    else:
        dst.copy_(x)  # the cast to bf16 rounds to nearest even, as astype does


def global_norm(tree) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(torch.square(g.float())) for g in leaves(tree)))


def _slice(mom, i):
    return {k: v[i] for k, v in mom.items()} if isinstance(mom, dict) else mom[i]


@torch.no_grad()
def adamw_update(grads, opt_state, params, config: AdamWConfig):
    """One AdamW step; returns (params, opt_state, metrics).  ``params``
    and the moments of ``opt_state`` are updated in place and returned;
    the step counter is a new tensor.  metrics: ``grad_norm`` (before
    clipping) and ``lr``, 0-d f32 tensors on the params' device."""
    step = opt_state["step"] + 1
    stepf = step.float()
    gnorm = global_norm(grads)
    clip = torch.clamp(config.grad_clip / torch.clamp(gnorm, min=1e-12), max=1.0)
    warm = torch.clamp(stepf / max(config.warmup_steps, 1), max=1.0)
    lr = config.lr * warm
    b1, b2 = config.b1, config.b2
    f32 = dict(dtype=torch.float32, device=stepf.device)
    bc1 = 1.0 - torch.tensor(b1, **f32) ** stepf
    bc2 = 1.0 - torch.tensor(b2, **f32) ** stepf
    sd = config.state_dtype

    def leaf_update(p, g, m, v):
        g = g.float() * clip
        mf = _read_moment(m, p, sd, "m")
        vf = _read_moment(v, p, sd, "v")
        mf = b1 * mf + (1.0 - b1) * g
        vf = b2 * vf + (1.0 - b2) * torch.square(g)
        mhat = mf / bc1
        vhat = torch.clamp(vf / bc2, min=0.0)
        delta = mhat / (torch.sqrt(vhat) + config.eps) + config.weight_decay * p.float()
        p.copy_(p.float() - lr * delta)
        _write_moment(m, mf, sd, "m")
        _write_moment(v, vf, sd, "v")

    def upd(p, g, m, v):
        # layer-stacked leaves update one layer at a time (the reference's
        # lax.map): the f32 chain keeps ~10 temporaries of the leaf's size
        if p.ndim >= 3 and p.shape[0] > 1:
            for i in range(p.shape[0]):
                leaf_update(p[i], g[i], _slice(m, i), _slice(v, i))
        else:
            leaf_update(p, g, m, v)

    map_tree(upd, params, grads, opt_state["m"], opt_state["v"])
    new_state = {"m": opt_state["m"], "v": opt_state["v"], "step": step}
    return params, new_state, {"grad_norm": gnorm, "lr": lr}


def opt_state_pspecs(param_pspec_tree, param_shapes, config: AdamWConfig, mesh=None):
    """Shard optimizer moments like their parameters (scales: prefix spec).

    ``param_pspec_tree`` is ``sharding.rules.param_pspecs``'s tree; the
    specs are tuples, one entry per dim.  ``mesh`` is unused (the
    reference's signature)."""

    def one(role):
        def fn(spec, shape):
            if _role_dtype(config.state_dtype, role) != "int8":
                return spec
            # q keeps the param layout; scale drops sharding on the shrunk last dim
            scale = tuple(spec[:-1]) + (None,) if spec else ()
            return {"q": tuple(spec), "scale": scale}

        return map_tree(fn, param_pspec_tree, param_shapes)

    return {"m": one("m"), "v": one("v"), "step": ()}

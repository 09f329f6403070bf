"""Selective SSM (Mamba-style) layer used by the hymba hybrid (PyTorch).

Counterpart of the JAX package's ``models/ssm.py``, with the same names,
parameter tree and tensor layouts.  Recurrent formulation with a diagonal
state transition:
    h_t = exp(dt_t * A) * h_{t-1} + (dt_t * B_t) * x_t        (per channel, N states)
    y_t = C_t . h_t + D * x_t
Prefill walks the tokens in order (``chunked_recurrent_scan``: plain
PyTorch, as the JAX package's ``lax.scan`` runs outside any Pallas kernel).
Decode is a single O(1) state update.  With ``mesh`` the channels shard
over 'model' and the scan runs on each rank's shards.  The casts sit where the JAX package
puts them: the coefficients in float32, the scan output cast back to the
activations' dtype before the gate.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.models.layers import (
    DEFAULT_DTYPE,
    chunked_recurrent_scan,
    constrain,
    dense_init,
    mesh_axes,
    proj,
    shard_if,
    sharded_recurrent_scan,
)


def _dims(cfg):
    di = cfg.ssm.expand * cfg.d_model
    dt_rank = cfg.ssm.dt_rank or max(1, math.ceil(cfg.d_model / 16))
    return di, dt_rank, cfg.ssm.state_dim, cfg.ssm.conv_kernel


def softplus(x):
    """``jax.nn.softplus``: ``logaddexp(x, 0)`` at every x (torch's
    ``F.softplus`` returns x itself above its threshold)."""
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype, device=x.device))


def ssm_init(gen: torch.Generator, cfg, *, lead=()):
    """Parameters [*lead, ...]; the numbers differ from JAX's draws."""
    d = cfg.d_model
    di, dt_rank, N, K = _dims(cfg)
    dev = gen.device
    conv_w = torch.randn((*lead, K, di), generator=gen, device=dev).mul_(1.0 / math.sqrt(K))
    A_log = torch.log(torch.arange(1, N + 1, dtype=torch.float32, device=dev))
    return {
        "w_in": dense_init(gen, d, 2 * di, lead=lead),  # x and z (gate)
        "conv_w": conv_w.to(DEFAULT_DTYPE),
        "w_xproj": dense_init(gen, di, dt_rank + 2 * N, lead=lead),
        "w_dt": dense_init(gen, dt_rank, di, lead=lead),
        "dt_bias": torch.zeros((*lead, di), dtype=torch.float32, device=dev),
        "A_log": A_log.expand(*lead, di, N).clone(),
        "D": torch.ones((*lead, di), dtype=torch.float32, device=dev),
        "w_out": dense_init(gen, di, d, lead=lead),
    }


def ssm_state_init(cfg, batch: int, *, lead=(), device=None):
    di, _, N, K = _dims(cfg)
    return {
        "h": torch.zeros((*lead, batch, di, N), dtype=torch.float32, device=device),
        "conv": torch.zeros((*lead, batch, K - 1, di), dtype=DEFAULT_DTYPE, device=device),
    }


def _causal_conv(p, x, conv_state):
    """Depthwise causal conv1d.  x: [B, S, di]; conv_state: [B, K-1, di].
    The K products are summed in the JAX package's order and dtype."""
    K = p["conv_w"].shape[0]
    S = x.shape[1]
    xp = torch.cat([conv_state, x], dim=1)  # [B, K-1+S, di]
    out = sum(xp[:, i : i + S] * p["conv_w"][i] for i in range(K))
    new_state = xp[:, -(K - 1) :] if K > 1 else conv_state
    return F.silu(out), new_state


def _ssm_coeffs(p, cfg, xc, mesh=None):
    """xc: [B, S, di] post-conv activations -> (dA, dBx, C).  ``mesh``: dt
    keeps the channel layout and B, C the sequence whole, so the [B, S, di,
    N] coefficients form where the scan reads them."""
    _, dt_rank, N, _ = _dims(cfg)
    coef = proj(xc, p["w_xproj"])  # [B, S, dt_rank + 2N]
    coef = coef.float()  # slices, not torch.split: see ssm_forward's xi, z
    dt_r, Bmat, Cmat = (coef[..., :dt_rank], coef[..., dt_rank : dt_rank + N],
                        coef[..., dt_rank + N :])
    dt = softplus(proj(dt_r, p["w_dt"].float()) + p["dt_bias"])  # [B, S, di]
    if mesh is not None and "model" in mesh.mesh_dim_names:
        dt = _constrain_channels(dt, mesh)
        b = (shard_if(mesh, xc.shape[0], mesh_axes(mesh)[0]), None, None)
        Bmat, Cmat = constrain(Bmat, mesh, b), constrain(Cmat, mesh, b)
    A = -torch.exp(p["A_log"])  # [di, N]
    dA = torch.exp(dt[..., None] * A)  # [B, S, di, N]
    dBx = (dt * xc.float())[..., None] * Bmat[..., None, :]  # [B, S, di, N]
    return dA, dBx, Cmat


def _scan_step(h, inp):
    dA_t, dBx_t, C_t = inp
    h = dA_t * h + dBx_t
    y = torch.matmul(h, C_t[:, :, None])[..., 0]  # einsum("bdn,bn->bd")
    return h, y


def _constrain_channels(t, mesh, *, ch_dim=2):
    """SSM layout: sequence replicated, channels (d_inner) sharded over
    'model', batch over the data axes (the reference's: a recurrence is
    sequential over tokens and parallel over channels)."""
    if mesh is None or "model" not in mesh.mesh_dim_names:
        return t
    dp, _ = mesh_axes(mesh)
    spec = [None] * t.ndim
    spec[0] = shard_if(mesh, t.shape[0], dp)
    spec[ch_dim] = shard_if(mesh, t.shape[ch_dim], "model")
    return constrain(t, mesh, tuple(spec))


def _scan_step_state(st, inp):
    h, y = _scan_step(st["h"], inp)
    return {"h": h}, y


def ssm_forward(p, cfg, x, state, mesh=None):
    """x: [B, S, d] -> (y [B, S, d], new_state), the tokens in order.
    ``mesh``: channels sharded over 'model', the scan on local shards
    (``layers.sharded_recurrent_scan``)."""
    xz = proj(x, p["w_in"])
    # slices, not torch.chunk: chunk's backward concatenates the pieces'
    # grads, whose DTensor layouts differ and which DTensor cannot
    # concatenate (it has no rule from Shard to Partial)
    di = xz.shape[-1] // 2
    xi, z = xz[..., :di], xz[..., di:]
    xi = _constrain_channels(xi, mesh)
    z = _constrain_channels(z, mesh)
    # the conv state [B, K-1, di] takes xi's layout, so the concatenation
    # in the conv keeps d_inner sharded
    xc, conv_state = _causal_conv(p, xi, _constrain_channels(state["conv"], mesh))
    dA, dBx, Cmat = _ssm_coeffs(p, cfg, xc, mesh)
    to_s = lambda a: a.movedim(1, 0)
    xs = (to_s(dA), to_s(dBx), to_s(Cmat))
    if mesh is None:
        h, ys = chunked_recurrent_scan(_scan_step, state["h"], xs, chunk=128)  # ys [S, B, di]
    else:
        dp, _ = mesh_axes(mesh)
        b = shard_if(mesh, x.shape[0], dp)
        c = shard_if(mesh, dA.shape[2], "model")
        carry, ys = sharded_recurrent_scan(
            _scan_step_state, {"h": state["h"]}, xs, mesh=mesh, init_specs={"h": (b, c, None)},
            xs_specs=((None, b, c, None), (None, b, c, None), (None, b, None)),
            ys_spec=(None, b, c), chunk=128)
        h = carry["h"]
    y = ys.transpose(0, 1) + p["D"] * xc.float()
    out = proj(y.to(x.dtype) * F.silu(z), p["w_out"])
    return out, {"h": h, "conv": conv_state}


def ssm_decode(p, cfg, x, state, mesh=None):
    """Single-token step.  x: [B, 1, d]."""
    return ssm_forward(p, cfg, x, state, mesh=mesh)

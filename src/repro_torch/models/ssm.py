"""Selective SSM (Mamba-style) layer used by the hymba hybrid (PyTorch).

Counterpart of the JAX package's ``models/ssm.py``, with the same names,
parameter tree and tensor layouts.  Recurrent formulation with a diagonal
state transition:
    h_t = exp(dt_t * A) * h_{t-1} + (dt_t * B_t) * x_t        (per channel, N states)
    y_t = C_t . h_t + D * x_t
Prefill walks the tokens in order (``chunked_recurrent_scan``: plain
PyTorch, as the JAX package's ``lax.scan`` runs outside any Pallas kernel).
Decode is a single O(1) state update.  The casts sit where the JAX package
puts them: the coefficients in float32, the scan output cast back to the
activations' dtype before the gate.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.models.layers import DEFAULT_DTYPE, chunked_recurrent_scan, dense_init


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


def _ssm_coeffs(p, cfg, xc):
    """xc: [B, S, di] post-conv activations -> (dA, dBx, C)."""
    _, dt_rank, N, _ = _dims(cfg)
    proj = xc @ p["w_xproj"]  # [B, S, dt_rank + 2N]
    dt_r, Bmat, Cmat = torch.split(proj.float(), [dt_rank, N, N], dim=-1)
    dt = softplus(dt_r @ p["w_dt"].float() + p["dt_bias"])  # [B, S, di]
    A = -torch.exp(p["A_log"])  # [di, N]
    dA = torch.exp(dt[..., None] * A)  # [B, S, di, N]
    dBx = (dt * xc.float())[..., None] * Bmat[..., None, :]  # [B, S, di, N]
    return dA, dBx, Cmat


def _scan_step(h, inp):
    dA_t, dBx_t, C_t = inp
    h = dA_t * h + dBx_t
    y = torch.matmul(h, C_t[:, :, None])[..., 0]  # einsum("bdn,bn->bd")
    return h, y


def ssm_forward(p, cfg, x, state):
    """x: [B, S, d] -> (y [B, S, d], new_state), the tokens in order."""
    xz = x @ p["w_in"]
    xi, z = torch.chunk(xz, 2, dim=-1)
    xc, conv_state = _causal_conv(p, xi, state["conv"])
    dA, dBx, Cmat = _ssm_coeffs(p, cfg, xc)
    to_s = lambda a: a.movedim(1, 0)
    h, ys = chunked_recurrent_scan(
        _scan_step, state["h"], (to_s(dA), to_s(dBx), to_s(Cmat)), chunk=128
    )  # ys [S, B, di]
    y = ys.transpose(0, 1) + p["D"] * xc.float()
    out = (y.to(x.dtype) * F.silu(z)) @ p["w_out"]
    return out, {"h": h, "conv": conv_state}


def ssm_decode(p, cfg, x, state):
    """Single-token step.  x: [B, 1, d]."""
    return ssm_forward(p, cfg, x, state)

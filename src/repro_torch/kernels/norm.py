"""The norms, each in one launch: a hand-written CUDA kernel
(``csrc/norm.cu``) and its plain PyTorch version.

``norm(x, weight, bias=None, *, kind, eps)`` is the reference's
``rms_norm`` (``kind="rms"``) or ``layer_norm`` (``kind="layer"``) over the
last dim (``src/repro/models/layers.py:140-152``): in f32 from ``x``'s
elements and the weight's, cast back to ``x``'s type.  ``x`` is bf16 or f32
of any leading shape; ``weight`` (and ``bias``) has a suffix of ``x``'s
shape: ``[d]``, or per head (xlstm's ``hnorm`` ``[nh, dh]``: row r takes
weight row r mod nh).

It replaces no TPU kernel: the reference runs ``jnp.mean`` / ``jnp.var`` and
``rsqrt`` as XLA ops.  On the card the port ran each norm as eight plain
passes around a row-statistic kernel that gave every row one reduction
order, whatever the rows beside it (a decode step, a prefill chunk and a
fused launch of both must norm a row to the same bits).  The kernel keeps
that order and computes the whole norm in one pass: x read once, y written
once, every later operation rounded as the plain chain rounds it, so its
output is bitwise the route it replaces.  It is bound by bytes; rows up to
2048 wide stay in registers between the statistic and the output, wider
rows are read again from L1/L2, and the grid fills the SMs at any row
count (``csrc/norm.cu`` says how).

``ordered_stat`` writes that order out in torch f32 adds (lanes x 4-element
steps, then the xor-shuffle tree, then the division), and
``replaced_route`` follows it with ``norm_ref``'s elementwise chain: the
route the kernel replaced, which the tests and ``chip_smoke.py`` hold the
kernel against bitwise on the card.

Dispatch: an input that requires grad raises on either device
(``guard.refuse_grad``: no backward; training keeps the plain version, see
``models.layers``); a CPU tensor goes to ``norm_ref``; a CUDA tensor
launches the kernel or raises (an unsupported dtype, a weight whose shape
is not a suffix of ``x``'s, a failed launch); any other device raises.  A
non-contiguous input is copied contiguous first.  ``norm.launches`` counts
kernel launches.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.kernels.guard import refuse_grad

KINDS = {"rms": 0, "layer": 1}
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _lib() -> ctypes.CDLL:
    lib = build.load("norm")
    fn = lib.norm_forward
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                       ctypes.c_int64, ctypes.c_int, ctypes.c_int64, ctypes.c_float,
                       ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        probe = lib.norm_rsqrt_probe
        probe.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p]
        probe.restype = ctypes.c_int
    return lib


def library_stat(xf: torch.Tensor, stat: str) -> torch.Tensor:
    """A norm's statistic over the last dim as the plain version takes it:
    ``torch.mean`` / ``torch.var`` (population), ``[..., 1]``."""
    if stat == "mean":
        return torch.mean(xf, dim=-1, keepdim=True)
    if stat == "mean_square":
        return torch.mean(xf * xf, dim=-1, keepdim=True)
    if stat == "var":
        return torch.var(xf, dim=-1, keepdim=True, unbiased=False)
    raise ValueError(f"norm: unknown statistic {stat!r}")


def ordered_stat(xf: torch.Tensor, stat: str) -> torch.Tensor:
    """The kernel's statistic in its order, in torch f32 ops (tests only):
    lane l sums the terms 4 (l + 32 k) + j, k ascending, j = 0..3; the 32
    lane sums meet in the xor-shuffle tree 16, 8, 4, 2, 1; the sum is
    divided by d (by a tensor: torch multiplies by the reciprocal of a
    Python scalar).  The variance is about this mean.  Padding adds +0.0,
    which leaves a sum that starts at +0.0 unchanged."""
    if stat == "var":
        c = xf - ordered_stat(xf, "mean")
        t = c * c
    elif stat in ("mean", "mean_square"):
        t = xf if stat == "mean" else xf * xf
    else:
        raise ValueError(f"norm: unknown statistic {stat!r}")
    *lead, d = t.shape
    nk = -(-d // 128)
    t = torch.nn.functional.pad(t, (0, 128 * nk - d)).reshape(*lead, nk, 32, 4)
    s = torch.zeros((*lead, 32), dtype=torch.float32, device=t.device)
    for k in range(nk):
        for j in range(4):
            s = s + t[..., k, :, j]
    lanes = torch.arange(32, device=t.device)
    for off in (16, 8, 4, 2, 1):
        s = s + s[..., lanes ^ off]
    return s[..., :1] / torch.full_like(s[..., :1], float(d))


def _check(x, weight, bias, kind):
    if kind not in KINDS:
        raise ValueError(f"norm: unknown kind {kind!r} (rms or layer)")
    if (bias is None) != (kind == "rms"):
        raise ValueError(f"norm: the {kind} norm takes {'no bias' if kind == 'rms' else 'a bias'}")
    for name, t in (("weight", weight), ("bias", bias)):
        if t is None:
            continue
        if t.dim() == 0 or t.dim() > x.dim() or tuple(t.shape) != tuple(x.shape[x.dim() - t.dim():]):
            raise ValueError(f"norm: {name} {tuple(t.shape)} is not a suffix of x's shape "
                             f"{tuple(x.shape)}")


def _chain(x, weight, bias, kind, eps, stat):
    _check(x, weight, bias, kind)
    xf = x.float()
    if kind == "rms":
        out = xf * torch.rsqrt(stat(xf, "mean_square") + eps)
        return (out * weight.float()).to(x.dtype)
    out = (xf - stat(xf, "mean")) * torch.rsqrt(stat(xf, "var") + eps)
    return (out * weight.float() + bias.float()).to(x.dtype)


def norm_ref(x, weight, bias=None, *, kind: str, eps: float):
    """The plain version: the reference's formulas in f32, the statistics
    from ``torch.mean`` / ``torch.var`` (``library_stat``)."""
    return _chain(x, weight, bias, kind, eps, library_stat)


def replaced_route(x, weight, bias=None, *, kind: str, eps: float):
    """The route the kernel replaced (tests only): ``norm_ref``'s
    elementwise chain on the statistics of ``ordered_stat``."""
    return _chain(x, weight, bias, kind, eps, ordered_stat)


def norm(x, weight, bias=None, *, kind: str, eps: float):
    """``kind`` norm of ``x`` [..., d] with ``weight`` (and ``bias``), in
    ``x``'s dtype."""
    refuse_grad("norm", x, weight, bias)
    _check(x, weight, bias, kind)
    if x.device.type == "cpu":
        return norm_ref(x, weight, bias, kind=kind, eps=eps)
    if x.device.type != "cuda":
        raise ValueError(f"norm: unsupported device {x.device}")
    for name, t in (("x", x), ("weight", weight), ("bias", bias)):
        if t is None:
            continue
        if t.dtype not in _DTYPES:
            raise TypeError(f"norm: {name} dtype {t.dtype} not supported (float32, bfloat16)")
        if t.device != x.device:
            raise ValueError(f"norm: {name} on {t.device}, x on {x.device}")
    if bias is not None and bias.dtype != weight.dtype:
        raise TypeError(f"norm: bias dtype {bias.dtype} is not the weight's {weight.dtype}")
    d = x.shape[-1]
    if d == 0:
        raise ValueError("norm: rows of width 0 have no statistic")
    out = torch.empty(x.shape, dtype=x.dtype, device=x.device)
    R = out.numel() // d
    if R == 0:
        return out
    x = x.contiguous()
    weight = weight.contiguous()
    bias = bias.contiguous() if bias is not None else None
    vec = lambda t: d % 4 == 0 and t.data_ptr() % (4 * t.element_size()) == 0
    flags = (vec(x) | vec(weight) << 1 | (bias is not None and vec(bias)) << 2
             | vec(out) << 3)
    rc = build.launch(_lib().norm_forward, x.device, x.data_ptr(), weight.data_ptr(),
                      None if bias is None else bias.data_ptr(), out.data_ptr(), R, d,
                      weight.numel() // d, eps, KINDS[kind], _DTYPES[x.dtype],
                      _DTYPES[weight.dtype], flags)
    if rc != 0:
        raise RuntimeError(f"norm: kernel launch failed (CUDA error {rc})")
    norm.launches += 1
    return out


norm.launches = 0


def rsqrt_probe(t: torch.Tensor) -> torch.Tensor:
    """The kernel's ``rsqrtf`` over a CUDA f32 tensor (tests only: held
    against ``torch.rsqrt``)."""
    if t.device.type != "cuda" or t.dtype != torch.float32:
        raise ValueError("rsqrt_probe: a CUDA float32 tensor")
    t = t.contiguous()
    out = torch.empty_like(t)
    rc = build.launch(_lib().norm_rsqrt_probe, t.device, t.data_ptr(), out.data_ptr(), t.numel())
    if rc != 0:
        raise RuntimeError(f"rsqrt_probe: kernel launch failed (CUDA error {rc})")
    return out

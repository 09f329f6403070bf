"""The norms (``repro_torch.kernels.norm``) on the CPU, against the JAX
package's ``rms_norm`` / ``layer_norm`` (``src/repro/models/layers.py``).

The same numpy inputs from a seed go through the JAX function, the port's
plain version ``norm_ref``, its wrapper ``norm`` (a CPU tensor takes the
plain version) and ``layers.rms_norm`` / ``layer_norm`` (the CPU route), in
float32 and bfloat16, at widths 2048 (qwen3-1.7b), 128 (its qk-norm), 2047
(not a multiple of 4: the kernel's scalar loads) and 768 (whisper-small),
with ``[d]`` weights and xlstm's per-head ``[nh, dh]`` weights.

Tolerances: float32 within 1e-6 (relative and absolute; the two packages
sum a row in other orders: measured max |d| 9.5e-7 over outputs up to
10.7 in magnitude); bfloat16 within one bf16 spacing of the output (2^-7
relative, no absolute term: an f32 result on a rounding boundary rounds
either way; measured max |d| 0 for the RMS norm, 4.9e-4 for the layer
norm, 4.4e-3 relative).  The CPU route is bitwise the formula it replaced,
so the training forward and
``tests/torch_forward_digest.py``'s digests do not move.  ``ordered_stat``
(the kernel's summation order in torch ops, which the card tests hold the
kernel against) is within 1e-6 of ``torch.mean`` / ``torch.var``, and
``replaced_route`` (that order, then the elementwise chain) within 1e-6 of
``norm_ref``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.models.layers as jl
from repro_torch.kernels import norm as nm
from repro_torch.models import layers as tl

JAX_NORM = {"rms": lambda x, w, b: jl.rms_norm(x, w), "layer": jl.layer_norm}
TORCH_NORM = {"rms": lambda x, w, b: tl.rms_norm(x, w), "layer": tl.layer_norm}
EPS = {"rms": 1e-6, "layer": 1e-5}  # the defaults of both packages
# (x shape, weight shape): rows of 2048, 128, 2047, 768; per-head [nh, dh]
SHAPES = {"2048": ((3, 5, 2048), (2048,)), "128": ((4, 16, 128), (128,)),
          "2047": ((3, 5, 2047), (2047,)), "768": ((2, 7, 768), (768,)),
          "per_head": ((2, 6, 4, 256), (4, 256))}
TOL = {torch.float32: dict(rtol=1e-6, atol=1e-6), torch.bfloat16: dict(rtol=2 ** -7, atol=0)}
J_DTYPE = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}


def _inputs(shape, wshape, seed):
    rng = np.random.default_rng(seed)
    x = (rng.normal(size=shape) * rng.uniform(0.5, 3.0, size=shape[:-1] + (1,))).astype(np.float32)
    w = rng.normal(size=wshape).astype(np.float32)
    b = rng.normal(size=wshape).astype(np.float32)
    return x, w, b


@pytest.mark.parametrize("shape", list(SHAPES))
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("kind", ["rms", "layer"])
def test_norm_matches_jax(kind, dtype, shape):
    """norm_ref, norm on a CPU tensor and the layers' CPU route against the
    JAX package (the module's tolerance); the three port routes equal."""
    xs, ws = SHAPES[shape]
    x, w, b = _inputs(xs, ws, seed=len(xs) * 1000 + xs[-1])
    jd = J_DTYPE[dtype]
    want = JAX_NORM[kind](jnp.asarray(x).astype(jd), jnp.asarray(w).astype(jd),
                          jnp.asarray(b).astype(jd))
    want = torch.from_numpy(np.array(want.astype(jnp.float32)))
    tx, tw, tb = (torch.from_numpy(a).to(dtype) for a in (x, w, b))
    bias = tb if kind == "layer" else None
    ref = nm.norm_ref(tx, tw, bias, kind=kind, eps=EPS[kind])
    n0 = nm.norm.launches
    got = nm.norm(tx, tw, bias, kind=kind, eps=EPS[kind])
    assert nm.norm.launches == n0
    layer = TORCH_NORM[kind](tx, tw, tb)
    for t in (ref, got, layer):
        assert t.dtype == dtype and t.shape == tx.shape
    assert torch.equal(got, ref) and torch.equal(layer, ref)
    torch.testing.assert_close(ref.float(), want, **TOL[dtype])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("kind", ["rms", "layer"])
def test_norm_cpu_route_is_the_formula_it_replaces(kind, dtype):
    """The layers' CPU route, bitwise the plain chain the port ran before
    the kernel (``torch.mean`` / ``torch.var`` and the elementwise ops)."""
    x, w, b = (torch.from_numpy(a).to(dtype) for a in _inputs((4, 9, 2048), (2048,), seed=7))
    xf = x.float()
    if kind == "rms":
        var = torch.mean(xf * xf, dim=-1, keepdim=True)
        want = (xf * torch.rsqrt(var + 1e-6) * w.float()).to(dtype)
        got = tl.rms_norm(x, w)
    else:
        mu = torch.mean(xf, dim=-1, keepdim=True)
        var = torch.var(xf, dim=-1, keepdim=True, unbiased=False)
        want = ((xf - mu) * torch.rsqrt(var + 1e-5) * w.float() + b.float()).to(dtype)
        got = tl.layer_norm(x, w, b)
    assert torch.equal(got, want)


@pytest.mark.parametrize("stat", ["mean", "mean_square", "var"])
def test_ordered_stat_is_within_f32_of_the_library(stat):
    """The kernel's order written out in torch f32 ops, against
    ``torch.mean`` / ``torch.var`` over rows of 2048, 128, 2047 and 5 (one
    lane's chunk only partly filled), 1e-6."""
    x = torch.from_numpy(_inputs((6, 4, 2048), (2048,), seed=40)[0] * 3.0)
    for a in (x, x[..., :128], x[..., :2047], x[..., :5]):
        torch.testing.assert_close(nm.ordered_stat(a, stat), nm.library_stat(a, stat),
                                   rtol=1e-6, atol=1e-6)



@pytest.mark.parametrize("kind", ["rms", "layer"])
def test_replaced_route_is_within_f32_of_norm_ref(kind):
    """``replaced_route`` (which the card tests hold the kernel against
    bitwise) is ``norm_ref`` but for the statistic's order: within 1e-6 of
    it in float32 at every shape of SHAPES."""
    for xs, ws in SHAPES.values():
        x, w, b = (torch.from_numpy(a) for a in _inputs(xs, ws, seed=41))
        b = b if kind == "layer" else None
        got = nm.replaced_route(x, w, b, kind=kind, eps=EPS[kind])
        want = nm.norm_ref(x, w, b, kind=kind, eps=EPS[kind])
        torch.testing.assert_close(got, want, **TOL[torch.float32])

def _raises(case):
    x = torch.ones((2, 8))
    w = torch.ones((8,))
    if case == "grad":
        with pytest.raises(RuntimeError, match="no backward"):
            nm.norm(x.clone().requires_grad_(), w, kind="rms", eps=1e-6)
    elif case == "kind":
        with pytest.raises(ValueError, match="unknown kind"):
            nm.norm(x, w, kind="batch", eps=1e-6)
    elif case == "weight_not_suffix":
        with pytest.raises(ValueError, match="not a suffix"):
            nm.norm(x, torch.ones((2,)), kind="rms", eps=1e-6)
        with pytest.raises(ValueError, match="not a suffix"):
            nm.norm(x, torch.ones((3, 8)), kind="rms", eps=1e-6)
        with pytest.raises(ValueError, match="not a suffix"):
            nm.norm(x, w, torch.ones((4,)), kind="layer", eps=1e-5)
    elif case == "bias":
        with pytest.raises(ValueError, match="no bias"):
            nm.norm(x, w, w, kind="rms", eps=1e-6)
        with pytest.raises(ValueError, match="a bias"):
            nm.norm(x, w, kind="layer", eps=1e-5)
    elif case == "device":
        with pytest.raises(ValueError, match="unsupported device"):
            nm.norm(x.to("meta"), w.to("meta"), kind="rms", eps=1e-6)


@pytest.mark.parametrize("case", ["grad", "kind", "weight_not_suffix", "bias", "device"])
def test_norm_refuses_on_the_cpu(case):
    """A grad-requiring input, an unknown kind, a weight or bias whose shape
    is not a suffix of x's, a bias given to the RMS norm or missing from
    the layer norm, and a device that is neither the CPU nor CUDA raise
    before any launch."""
    n0 = nm.norm.launches
    _raises(case)
    assert nm.norm.launches == n0


def test_norm_under_no_grad_on_the_cpu_takes_the_plain_route():
    """Under ``torch.no_grad`` (the serving paths) a CPU tensor still takes
    the plain version: no launch is counted, and the bits are norm_ref's."""
    x, w, b = (torch.from_numpy(a) for a in _inputs((5, 768), (768,), seed=3))
    n0 = nm.norm.launches
    with torch.no_grad():
        got = (tl.rms_norm(x, w), tl.layer_norm(x, w, b))
    assert nm.norm.launches == n0
    assert torch.equal(got[0], nm.norm_ref(x, w, kind="rms", eps=1e-6))
    assert torch.equal(got[1], nm.norm_ref(x, w, b, kind="layer", eps=1e-5))

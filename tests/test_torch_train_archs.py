"""Every family's training objective in the port against the JAX package.

For each config of ``repro_torch.configs`` at its reduced size, the same
parameters (the JAX init, bridged by ``params_from_jax``) and the same
numpy batch (tokens, plus ``frames`` for whisper and ``patch_embeds`` for
phi-3-vision) go through the JAX ``bundle.loss_fn`` under
``jax.value_and_grad`` and the port's ``bundle.loss_fn`` under
``torch.autograd.grad``, in float32 and in bfloat16.

Tolerances, set from the measured worst case over the ten configs:
  - float32: loss within 1e-5 (measured max |d| 4.8e-7), every grad leaf
    within 1e-5 of that leaf's largest |g| (measured 1.3e-6, hymba's embed);
  - bfloat16: loss within 5e-3 (measured 7.3e-4, qwen3), every grad leaf
    within 4e-2 of its largest |g| (measured 2.1e-2, hymba's embed: about
    five bf16 ulps, the two frameworks rounding bf16 matmuls and sums in
    different orders).
Also: the training attention and cross-entropy over several blocks and
chunks against the reference's under ``jax.grad``, the analytic parameter
counts equal the reference's for all ten configs at full size, and no
kernel wrapper takes an input that requires grad.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config, reduced
from repro.models.registry import analytic_param_count as jax_count
from repro.models.registry import build_model as jax_build_model
from repro_torch import configs as t_configs
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import kv_block_copy as kbc
from repro_torch.kernels import paged_attention as pa
from repro_torch.kernels.guard import refuse_grad
from repro_torch.models.registry import analytic_param_count, build_model
from repro_torch.params import params_from_jax
from repro_torch.training.tree import leaves_with_paths

ARCHS = sorted(t_configs.ARCHITECTURES)
TOL = {"float32": dict(loss=1e-5, grad=1e-5), "bfloat16": dict(loss=5e-3, grad=4e-2)}


def _batch(cfg, B=2, S=16):
    rng = np.random.default_rng(0)
    b = {"tokens": rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)}
    if cfg.frontend == "audio_frames":
        b["frames"] = rng.normal(size=(B, 8, cfg.d_model)).astype(np.float32)
    if cfg.frontend == "image_patches":
        b["patch_embeds"] = rng.normal(size=(B, cfg.frontend_len, cfg.d_model)).astype(np.float32)
    return b


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", ARCHS)
def test_loss_and_grads_match_jax(name, dtype):
    cfg = reduced(get_config(name))
    jd = jnp.float32 if dtype == "float32" else jnp.bfloat16
    td = torch.float32 if dtype == "float32" else torch.bfloat16
    jb = jax_build_model(cfg)
    params = jax.tree.map(
        lambda a: a.astype(jd) if jnp.issubdtype(a.dtype, jnp.floating) else a,
        jb.init_params(jax.random.PRNGKey(0)),
    )
    batch = _batch(cfg)
    jbatch = {k: jnp.asarray(v, jd) if v.dtype == np.float32 else jnp.asarray(v)
              for k, v in batch.items()}
    want_loss, want_grads = jax.jit(jax.value_and_grad(jb.loss_fn))(params, jbatch)
    want = dict(leaves_with_paths(jax.tree.map(lambda a: np.asarray(a, np.float32), want_grads)))

    tparams = params_from_jax(jax.tree.map(np.asarray, params), "cpu")
    paths, leaves = zip(*leaves_with_paths(tparams))
    for t in leaves:
        t.requires_grad_()
    tbatch = {k: torch.from_numpy(v).to(td) if v.dtype == np.float32 else torch.from_numpy(v)
              for k, v in batch.items()}
    bundle = build_model(t_configs.reduced(t_configs.get_config(name)), device="cpu")
    loss = bundle.loss_fn(tparams, tbatch)
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)

    tol = TOL[dtype]
    d_loss = abs(float(loss.detach()) - float(want_loss))
    assert loss.dtype == torch.float32 and loss.dim() == 0
    assert d_loss <= tol["loss"], f"{name} {dtype}: loss max |d| {d_loss:.3e}"
    worst, where = 0.0, None
    for path, g in zip(paths, grads):
        ref = want[path]
        got = np.zeros_like(ref) if g is None else g.float().numpy()
        rel = float(np.abs(got - ref).max()) / max(float(np.abs(ref).max()), 1e-30)
        if rel > worst:
            worst, where = rel, "/".join(path)
    assert worst <= tol["grad"], f"{name} {dtype}: grad max |d| {worst:.3e} of max |g| at {where}"


@pytest.mark.parametrize("name", ARCHS)
def test_param_counts_match_reference(name):
    """Full size, no allocation: ``analytic_param_count`` and the config's
    ``param_count``/``active_param_count`` equal the reference's."""
    tcfg, jcfg = t_configs.get_config(name), get_config(name)
    for active in (False, True):
        assert analytic_param_count(tcfg, active_only=active) == jax_count(jcfg, active_only=active)
    assert tcfg.param_count() == jcfg.param_count()
    assert tcfg.active_param_count() == jcfg.active_param_count()


def test_shapes_match_reference():
    from repro.configs import ALL_SHAPES, shape_applicable

    assert [(s.name, s.seq_len, s.global_batch, s.kind, s.tokens_per_step)
            for s in t_configs.ALL_SHAPES] == [
        (s.name, s.seq_len, s.global_batch, s.kind, s.tokens_per_step) for s in ALL_SHAPES]
    for name in ARCHS:
        for ts, js in zip(t_configs.ALL_SHAPES, ALL_SHAPES):
            assert t_configs.shape_applicable(t_configs.get_config(name), ts) == \
                shape_applicable(get_config(name), js)


def test_refuse_grad_helper():
    x = torch.zeros(2, requires_grad=True)
    with pytest.raises(RuntimeError, match="k: the kernel has no backward"):
        refuse_grad("k", torch.zeros(2), x)
    refuse_grad("k", torch.zeros(2), 3)  # nothing requires grad
    with torch.no_grad():
        refuse_grad("k", x)  # grad disabled: the serving paths


def _wrapper_calls():
    """Each wrapper on small CPU operands; ``grad`` marks which operand
    requires grad."""
    def t(*shape, grad=False, dtype=torch.float32):
        return torch.zeros(shape, dtype=dtype).requires_grad_(grad)

    i32 = dict(dtype=torch.int32)
    return {
        "flash_attention": lambda g: fa.flash_attention(t(1, 2, 4, 8, grad=g), t(1, 2, 4, 8),
                                                        t(1, 2, 4, 8)),
        "paged_decode_attention": lambda g: pa.paged_decode_attention(
            t(1, 1, 2, 8), t(1, 2, 4, 8, grad=g), t(1, 2, 4, 8), t(1, 1, **i32),
            t(1, **i32), t(1, 1, 2, 8), t(1, 1, 2, 8), t(1, 2, **i32) - 1, t(1, **i32)),
        "paged_prefill_attention": lambda g: pa.paged_prefill_attention(
            t(1, 1, 2, 4, 8), t(1, 2, 4, 8), t(1, 2, 4, 8), t(1, 1, **i32), t(1, **i32),
            t(1, 1, 4, 8, grad=g), t(1, 1, 4, 8)),
        "paged_attention": lambda g: pa.paged_attention(
            t(1, 1, 2, 8, grad=g), t(1, 2, 4, 8), t(1, 2, 4, 8), t(1, 1, **i32),
            t(1, **i32) + 1),
        "kv_block_copy": lambda g: kbc.kv_block_copy(t(2, 4, 1, 8, grad=g), [1, 0]),
    }


@pytest.mark.parametrize("kernel", sorted(_wrapper_calls()))
def test_kernel_wrappers_refuse_grad(kernel):
    """A CUDA kernel has no backward, so a training forward must never
    reach one.  Every wrapper refuses a grad-requiring input on either
    device (here on the CPU, where it would otherwise take the plain
    version); with no operand requiring grad, or under no_grad, it runs."""
    call = _wrapper_calls()[kernel]
    with pytest.raises(RuntimeError, match=f"{kernel}: the kernel has no backward"):
        call(True)
    call(False)
    with torch.no_grad():
        call(True)


@pytest.mark.parametrize("causal,window,softcap", [(True, 0, 0.0), (True, 12, 0.0),
                                                   (True, 0, 30.0), (False, 0, 0.0)])
def test_attention_prefill_remat_grads_match_jax(causal, window, softcap):
    """The training attention over several query blocks and key chunks
    (S = 40 in blocks of 8 queries and 16 keys, a ragged last block), its
    value and the grads of q, k and v against the reference's
    ``attention_prefill`` under ``jax.grad`` in f32 (1e-5; measured max
    |d| 6.6e-7 for the value, 1.7e-6 for the grads, with soft-cap 30)."""
    from repro.models import layers as jl
    from repro_torch.models import layers as tl

    rng = np.random.default_rng(5)
    B, S, H, KV, D = 2, 40, 4, 2, 16
    q, k, v = (rng.normal(size=(B, S, n, D)).astype(np.float32) for n in (H, KV, KV))
    w = rng.normal(size=(B, S, H, D)).astype(np.float32)  # a random cotangent
    pos = np.broadcast_to(np.arange(S), (B, S)).astype(np.int32)
    kw = dict(causal=causal, window=window, softcap=softcap, q_chunk=8, kv_chunk=16)

    def jloss(q, k, v):
        out = jl.attention_prefill(q, k, v, q_positions=jnp.asarray(pos),
                                   kv_positions=jnp.asarray(pos), **kw)
        return jnp.sum(out * w), out

    (_, want), jg = jax.value_and_grad(jloss, argnums=(0, 1, 2), has_aux=True)(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    tq, tk, tv = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    out = tl.attention_prefill(tq, tk, tv, q_positions=torch.from_numpy(pos),
                               kv_positions=torch.from_numpy(pos), remat=True, **kw)
    tg = torch.autograd.grad((out * torch.from_numpy(w)).sum(), (tq, tk, tv))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
    for a, b in zip(tg, jg):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5, atol=1e-5)


def test_chunked_cross_entropy_matches_jax():
    """Several chunks (S = 20 in chunks of 8), -1 labels and a label past
    V: the value and the grads of x and the unembedding against the
    reference in f32 (1e-6; measured: the value equal, the grads 3.0e-8)."""
    from repro.models import layers as jl
    from repro_torch.models import layers as tl

    rng = np.random.default_rng(6)
    x = rng.normal(size=(2, 20, 16)).astype(np.float32)
    w = rng.normal(size=(16, 50)).astype(np.float32)
    labels = rng.integers(0, 50, (2, 20)).astype(np.int32)
    labels[0, 3:9] = -1
    labels[1, -1] = -1
    labels[1, 5] = 60  # outside [0, V): picks no logit in either package
    want, jg = jax.value_and_grad(
        lambda x, w: jl.chunked_cross_entropy(x, w, jnp.asarray(labels), chunk=8), argnums=(0, 1)
    )(jnp.asarray(x), jnp.asarray(w))
    tx, tw = torch.from_numpy(x).requires_grad_(), torch.from_numpy(w).requires_grad_()
    got = tl.chunked_cross_entropy(tx, tw, torch.from_numpy(labels), chunk=8)
    tg = torch.autograd.grad(got, (tx, tw))
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=1e-6)
    for a, b in zip(tg, jg):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6, atol=1e-6)

"""tests/test_smoke_archs.py's serving halves held against the port (CPU).

For every config at its reduced size, ``test_prefill_then_decode`` runs
the reference's prefill (cache_len 32) and two greedy decode steps in the
JAX package and in the port over the same parameters (the JAX init from
PRNGKey 1, cast to float32 and bridged by ``params_from_jax``) and the
same numpy batch (tokens, plus ``frames`` for whisper and
``patch_embeds`` for phi-3-vision): the port keeps the reference test's
assertions (shapes, finite logits), the prefill logits match the
reference's within 1e-4 and each decode step's within 5e-4 (float32
weights; both packages keep the KV cache in bfloat16, and the decode steps
read it back: measured worst 1.2e-4, deepseek-7b, h2o-danube-1.8b and
stablelm-12b).  The port feeds each step the reference's argmax, so one
flipped argmax cannot fork the two runs.
``test_decode_matches_prefill_dense`` holds the port's teacher-forced
decode against its own prefill at the reference test's 2e-2, and against
the reference's decode logits at 5e-4.  The training halves of
tests/test_smoke_archs.py (finite loss and grads) are held by
tests/test_torch_train_archs.py, which matches every config's loss and
grads against ``jax.value_and_grad``, so they are not repeated here.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config, reduced
from repro.models.registry import build_model as jax_build_model
from repro_torch import configs as t_configs
from repro_torch.models.registry import build_model
from repro_torch.params import params_from_jax
from torch_one_thread import one_torch_thread  # noqa: F401  (autouse fixture)

ARCHS = sorted(t_configs.ARCHITECTURES)
TOL = dict(rtol=1e-4, atol=1e-4)
TOL_DECODE = dict(rtol=5e-4, atol=5e-4)  # steps that read the bf16 KV cache


def _batch_for(cfg, B=2, S=16):
    rng = np.random.default_rng(0)
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)}
    if cfg.frontend == "image_patches":
        batch["patch_embeds"] = rng.normal(size=(B, cfg.frontend_len, cfg.d_model)).astype(np.float32)
    if cfg.family == "audio":
        batch["frames"] = rng.normal(size=(B, S, cfg.d_model)).astype(np.float32)
    return batch


def _both(name, seed):
    cfg = reduced(get_config(name))
    jb = jax_build_model(cfg)
    jp = jax.tree.map(lambda a: a.astype(jnp.float32) if jnp.issubdtype(a.dtype, jnp.floating)
                      else a, jb.init_params(jax.random.PRNGKey(seed)))
    tb = build_model(t_configs.reduced(t_configs.get_config(name)), device="cpu")
    tp = params_from_jax(jax.tree.map(np.asarray, jp), "cpu")
    return cfg, jb, jp, tb, tp


def _np(t):
    return t.float().numpy() if isinstance(t, torch.Tensor) else np.asarray(t, np.float32)


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_then_decode(arch):
    cfg, jb, jp, tb, tp = _both(arch, 1)
    B, S = 2, 8
    batch = _batch_for(cfg, B, S)
    jl, jcache = jax.jit(lambda p, b: jb.prefill_fn(p, b, 32))(
        jp, {k: jnp.asarray(v) for k, v in batch.items()})
    tl, tcache = tb.prefill_fn(tp, {k: torch.from_numpy(v) for k, v in batch.items()}, 32)
    assert tl.shape == (B, cfg.vocab_size)
    assert torch.isfinite(tl).all()
    np.testing.assert_allclose(_np(tl), _np(jl), **TOL)

    # frontend prefixes shift the next absolute position
    extra = cfg.frontend_len if cfg.frontend == "image_patches" else 0
    pos = np.full((B,), S + extra, np.int32)
    jdecode = jax.jit(jb.decode_fn)
    for step in range(2):  # the second step exercises cache reuse
        tok = np.asarray(jnp.argmax(jl, -1)).astype(np.int32)
        jl, jcache = jdecode(jp, jcache, jnp.asarray(tok), jnp.asarray(pos + step))
        tl, tcache = tb.decode_fn(tp, tcache, torch.from_numpy(tok), torch.from_numpy(pos + step))
        assert tl.shape == (B, cfg.vocab_size)
        assert torch.isfinite(tl).all()
        np.testing.assert_allclose(_np(tl), _np(jl), **TOL_DECODE)


def test_decode_matches_prefill_dense():
    """Teacher-forced decode reproduces the prefill's logits (dense arch)."""
    cfg, jb, jp, tb, tp = _both("qwen3-1.7b", 2)
    B, S = 1, 6
    tokens = np.random.default_rng(3).integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    t = torch.from_numpy(tokens)
    full, _ = tb.prefill_fn(tp, {"tokens": t}, 32)
    _, cache = tb.prefill_fn(tp, {"tokens": t[:, :-1]}, 32)
    dec, _ = tb.decode_fn(tp, cache, t[:, -1], torch.full((B,), S - 1, dtype=torch.int32))
    np.testing.assert_allclose(_np(full), _np(dec), rtol=2e-2, atol=2e-2)
    _, jcache = jb.prefill_fn(jp, {"tokens": jnp.asarray(tokens[:, :-1])}, 32)
    jdec, _ = jb.decode_fn(jp, jcache, jnp.asarray(tokens[:, -1]), jnp.full((B,), S - 1, jnp.int32))
    np.testing.assert_allclose(_np(dec), _np(jdec), **TOL_DECODE)

"""The port's model layers against ``repro.models.layers``.

Same numpy draws through both frameworks at the reduced configs (qwen3 for
qk-norm, h2o-danube for the sliding window, stablelm-12b for head_dim 160 at
G = 4, deepseek-7b for G = 1; the last two keep their head shapes:
``small`` in tests/test_torch_params.py).  Tolerances: 1e-5 in float32
(different summation orders only); for bf16 activations 2e-2, the bf16
tolerance of tests/test_kernels.py (one bf16 ulp at these magnitudes).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config, reduced
from repro.models import layers as jl
from repro.models.registry import build_model as jax_build_model
from repro_torch.configs import get_config as t_get_config
from repro_torch.configs import reduced as t_reduced
from repro_torch.models import layers as tl
from repro_torch.params import params_from_jax
from test_torch_params import ARCHS, small

F32 = dict(rtol=1e-5, atol=1e-5)
BF16 = dict(rtol=2e-2, atol=2e-2)



def _np(t):
    return t.float().numpy()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rms_norm_matches(dtype):
    rng = np.random.default_rng(0)
    x = rng.normal(size=(3, 5, 64)).astype(np.float32)
    w = rng.normal(size=(64,)).astype(np.float32)
    jd = jnp.float32 if dtype == "float32" else jnp.bfloat16
    td = torch.float32 if dtype == "float32" else torch.bfloat16
    want = jl.rms_norm(jnp.asarray(x, jd), jnp.asarray(w, jd))
    got = tl.rms_norm(torch.from_numpy(x).to(td), torch.from_numpy(w).to(td))
    np.testing.assert_allclose(_np(got), np.asarray(want, np.float32), **(F32 if dtype == "float32" else BF16))


@pytest.mark.parametrize("theta", [10000.0, 1_000_000.0])
def test_apply_rope_matches(theta):
    rng = np.random.default_rng(1)
    x = rng.normal(size=(2, 7, 4, 16)).astype(np.float32)
    pos = rng.integers(0, 500, (2, 7))
    want = jl.apply_rope(jnp.asarray(x), jnp.asarray(pos), theta)
    got = tl.apply_rope(torch.from_numpy(x), torch.from_numpy(pos), theta)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)


@pytest.fixture(scope="module", params=ARCHS)
def layer_setup(request):
    cfg = small(reduced, get_config(request.param))
    params = jax_build_model(cfg).init_params(jax.random.PRNGKey(0))
    p0 = jax.tree.map(lambda a: np.asarray(a[0], np.float32), params["layers"]["attn"])
    return cfg, small(t_reduced, t_get_config(request.param)), p0


def test_attn_qkv_matches(layer_setup):
    """Projections, qk-norm (qwen3), RoPE — f32 weights from the JAX init."""
    cfg, tcfg, p0 = layer_setup
    rng = np.random.default_rng(2)
    x = rng.normal(size=(2, 6, cfg.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(10, 16), (2, 6)).astype(np.int32)
    jq = jl.attn_qkv(jax.tree.map(jnp.asarray, p0), cfg, jnp.asarray(x), jnp.asarray(pos))
    tq = tl.attn_qkv(params_from_jax(p0, "cpu"), tcfg, torch.from_numpy(x), torch.from_numpy(pos))
    for a, b in zip(jq, tq):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-4, atol=1e-4)


def _paged_inputs(rng, B, KV, D, page, P, N, T, dtype):
    jd = jnp.float32 if dtype == "float32" else jnp.bfloat16
    td = torch.float32 if dtype == "float32" else torch.bfloat16
    arrays = dict(
        k_pages=rng.normal(size=(KV, N, page, D)),
        v_pages=rng.normal(size=(KV, N, page, D)),
        k_tail=rng.normal(size=(B, T, KV, D)),
        v_tail=rng.normal(size=(B, T, KV, D)),
    )
    j = {k: jnp.asarray(v, jd) for k, v in arrays.items()}
    t = {k: torch.from_numpy(v.astype(np.float32)).to(td) for k, v in arrays.items()}
    return j, t


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_paged_attention_decode_matches(layer_setup, dtype):
    """The layer's decode attention (JAX: gather + dense attention on the
    CPU; port: the kernel wrapper's plain version), with the config's
    sliding window where it has one."""
    cfg, _, _ = layer_setup
    rng = np.random.default_rng(3)
    B, KV, D, page, P, N, T = 3, cfg.num_kv_heads, cfg.resolved_head_dim, 4, 6, 24, 8
    H = cfg.num_heads
    j, t = _paged_inputs(rng, B, KV, D, page, P, N, T, dtype)
    q = rng.normal(size=(B, 1, H, D))
    bt = rng.integers(0, N, (B, P)).astype(np.int32)
    plen = np.array([P * page, 9, 0], np.int32)
    t_used = np.array([3, 8, 5])
    tpos = np.full((B, T), -1, np.int32)
    for b in range(B):
        tpos[b, : t_used[b]] = plen[b] + np.arange(t_used[b])
    cur = (plen + t_used - 1).astype(np.int32)
    jd = jnp.float32 if dtype == "float32" else jnp.bfloat16
    td = torch.float32 if dtype == "float32" else torch.bfloat16
    want = jl.paged_attention_decode(
        jnp.asarray(q, jd), j["k_pages"], j["v_pages"], jnp.asarray(bt), jnp.asarray(plen),
        j["k_tail"], j["v_tail"], jnp.asarray(tpos), jnp.asarray(cur),
        window=cfg.sliding_window,
    )
    got = tl.paged_attention_decode(
        torch.from_numpy(q.astype(np.float32)).to(td), t["k_pages"], t["v_pages"],
        torch.from_numpy(bt), torch.from_numpy(plen), t["k_tail"], t["v_tail"],
        torch.from_numpy(tpos), torch.from_numpy(cur), window=cfg.sliding_window,
    )
    np.testing.assert_allclose(_np(got), np.asarray(want, np.float32), **(F32 if dtype == "float32" else BF16))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_paged_attention_prefill_matches(layer_setup, dtype):
    cfg, _, _ = layer_setup
    rng = np.random.default_rng(4)
    B, KV, D, page, P, N, C = 2, cfg.num_kv_heads, cfg.resolved_head_dim, 4, 6, 24, 8
    H = cfg.num_heads
    j, t = _paged_inputs(rng, B, KV, D, page, P, N, C, dtype)
    q = rng.normal(size=(B, C, H, D))
    bt = rng.integers(0, N, (B, P)).astype(np.int32)
    plen = np.array([16, 0], np.int32)
    qpos = (plen[:, None] + np.arange(C)[None]).astype(np.int32)
    jd = jnp.float32 if dtype == "float32" else jnp.bfloat16
    td = torch.float32 if dtype == "float32" else torch.bfloat16
    want = jl.paged_attention_prefill(
        jnp.asarray(q, jd), j["k_pages"], j["v_pages"], jnp.asarray(bt), jnp.asarray(plen),
        j["k_tail"], j["v_tail"], jnp.asarray(qpos), window=cfg.sliding_window,
    )
    got = tl.paged_attention_prefill(
        torch.from_numpy(q.astype(np.float32)).to(td), t["k_pages"], t["v_pages"],
        torch.from_numpy(bt), torch.from_numpy(plen), t["k_tail"], t["v_tail"],
        torch.from_numpy(qpos), window=cfg.sliding_window,
    )
    np.testing.assert_allclose(_np(got), np.asarray(want, np.float32), **(F32 if dtype == "float32" else BF16))


def test_attention_prefill_matches():
    """The monolithic prefill attention (prefill_chunk=0 path), f32."""
    rng = np.random.default_rng(5)
    B, S, H, KV, D = 2, 20, 4, 2, 16
    q = rng.normal(size=(B, S, H, D)).astype(np.float32)
    k = rng.normal(size=(B, S, KV, D)).astype(np.float32)
    v = rng.normal(size=(B, S, KV, D)).astype(np.float32)
    pos = np.broadcast_to(np.arange(S), (B, S)).astype(np.int32)
    for window, qc, kc in ((0, 512, 1024), (8, 8, 8)):
        want = jl.attention_prefill(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), q_positions=jnp.asarray(pos),
            kv_positions=jnp.asarray(pos), window=window, q_chunk=qc, kv_chunk=kc,
        )
        got = tl.attention_prefill(
            torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
            q_positions=torch.from_numpy(pos), kv_positions=torch.from_numpy(pos),
            window=window, q_chunk=qc, kv_chunk=kc,
        )
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)


@pytest.mark.parametrize("offset", [0, 5])
def test_attn_prefill_layer_positions_contract(layer_setup, offset):
    """The prefill layer over arange(S) or offset positions matches JAX's
    (f32).  ``contiguous=True`` — the promise the card's flash-attention
    kernel relies on — is accepted for arange(S) and refused otherwise."""
    cfg, tcfg, p0 = layer_setup
    rng = np.random.default_rng(6)
    x = rng.normal(size=(2, 12, cfg.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(offset, offset + 12), (2, 12)).astype(np.int32)
    want, _ = jl.attn_prefill_layer(jax.tree.map(jnp.asarray, p0), cfg, jnp.asarray(x), jnp.asarray(pos))
    tp, tx, tpos = params_from_jax(p0, "cpu"), torch.from_numpy(x), torch.from_numpy(pos)
    got, _ = tl.attn_prefill_layer(tp, tcfg, tx, tpos)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-4)
    if offset:
        with pytest.raises(ValueError, match="not arange"):
            tl.attn_prefill_layer(tp, tcfg, tx, tpos, contiguous=True)
    else:
        same, _ = tl.attn_prefill_layer(tp, tcfg, tx, tpos, contiguous=True)
        assert torch.equal(same, got)

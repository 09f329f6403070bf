"""The port's int8 KV cache against the JAX package's (reduced qwen3-1.7b,
``kv_cache_dtype="int8"``, dense decode mode).

Checked here:

* ``quantize_kv`` and ``dequantize_kv`` are BITWISE equal to JAX on seeded
  inputs (bf16 and f32, four magnitudes, round-half-to-even ties): no
  exception was found, so none is recorded;
* ``prefill`` plus two ``decode_step``s against JAX: with float32 weights
  the logits within 1e-5 (measured max |d| 2.2e-7; the dequantized cache is
  bf16 in both) and every int8 cache leaf bitwise; with bf16 weights within
  3e-2 (measured 4.8e-3); argmax equal;
* the port's int8 against its own bf16 cache under ``tests/test_int8_kv.py``'s
  bounds (atol 0.35, rtol 0.1, equal argmax);
* the scale-bearing cache shapes and dtypes;
* both dense engines on a prefix-reuse scenario: equal projected events,
  tokens, and reused-prefix logits (within 3e-2, the bf16 cross-graph
  tolerance).  The reference's int8 prefix reuse dequantizes the reused
  prefix to zeros (``_dense_cache`` copies int8 payloads into a cache whose
  scales stay zero); both packages give the same reuse-versus-cold
  difference, within 3e-2, and it is far above bf16's;
* witness paths A and B under int8 on both engines; the offloaded blocks are
  int8 pages.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config, reduced
from repro.core import analyzer
from repro.core.claims import ClaimMode as JClaimMode
from repro.core.events import EventLog as JEventLog
from repro.models import transformer as jax_tf
from repro.models.registry import build_model as jax_build_model
from repro.serving.engine import ServingEngine as JaxEngine
from repro_torch.configs import get_config as t_get_config
from repro_torch.configs import reduced as t_reduced
from repro_torch.core.claims import ClaimMode, ClaimState
from repro_torch.kernels import kv_block_copy as kbc
from repro_torch.models import transformer as t_tf
from repro_torch.models.registry import build_model
from repro_torch.params import params_from_jax
from repro_torch.serving.engine import ServingEngine

PREFIX = tuple(range(10, 26))  # 16 tokens = 4 blocks of 4
REUSE = PREFIX + (30, 31, 32, 33)  # a 20-token prompt on the 16-token prefix
TIMED = {"stage_latency"}
CACHE_LEN = 64
XGRAPH = dict(rtol=3e-2, atol=3e-2)  # the JAX package's cross-graph logits tolerance
NAME = "qwen3-1.7b"


@pytest.fixture(scope="module")
def models():
    """{kv dtype: {weights dtype: (jax bundle, jax params, port bundle, port params)}}."""
    base = reduced(get_config(NAME))
    jp = jax_build_model(base).init_params(jax.random.PRNGKey(0))
    out = {}
    for kv in ("bf16", "int8"):
        jb = jax_build_model(base.replace(kv_cache_dtype=kv))
        tb = build_model(t_reduced(t_get_config(NAME)).replace(kv_cache_dtype=kv), device="cpu")
        out[kv] = {}
        for dtype in ("bfloat16", "float32"):
            p = jp if dtype == "bfloat16" else jax.tree.map(lambda a: a.astype(jnp.float32), jp)
            out[kv][dtype] = (jb, p, tb, params_from_jax(jax.tree.map(np.asarray, p), "cpu"))
    return out


def _to_j(x, dtype):
    return jnp.asarray(x, jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
@pytest.mark.parametrize("scale", [1.0, 0.01, 100.0, 3.0])
def test_quantize_dequantize_bitwise(dtype, scale):
    x = (np.random.default_rng(int(scale * 100)).normal(size=(3, 17, 4, 64)) * scale).astype(np.float32)
    jq, js = jax_tf.quantize_kv(_to_j(x, dtype))
    tq, ts = t_tf.quantize_kv(torch.from_numpy(x).to(dtype))
    assert tq.dtype == torch.int8 and ts.dtype == torch.bfloat16
    assert tq.shape == (3, 17, 4, 64) and ts.shape == (3, 17, 4)
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.view(torch.int16).numpy(), np.asarray(js).view(np.int16))
    jd = jax_tf.dequantize_kv(jq, js)
    td = t_tf.dequantize_kv(tq, ts)
    assert td.dtype == torch.bfloat16
    np.testing.assert_array_equal(td.view(torch.int16).numpy(), np.asarray(jd).view(np.int16))


def test_quantize_ties_round_half_to_even():
    """Rows whose absmax is 127 put x / scale exactly on .5 ties."""
    x = np.array([[127.0, 0.5, 1.5, 2.5, -0.5, -1.5, 63.5, -63.5, 0.0]], np.float32)
    jq, _ = jax_tf.quantize_kv(jnp.asarray(x))
    tq, _ = t_tf.quantize_kv(torch.from_numpy(x))
    assert tq.tolist() == [[127, 0, 2, 2, 0, -2, 64, -64, 0]]
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))


def test_int8_cache_shapes(models):
    cfg = models["int8"]["bfloat16"][2].cfg
    cache = t_tf.make_cache(cfg, 2, 32, device="cpu")
    jcache = jax_tf.make_cache(models["int8"]["bfloat16"][0].cfg, 2, 32)
    L, KV, Dh = cfg.num_layers, cfg.num_kv_heads, cfg.resolved_head_dim
    assert set(cache) == set(jcache) == {"k", "v", "k_scale", "v_scale", "pos"}
    for key in ("k", "v"):
        assert cache[key].shape == (L, 2, 32, KV, Dh) and cache[key].dtype == torch.int8
    for key in ("k_scale", "v_scale"):
        assert cache[key].shape == (L, 2, 32, KV) and cache[key].dtype == torch.bfloat16
    for key in cache:
        assert tuple(cache[key].shape) == tuple(jcache[key].shape)
    # the int8 cache holds half the bf16 cache's KV bytes, plus the scales
    bf16 = t_tf.make_cache(models["bf16"]["bfloat16"][2].cfg, 2, 32, device="cpu")
    assert cache["k"].nbytes * 2 == bf16["k"].nbytes


def _j_leaf(v):
    return np.asarray(v) if v.dtype in (jnp.int8, jnp.int32) else np.asarray(v, np.float32)


def _t_leaf(v):
    return v.numpy() if v.dtype in (torch.int8, torch.int32) else v.float().numpy()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_int8_prefill_and_decode_match_jax(models, dtype):
    """float32 weights: logits within 1e-5 and the int8 cache bitwise; bf16
    weights: logits within 3e-2 with argmax equal."""
    jb, jp, tb, tp = models["int8"][dtype]
    tokens = np.random.default_rng(0).integers(0, jb.cfg.vocab_size, (2, 12))
    jl, jc = jb.prefill_fn(jp, {"tokens": jnp.asarray(tokens, jnp.int32)}, 32)
    tl, tc = tb.prefill_fn(tp, {"tokens": torch.from_numpy(tokens).int()}, 32)
    tol = dict(rtol=1e-5, atol=1e-5) if dtype == "float32" else XGRAPH
    pos = np.full((2,), 12, np.int32)
    for step in range(3):
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **tol)
        assert (tl.numpy().argmax(-1) == np.asarray(jl).argmax(-1)).all()
        assert set(tc) == set(jc)
        if dtype == "float32":
            for key in jc:
                np.testing.assert_array_equal(_t_leaf(tc[key]), _j_leaf(jc[key]), err_msg=key)
        if step == 2:
            break
        tok = np.asarray(jl).argmax(-1).astype(np.int32)
        jl, jc = jb.decode_fn(jp, jc, jnp.asarray(tok), jnp.asarray(pos + step))
        tl, tc = tb.decode_fn(tp, tc, torch.from_numpy(tok), torch.from_numpy(pos + step))


def test_int8_decode_tracks_bf16_in_the_port(models):
    """tests/test_int8_kv.py's check on the port alone: same bounds."""
    tokens = torch.from_numpy(
        np.random.default_rng(0).integers(0, models["bf16"]["bfloat16"][2].cfg.vocab_size, (2, 12))
    ).int()
    outs = {}
    for kv in ("bf16", "int8"):
        _, _, tb, tp = models[kv]["bfloat16"]
        logits, cache = tb.prefill_fn(tp, {"tokens": tokens}, 32)
        tok = logits.argmax(-1).int()
        pos = torch.full((2,), 12, dtype=torch.int32)
        l2, cache = tb.decode_fn(tp, cache, tok, pos)
        l3, _ = tb.decode_fn(tp, cache, l2.argmax(-1).int(), pos + 1)
        outs[kv] = (l2.numpy(), l3.numpy())
    for a, b in zip(outs["bf16"], outs["int8"]):
        assert (a.argmax(-1) == b.argmax(-1)).all()
        np.testing.assert_allclose(a, b, atol=0.35, rtol=0.1)


def test_int8_bundles_are_dense_only(models):
    jb, jp, tb, tp = models["int8"]["bfloat16"]
    assert tb.prefill_collect_fn is tb.paged_decode_fn is tb.prefill_chunk_fn is None
    assert jb.paged_decode_fn is None
    assert models["bf16"]["bfloat16"][2].paged_decode_fn is not None
    eng = ServingEngine(tb, tp, device="cpu", block_size=4, device_blocks=64, cache_len=CACHE_LEN)
    assert eng.decode_mode == "dense"
    eng.close()


def _engines(models, kv, dtype="bfloat16"):
    jb, jp, tb, tp = models[kv][dtype]
    kw = dict(block_size=4, device_blocks=64, decode_mode="dense", cache_len=CACHE_LEN)
    return (lambda: JaxEngine(jb, jp, **kw)), (lambda: ServingEngine(tb, tp, device="cpu", **kw))


def projection(log, key):
    out = {}
    for e in log.events:
        ident = getattr(e, key)
        if ident is not None and e.name not in TIMED:
            out.setdefault(ident, []).append((e.name, dict(e.payload)))
    return out


def _reuse_vs_cold(make):
    """(reused-prefix logits, cold logits, requests, events) of REUSE."""
    eng = make()
    first = eng.run(eng.submit(PREFIX, max_new_tokens=2))
    reused = eng.prefill_logits(REUSE)
    again = eng.run(eng.submit(REUSE, max_new_tokens=3))
    events = (projection(eng.events, "request_id"), eng.fail_closed_total())
    eng.close()
    eng = make()
    cold = eng.prefill_logits(REUSE)
    eng.close()
    return reused, cold, (first, again), events


def test_int8_prefix_reuse_matches_jax_and_reproduces_the_zero_scales(models):
    """Finding: the reference's int8 prefix reuse loses its scales.  Both
    packages give the same reuse-versus-cold difference; under bf16 the
    same difference is a rounding one."""
    diffs = {}
    for kv in ("bf16", "int8"):
        mj, mt = _engines(models, kv)
        jr, jc, jreqs, jev = _reuse_vs_cold(mj)
        tr, tc, treqs, tev = _reuse_vs_cold(mt)
        for a, b in zip(jreqs, treqs):
            assert (a.status, a.output_tokens, a.cached_tokens) == (b.status, b.output_tokens, b.cached_tokens)
            assert b.status == "finished"
        assert treqs[1].cached_tokens == len(REUSE)  # prefill_logits stored its blocks
        assert tev == jev
        np.testing.assert_allclose(tr, jr, **XGRAPH)
        np.testing.assert_allclose(tc, jc, **XGRAPH)
        assert tr.argmax() == jr.argmax() and tc.argmax() == jc.argmax()
        diffs[kv] = (float(np.abs(jr - jc).max()), float(np.abs(tr - tc).max()))
    (j8, t8), (j16, t16) = diffs["int8"], diffs["bf16"]
    assert abs(j8 - t8) <= XGRAPH["atol"], diffs
    assert j8 > 0.1 and t8 > 0.1, diffs  # the reused prefix reads zeros
    assert j16 < 0.02 and t16 < 0.02, diffs


def test_int8_reused_prefix_cache_has_zero_scales(models):
    """The mechanism, in the port: the gathered dense cache holds the int8
    payloads with zero scales, so the reused rows dequantize to zeros."""
    _, mt = _engines(models, "int8")
    eng = mt()
    eng.run(eng.submit(PREFIX, max_new_tokens=2))
    blocks = eng.pool.lookup_prefix(PREFIX, eng.block_size)
    assert len(blocks) == 4 and all(b.k.dtype == torch.int8 for b in blocks)
    cache, n = eng._dense_cache(blocks)
    assert n == len(PREFIX)
    assert cache["k"][:, 0, :n].abs().sum() > 0
    assert not cache["k_scale"].any() and not cache["v_scale"].any()
    assert not t_tf.dequantize_kv(cache["k"], cache["k_scale"]).any()
    eng.close()


def _claim_cycle(eng, mode_cls, fail):
    claim = eng.accept_claim(PREFIX, mode_cls.OFFLOADABLE)
    r1 = eng.submit(PREFIX + (30, 31), max_new_tokens=2)
    eng.run(r1)
    assert eng.offload_claim(claim.claim_id, request_id=r1.request_id)
    if fail:
        eng.connector.injection.resident_claim_load_failure = True
        eng.connector.injection.fail_claim_id = claim.claim_id
    r2 = eng.submit(PREFIX + (40, 41), max_new_tokens=3)
    eng.run(r2)
    return claim, r1, r2


@pytest.mark.parametrize("fail", [False, True], ids=["path_a", "path_b"])
def test_int8_witness_paths_match_jax(models, fail):
    mj, mt = _engines(models, "int8", "float32")
    je, te = mj(), mt()
    plain_before = kbc.gather_payloads.plain_copies
    jc, _, jr2 = _claim_cycle(je, JClaimMode, fail)
    tc, _, tr2 = _claim_cycle(te, ClaimMode, fail)
    assert kbc.gather_payloads.plain_copies == plain_before
    assert (tr2.status, tr2.output_tokens, tr2.restored_tokens) == (
        jr2.status, jr2.output_tokens, jr2.restored_tokens,
    )
    assert tc.state.value == jc.state.value
    log = JEventLog.from_dicts([e.to_dict() for e in te.events.events])
    assert analyzer.validate_event_sequence(log).passed
    if fail:
        assert tr2.status == "refused" and tc.state == ClaimState.RESTORATION_FAILED
        v = analyzer.check_failure_outcome_path(log, tc.claim_id, tr2.request_id)
    else:
        assert tr2.restored_tokens == len(PREFIX) and tc.state == ClaimState.RESTORED
        v = analyzer.check_observation_path(log, tc.claim_id, tr2.request_id)
        assert not te.fail_closed_total()
        # restored tokens equal a never-offloaded int8 engine's
        ref = mt()
        ref.accept_claim(PREFIX, ClaimMode.OFFLOADABLE)
        ref.run(ref.submit(PREFIX + (30, 31), max_new_tokens=2))
        r = ref.run(ref.submit(PREFIX + (40, 41), max_new_tokens=3))
        assert r.output_tokens == tr2.output_tokens
        ref.close()
    assert v.passed, v.reasons
    assert projection(te.events, "request_id") == projection(je.events, "request_id")
    assert projection(te.events, "claim_id") == projection(je.events, "claim_id")
    assert te.fail_closed_total() == je.fail_closed_total()
    te.close()
    je.close()

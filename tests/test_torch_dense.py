"""The port's dense decode mode against the JAX package's.

The JAX ``ServingEngine(decode_mode="dense", cache_len=64)`` and the port's
``ServingEngine(decode_mode="dense", cache_len=64, device="cpu")`` get the
same bridged parameters (``params_from_jax``), prompts and claim scenarios
at the reduced configs (block_size 4).  Checked here:

* greedy tokens equal (float32 weights; the dense cache is bf16 in both, as
  the JAX package's ``make_cache`` makes it);
* ``prefill_logits`` of fresh prompts within 1e-5 (float32) and 3e-2
  (bf16, the JAX package's cross-graph logits tolerance), same argmax;
* per-request and per-claim (name, payload) event projections, including
  the ``dense_cache_overflow`` refusal;
* restore after offload to host and to disk (logits within 3e-2: the
  replayed suffix reads the bf16 cache);
* the sliding-window ring on reduced h2o-danube (window 16, so the cache is
  a 16-slot ring) for a prompt longer than the window, and a cached prefix
  longer than the ring, which raises in both;
* ``make_cache``, ``prefill`` and ``decode_step`` at transformer level.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config, reduced
from repro.core.claims import ClaimMode as JClaimMode
from repro.models import transformer as jax_tf
from repro.models.registry import build_model as jax_build_model
from repro.serving.engine import ServingEngine as JaxEngine
from repro_torch.configs import get_config as t_get_config
from repro_torch.configs import reduced as t_reduced
from repro_torch.core.claims import ClaimMode, ClaimState
from repro_torch.models.registry import build_model
from repro_torch.params import params_from_jax
from repro_torch.serving.engine import ServingEngine

PREFIX = tuple(range(10, 26))  # 16 tokens = 4 blocks of 4
TIMED = {"stage_latency"}  # payloads carry wall-clock seconds
CACHE_LEN = 64


@pytest.fixture(scope="module", params=["qwen3-1.7b", "h2o-danube-1.8b"])
def pair(request):
    """(cfg name, {dtype: (jax bundle, jax params, port bundle, port params)})."""
    cfg = reduced(get_config(request.param))
    jb = jax_build_model(cfg)
    jp = jb.init_params(jax.random.PRNGKey(0))
    tb = build_model(t_reduced(t_get_config(request.param)), device="cpu")
    out = {}
    for dtype in ("bfloat16", "float32"):
        p = jp if dtype == "bfloat16" else jax.tree.map(lambda a: a.astype(jnp.float32), jp)
        out[dtype] = (jb, p, tb, params_from_jax(jax.tree.map(np.asarray, p), "cpu"))
    return request.param, out


def engines(pair, dtype, **kw):
    jb, jp, tb, tp = pair[1][dtype]
    kw.setdefault("block_size", 4)
    kw.setdefault("device_blocks", 64)
    kw.update(decode_mode="dense", cache_len=CACHE_LEN)
    return JaxEngine(jb, jp, **kw), ServingEngine(tb, tp, device="cpu", **kw)


def projection(log, key):
    """{id: [(name, payload), ...]} over events carrying that id."""
    out = {}
    for e in log.events:
        ident = getattr(e, key)
        if ident is not None and e.name not in TIMED:
            out.setdefault(ident, []).append((e.name, dict(e.payload)))
    return out


def same_requests(jr, tr):
    for a, b in zip(jr, tr):
        assert (a.status, a.output_tokens, a.cached_tokens, a.error) == (
            b.status, b.output_tokens, b.cached_tokens, b.error,
        )


def test_dense_greedy_tokens_and_events_match_jax(pair):
    je, te = engines(pair, "float32")
    first = [PREFIX + (30, 31), tuple(range(100, 121)), PREFIX + (40, 41, 42)]
    jr = je.run_batch([je.submit(p, max_new_tokens=5) for p in first])
    tr = te.run_batch([te.submit(p, max_new_tokens=5) for p in first])
    # a second batch finds the first batch's blocks: gather-to-dense plus a
    # replayed suffix, and an exact-prefix hit that replays its last token
    second = [PREFIX + (50, 51), PREFIX]
    jr += je.run_batch([je.submit(p, max_new_tokens=4) for p in second])
    tr += te.run_batch([te.submit(p, max_new_tokens=4) for p in second])
    same_requests(jr, tr)
    assert all(r.status == "finished" for r in tr)
    assert [r.cached_tokens for r in tr[3:]] == [16, 16]
    assert projection(te.events, "request_id") == projection(je.events, "request_id")
    n = len(te.stage_seconds.samples(stage="decode_step"))
    assert n == len(je.stage_seconds.samples(stage="decode_step")) == 5 + 4
    te.close()
    je.close()


@pytest.mark.parametrize("dtype,tol", [("float32", 1e-5), ("bfloat16", 3e-2)])
def test_dense_prefill_logits_match_jax(pair, dtype, tol):
    je, te = engines(pair, dtype)
    for prompt in (tuple(range(300, 340)), tuple(range(500, 537))):
        lj = je.prefill_logits(prompt)
        lt = te.prefill_logits(prompt)
        assert lt.shape == lj.shape and np.isfinite(lt).all()
        np.testing.assert_allclose(lt, lj, rtol=tol, atol=tol)
        assert lt.argmax() == lj.argmax()
    te.close()
    je.close()


def test_dense_cache_overflow_refusal_matches_jax(pair):
    """prompt + max_new_tokens > cache_len is refused fail-closed, with its
    ordered event; a sliding-window config is exempt (the ring is its
    contract) and serves the request."""
    name = pair[0]
    je, te = engines(pair, "float32")
    prompt = tuple(range(200, 250))  # 50 + 20 > 64
    jr = je.run(je.submit(prompt, max_new_tokens=20))
    tr = te.run(te.submit(prompt, max_new_tokens=20))
    same_requests([jr], [tr])
    if name == "qwen3-1.7b":
        assert tr.status == "refused" and tr.error.startswith("dense_cache_overflow")
        assert te.fail_closed_total() == je.fail_closed_total() == {"dense_cache_overflow": 1}
        refusal = te.events.named("scheduler_admission_refused")[0]
        assert refusal.payload["trigger"] == "dense_cache_overflow"
        assert refusal.payload["stage"] == "cache_shape"
    else:
        assert tr.status == "finished" and not te.fail_closed_total()
    assert projection(te.events, "request_id") == projection(je.events, "request_id")
    te.close()
    je.close()


@pytest.mark.parametrize("tier", ["host", "disk"])
def test_dense_restore_after_offload_matches_jax(pair, tier):
    """The claimed prefix is offloaded to {tier} and restored into the
    pool, gathered into a dense cache, and the suffix replayed; claim
    events and logits agree with the JAX dense engine."""
    logits, claims = {}, {}
    for which, (eng, mode) in zip(("jax", "port"), zip(engines(pair, "bfloat16"), (JClaimMode, ClaimMode))):
        claim = eng.accept_claim(PREFIX, mode.OFFLOADABLE)
        r1 = eng.submit(PREFIX + (30, 31), max_new_tokens=1)
        eng.run(r1)
        assert eng.offload_claim(claim.claim_id, tier=tier)
        logits[which] = eng.prefill_logits(PREFIX + (40, 41), max_new_tokens=2)
        claims[which] = (claim.state.value, projection(eng.events, "claim_id"))
        eng.close()
    assert claims["port"] == claims["jax"]
    assert claims["port"][0] == ClaimState.RESTORED.value
    np.testing.assert_allclose(logits["port"], logits["jax"], atol=3e-2, rtol=3e-2)
    assert logits["port"].argmax() == logits["jax"].argmax()


def test_dense_long_prompt_cache_layout_matches_jax(pair):
    """A 20-token prompt, then a request whose cached prefix is those 20
    tokens.  qwen3-1.7b keeps every position in its 64-slot cache and
    serves both.  On h2o-danube the 20 tokens overrun the 16-slot ring:
    prefill leaves them at slots 0..keep-1, not decode's slot p % Sc (a
    reference quirk the port reproduces), and the cached prefix longer than
    the ring raises ValueError in both, leaving the request running."""
    je, te = engines(pair, "float32")
    prompt = tuple(range(100, 120))
    jr = je.run(je.submit(prompt, max_new_tokens=4))
    tr = te.run(te.submit(prompt, max_new_tokens=4))
    same_requests([jr], [tr])
    assert tr.status == "finished"
    longer = prompt + (7, 8)
    if pair[0] == "qwen3-1.7b":
        jr = je.run(je.submit(longer, max_new_tokens=2))
        tr = te.run(te.submit(longer, max_new_tokens=2))
        same_requests([jr], [tr])
        assert (tr.status, tr.cached_tokens) == ("finished", 20)
    else:
        outcomes = []
        for eng in (je, te):
            r = eng.submit(longer, max_new_tokens=2)
            with pytest.raises(ValueError):
                eng.run(r)
            outcomes.append((r.status, r.cached_tokens, r.output_tokens))
        assert outcomes[0] == outcomes[1] == ("running", 20, [])
    assert projection(te.events, "request_id") == projection(je.events, "request_id")
    te.close()
    je.close()


def _t_cache(cache):
    return {k: v.float().numpy() if v.is_floating_point() else v.numpy() for k, v in cache.items()}


def _j_cache(cache):
    return {k: np.asarray(v, np.float32) if k != "pos" else np.asarray(v) for k, v in cache.items()}


def test_transformer_dense_steps_match_jax(pair):
    """make_cache, prefill and three decode_steps, float32 weights (the
    cache stays bf16): logits within 1e-5, caches equal within one bf16
    step, positions equal.  On reduced h2o-danube the 20-token prompt
    leaves pos = 4..19 in the 16-slot ring, and decoding position 20 writes
    slot 4: position 8 is dropped though 20 - 8 < window."""
    name, by_dtype = pair
    jb, jp, tb, tp = by_dtype["float32"]
    jcfg, tcfg = jb.cfg, tb.cfg
    for B in (1, 3):
        jc, tc = _j_cache(jb.make_cache(B, CACHE_LEN)), _t_cache(tb.make_cache(B, CACHE_LEN))
        assert jc.keys() == tc.keys()
        for k in jc:
            np.testing.assert_array_equal(tc[k], jc[k])
    tokens = np.random.default_rng(0).integers(0, 64, (2, 20)).astype(np.int32)
    jl, jcache = jax_tf.prefill(jp, jcfg, {"tokens": jnp.asarray(tokens)}, CACHE_LEN)
    tl, tcache = tb.prefill_fn(tp, {"tokens": torch.from_numpy(tokens)}, CACHE_LEN)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-5, atol=1e-5)
    pos = np.full(2, 20, np.int32)
    for step in range(3):
        a, b = _j_cache(jcache), _t_cache(tcache)
        np.testing.assert_array_equal(b["pos"], a["pos"])
        for k in ("k", "v"):
            np.testing.assert_allclose(b[k], a[k], rtol=1e-2, atol=1e-2)
        nxt = np.asarray(jl).argmax(-1).astype(np.int32)
        jl, jcache = jax_tf.decode_step(jp, jcfg, jcache, jnp.asarray(nxt), jnp.asarray(pos))
        tl, tcache = tb.decode_fn(tp, tcache, torch.from_numpy(nxt), torch.from_numpy(pos.copy()))
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-4, atol=1e-4)
        assert (tl.numpy().argmax(-1) == np.asarray(jl).argmax(-1)).all()
        if step == 0 and name == "h2o-danube-1.8b":
            assert a["pos"][0].tolist() == list(range(4, 20))
            ring = tcache["pos"][0].tolist()
            assert ring[4] == 20 and 8 not in ring and 20 - 8 < tcfg.sliding_window
        pos += 1


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("window,softcap", [(0, 0.0), (12, 0.0), (0, 20.0)])
def test_attention_decode_matches_jax(dtype, window, softcap):
    """The dense decode attention alone, over a half-written cache with a
    ragged current position (bf16 within 2e-2, f32 within 1e-5)."""
    from repro.models.layers import attention_decode as j_attention_decode
    from repro_torch.models.layers import attention_decode

    rng = np.random.default_rng(7)
    B, S, H, KV, D = 3, 24, 4, 2, 16
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    tdt = torch.float32 if dtype == "float32" else torch.bfloat16
    q, k, v = (rng.normal(size=s).astype(np.float32) for s in ((B, 1, H, D), (B, S, KV, D), (B, S, KV, D)))
    pos = np.tile(np.arange(S, dtype=np.int32), (B, 1))
    pos[:, 18:] = -1
    cur = np.array([17, 9, 3], np.int32)
    kw = dict(window=window, softcap=softcap)
    want = j_attention_decode(
        *(jnp.asarray(a, jdt) for a in (q, k, v)), kv_positions=jnp.asarray(pos), cur_pos=jnp.asarray(cur), **kw
    )
    got = attention_decode(
        *(torch.from_numpy(a).to(tdt) for a in (q, k, v)),
        kv_positions=torch.from_numpy(pos), cur_pos=torch.from_numpy(cur), **kw,
    )
    tol = 1e-5 if dtype == "float32" else 2e-2
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32), rtol=tol, atol=tol)

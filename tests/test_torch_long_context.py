"""Long contexts at reduced size, held against the JAX package (CPU).

The card runs qwen3-1.7b at 32,768 tokens and h2o-danube-1.8b past its
4096-key window (``chip_smoke.py`` phase 20).  Here the same paths run on
the reduced configs (block_size 4), on the JAX ``ServingEngine`` and on the
port's, over the same float32 parameters (``params_from_jax``), and the two
runs' observations must be equal (``test_torch_failure_paths.both``: the
projected ordered events, ``fail_closed_total``, every request's status,
error, output tokens and cached/restored counts, claim states, refcounts):

* qwen3: paged prompts of 640 and 384 tokens (10 and 6 splits of 64 keys)
  at ``prefill_chunk`` 8 and 64, their page bytes within 1e-5 of the
  reference's; a 600-token claim through witness paths A and B;
* h2o-danube (window 16): paged and dense prompts of 200 and 90 tokens
  with 40 new tokens each, so the dense mode's 16-slot ring wraps; a claim
  four tokens inside the window accepted and restored (path A), one four
  tokens past it rejected with nothing registered;
* h2o-danube's ``decode_fn`` at long_500k's last position (524,287) over a
  16-slot ring, port against JAX within 1e-2: both packages cast the
  softmax weights to the bf16 cache's type before P.V, and a weight on a
  bf16 rounding boundary rounds either way, so the logits move with the
  positions (measured max |d| 1.2e-3 at 524,287, 5.3e-4 at 65,535, 2.5e-7
  at 32,767); the RoPE angles and their sines are bitwise equal there;
* within the port: chunk 8 against 64 bitwise in float32 under the window.

The norms (one reduction order per row on every route) are held against
the JAX package in ``tests/test_torch_norm.py``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core.analyzer as j_analyzer
from repro.configs import get_config, reduced
from repro.core.claims import ClaimMode as JClaimMode
from repro.core.claims import ClaimRejected as JClaimRejected
from repro.core.claims import ClaimState as JClaimState
from repro.models.registry import build_model as jax_build_model
from repro.serving.engine import ServingEngine as JaxEngine
from repro_torch.configs import get_config as t_get_config
from repro_torch.configs import reduced as t_reduced
from repro_torch.core import analyzer as t_analyzer
from repro_torch.core.claims import ClaimMode, ClaimRejected, ClaimState
from repro_torch.models.registry import build_model
from repro_torch.params import params_from_jax
from repro_torch.serving.engine import ServingEngine
from test_torch_failure_paths import Pkg, both, observe, pkgs  # noqa: F401  (fixture)
from torch_one_thread import one_torch_thread  # noqa: F401  (autouse fixture)

PAGE_ATOL = 1e-5  # float32 page bytes across the two frameworks
LOGITS_ATOL = 1e-2  # decode logits over a bf16 ring across the two frameworks (docstring)
LONG_500K = 524_288


def _prompts(V, lens, seed):
    rng = np.random.default_rng(seed)
    return [tuple(int(t) for t in rng.integers(0, V, n)) for n in lens]


def _pages(eng, prompt):
    """The k/v page bytes of ``prompt``'s resident full blocks, as numpy."""
    blocks = eng.pool.lookup_prefix(prompt, eng.block_size)
    slots = eng.pool.page_table(blocks)
    k, v = eng.pool.k_pages, eng.pool.v_pages
    if isinstance(k, torch.Tensor):
        k, v = k.numpy(), v.numpy()
    return len(slots), np.asarray(k)[:, :, slots], np.asarray(v)[:, :, slots]


def both_with_pages(pkgs, scenario, *args):
    """``both`` over the observations, and the page bytes of each run
    (returned beside them) equal within PAGE_ATOL."""
    pages = {}

    def run(pkg, *a):
        obs, pages[pkg.name] = scenario(pkg, *a)
        return obs

    got = both(pkgs, run, *args)
    for (nj, kj, vj), (nt, kt, vt) in zip(pages["jax"], pages["port"]):
        assert nj == nt and nt > 0
        np.testing.assert_allclose(kt, kj, atol=PAGE_ATOL, rtol=0)
        np.testing.assert_allclose(vt, vj, atol=PAGE_ATOL, rtol=0)
    return got


@pytest.fixture(scope="module")
def dpkgs():
    """Reduced h2o-danube-1.8b (window 16) in both packages over the same
    float32 parameters, as ``pkgs`` has qwen3."""
    cfg = reduced(get_config("h2o-danube-1.8b"))
    jb = jax_build_model(cfg)
    jp = jax.tree.map(lambda a: a.astype(jnp.float32), jb.init_params(jax.random.PRNGKey(0)))
    tb = build_model(t_reduced(t_get_config("h2o-danube-1.8b")), device="cpu")
    tp = params_from_jax(jax.tree.map(np.asarray, jp), "cpu")
    common = dict(cfg=cfg, jb=jb, jp=jp, tb=tb, tp=tp)
    return {
        "jax": Pkg(name="jax", ClaimMode=JClaimMode, ClaimState=JClaimState,
                   ClaimRejected=JClaimRejected, analyzer=j_analyzer,
                   engine=lambda **kw: JaxEngine(jb, jp, **kw), **common),
        "port": Pkg(name="port", ClaimMode=ClaimMode, ClaimState=ClaimState,
                    ClaimRejected=ClaimRejected, analyzer=t_analyzer,
                    engine=lambda **kw: ServingEngine(tb, tp, device="cpu", **kw), **common),
    }


# ---------------------------------------------------------------------------
# qwen3: prompts over several key splits, a long claim
# ---------------------------------------------------------------------------


def _long_paged(pkg, chunk):
    prompts = _prompts(64, (640, 384), 28)
    with pkg.make(device_blocks=320, prefill_chunk=chunk) as eng:
        reqs = [eng.submit(p, max_new_tokens=4) for p in prompts]
        eng.run_batch(reqs)
        assert all(r.status == "finished" and len(r.output_tokens) == 4 for r in reqs)
        assert not eng.fail_closed_total()
        return observe(eng, reqs), [_pages(eng, p) for p in prompts]


@pytest.mark.parametrize("chunk", [8, 64])
def test_long_paged_prompts_match_jax(pkgs, chunk):
    """640 and 384 tokens in one ``run_batch`` at ``prefill_chunk`` 8 and
    64: the same tokens, events and (within 1e-5) page bytes."""
    both_with_pages(pkgs, _long_paged, chunk)


def _long_claim(pkg, path):
    an = pkg.analyzer
    prefix = _prompts(64, (600,), 29)[0]
    kw = dict(device_blocks=400, host_blocks=200, prefill_chunk=64)
    with pkg.make(**kw) as cold_eng:
        cold = cold_eng.run(cold_eng.submit(prefix + (40, 41), max_new_tokens=3))
    with pkg.make(**kw) as eng:
        claim = eng.accept_claim(prefix, pkg.ClaimMode.OFFLOADABLE)
        r1 = eng.run(eng.submit(prefix + (30, 31), max_new_tokens=2))
        assert claim.state == pkg.ClaimState.MATERIALIZED
        assert eng.offload_claim(claim.claim_id, request_id=r1.request_id)
        if path == "B":
            eng.connector.injection.resident_claim_load_failure = True
            eng.connector.injection.fail_claim_id = claim.claim_id
        r2 = eng.run(eng.submit(prefix + (40, 41), max_new_tokens=3))
        assert an.validate_event_sequence(eng.events).passed
        if path == "A":
            assert r2.status == "finished" and r2.restored_tokens == 600
            assert r2.output_tokens == cold.output_tokens
            v = an.check_observation_path(eng.events, claim.claim_id, r2.request_id)
        else:
            assert r2.status == "refused" and r2.output_tokens == []
            assert claim.state == pkg.ClaimState.RESTORATION_FAILED
            v = an.check_failure_outcome_path(eng.events, claim.claim_id, r2.request_id)
        assert v.passed, v.reasons
        return observe(eng, [r1, r2], [claim], verdict=list(v.reasons))


@pytest.mark.parametrize("path", ["A", "B"])
def test_long_claim_witness_paths_match_jax(pkgs, path):
    """A 600-token claim (150 blocks): A restores it and serves the tokens
    of a never-offloaded engine; B's injected load failure is refused in
    order; both packages alike."""
    both(pkgs, _long_claim, path)


# ---------------------------------------------------------------------------
# h2o-danube: past the window, paged and dense, claims at the window
# ---------------------------------------------------------------------------


def _windowed_serving(pkg, mode):
    prompts = _prompts(64, (200, 90), 30)
    kw = dict(decode_mode=mode, device_blocks=160, cache_len=64)
    with pkg.make(**kw) as eng:
        reqs = [eng.submit(p, max_new_tokens=40) for p in prompts]
        eng.run_batch(reqs)
        assert all(r.status == "finished" and len(r.output_tokens) == 40 for r in reqs)
        assert not eng.fail_closed_total()
        pages = [_pages(eng, p) for p in prompts] if mode == "paged" else []
        return observe(eng, reqs), pages


@pytest.mark.parametrize("mode", ["paged", "dense"])
def test_windowed_prompts_match_jax(dpkgs, mode):
    """Prompts of 200 and 90 tokens, 12 and 5 windows long, with 40 new
    tokens each: in the dense mode the 16-slot ring wraps twice past the
    prompt (the reference's slot arithmetic, its long-prefill quirk
    included); the paged mode masks by the window in K1 and K2."""
    both_with_pages(dpkgs, _windowed_serving, mode)


def _window_claims(pkg):
    window = pkg.cfg.sliding_window
    prefix = _prompts(64, (window - 4,), 31)[0]
    deep = _prompts(64, (window + 4,), 32)[0]
    with pkg.make() as cold_eng:
        cold = cold_eng.run(cold_eng.submit(prefix + (40, 41), max_new_tokens=3))
    with pkg.make(host_blocks=32) as eng:
        with pytest.raises(pkg.ClaimRejected):
            eng.accept_claim(deep, pkg.ClaimMode.OFFLOADABLE)
        assert not eng.events.named("resident_claim_accepted")
        claim = eng.accept_claim(prefix, pkg.ClaimMode.OFFLOADABLE)
        r1 = eng.run(eng.submit(prefix + (30, 31), max_new_tokens=2))
        assert eng.offload_claim(claim.claim_id, request_id=r1.request_id)
        r2 = eng.run(eng.submit(prefix + (40, 41), max_new_tokens=3))
        assert r2.status == "finished" and r2.restored_tokens == window - 4
        assert r2.output_tokens == cold.output_tokens
        v = pkg.analyzer.check_observation_path(eng.events, claim.claim_id, r2.request_id)
        assert v.passed, v.reasons
        return observe(eng, [r1, r2], [claim], verdict=list(v.reasons))


def test_window_bounds_the_claim_in_both_packages(dpkgs):
    """A claim four tokens past the 16-key window is rejected with nothing
    registered; one four tokens inside it is accepted, offloaded and
    restored through path A with the never-offloaded tokens."""
    both(dpkgs, _window_claims)


def test_decode_at_long_500k_position_matches_jax(dpkgs):
    """``decode_fn`` at position 524,287 over a 16-slot ring holding
    positions 524,272-524,287 (seeded K/V): the port's logits and ring
    positions against the JAX package's."""
    cfg, jb, jp, tb, tp = (dpkgs["jax"].cfg, dpkgs["jax"].jb, dpkgs["jax"].jp, dpkgs["port"].tb,
                           dpkgs["port"].tp)
    W, L, KV, D = cfg.sliding_window, cfg.num_layers, cfg.num_kv_heads, cfg.resolved_head_dim
    rng = np.random.default_rng(500)
    k = rng.normal(size=(L, 1, W, KV, D)).astype(np.float32)
    v = rng.normal(size=(L, 1, W, KV, D)).astype(np.float32)
    pos = np.arange(LONG_500K - W, LONG_500K, dtype=np.int32)
    ring = np.empty(W, np.int32)
    ring[pos % W] = pos
    tok, cur = np.array([7], np.int32), np.array([LONG_500K - 1], np.int32)
    jcache = jb.make_cache(1, W)
    jcache = dict(jcache, k=jnp.asarray(k, jcache["k"].dtype), v=jnp.asarray(v, jcache["v"].dtype),
                  pos=jnp.asarray(ring[None]))
    want, jnew = jb.decode_fn(jp, jcache, jnp.asarray(tok), jnp.asarray(cur))
    tcache = tb.make_cache(1, W)
    tcache = dict(tcache, k=torch.from_numpy(k).to(tcache["k"].dtype),
                  v=torch.from_numpy(v).to(tcache["v"].dtype), pos=torch.from_numpy(ring[None]))
    got, tnew = tb.decode_fn(tp, tcache, torch.from_numpy(tok), torch.from_numpy(cur))
    np.testing.assert_array_equal(tnew["pos"].numpy(), np.asarray(jnew["pos"]))
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               atol=LOGITS_ATOL, rtol=0)
    assert int(got.argmax()) == int(np.asarray(want).argmax())


def test_chunk_size_invariance_under_the_window_bitwise(dpkgs):
    """Within the port, float32: a 200-token prompt at ``prefill_chunk`` 8
    and 64 gives the same entry logits and page bytes, bit for bit."""
    out = []
    for chunk in (8, 64):
        with dpkgs["port"].make(device_blocks=96, prefill_chunk=chunk) as eng:
            prompt = _prompts(64, (200,), 33)[0]
            out.append((eng.prefill_logits(prompt), _pages(eng, prompt)))
    (la, (na, ka, va)), (lb, (nb, kb, vb)) = out
    assert na == nb == 50
    assert np.array_equal(la, lb)
    assert np.array_equal(ka, kb) and np.array_equal(va, vb)

"""The port's serving slice as a whole against the JAX package's engine.

The JAX ``ServingEngine`` and the port's ``ServingEngine(device="cpu")`` get
the same bridged parameters (``params_from_jax``), prompts and claim
scenarios at the reduced configs (block_size 4; stablelm-12b keeps its
head_dim 160 at G = 4 and deepseek-7b its G = 1: ``small`` in
tests/test_torch_params.py).  Checked
here:

* greedy tokens are equal (float32 weights: the comparison is about the
  algorithm, and bf16 rounding at other places in the two frameworks could
  flip a near-tie argmax);
* ``prefill_logits`` agree — float32 within 1e-5 (measured max |d|
  1.6e-7 on qwen3), bf16 within 3e-2 (measured max |d| 2.6e-3 on qwen3;
  3e-2 is the JAX package's own cross-graph logits tolerance);
* per-request and per-claim (name, payload) event projections are equal,
  ``nbytes`` and footprints included;
* witness paths A and B pass the JAX package's analyzer on the port's
  events; radix reuse with copy-on-write matches;
* within the port, bitwise: chunk-size invariance (8/16/32) and
  restored-vs-cold parity.
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
from repro.models.registry import build_model as jax_build_model
from repro.serving.engine import ServingEngine as JaxEngine
from repro_torch.configs import get_config as t_get_config
from repro_torch.configs import reduced as t_reduced
from repro_torch.core.claims import ClaimMode, ClaimState
from repro_torch.models.registry import build_model
from repro_torch.params import params_from_jax
from repro_torch.serving.engine import ServingEngine
from test_torch_params import ARCHS, small

PREFIX = tuple(range(10, 26))  # 16 tokens = 4 blocks of 4
TIMED = {"stage_latency"}  # payloads carry wall-clock seconds

@pytest.fixture(scope="module", params=ARCHS)
def pair(request):
    """(cfg name, {dtype: (jax bundle, jax params, port bundle, port params)})."""
    cfg = small(reduced, get_config(request.param))
    jb = jax_build_model(cfg)
    jp = jb.init_params(jax.random.PRNGKey(0))
    tb = build_model(small(t_reduced, t_get_config(request.param)), device="cpu")
    out = {}
    for dtype in ("bfloat16", "float32"):
        p = jp if dtype == "bfloat16" else jax.tree.map(lambda a: a.astype(jnp.float32), jp)
        out[dtype] = (jb, p, tb, params_from_jax(jax.tree.map(np.asarray, p), "cpu"))
    return request.param, out


def engines(pair, dtype, **kw):
    jb, jp, tb, tp = pair[1][dtype]
    kw.setdefault("block_size", 4)
    kw.setdefault("device_blocks", 64)
    return JaxEngine(jb, jp, cache_len=64, **kw), ServingEngine(tb, tp, device="cpu", **kw)


def projection(log, key):
    """{id: [(name, payload), ...]} over events carrying that id."""
    out = {}
    for e in log.events:
        ident = getattr(e, key)
        if ident is not None and e.name not in TIMED:
            out.setdefault(ident, []).append((e.name, dict(e.payload)))
    return out


def to_jax_log(log):
    return JEventLog.from_dicts([e.to_dict() for e in log.events])


def test_greedy_tokens_match_jax(pair):
    je, te = engines(pair, "float32")
    prompts = [
        PREFIX + (30, 31),
        PREFIX + (40, 41, 42),
        tuple(range(100, 137)),
        tuple(range(200, 216)),  # block-aligned: exact-prefix feed
    ]
    jr = je.run_batch([je.submit(p, max_new_tokens=5) for p in prompts])
    tr = te.run_batch([te.submit(p, max_new_tokens=5) for p in prompts])
    # a second batch descends the radix index onto the first batch's pages
    jr += je.run_batch([je.submit(PREFIX + (50, 51), max_new_tokens=5)])
    tr += te.run_batch([te.submit(PREFIX + (50, 51), max_new_tokens=5)])
    for a, b in zip(jr, tr):
        assert (a.status, a.output_tokens, a.cached_tokens) == (b.status, b.output_tokens, b.cached_tokens)
        assert b.status == "finished" and len(b.output_tokens) == 5
    assert te.prefix_reuse_hits.value() == je.prefix_reuse_hits.value() > 0
    assert projection(te.events, "request_id") == projection(je.events, "request_id")
    te.close()
    je.close()


@pytest.mark.parametrize("dtype,tol", [("float32", 1e-5), ("bfloat16", 3e-2)])
def test_prefill_logits_match_jax(pair, dtype, tol):
    je, te = engines(pair, dtype)
    for prompt in (tuple(range(300, 340)), tuple(range(500, 537))):
        lj = je.prefill_logits(prompt)
        lt = te.prefill_logits(prompt)
        assert lt.shape == lj.shape and np.isfinite(lt).all()
        np.testing.assert_allclose(lt, lj, rtol=tol, atol=tol)
        assert lt.argmax() == lj.argmax()
    te.close()
    je.close()


def _claim_cycle(eng, mode_cls, fail):
    claim = eng.accept_claim(PREFIX, mode_cls.OFFLOADABLE)
    r1 = eng.submit(PREFIX + (30, 31), max_new_tokens=2)
    eng.run(r1)
    assert eng.offload_claim(claim.claim_id, request_id=r1.request_id)
    if fail:
        eng.connector.injection.resident_claim_load_failure = True
        eng.connector.injection.fail_claim_id = claim.claim_id
    r2 = eng.submit(PREFIX + (40, 41), max_new_tokens=2)
    eng.run(r2)
    return claim, r1, r2


@pytest.mark.parametrize("fail", [False, True], ids=["path_a", "path_b"])
def test_witness_paths_match_jax(pair, fail):
    je, te = engines(pair, "float32")
    jc, _, jr2 = _claim_cycle(je, JClaimMode, fail)
    tc, _, tr2 = _claim_cycle(te, ClaimMode, fail)
    assert (tr2.status, tr2.output_tokens, tr2.restored_tokens) == (
        jr2.status, jr2.output_tokens, jr2.restored_tokens,
    )
    assert tc.state.value == jc.state.value
    log = to_jax_log(te.events)
    assert analyzer.validate_event_sequence(log).passed
    if fail:
        assert tr2.status == "refused" and tr2.output_tokens == []
        assert tc.state == ClaimState.RESTORATION_FAILED
        v = analyzer.check_failure_outcome_path(log, tc.claim_id, tr2.request_id)
    else:
        assert tr2.restored_tokens == len(PREFIX) and tc.state == ClaimState.RESTORED
        v = analyzer.check_observation_path(log, tc.claim_id, tr2.request_id)
        assert not te.fail_closed_total()
    assert v.passed, v.reasons
    assert analyzer.check_metrics_reconcile(log, te.metrics).passed
    assert projection(te.events, "request_id") == projection(je.events, "request_id")
    assert projection(te.events, "claim_id") == projection(je.events, "claim_id")
    assert te.fail_closed_total() == je.fail_closed_total()
    te.close()
    je.close()


def test_radix_cow_matches_jax(pair):
    """Two continuations diverging inside a shared decode-tail block: COW
    witnessed, shared bytes untouched, reuse zero-copy, tokens as in JAX."""
    je, te = engines(pair, "float32")
    outs = {}
    for name, eng in (("jax", je), ("port", te)):
        t1 = tuple(range(40, 56))
        r1 = eng.submit(t1, max_new_tokens=6)
        eng.run(r1)
        seq1 = t1 + tuple(r1.output_tokens)
        r2 = eng.submit(seq1 + (901, 902), max_new_tokens=2)
        r3 = eng.submit(seq1 + (911, 912), max_new_tokens=2)
        if name == "port":
            blocks = eng.pool.lookup_prefix(seq1, eng.block_size)
            pb = eng.pool.lookup_partial(blocks[-1].chain, seq1[20:])
            n_shared = len(pb.tokens)
            before = pb.k[:, :n_shared].clone()
            store = eng.pool.k_pages.untyped_storage().data_ptr()
            for b in blocks + [pb]:
                assert b.k.untyped_storage().data_ptr() == store, "reuse must be zero-copy"
        eng.run_batch([r2, r3])
        outs[name] = [r.output_tokens for r in (r1, r2, r3)] + [len(eng.events.named("page_cow"))]
    assert outs["port"] == outs["jax"]
    assert outs["port"][-1] > 0
    assert torch.equal(pb.k[:, :n_shared], before), "shared bytes moved"
    te.pool.assert_consistent()
    log = to_jax_log(te.events)
    assert analyzer.check_shared_page_immutability(log).passed
    assert analyzer.check_step_interleave_order(log).passed
    te.close()
    je.close()


def _port_engine(pair, **kw):
    _, _, tb, tp = pair[1]["bfloat16"]
    kw.setdefault("block_size", 4)
    kw.setdefault("device_blocks", 64)
    return ServingEngine(tb, tp, device="cpu", **kw)


@pytest.mark.parametrize("chunk", [8, 16, 32])
def test_chunk_size_invariance_bitwise(pair, chunk):
    """Tolerance: none (bf16, the serving dtype)."""
    prompt = tuple(range(300, 340))
    with _port_engine(pair, prefill_chunk=64) as a, _port_engine(pair, prefill_chunk=chunk) as b:
        assert np.array_equal(a.prefill_logits(prompt), b.prefill_logits(prompt))


def test_restored_vs_cold_bitwise(pair):
    """A block-aligned prompt served cold and through offload -> disk ->
    restore yields identical logits (bf16, no tolerance).  A sliding-window
    config accepts claims no deeper than its window."""
    window = pair[1]["bfloat16"][2].cfg.sliding_window
    prompt = tuple(range(600, 600 + (window or 40)))
    with _port_engine(pair) as cold:
        lg_cold = cold.prefill_logits(prompt)
    with _port_engine(pair) as eng:
        claim = eng.accept_claim(prompt, ClaimMode.OFFLOADABLE)
        eng.run(eng.submit(prompt, max_new_tokens=1))
        assert claim.state == ClaimState.MATERIALIZED
        assert eng.offload_claim(claim.claim_id, tier="disk")
        assert np.array_equal(eng.prefill_logits(prompt), lg_cold)
        assert claim.state == ClaimState.RESTORED

"""tests/test_radix_reuse.py held against the port (CPU).

Pool-wide radix prefix reuse at the engine level, each scenario run on the
JAX ``ServingEngine`` and on the port's (reduced qwen3-1.7b, paged decode,
the same float32 parameters bridged by ``params_from_jax``), with the
reference test's assertions on both and the two runs' observations equal
(``test_torch_failure_paths.observe``, plus each scenario's own extras):
multi-turn reuse of prompt AND decode-tail pages, the no-sharing baseline,
divergent continuations' copy-on-write, a fault on a shared restore
failing every sharer closed while a bystander serves (corruption and a
permanent I/O fault), and claim expiry releasing only its own scope.
"""
import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config, reduced
from repro.models.registry import build_model as jax_build_model
from repro.serving.engine import ServingEngine as JaxEngine
from repro_torch.configs import get_config as t_get_config
from repro_torch.configs import reduced as t_reduced
from repro_torch.models.registry import build_model
from repro_torch.params import params_from_jax
from repro_torch.serving.engine import ServingEngine
from test_torch_failure_paths import both, observe
from test_torch_failure_paths import pkgs as f32_pkgs
from torch_one_thread import one_torch_thread  # noqa: F401  (autouse fixture)


@pytest.fixture(scope="module")
def pkgs(f32_pkgs):
    """The shared harness's packages over the reference test's own bfloat16
    parameters (the JAX init uncast): byte identity of a reused prefix is a
    bf16 property in the port (ROADMAP Queue 3: in float32 the port's
    prefill logits move in the last bits between chunk sizes)."""
    cfg = reduced(get_config("qwen3-1.7b"))
    jb = jax_build_model(cfg)
    jp = jb.init_params(jax.random.PRNGKey(0))
    tb = build_model(t_reduced(t_get_config("qwen3-1.7b")), device="cpu")
    tp = params_from_jax(jax.tree.map(np.asarray, jp), "cpu")
    out = {k: type(v)(**vars(v)) for k, v in f32_pkgs.items()}
    out["jax"].engine = lambda **kw: JaxEngine(jb, jp, **kw)
    out["port"].engine = lambda **kw: ServingEngine(tb, tp, device="cpu", **kw)
    return out


def _make(pkg, **kw):
    return pkg.make(decode_mode="paged", **kw)


def _shares_pool(eng, blk) -> bool:
    """The block's payload is a view of the pool-wide page array."""
    if isinstance(blk.k, torch.Tensor):
        return blk.k.untyped_storage().data_ptr() == eng.pool.k_pages.untyped_storage().data_ptr()
    return np.shares_memory(blk.k, eng.pool.k_pages)


def _copy(x):
    return x.clone().float().numpy() if isinstance(x, torch.Tensor) else np.array(x, np.float32)


def _counter_total(pkg, eng, family):
    return sum(pkg.analyzer._counter_series(eng.metrics.snapshot(), family).values())


def _multi_turn(pkg):
    """Turn 2 reuses turn 1's prompt blocks AND its readmitted decode tail:
    the same pool pages, a ``prefix_reuse`` admission, and prefill logits
    byte-identical to a cold engine's serve of the whole prompt."""
    an = pkg.analyzer
    with _make(pkg) as eng, _make(pkg) as cold, _make(pkg) as cold2:
        t1 = tuple(range(10, 26))  # 16 tokens = 4 blocks
        r1 = eng.run(eng.submit(t1, max_new_tokens=6))
        assert r1.status == "finished" and len(r1.output_tokens) == 6
        t2 = t1 + tuple(r1.output_tokens) + (901, 902)  # 5 full blocks + a 2-token tail
        blocks = eng.pool.lookup_prefix(t2, eng.block_size)
        assert len(blocks) == 5, "prompt + folded decode tokens must be resident"
        pb = eng.pool.lookup_partial(blocks[-1].chain, t2[20:])
        assert pb is not None and pb.tokens == tuple(r1.output_tokens[4:])
        for b in blocks + [pb]:
            assert b.page_index is not None
            assert _shares_pool(eng, b), "reuse must be zero-copy"
        lg_warm = eng.prefill_logits(t2, max_new_tokens=2)
        lg_cold = cold.prefill_logits(t2, max_new_tokens=2)
        assert np.array_equal(lg_warm, lg_cold), "shared-prefix serve must be byte-identical"
        ev = eng.events.named("prefix_reuse")
        assert ev, "warm admission must witness the reuse"
        assert ev[-1].payload["n_tokens"] == 22
        assert ev[-1].payload["n_blocks"] == 6
        assert ev[-1].payload["partial_tokens"] == 2
        r2 = eng.run(eng.submit(t2, max_new_tokens=4))
        rc = cold2.run(cold2.submit(t2, max_new_tokens=4))
        assert r2.status == "finished" and r2.output_tokens == rc.output_tokens
        eng.pool.assert_consistent()
        assert an.validate_event_sequence(eng.events).passed
        assert an.check_shared_page_immutability(eng.events).passed
        assert an.check_metrics_reconcile(eng.events, eng.metrics).passed
        # the prefill_logits probe leaves its request un-decoded
        assert an.check_step_interleave_order(eng.events, require_terminal=False).passed
        return observe(eng, [r1, r2], pages=[b.page_index for b in blocks + [pb]],
                       reuse=[(e.payload["n_tokens"], e.payload["n_blocks"]) for e in ev])


def test_multi_turn_reuse_shares_pages_and_logits(pkgs):
    both(pkgs, _multi_turn)


def _no_sharing(pkg):
    """prefix_sharing=False salts every chain: a repeat serve reuses
    nothing, and the outputs still agree."""
    with _make(pkg, prefix_sharing=False) as eng:
        prompt = tuple(range(120, 136)) + (30, 31)
        r1 = eng.run(eng.submit(prompt, max_new_tokens=3))
        r2 = eng.run(eng.submit(prompt, max_new_tokens=3))
        assert r2.cached_tokens == 0
        assert not eng.events.named("prefix_reuse")
        assert not eng.events.named("page_cow")
        assert r1.output_tokens == r2.output_tokens
        return observe(eng, [r1, r2])


def test_no_sharing_baseline_isolates_requests(pkgs):
    both(pkgs, _no_sharing)


def _cow(pkg):
    """Two continuations diverging inside the shared decode-tail block copy
    it on write; the shared bytes never move; both serves equal cold serves."""
    an = pkg.analyzer
    with _make(pkg) as eng:
        t1 = tuple(range(40, 56))
        r1 = eng.run(eng.submit(t1, max_new_tokens=6))
        seq1 = t1 + tuple(r1.output_tokens)  # 22 tokens
        blocks = eng.pool.lookup_prefix(seq1, eng.block_size)
        pb = eng.pool.lookup_partial(blocks[-1].chain, seq1[20:])
        assert pb is not None
        n_shared = len(pb.tokens)
        shared_before = _copy(pb.k[:, :n_shared])
        p2, p3 = seq1 + (901, 902), seq1 + (911, 912)
        r2 = eng.submit(p2, max_new_tokens=2)
        r3 = eng.submit(p3, max_new_tokens=2)
        eng.run_batch([r2, r3])
        assert r2.status == "finished" and r3.status == "finished"
        cows = eng.events.named("page_cow")
        assert cows, "diverging continuations over a shared partial must COW"
        for e in cows:
            assert e.payload["refcount"] > 1
            assert e.payload["new_page_index"] != e.payload["page_index"]
        assert _counter_total(pkg, eng, "cow_copies_total") == len(cows)
        assert np.array_equal(_copy(pb.k[:, :n_shared]), shared_before)
        for req, prompt in ((r2, p2), (r3, p3)):
            with _make(pkg) as cold:
                rc = cold.run(cold.submit(prompt, max_new_tokens=2))
            assert req.output_tokens == rc.output_tokens
        eng.pool.assert_consistent()
        assert an.check_shared_page_immutability(eng.events).passed
        assert an.check_metrics_reconcile(eng.events, eng.metrics).passed
        return observe(eng, [r1, r2, r3],
                       cows=[(e.payload["refcount"], e.payload["page_index"],
                              e.payload["new_page_index"]) for e in cows])


def test_divergent_continuations_cow_shared_tail(pkgs):
    both(pkgs, _cow)


def _shared_restore_fault(pkg, trigger_name):
    """A fault on a restore whose leading blocks two nested claims cover
    fails BOTH closed, each with its own E12 and one refusal naming both,
    while a bystander claim restores and serves as a cold engine does."""
    an, ch = pkg.analyzer, pkg.chaos
    trigger = getattr(ch, trigger_name)
    plan = ch.FaultPlan(seed=11)
    with _make(pkg, fault_plan=plan, quarantine_after=None) as eng:
        p8 = tuple(range(200, 208))
        p16 = p8 + tuple(range(210, 218))  # extends p8: leading blocks shared
        pc = tuple(range(300, 316))  # disjoint bystander prefix
        a = eng.accept_claim(p8, pkg.ClaimMode.OFFLOADABLE)
        b = eng.accept_claim(p16, pkg.ClaimMode.OFFLOADABLE)
        c = eng.accept_claim(pc, pkg.ClaimMode.OFFLOADABLE)
        eng.run(eng.submit(p16 + (30, 31), max_new_tokens=1))
        eng.run(eng.submit(pc + (30, 31), max_new_tokens=1))
        for blk in eng.pool.lookup_prefix(p8, eng.block_size):
            assert {a.claim_id, b.claim_id} <= blk.claim_ids
        # offload B, bring A's 2 leading blocks back by an unclaimed restore,
        # then offload A: both claims OFFLOADED, the next p16 restore covers both
        assert eng.offload_claim(b.claim_id)
        r_mid = eng.run(eng.submit(p8 + (40, 41), max_new_tokens=1))
        assert r_mid.status == "finished" and b.state == pkg.ClaimState.OFFLOADED
        if trigger == ch.TRIGGER_CORRUPTION:
            plan.schedule(ch.FaultSpec(trigger, boundary="host", claim_id=a.claim_id))
        assert eng.offload_claim(a.claim_id)
        assert eng.offload_claim(c.claim_id)
        if trigger == ch.TRIGGER_PERMANENT:
            plan.schedule(ch.FaultSpec(trigger, boundary="host_to_device", claim_id=a.claim_id))
        r = eng.run(eng.submit(p16 + (50, 51), max_new_tokens=2))
        assert r.status == "refused" and r.output_tokens == []
        assert a.state == pkg.ClaimState.RESTORATION_FAILED
        assert b.state == pkg.ClaimState.RESTORATION_FAILED
        e12 = eng.events.named("scheduler_resident_claim_restoration_failed")
        assert {e.claim_id for e in e12} >= {a.claim_id, b.claim_id}
        e13 = [e for e in eng.events.named("scheduler_active_request_refused")
               if e.request_id == r.request_id]
        assert e13 and set(e13[0].payload["blocking_claim_ids"]) == {a.claim_id, b.claim_id}
        assert eng.fail_closed_total() == {trigger: 1}
        r4 = eng.run(eng.submit(pc + (60, 61), max_new_tokens=2))
        assert r4.status == "finished" and c.state == pkg.ClaimState.RESTORED
        with _make(pkg) as cold:
            rc = cold.run(cold.submit(pc + (60, 61), max_new_tokens=2))
        assert r4.output_tokens == rc.output_tokens
        assert an.validate_event_sequence(eng.events).passed
        assert an.check_fail_closed_attribution(eng.events).passed
        assert an.check_metrics_reconcile(eng.events, eng.metrics).passed
        assert an.check_shared_page_immutability(eng.events).passed
        return observe(eng, [r_mid, r, r4], [a, b, c])


@pytest.mark.parametrize("trigger", ["TRIGGER_CORRUPTION", "TRIGGER_PERMANENT"])
def test_fault_on_shared_restore_fails_every_sharer_closed(pkgs, trigger):
    both(pkgs, _shared_restore_fault, trigger)


def _expiry_scope(pkg):
    """Expiry of one sharer decrements, never invalidates: the shared
    blocks lose the expired claim and keep the survivor's, and serve on."""
    with _make(pkg) as eng:
        p8 = tuple(range(600, 608))
        p16 = p8 + tuple(range(610, 618))
        a = eng.accept_claim(p8, pkg.ClaimMode.EXPIRING, duration_s=3600.0)
        b = eng.accept_claim(p16, pkg.ClaimMode.SOFT_PRIORITY, priority=5)
        r1 = eng.run(eng.submit(p16 + (30, 31), max_new_tokens=1))
        blocks = eng.pool.lookup_prefix(p16, eng.block_size)
        assert len(blocks) == 4
        shared = blocks[:2]
        for blk in shared:
            assert {a.claim_id, b.claim_id} <= blk.claim_ids
            assert blk.priority == 5
        expired = eng.scheduler.sweep_expiry(now=float("inf"))
        assert [cl.claim_id for cl in expired] == [a.claim_id]
        eng._release_claim_blocks(expired)
        assert a.state == pkg.ClaimState.EXPIRED
        for blk in shared:
            assert a.claim_id not in blk.claim_ids
            assert b.claim_id in blk.claim_ids, "live sharer must keep its claim"
            assert blk.priority == 5, "priority recomputed from the survivor"
            assert blk.block_id in eng.pool.blocks, "shared block never invalidated"
        assert eng.pool.lookup_prefix(p16, eng.block_size) == blocks
        r2 = eng.run(eng.submit(p16 + (40, 41), max_new_tokens=1))
        assert r2.status == "finished" and r2.cached_tokens >= len(p16)
        eng.pool.assert_consistent()
        return observe(eng, [r1, r2], [a, b],
                       shared=[sorted(blk.claim_ids) for blk in shared])


def test_claim_expiry_releases_only_its_scope(pkgs):
    both(pkgs, _expiry_scope)

"""The JAX package's failure-path tests, held against the port (CPU).

Each scenario of tests/test_cache_object_lifecycle.py (the KV half),
tests/test_scheduler.py, tests/test_chunked_prefill.py and
tests/test_paged_decode.py runs twice, once on the JAX ``ServingEngine``
and once on the port's (``device="cpu"``), with the same reduced qwen3-1.7b
parameters (float32, bridged by ``params_from_jax``), prompts, injected
faults and stubbed launches.  Each run keeps the reference test's own
assertions, and the two runs' observations must be equal:

* the ordered event stream projected to (name, request id, claim id,
  blocking claim ids, trigger, reason), string for string;
* ``fail_closed_total`` and every request's status, error string, output
  tokens and cached/restored token counts;
* every claim's state and the pool's refcounts.

The harness (``Pkg``, ``both``, ``observe``) is shared with
tests/test_torch_chaos.py.  A launch failure is injected where each
engine launches: the JAX engine's ``_jit_paged_decode``,
``_jit_prefill_chunk`` and ``_jit_decode``, the port's
``_step_paged_decode``, ``_step_prefill_chunk`` and ``_step_decode``.
"""
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import repro.core.analyzer as j_analyzer
import repro.serving.chaos as j_chaos
import repro.serving.kv_cache as j_kv
import repro.serving.offload as j_offload
import repro.serving.tiers as j_tiers
import repro.serving.transfer_queue as j_tq
import repro_torch.core.analyzer as t_analyzer
import repro_torch.serving.chaos as t_chaos
import repro_torch.serving.kv_cache as t_kv
import repro_torch.serving.offload as t_offload
import repro_torch.serving.tiers as t_tiers
import repro_torch.serving.transfer_queue as t_tq
from repro.configs import get_config, reduced
from repro.core.claims import ClaimMode as JClaimMode
from repro.core.claims import ClaimState as JClaimState
from repro.core.events import EventLog as JEventLog
from repro.models.registry import build_model as jax_build_model
from repro.serving.engine import ServingEngine as JaxEngine
from repro_torch.configs import get_config as t_get_config
from repro_torch.configs import reduced as t_reduced
from repro_torch.core.claims import ClaimMode, ClaimState
from repro_torch.core.events import EventLog
from repro_torch.models.registry import build_model
from repro_torch.params import params_from_jax
from repro_torch.serving.engine import ServingEngine

PREFIX = tuple(range(10, 26))  # 16 tokens = 4 blocks of 4
TIMED = {"stage_latency"}  # payloads carry wall-clock seconds
LAUNCH = {  # engine attribute of each launch, per package
    "jax": dict(paged_decode="_jit_paged_decode", prefill_chunk="_jit_prefill_chunk",
                decode="_jit_decode"),
    "port": dict(paged_decode="_step_paged_decode", prefill_chunk="_step_prefill_chunk",
                 decode="_step_decode"),
}


class Pkg(SimpleNamespace):
    """One package's names, and ``make(**kw)``: a reduced qwen3 engine
    (block_size 4, device_blocks 64, cache_len 64 unless overridden)."""

    def make(self, **kw):
        kw.setdefault("block_size", 4)
        kw.setdefault("device_blocks", 64)
        kw.setdefault("cache_len", 64)
        return self.engine(**kw)

    def stub_launch(self, eng, which, message):
        """Replace one launch of ``eng`` by a function that raises."""
        def boom(*args):
            raise RuntimeError(message)

        setattr(eng, LAUNCH[self.name][which], boom)


@pytest.fixture(scope="module")
def pkgs():
    """{"jax": Pkg, "port": Pkg} over the same float32 parameters."""
    cfg = reduced(get_config("qwen3-1.7b"))
    jb = jax_build_model(cfg)
    jp = jax.tree.map(lambda a: a.astype(jnp.float32), jb.init_params(jax.random.PRNGKey(0)))
    tb = build_model(t_reduced(t_get_config("qwen3-1.7b")), device="cpu")
    tp = params_from_jax(jax.tree.map(np.asarray, jp), "cpu")
    common = dict(PREFIX=PREFIX)
    return {
        "jax": Pkg(name="jax", ClaimMode=JClaimMode, ClaimState=JClaimState, chaos=j_chaos,
                   kv=j_kv, offload=j_offload, tiers=j_tiers, tq=j_tq, analyzer=j_analyzer,
                   EventLog=JEventLog, engine=lambda **kw: JaxEngine(jb, jp, **kw), **common),
        "port": Pkg(name="port", ClaimMode=ClaimMode, ClaimState=ClaimState, chaos=t_chaos,
                    kv=t_kv, offload=t_offload, tiers=t_tiers, tq=t_tq, analyzer=t_analyzer,
                    EventLog=EventLog,
                    engine=lambda **kw: ServingEngine(tb, tp, device="cpu", **kw), **common),
    }


def project(log):
    """The ordered events as (name, request id, claim id, blocking claim
    ids, trigger, reason)."""
    return [
        (e.name, e.request_id, e.claim_id, tuple(e.payload.get("blocking_claim_ids") or ()),
         e.payload.get("trigger"), e.payload.get("reason"))
        for e in log.events if e.name not in TIMED
    ]


def observe(eng, reqs=(), claims=(), **extra):
    """What the two packages must agree on after a scenario."""
    return dict(
        events=project(eng.events),
        fail_closed=eng.fail_closed_total(),
        requests=[(r.request_id, r.status, r.error, list(r.output_tokens), r.cached_tokens,
                   r.restored_tokens) for r in reqs],
        claims=[(c.claim_id, c.state.value) for c in claims],
        refs=sorted((bid, b.ref) for bid, b in eng.pool.blocks.items()),
        **extra,
    )


def both(pkgs, scenario, *args, **kw):
    """Run ``scenario(pkg, ...)`` on the reference and on the port; their
    observations must be equal.  Returns the port's."""
    want = scenario(pkgs["jax"], *args, **kw)
    got = scenario(pkgs["port"], *args, **kw)
    assert got.keys() == want.keys()
    for key in want:
        assert got[key] == want[key], key
    return got


def terminal(eng, req):
    fin = [e for e in eng.events.named("request_finished") if e.request_id == req.request_id]
    assert len(fin) == 1
    return fin[0].payload["status"]


# ---------------------------------------------------------------------------
# tests/test_cache_object_lifecycle.py, the KV half
# ---------------------------------------------------------------------------


def _materialize(eng, prefix):
    return eng.run(eng.submit(prefix + (30, 31), max_new_tokens=1))


def _reuse(eng, prefix, extra=(40, 41), max_new_tokens=2):
    return eng.run(eng.submit(prefix + extra, max_new_tokens=max_new_tokens))


def _restore_failure(pkg, tier):
    an = pkg.analyzer
    eng = pkg.make()
    claim = eng.accept_claim(PREFIX, pkg.ClaimMode.OFFLOADABLE)
    r1 = _materialize(eng, PREFIX)
    assert claim.state == pkg.ClaimState.MATERIALIZED
    assert eng.offload_claim(claim.claim_id, tier=tier)
    assert claim.state == pkg.ClaimState.OFFLOADED
    if tier == "disk":
        assert eng.disk.used > 0 and eng.host.used == 0
        assert all(b.k is None for b in eng.disk.blocks.values())
    eng.connector.injection.resident_claim_load_failure = True
    eng.connector.injection.fail_claim_id = claim.claim_id
    req = _reuse(eng, PREFIX)
    assert req.status == "refused" and req.output_tokens == []
    assert claim.state == pkg.ClaimState.RESTORATION_FAILED
    assert an.validate_event_sequence(eng.events).passed
    v = an.check_failure_outcome_path(eng.events, claim.claim_id, req.request_id, source_tier=tier)
    assert v.passed, v.reasons
    e13 = eng.events.named("scheduler_active_request_refused")[0]
    assert e13.payload["blocking_claim_ids"] == [claim.claim_id]
    out = observe(eng, [r1, req], [claim], verdict=(v.passed, list(v.reasons)))
    eng.close()
    return out


@pytest.mark.parametrize("tier", ["host", "disk"])
def test_same_claim_restore_failure_fail_closed(pkgs, tier):
    both(pkgs, _restore_failure, tier)


def _observation_over_tier(pkg, tier):
    an = pkg.analyzer
    with pkg.make() as cold_eng:
        cold = _reuse(cold_eng, PREFIX, max_new_tokens=3)
    eng = pkg.make()
    claim = eng.accept_claim(PREFIX, pkg.ClaimMode.OFFLOADABLE)
    _materialize(eng, PREFIX)
    assert eng.offload_claim(claim.claim_id, tier=tier)
    req = _reuse(eng, PREFIX, max_new_tokens=3)
    assert req.status == "finished" and req.restored_tokens == len(PREFIX)
    assert claim.state == pkg.ClaimState.RESTORED
    assert req.output_tokens == cold.output_tokens
    assert an.validate_event_sequence(eng.events).passed
    v = an.check_observation_path(eng.events, claim.claim_id, req.request_id, source_tier=tier)
    assert v.passed, v.reasons
    if tier == "disk":
        assert eng.events.named("offload_tier_promote")
    out = observe(eng, [req], [claim], cold=cold.output_tokens)
    eng.close()
    return out


@pytest.mark.parametrize("tier", ["host", "disk"])
def test_observation_path_over_tiers(pkgs, tier):
    both(pkgs, _observation_over_tier, tier)


def _spill_failure(pkg):
    inj = pkg.offload.FailureInjectionConfig(
        resident_claim_load_failure=True, fail_tier_boundary="host_to_disk")
    eng = pkg.make(host_blocks=0, injection=inj)
    claim = eng.accept_claim(PREFIX, pkg.ClaimMode.OFFLOADABLE)
    _materialize(eng, PREFIX)
    assert eng.offload_claim(claim.claim_id)
    used = (eng.host.used, eng.disk.used)
    assert used[0] > 0 and used[1] == 0  # the spill failed closed
    fails = [e for e in eng.events.named("offload_worker_transfer_finished")
             if e.payload.get("direction") == "host_to_disk" and not e.payload.get("ok")]
    assert fails
    eng.connector.injection.fail_tier_boundary = None
    eng.connector.injection.resident_claim_load_failure = False
    req = _reuse(eng, PREFIX)
    assert req.status == "finished" and req.restored_tokens == len(PREFIX)
    out = observe(eng, [req], [claim], used=used, failed_spills=len(fails))
    eng.close()
    return out


def test_spill_failure_is_fail_closed(pkgs):
    both(pkgs, _spill_failure)


def _host_overflow(pkg):
    eng = pkg.make(host_blocks=0)
    claim = eng.accept_claim(PREFIX, pkg.ClaimMode.OFFLOADABLE)
    _materialize(eng, PREFIX)
    assert eng.offload_claim(claim.claim_id)
    used = (eng.host.used, eng.disk.used)
    assert used[0] == 0 and used[1] > 0
    assert eng.events.named("offload_tier_spill")
    req = _reuse(eng, PREFIX)
    assert req.status == "finished" and req.restored_tokens == len(PREFIX)
    v = pkg.analyzer.check_observation_path(eng.events, claim.claim_id, req.request_id)
    assert v.passed, v.reasons
    out = observe(eng, [req], [claim], used=used)
    eng.close()
    return out


def test_host_overflow_spills_then_restores(pkgs):
    both(pkgs, _host_overflow)


def _pool_exhaustion_isolation(pkg):
    eng = pkg.make(device_blocks=64)
    orig = eng.pool.add_block
    calls = {"n": 0}

    def flaky(*a, **kw):
        calls["n"] += 1
        if calls["n"] == 4:  # the second request's first prefix-block store
            raise pkg.kv.PoolExhausted("forced", ["claim-blocker"])
        return orig(*a, **kw)

    eng.pool.add_block = flaky
    reqs = [eng.submit(tuple(range(s, s + 12)), max_new_tokens=2) for s in (100, 200, 300)]
    eng.run_batch(reqs)
    assert [r.status for r in reqs] == ["finished", "refused", "finished"]
    assert terminal(eng, reqs[1]) == "REFUSED_ADMISSION"
    ref = [e for e in eng.events.named("scheduler_admission_refused")
           if e.request_id == reqs[1].request_id]
    assert ref and ref[0].payload["blocking_claim_ids"] == ["claim-blocker"]
    assert pkg.analyzer.validate_event_sequence(eng.events).passed
    out = observe(eng, reqs, store_calls=calls["n"])
    eng.close()
    return out


def test_batch_pool_exhaustion_isolation(pkgs):
    both(pkgs, _pool_exhaustion_isolation)


def _two_claims(pkg, eng, tp, op):
    target = eng.accept_claim(tp, pkg.ClaimMode.OFFLOADABLE)
    other = eng.accept_claim(op, pkg.ClaimMode.OFFLOADABLE)
    for pfx in (tp, op):
        eng.run(eng.submit(pfx + (5, 6), max_new_tokens=1))
    eng.offload_claim(target.claim_id)
    eng.offload_claim(other.claim_id, tier="disk")
    eng.connector.injection.resident_claim_load_failure = True
    eng.connector.injection.fail_claim_id = target.claim_id
    return target, other


def _batch_failure_isolation(pkg):
    an = pkg.analyzer
    eng = pkg.make(device_blocks=256)
    tp, op = tuple(range(500, 516)), tuple(range(600, 616))
    target, other = _two_claims(pkg, eng, tp, op)
    reqs = [eng.submit(tp + (7, 8), max_new_tokens=2), eng.submit(op + (7, 8), max_new_tokens=2),
            eng.submit(tuple(range(700, 712)), max_new_tokens=2)]
    eng.run_batch(reqs)
    r_target, r_other, r_fresh = reqs
    assert r_target.status == "refused" and r_target.output_tokens == []
    assert r_other.status == "finished" and r_other.restored_tokens == len(op)
    assert r_fresh.status == "finished"
    assert target.state == pkg.ClaimState.RESTORATION_FAILED
    assert other.state == pkg.ClaimState.RESTORED
    e13s = eng.events.named("scheduler_active_request_refused")
    assert [e.payload["blocking_claim_ids"] for e in e13s] == [[target.claim_id]]
    v = an.check_failure_outcome_path(eng.events, target.claim_id, r_target.request_id)
    assert v.passed, v.reasons
    assert an.validate_event_sequence(eng.events).passed
    out = observe(eng, reqs, [target, other])
    eng.close()
    return out


def test_batch_failure_isolation(pkgs):
    both(pkgs, _batch_failure_isolation)


def _blast_radius_run(pkg, fault):
    """A bystander claim's whole lifecycle runs before a (possibly) faulted
    victim reuse; returns the bystander's outputs, state and request-scoped
    (name, payload) stream, the victim's status, and the observation."""
    plan = pkg.chaos.FaultPlan(seed=99)
    eng = pkg.make(device_blocks=256, fault_plan=plan, quarantine_after=None)
    vp, bp = tuple(range(800, 816)), tuple(range(900, 916))
    victim = eng.accept_claim(vp, pkg.ClaimMode.OFFLOADABLE)
    bystander = eng.accept_claim(bp, pkg.ClaimMode.OFFLOADABLE)
    for pfx in (vp, bp):
        eng.run(eng.submit(pfx + (5, 6), max_new_tokens=1))
    eng.offload_claim(victim.claim_id)
    eng.offload_claim(bystander.claim_id, tier="disk")
    if fault:
        plan.schedule(pkg.chaos.FaultSpec(pkg.chaos.TRIGGER_PERMANENT, boundary="host_to_device",
                                          claim_id=victim.claim_id))
    r_by = eng.run(eng.submit(bp + (7, 8), max_new_tokens=3))
    r_victim = eng.run(eng.submit(vp + (7, 8), max_new_tokens=3))
    by_events = [(e.name, e.payload) for e in eng.events.for_request(r_by.request_id)
                 if e.name not in TIMED]
    out = (r_by.output_tokens, r_by.status, bystander.state.value, by_events, r_victim.status,
           observe(eng, [r_by, r_victim], [victim, bystander], injected=dict(plan.stats.injected)))
    eng.close()
    return out


def _blast_radius(pkg):
    toks_f, status_f, state_f, events_f, victim_f, obs_f = _blast_radius_run(pkg, fault=True)
    toks_c, status_c, state_c, events_c, victim_c, obs_c = _blast_radius_run(pkg, fault=False)
    assert victim_f == "refused" and victim_c == "finished"
    assert toks_f == toks_c
    assert status_f == status_c == "finished"
    assert state_f == state_c == "restored"
    assert events_f == events_c
    assert obs_f["fail_closed"] == obs_f["injected"] == {pkg.chaos.TRIGGER_PERMANENT: 1}
    return dict(faulted=obs_f, clean=obs_c, bystander=(toks_f, events_f))


def test_fault_blast_radius_bystander_byte_identical(pkgs):
    both(pkgs, _blast_radius)


# ---------------------------------------------------------------------------
# tests/test_scheduler.py
# ---------------------------------------------------------------------------


def _interleave_ok(pkg, eng):
    v = pkg.analyzer.check_step_interleave_order(eng.events)
    assert v.passed, v.reasons


def _decode_launch_failure_paged(pkg):
    an = pkg.analyzer
    eng = pkg.make()
    reqs = [eng.submit(tuple(range(100, 112)), max_new_tokens=2),
            eng.submit(tuple(range(200, 212)), max_new_tokens=2)]
    pkg.stub_launch(eng, "paged_decode", "injected decode launch failure")
    assert eng.run_batch(reqs) == reqs  # must not raise
    for r in reqs:
        assert r.status == "error" and "decode_launch_failure" in r.error
        assert terminal(eng, r) == "FINISHED_ERROR"
        wit = [e for e in eng.events.named("fail_closed_refused") if e.request_id == r.request_id]
        assert wit and wit[0].payload["trigger"] == "decode_launch_failure"
    assert eng.fail_closed.get("decode_launch_failure") == 2
    assert all(b.ref == 0 for b in eng.pool.blocks.values())
    assert an.validate_event_sequence(eng.events).passed
    _interleave_ok(pkg, eng)
    assert an.check_metrics_reconcile(eng.events, eng.metrics).passed
    out = observe(eng, reqs)
    eng.close()
    return out


def test_decode_launch_failure_fails_closed_paged(pkgs):
    both(pkgs, _decode_launch_failure_paged)


def _prefill_launch_failure(pkg):
    eng = pkg.make()
    r = eng.submit(tuple(range(300, 324)), max_new_tokens=2)
    pkg.stub_launch(eng, "prefill_chunk", "injected prefill launch failure")
    eng.run_batch([r])
    assert r.status == "error" and "prefill_launch_failure" in r.error
    assert terminal(eng, r) == "FINISHED_ERROR"
    assert all(b.ref == 0 for b in eng.pool.blocks.values())
    _interleave_ok(pkg, eng)
    out = observe(eng, [r])
    eng.close()
    return out


def test_prefill_launch_failure_fails_closed(pkgs):
    both(pkgs, _prefill_launch_failure)


def _decode_launch_failure_dense(pkg):
    eng = pkg.make(decode_mode="dense")
    r = eng.submit(tuple(range(400, 412)), max_new_tokens=2)
    pkg.stub_launch(eng, "decode", "injected dense decode failure")
    eng.run_batch([r])
    assert r.status == "error" and "decode_launch_failure" in r.error
    assert terminal(eng, r) == "FINISHED_ERROR"
    _interleave_ok(pkg, eng)
    out = observe(eng, [r])
    eng.close()
    return out


def test_decode_launch_failure_fails_closed_dense(pkgs):
    both(pkgs, _decode_launch_failure_dense)


def _fifo_under_budget(pkg):
    eng = pkg.make(device_blocks=128, prefill_chunk=8, max_tokens_per_step=16)
    reqs = [eng.submit(tuple(range(50, 58)), max_new_tokens=20),
            eng.submit(tuple(range(100, 124)), max_new_tokens=1),
            eng.submit(tuple(range(200, 228)), max_new_tokens=1),
            eng.submit(tuple(range(300, 336)), max_new_tokens=1)]
    eng.run_batch(reqs)
    assert all(r.status == "finished" for r in reqs)
    assert len(reqs[0].output_tokens) == 20
    assert reqs[1].first_token_ts < reqs[2].first_token_ts < reqs[3].first_token_ts
    assert eng.decode_stalls.value() == 0
    steps = [(e.payload["step_tokens"], e.payload["budget"], e.payload["n_rows"],
              e.payload["prefill_tokens"]) for e in eng.events.named("step_scheduled")]
    assert all(t <= b for t, b, _, _ in steps)
    _interleave_ok(pkg, eng)
    out = observe(eng, reqs, steps=steps)
    eng.close()
    return out


def test_fifo_job_order_under_budget_pressure(pkgs):
    both(pkgs, _fifo_under_budget)


def _midstream_completion(pkg):
    eng = pkg.make(device_blocks=10, prefill_chunk=8)
    reqs = [eng.submit(tuple(range(100, 124)), max_new_tokens=1),  # 6 blocks
            eng.submit(tuple(range(200, 228)), max_new_tokens=1)]  # 7 blocks
    eng.run_batch(reqs)
    assert [r.status for r in reqs] == ["finished", "finished"], [r.error for r in reqs]
    assert all(b.ref == 0 for b in eng.pool.blocks.values())
    _interleave_ok(pkg, eng)
    out = observe(eng, reqs)
    eng.close()
    return out


def test_midstream_completion_frees_pages(pkgs):
    both(pkgs, _midstream_completion)


def _request_projection(eng, req):
    """Per-request (name, sorted payload) with the request id normalized."""
    return [(e.name, tuple(sorted({k: ("<rid>" if v == req.request_id else v)
                                   for k, v in e.payload.items()}.items())))
            for e in eng.events.for_request(req.request_id) if e.name not in TIMED]


def _bystander_under_admission(pkg):
    prompt = tuple(range(100, 112))
    eng_a = pkg.make(device_blocks=128)
    ra = eng_a.submit(prompt, max_new_tokens=4)
    eng_a.run_batch([ra])
    eng_b = pkg.make(device_blocks=128)
    rb = eng_b.submit(prompt, max_new_tokens=4)
    r_long = eng_b.submit(tuple(range(500, 572)), max_new_tokens=2)  # 72 tokens
    eng_b.run_batch([rb, r_long])
    assert ra.status == rb.status == r_long.status == "finished"
    assert ra.output_tokens == rb.output_tokens
    assert _request_projection(eng_a, ra) == _request_projection(eng_b, rb)
    for eng in (eng_a, eng_b):
        _interleave_ok(pkg, eng)
    out = dict(alone=observe(eng_a, [ra]), admitted=observe(eng_b, [rb, r_long]),
               projection=_request_projection(eng_b, rb))
    eng_a.close()
    eng_b.close()
    return out


def test_bystander_projection_byte_identical_under_admission(pkgs):
    both(pkgs, _bystander_under_admission)


# ---------------------------------------------------------------------------
# tests/test_chunked_prefill.py and tests/test_paged_decode.py
# ---------------------------------------------------------------------------


def _mid_prefill_store_failure(pkg):
    eng = pkg.make(prefill_chunk=16)
    calls = {"n": 0}
    orig = eng.pool.add_block

    def failing_add_block(*a, **kw):
        calls["n"] += 1
        if calls["n"] == 6:  # second chunk (chunk 16 -> 4 blocks per chunk)
            raise pkg.kv.PoolExhausted("injected mid-prefill store failure", ["claim-x"])
        return orig(*a, **kw)

    eng.pool.add_block = failing_add_block
    r = eng.run(eng.submit(tuple(range(900, 940)), max_new_tokens=2))
    assert r.status == "refused" and r.output_tokens == []
    assert calls["n"] >= 6
    refusals = [e for e in eng.events.named("scheduler_admission_refused")
                if e.request_id == r.request_id]
    assert refusals and refusals[0].payload["stage"] == "allocation"
    assert refusals[0].payload["blocking_claim_ids"] == ["claim-x"]
    assert terminal(eng, r) == "REFUSED_ADMISSION"
    assert all(b.ref == 0 for b in eng.pool.blocks.values())
    assert pkg.analyzer.validate_event_sequence(eng.events).passed
    out = observe(eng, [r], store_calls=calls["n"])
    eng.close()
    return out


def test_mid_prefill_store_failure_fails_closed(pkgs):
    both(pkgs, _mid_prefill_store_failure)


def _mid_prefill_isolation(pkg):
    eng = pkg.make(device_blocks=10, prefill_chunk=8)
    reqs = [eng.submit(tuple(range(100, 124)), max_new_tokens=2),
            eng.submit(tuple(range(200, 224)), max_new_tokens=2)]
    eng.run_batch(reqs)
    assert sorted(r.status for r in reqs) == ["finished", "refused"]
    ok = reqs[0] if reqs[0].status == "finished" else reqs[1]
    assert len(ok.output_tokens) == 2
    assert all(b.ref == 0 for b in eng.pool.blocks.values())
    assert pkg.analyzer.validate_event_sequence(eng.events).passed
    out = observe(eng, reqs)
    eng.close()
    return out


def test_mid_prefill_failure_isolated_within_bucket(pkgs):
    both(pkgs, _mid_prefill_isolation)


def _tiny_pool_continuation(pkg):
    eng = pkg.make(device_blocks=2)
    r1 = eng.run(eng.submit(tuple(range(100, 108)), max_new_tokens=1))  # fills the pool
    assert r1.status == "finished"
    r2 = eng.run(eng.submit(tuple(range(100, 112)), max_new_tokens=1))  # must not crash
    assert r2.status == "refused"
    assert terminal(eng, r2) == "REFUSED_ADMISSION"
    blocks = eng.pool.lookup_prefix(tuple(range(100, 108)), 4)
    assert len(blocks) == 2 and all(b.ref == 0 for b in blocks)
    out = observe(eng, [r1, r2])
    eng.close()
    return out


def test_tiny_pool_continuation_refuses_not_crashes(pkgs):
    both(pkgs, _tiny_pool_continuation)


def _paged_restore_failure(pkg, tier):
    eng = pkg.make()
    claim = eng.accept_claim(PREFIX, pkg.ClaimMode.OFFLOADABLE)
    r1 = eng.run(eng.submit(PREFIX + (30, 31), max_new_tokens=1))
    assert eng.offload_claim(claim.claim_id, tier=tier)
    eng.connector.injection.resident_claim_load_failure = True
    eng.connector.injection.fail_claim_id = claim.claim_id
    r2 = eng.run(eng.submit(PREFIX + (40, 41), max_new_tokens=2))
    assert r2.status == "refused" and r2.output_tokens == []
    assert claim.state == pkg.ClaimState.RESTORATION_FAILED
    assert pkg.analyzer.validate_event_sequence(eng.events).passed
    v = pkg.analyzer.check_failure_outcome_path(eng.events, claim.claim_id, r2.request_id,
                                                source_tier=tier)
    assert v.passed, v.reasons
    out = observe(eng, [r1, r2], [claim])
    eng.close()
    return out


@pytest.mark.parametrize("tier", ["host", "disk"])
def test_paged_restore_failure_fail_closed(pkgs, tier):
    both(pkgs, _paged_restore_failure, tier)


def _paged_batch_failure_isolation(pkg):
    eng = pkg.make(device_blocks=256)
    tp, op = tuple(range(800, 816)), tuple(range(900, 916))
    target, other = _two_claims(pkg, eng, tp, op)
    reqs = [eng.submit(tp + (7, 8), max_new_tokens=2), eng.submit(op + (7, 8), max_new_tokens=2)]
    eng.run_batch(reqs)
    r_t, r_o = reqs
    assert r_t.status == "refused" and r_t.output_tokens == []
    assert r_o.status == "finished" and r_o.restored_tokens == len(op)
    assert target.state == pkg.ClaimState.RESTORATION_FAILED
    assert other.state == pkg.ClaimState.RESTORED
    v = pkg.analyzer.check_observation_path(eng.events, other.claim_id, r_o.request_id)
    assert v.passed, v.reasons
    out = observe(eng, reqs, [target, other])
    eng.close()
    return out


def test_paged_batch_failure_isolation(pkgs):
    both(pkgs, _paged_batch_failure_isolation)

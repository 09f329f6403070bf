"""tests/test_chaos.py, held against the port (CPU).

Unit layer (no model): the port's ``FaultPlan`` draws the reference's
decisions for the same seed, rates and sites, statelessly; scheduled specs
fire as in the reference; ``payload_checksum`` gives the reference's
string for the same bytes and a corrupted copy changes it; the transfer
queue survives a worker death and retries transients as the reference's
does; ``DiskTier.close`` removes the spill files.

Engine layer (reduced qwen3-1.7b, float32 weights bridged from the JAX
package): each fault class runs on the JAX engine and on the port's with the
same fault plan, and the two observations (tests/test_torch_failure_paths.py:
the projected event stream, ``fail_closed_total``, request statuses and
errors, claim states, pool refcounts) must be equal.  Besides the
reference test's own assertions, every ``fail_closed_total`` counter must
equal what the plan injected.
"""
import os
import threading

import numpy as np
import pytest
import torch

from test_torch_failure_paths import PREFIX, both, observe, pkgs  # noqa: F401  (fixture)


def _draw_stream(plan, sites):
    return [(d.trigger if d else None)
            for d in (plan.draw_transfer(direction, {cid}, bid) for direction, cid, bid in sites)]


def test_fault_plan_rates_deterministic_and_stateless(pkgs):
    sites = [("host_to_device", f"c{i}", i) for i in range(64)]
    streams = {}
    for name, pkg in pkgs.items():
        ch = pkg.chaos
        rates = {ch.TRIGGER_TRANSIENT: 0.2, ch.TRIGGER_PERMANENT: 0.1}
        a = _draw_stream(ch.FaultPlan(seed=7, rates=rates), sites)
        assert a == _draw_stream(ch.FaultPlan(seed=7, rates=rates), sites)
        assert any(t is not None for t in a)
        plan = ch.FaultPlan(seed=7, rates=rates)
        for direction, cid, bid in sites[:32]:  # interleaved extra draws
            plan.draw_transfer(direction, {cid}, bid + 1000)
            plan.draw_transfer(direction, {cid}, bid)
        assert _draw_stream(ch.FaultPlan(seed=7, rates=rates), sites) == a
        b = _draw_stream(ch.FaultPlan(seed=8, rates=rates), sites)
        assert b != a
        streams[name] = (a, b)
    assert streams["port"] == streams["jax"]


def test_fault_plan_scheduled_specs_exact(pkgs):
    out = {}
    for name, pkg in pkgs.items():
        ch = pkg.chaos
        plan = ch.FaultPlan(seed=0).schedule(
            ch.FaultSpec(ch.TRIGGER_PERMANENT, boundary="disk_to_device", claim_id="c1"),
            ch.FaultSpec(ch.TRIGGER_TRANSIENT, boundary="host_to_device", claim_id="c2", repeats=2),
        )
        assert plan.armed_remaining == 2
        assert plan.draw_transfer("host_to_device", {"c1"}, 1) is None
        assert plan.draw_transfer("disk_to_device", {"c9"}, 1) is None
        d = plan.draw_transfer("disk_to_device", {"c1"}, 1)
        assert d.trigger == ch.TRIGGER_PERMANENT and not d.transient
        d1 = plan.draw_transfer("host_to_device", {"c2"}, 5)
        d2 = plan.draw_transfer("host_to_device", {"c2"}, 5)
        assert d1.transient and d2.transient
        assert plan.draw_transfer("host_to_device", {"c2"}, 5) is None
        assert plan.armed_remaining == 0
        assert plan.stats.injected == {ch.TRIGGER_PERMANENT: 1, ch.TRIGGER_TRANSIENT: 2}
        out[name] = [(x.trigger, x.transient, x.reason) for x in (d, d1, d2)]
    assert out["port"] == out["jax"]


def test_checksum_detects_corrupted_copy(pkgs):
    """The port's checksum of a torch tensor is the reference's of the same
    bytes in numpy; a corrupted copy flips the same byte in both."""
    k = np.arange(64, dtype=np.float32).reshape(2, 8, 2, 2)
    v = np.ones_like(k)
    jc, tc = pkgs["jax"].chaos, pkgs["port"].chaos
    tk, tv = torch.from_numpy(k.copy()), torch.from_numpy(v.copy())
    c = tc.payload_checksum(tk, tv)
    assert c == jc.payload_checksum(k, v)
    assert c == tc.payload_checksum(tk.clone(), tv.clone())
    bad = tc.corrupted_copy(tk)
    assert bad.shape == tk.shape and bad.dtype == tk.dtype
    assert tc.payload_checksum(bad, tv) != c
    assert tc.payload_checksum(bad, tv) == jc.payload_checksum(jc.corrupted_copy(k), v)
    assert not torch.equal(bad, tk) and tk[0, 0, 0, 0] == 0  # input untouched


def _worker_death(pkg):
    ch, tq = pkg.chaos, pkg.tq
    q = tq.TransferQueue()
    gate = threading.Event()
    j_hold = tq.TransferJob(0, "store", gate.wait)
    j_die = tq.TransferJob(1, "load", lambda: (_ for _ in ()).throw(
        ch.WorkerKilled("chaos:worker_death", 7, "host_to_device")))
    j_queued = tq.TransferJob(2, "load", lambda: None)
    for j in (j_hold, j_die, j_queued):
        q.submit(j)
    gate.set()
    errors = []
    for j in (j_die, j_queued):
        with pytest.raises(ch.TransferWorkerDied) as info:
            j.wait(timeout=5)
        errors.append(str(info.value))
    assert q.worker_deaths == 1
    done = []
    j_next = tq.TransferJob(3, "store", lambda: done.append(True))
    q.submit(j_next)
    j_next.wait(timeout=5)
    assert done == [True]
    q.shutdown()
    q.shutdown()  # idempotent
    return dict(errors=errors, deaths=q.worker_deaths)


def test_worker_death_unblocks_waiter_and_queue_stays_serviceable(pkgs):
    assert _worker_death(pkgs["port"]) == _worker_death(pkgs["jax"])


def _transient_retry(pkg):
    ch, tq = pkg.chaos, pkg.tq
    q = tq.TransferQueue()
    calls = {"n": 0}

    def flaky():
        calls["n"] += 1
        if calls["n"] < 3:
            raise ch.TransientTransferFault("chaos:transient_io@x", 1, "host_to_device")

    j = tq.TransferJob(0, "load", flaky, policy=tq.RetryPolicy(max_attempts=4, backoff_base_s=0.0))
    q.submit(j)
    j.wait(timeout=5)
    q.shutdown()
    return dict(calls=calls["n"], retries=q.retries_performed, attempts=j.attempts)


def test_transient_retry_in_queue_reruns_fn(pkgs):
    got = _transient_retry(pkgs["port"])
    assert got["calls"] == 3 and got["retries"] == 2
    assert got == _transient_retry(pkgs["jax"])


def _block(pkg, bid=1):
    k = np.arange(32, dtype=np.float32).reshape(2, 2, 2, 4)
    if pkg.name == "port":
        k = torch.from_numpy(k)
    return pkg.kv.KVBlock(bid, (1, 2), f"ch{bid}", k, k.clone() if pkg.name == "port" else k.copy(),
                          np.arange(2))


def test_disk_tier_close_removes_spill_files(pkgs):
    pkg = pkgs["port"]
    tier = pkg.tiers.DiskTier()
    tier.put(_block(pkg))
    d = tier._tmp
    assert d is not None and os.path.isdir(d) and os.listdir(d)
    tier.close()
    assert not os.path.isdir(d)
    assert tier.used == 0
    tier.close()  # idempotent
    assert not hasattr(pkg.tiers.DiskTier, "__del__")


def test_disk_tier_context_manager(pkgs):
    pkg = pkgs["port"]
    with pkg.tiers.DiskTier() as tier:
        tier.put(_block(pkg))
        d = tier._tmp
        assert os.listdir(d)
    assert not os.path.isdir(d)


# ---------------------------------------------------------------------------
# engine layer
# ---------------------------------------------------------------------------


def _offloaded_claim(pkg, eng, prefix=PREFIX, tier="host"):
    claim = eng.accept_claim(prefix, pkg.ClaimMode.OFFLOADABLE)
    eng.run(eng.submit(prefix + (30, 31), max_new_tokens=1))
    assert eng.offload_claim(claim.claim_id, tier=tier)
    return claim


def _transient_recovers(pkg, tier):
    ch, an = pkg.chaos, pkg.analyzer
    plan = ch.FaultPlan(seed=1)
    eng = pkg.make(fault_plan=plan, quarantine_after=None)
    claim = _offloaded_claim(pkg, eng, tier=tier)
    plan.schedule(ch.FaultSpec(ch.TRIGGER_TRANSIENT, boundary=f"{tier}_to_device",
                               claim_id=claim.claim_id, repeats=2))
    r = eng.run(eng.submit(PREFIX + (40, 41), max_new_tokens=1))
    assert r.status == "finished" and r.cached_tokens == len(PREFIX)
    assert claim.state == pkg.ClaimState.RESTORED
    assert plan.stats.injected == {ch.TRIGGER_TRANSIENT: 2}
    assert eng.fail_closed_total() == {}
    retries = [e.payload["attempt"] for e in eng.events.named("transfer_retry_scheduled")]
    assert retries == [1, 2]
    assert eng.connector.retry_histogram == {1: 1, 2: 1}
    assert an.check_retry_bounded(eng.events, eng.connector.retry_policy.max_attempts).passed
    assert an.validate_event_sequence(eng.events).passed
    out = observe(eng, [r], [claim], retries=retries, injected=dict(plan.stats.injected))
    eng.close()
    return out


@pytest.mark.parametrize("tier", ["host", "disk"])
def test_transient_fault_recovers_via_retry(pkgs, tier):
    both(pkgs, _transient_recovers, tier)


def _transient_exhaustion(pkg):
    ch, an = pkg.chaos, pkg.analyzer
    plan = ch.FaultPlan(seed=2)
    eng = pkg.make(fault_plan=plan, quarantine_after=None)
    claim = _offloaded_claim(pkg, eng)
    plan.schedule(ch.FaultSpec(ch.TRIGGER_TRANSIENT, boundary="host_to_device",
                               claim_id=claim.claim_id, repeats=10))
    r = eng.run(eng.submit(PREFIX + (40, 41), max_new_tokens=1))
    assert r.status == "refused" and "exhausted" in r.error
    assert eng.fail_closed_total() == {ch.TRIGGER_TRANSIENT_EXHAUSTED: 1}
    # the retry budget bounds the injected transients: one per attempt
    assert plan.stats.injected == {ch.TRIGGER_TRANSIENT: eng.connector.retry_policy.max_attempts}
    v = an.check_failure_outcome_path(eng.events, claim.claim_id, r.request_id)
    assert v.passed, v.reasons
    assert an.check_retry_bounded(eng.events, eng.connector.retry_policy.max_attempts).passed
    out = observe(eng, [r], [claim], injected=dict(plan.stats.injected))
    eng.close()
    return out


def test_transient_exhaustion_escalates_fail_closed(pkgs):
    both(pkgs, _transient_exhaustion)


def _permanent(pkg, tier):
    ch, an = pkg.chaos, pkg.analyzer
    plan = ch.FaultPlan(seed=3)
    eng = pkg.make(fault_plan=plan, quarantine_after=None)
    claim = _offloaded_claim(pkg, eng, tier=tier)
    plan.schedule(ch.FaultSpec(ch.TRIGGER_PERMANENT, boundary=f"{tier}_to_device",
                               claim_id=claim.claim_id))
    r = eng.run(eng.submit(PREFIX + (40, 41), max_new_tokens=1))
    assert r.status == "refused" and f"chaos:{ch.TRIGGER_PERMANENT}" in r.error
    assert claim.state == pkg.ClaimState.RESTORATION_FAILED
    assert eng.fail_closed_total() == {ch.TRIGGER_PERMANENT: 1} == plan.stats.injected
    v = an.check_failure_outcome_path(eng.events, claim.claim_id, r.request_id, source_tier=tier)
    assert v.passed, v.reasons
    assert an.check_fail_closed_attribution(eng.events).passed
    out = observe(eng, [r], [claim])
    eng.close()
    return out


@pytest.mark.parametrize("tier", ["host", "disk"])
def test_permanent_fault_is_attributed_claim_refusal(pkgs, tier):
    both(pkgs, _permanent, tier)


def _corruption(pkg, tier):
    ch, an = pkg.chaos, pkg.analyzer
    plan = ch.FaultPlan(seed=4)
    eng = pkg.make(fault_plan=plan, quarantine_after=None)
    claim = eng.accept_claim(PREFIX, pkg.ClaimMode.OFFLOADABLE)
    eng.run(eng.submit(PREFIX + (30, 31), max_new_tokens=1))
    plan.schedule(ch.FaultSpec(ch.TRIGGER_CORRUPTION, boundary=tier, claim_id=claim.claim_id))
    assert eng.offload_claim(claim.claim_id, tier=tier)
    assert plan.stats.injected == {ch.TRIGGER_CORRUPTION: 1}
    r = eng.run(eng.submit(PREFIX + (40, 41), max_new_tokens=1))
    assert r.status == "refused" and "checksum_mismatch" in r.error
    assert eng.fail_closed_total() == {ch.TRIGGER_CORRUPTION: 1} == plan.stats.injected
    bad = [e.payload["block_id"] for e in eng.events.named("offload_worker_load_failed")]
    assert bad and all(bid not in eng.pool.blocks for bid in bad)
    v = an.check_failure_outcome_path(eng.events, claim.claim_id, r.request_id, source_tier=tier)
    assert v.passed, v.reasons
    out = observe(eng, [r], [claim], bad=bad)
    eng.close()
    return out


@pytest.mark.parametrize("tier", ["host", "disk"])
def test_corruption_detected_at_restore_never_reaches_device(pkgs, tier):
    both(pkgs, _corruption, tier)


def _worker_death_engine(pkg):
    ch, an = pkg.chaos, pkg.analyzer
    plan = ch.FaultPlan(seed=5)
    eng = pkg.make(fault_plan=plan, quarantine_after=None)
    claim = _offloaded_claim(pkg, eng)
    plan.schedule(ch.FaultSpec(ch.TRIGGER_WORKER_DEATH, boundary="host_to_device",
                               claim_id=claim.claim_id))
    r = eng.run(eng.submit(PREFIX + (40, 41), max_new_tokens=1))
    assert r.status == "refused" and ch.TRIGGER_WORKER_DEATH in r.error
    assert eng.fail_closed_total() == {ch.TRIGGER_WORKER_DEATH: 1} == plan.stats.injected
    assert eng.connector.queue.worker_deaths == 1
    v = an.check_failure_outcome_path(eng.events, claim.claim_id, r.request_id)
    assert v.passed, v.reasons
    other = tuple(range(300, 316))
    c2 = _offloaded_claim(pkg, eng, prefix=other, tier="disk")
    r2 = eng.run(eng.submit(other + (40, 41), max_new_tokens=1))
    assert r2.status == "finished" and c2.state == pkg.ClaimState.RESTORED
    assert an.validate_event_sequence(eng.events).passed
    out = observe(eng, [r, r2], [claim, c2])
    eng.close()
    return out


def test_worker_death_is_claim_refusal_and_engine_survives(pkgs):
    both(pkgs, _worker_death_engine)


def _capacity_pressure(pkg):
    ch = pkg.chaos
    plan = ch.FaultPlan(seed=6).schedule(ch.FaultSpec(ch.TRIGGER_CAPACITY))
    eng = pkg.make(fault_plan=plan, quarantine_after=None)
    r = eng.run(eng.submit(tuple(range(100, 108)), max_new_tokens=1))
    assert r.status == "refused" and ch.TRIGGER_CAPACITY in r.error
    assert eng.fail_closed_total() == {ch.TRIGGER_CAPACITY: 1} == plan.stats.injected
    fin = [e for e in eng.events.named("request_finished") if e.request_id == r.request_id]
    assert fin and fin[0].payload["status"] == "REFUSED_ADMISSION"
    r2 = eng.run(eng.submit(tuple(range(200, 208)), max_new_tokens=1))
    assert r2.status == "finished"
    out = observe(eng, [r, r2])
    eng.close()
    return out


def test_capacity_pressure_refused_at_admission(pkgs):
    both(pkgs, _capacity_pressure)


def _quarantine(pkg):
    ch, an = pkg.chaos, pkg.analyzer
    plan = ch.FaultPlan(seed=7)
    eng = pkg.make(fault_plan=plan, quarantine_after=2, device_blocks=128)
    victims, prefixes = [], []
    for i in range(3):
        p = tuple(range(1000 + 100 * i, 1016 + 100 * i))
        victims.append(_offloaded_claim(pkg, eng, prefix=p, tier="disk"))
        prefixes.append(p)
    host_p = tuple(range(5000, 5016))
    host_c = _offloaded_claim(pkg, eng, prefix=host_p, tier="host")
    reqs = []
    for c, p in zip(victims[:2], prefixes[:2]):
        plan.schedule(ch.FaultSpec(ch.TRIGGER_PERMANENT, boundary="disk_to_device",
                                   claim_id=c.claim_id))
        reqs.append(eng.run(eng.submit(p + (1, 2), max_new_tokens=1)))
        assert reqs[-1].status == "refused"
    q = eng.events.named("tier_quarantined")
    assert len(q) == 1 and q[0].payload["tier"] == "disk"
    assert eng.connector.health.is_quarantined("disk")
    reads = eng.connector.disk.bytes_read
    r3 = eng.run(eng.submit(prefixes[2] + (1, 2), max_new_tokens=1))
    assert r3.status == "refused" and "tier_quarantined:disk" in r3.error
    assert eng.connector.disk.bytes_read == reads
    c_new = eng.accept_claim(tuple(range(7000, 7016)), pkg.ClaimMode.OFFLOADABLE)
    eng.run(eng.submit(tuple(range(7000, 7016)) + (1,), max_new_tokens=1))
    assert not eng.offload_claim(c_new.claim_id, tier="disk")
    assert c_new.state == pkg.ClaimState.MATERIALIZED
    rh = eng.run(eng.submit(host_p + (1, 2), max_new_tokens=1))
    assert rh.status == "finished" and host_c.state == pkg.ClaimState.RESTORED
    assert eng.fail_closed_total() == {ch.TRIGGER_PERMANENT: 2, ch.TRIGGER_QUARANTINE: 2}
    # the permanent faults are the plan's; the quarantine refusals the tier health's
    assert plan.stats.injected == {ch.TRIGGER_PERMANENT: 2}
    assert an.check_fail_closed_attribution(eng.events).passed
    assert an.validate_event_sequence(eng.events).passed
    out = observe(eng, reqs + [r3, rh], victims + [host_c, c_new], reads=reads)
    eng.close()
    return out


def test_tier_quarantine_refuses_attributed_and_host_keeps_serving(pkgs):
    both(pkgs, _quarantine)


def test_engine_close_is_idempotent_and_cleans_disk(pkgs):
    pkg = pkgs["port"]
    eng = pkg.make()
    _offloaded_claim(pkg, eng, tier="disk")
    d = eng.connector.disk._tmp
    assert d is not None and os.path.isdir(d)
    eng.close()
    assert not os.path.isdir(d)
    eng.close()  # idempotent
    with pkg.make() as eng2:
        _offloaded_claim(pkg, eng2, tier="disk")
        d2 = eng2.connector.disk._tmp
    assert not os.path.isdir(d2)

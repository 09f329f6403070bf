"""tests/test_observability.py held against the port (CPU).

Claim-scoped telemetry at the engine level: each scenario runs on the JAX
``ServingEngine`` and on the port's (reduced qwen3-1.7b, the same float32
parameters bridged by ``params_from_jax``) with the reference test's
assertions on both, and the two runs' observations must be equal
(``test_torch_failure_paths.observe`` plus the spans' names and their
status, trigger and ok fields, in order): every fault class's refusal
span carries its trigger, transient faults show retries and no refusal,
quarantine instants and gauges, counter-vs-plan through the registry, the
Prometheus exposition equal to ``fail_closed_total()``, reconcile drift
caught both ways, the tier gauges, and the Perfetto export.
"""
import copy

import pytest

import repro.serving.tracing as j_tracing
import repro_torch.serving.tracing as t_tracing
from test_torch_failure_paths import PREFIX, both, observe, pkgs  # noqa: F401  (fixture)
from torch_one_thread import one_torch_thread  # noqa: F401  (autouse fixture)

TRACING = {"jax": j_tracing, "port": t_tracing}


def _offloaded_claim(pkg, eng, prefix=PREFIX, tier="host"):
    claim = eng.accept_claim(prefix, pkg.ClaimMode.OFFLOADABLE)
    eng.run(eng.submit(prefix + (30, 31), max_new_tokens=1))
    assert eng.offload_claim(claim.claim_id, tier=tier)
    return claim


def _by_name(spans):
    out = {}
    for s in spans:
        out.setdefault(s.name, []).append(s)
    return out


def _span_view(pkg, eng):
    return [(s.name, s.args.get("status"), s.args.get("trigger"), s.args.get("ok"))
            for s in TRACING[pkg.name].build_spans(eng.events)]


def _refusal_span(pkg, trigger_name):
    ch, an, tr = pkg.chaos, pkg.analyzer, TRACING[pkg.name]
    trigger = getattr(ch, trigger_name)
    plan = ch.FaultPlan(seed=11)
    with pkg.make(fault_plan=plan, quarantine_after=None) as eng:
        claim = eng.accept_claim(PREFIX, pkg.ClaimMode.OFFLOADABLE)
        eng.run(eng.submit(PREFIX + (30, 31), max_new_tokens=1))
        if trigger == ch.TRIGGER_CORRUPTION:  # corrupt at rest when the bytes land
            plan.schedule(ch.FaultSpec(trigger, boundary="host", claim_id=claim.claim_id))
        assert eng.offload_claim(claim.claim_id, tier="host")
        if trigger != ch.TRIGGER_CORRUPTION:
            plan.schedule(ch.FaultSpec(trigger, boundary="host_to_device", claim_id=claim.claim_id))
        r = eng.run(eng.submit(PREFIX + (40, 41), max_new_tokens=1))
        assert r.status == "refused"
        spans = tr.build_spans(eng.events)
        by = _by_name(spans)
        (refusal,) = by["refusal"]
        assert refusal.args["trigger"] == trigger
        assert refusal.args["via"] == "scheduler_active_request_refused"
        assert refusal.args["blocking_claim_ids"] == [claim.claim_id]
        assert {s.args["status"] for s in by["request"]} == {"FINISHED_OK", "FINISHED_ERROR"}
        restores = [s for s in by["restore"] if not s.args["ok"]]
        assert restores and restores[0].args["trigger"] == trigger
        assert all(s.end_seq >= s.start_seq and s.duration_s >= 0 for s in spans)
        assert an.check_metrics_reconcile(eng.events, eng.metrics).passed
        return observe(eng, [r], [claim], spans=_span_view(pkg, eng))


@pytest.mark.parametrize("trigger", ["TRIGGER_PERMANENT", "TRIGGER_CORRUPTION",
                                     "TRIGGER_WORKER_DEATH"])
def test_fault_refusal_span_attributed(pkgs, trigger):
    both(pkgs, _refusal_span, trigger)


def _transient(pkg):
    ch, an, tr = pkg.chaos, pkg.analyzer, TRACING[pkg.name]
    plan = ch.FaultPlan(seed=12)
    with pkg.make(fault_plan=plan, quarantine_after=None) as eng:
        claim = _offloaded_claim(pkg, eng)
        plan.schedule(ch.FaultSpec(ch.TRIGGER_TRANSIENT, boundary="host_to_device",
                                   claim_id=claim.claim_id, repeats=2))
        r = eng.run(eng.submit(PREFIX + (40, 41), max_new_tokens=1))
        assert r.status == "finished"  # bounded retry recovered
        by = _by_name(tr.build_spans(eng.events))
        assert "refusal" not in by
        assert all(s.args["status"] == "FINISHED_OK" for s in by["request"])
        retries = [i for i in tr.build_instants(eng.events) if i.name == "transfer_retry"]
        assert len(retries) == 2 and {i.args["attempt"] for i in retries} == {1, 2}
        assert any(s.args["ok"] for s in by["restore"])
        assert eng.fail_closed_total() == {}
        assert an.check_metrics_reconcile(eng.events, eng.metrics).passed
        return observe(eng, [r], [claim], spans=_span_view(pkg, eng))


def test_transient_fault_spans_show_retries_not_refusals(pkgs):
    both(pkgs, _transient)


def _quarantine(pkg):
    ch, an, tr = pkg.chaos, pkg.analyzer, TRACING[pkg.name]
    plan = ch.FaultPlan(seed=13)
    with pkg.make(fault_plan=plan, quarantine_after=2, device_blocks=128) as eng:
        claims = [(_offloaded_claim(pkg, eng, tuple(range(1000 + 100 * i, 1016 + 100 * i)),
                                    tier="disk"), tuple(range(1000 + 100 * i, 1016 + 100 * i)))
                  for i in range(3)]
        reqs = []
        for c, prefix in claims[:2]:
            plan.schedule(ch.FaultSpec(ch.TRIGGER_PERMANENT, boundary="disk_to_device",
                                       claim_id=c.claim_id))
            reqs.append(eng.run(eng.submit(prefix + (1, 2), max_new_tokens=1)))
            assert reqs[-1].status == "refused"
        c3, p3 = claims[2]  # refused on the quarantined tier without disk I/O
        reqs.append(eng.run(eng.submit(p3 + (3, 4), max_new_tokens=1)))
        assert reqs[-1].status == "refused"
        inst = [i for i in tr.build_instants(eng.events) if i.cat == "quarantine"]
        assert len(inst) == 1 and inst[0].args["tier"] == "disk"
        by = _by_name(tr.build_spans(eng.events))
        triggers = [s.args["trigger"] for s in by["refusal"]]
        assert triggers.count(ch.TRIGGER_PERMANENT) == 2
        assert triggers.count(ch.TRIGGER_QUARANTINE) == 1
        q_refusal = next(s for s in by["refusal"] if s.args["trigger"] == ch.TRIGGER_QUARANTINE)
        assert q_refusal.start_seq > inst[0].seq
        assert eng.metrics.get("tier_quarantined").value(tier="disk") == 1
        assert eng.metrics.get("tier_quarantined").value(tier="host") == 0
        assert an.check_metrics_reconcile(eng.events, eng.metrics).passed
        return observe(eng, reqs, [c for c, _ in claims], spans=_span_view(pkg, eng))


def test_quarantine_spans_instants_and_gauge(pkgs):
    both(pkgs, _quarantine)


def _counter_vs_plan(pkg):
    """bench_chaos's exact counter-vs-plan equality as a unit: scheduled
    faults -> ``fail_closed_total()`` equals the expected dict exactly."""
    ch, an = pkg.chaos, pkg.analyzer
    plan = ch.FaultPlan(seed=14)
    with pkg.make(fault_plan=plan, quarantine_after=None, device_blocks=128) as eng:
        expected, reqs = {}, []
        for i, trigger in enumerate((ch.TRIGGER_PERMANENT, ch.TRIGGER_PERMANENT,
                                     ch.TRIGGER_WORKER_DEATH)):
            prefix = tuple(range(2000 + 100 * i, 2016 + 100 * i))
            c = eng.accept_claim(prefix, pkg.ClaimMode.OFFLOADABLE)
            eng.run(eng.submit(prefix + (90 + i,), max_new_tokens=1))
            assert eng.offload_claim(c.claim_id, tier="host")
            plan.schedule(ch.FaultSpec(trigger, boundary="host_to_device", claim_id=c.claim_id))
            reqs.append(eng.run(eng.submit(prefix + (1, 2), max_new_tokens=1)))
            assert reqs[-1].status == "refused"
            expected[trigger] = expected.get(trigger, 0) + 1
        assert eng.fail_closed_total() == dict(sorted(expected.items()))
        fam = eng.metrics.get("fail_closed_total")
        assert fam is eng.fail_closed  # one counting path
        assert fam.as_dict() == eng.fail_closed_total()
        assert eng.metrics.get("chaos_faults_injected_total").as_dict() == dict(
            sorted(plan.stats.injected.items()))
        assert an.check_metrics_reconcile(eng.events, eng.metrics).passed
        return observe(eng, reqs, injected=dict(sorted(plan.stats.injected.items())))


def test_counter_vs_plan_exact_through_registry(pkgs):
    both(pkgs, _counter_vs_plan)


def _exposition(pkg):
    ch = pkg.chaos
    plan = ch.FaultPlan(seed=15)
    with pkg.make(fault_plan=plan, quarantine_after=None) as eng:
        claim = _offloaded_claim(pkg, eng)
        plan.schedule(ch.FaultSpec(ch.TRIGGER_PERMANENT, boundary="host_to_device",
                                   claim_id=claim.claim_id))
        r = eng.run(eng.submit(PREFIX + (40, 41), max_new_tokens=1))
        assert r.status == "refused"
        exposed = {}
        for line in eng.metrics.prometheus_text().splitlines():
            if line.startswith("fail_closed_total{"):
                labels, value = line.rsplit(" ", 1)
                exposed[labels.split('trigger="', 1)[1].split('"', 1)[0]] = int(value)
        assert exposed == eng.fail_closed_total() == {ch.TRIGGER_PERMANENT: 1}
        return observe(eng, [r], [claim], exposed=exposed)


def test_prometheus_exposition_matches_fail_closed_view(pkgs):
    both(pkgs, _exposition)


def _reconcile_drift(pkg):
    ch, an = pkg.chaos, pkg.analyzer
    plan = ch.FaultPlan(seed=16)
    with pkg.make(fault_plan=plan, quarantine_after=None) as eng:
        claim = _offloaded_claim(pkg, eng)
        plan.schedule(ch.FaultSpec(ch.TRIGGER_PERMANENT, boundary="host_to_device",
                                   claim_id=claim.claim_id))
        eng.run(eng.submit(PREFIX + (40, 41), max_new_tokens=1))
        assert an.check_metrics_reconcile(eng.events, eng.metrics).passed
        snap = eng.metrics.snapshot()
        assert an.check_metrics_reconcile(eng.events, snap).passed  # the snapshot form too
        t1 = copy.deepcopy(snap)  # a counter increment with no witness event
        t1["fail_closed_total"]["series"].append({"labels": {"trigger": "corruption"}, "value": 1})
        v1 = an.check_metrics_reconcile(eng.events, t1)
        assert not v1.passed and "fail_closed_total" in v1.reasons[0]
        t2 = copy.deepcopy(snap)  # a dropped histogram observation
        for s in t2["transfer_block_seconds"]["series"]:
            s["count"] -= 1
            break
        v2 = an.check_metrics_reconcile(eng.events, t2)
        assert not v2.passed
        t3 = copy.deepcopy(snap)  # restore-count drift
        t3["claim_restores_total"]["series"] = [{"labels": {}, "value": 99}]
        v3 = an.check_metrics_reconcile(eng.events, t3)
        assert not v3.passed and "claim_restores_total" in v3.reasons[0]
        return observe(eng, [], [claim], reasons=[list(v.reasons) for v in (v1, v2, v3)])


def test_reconcile_rejects_drift_both_ways(pkgs):
    both(pkgs, _reconcile_drift)


def _tier_gauges(pkg):
    with pkg.make() as eng:
        claim = _offloaded_claim(pkg, eng, tier="host")
        blocks, nbytes = eng.metrics.get("tier_blocks"), eng.metrics.get("tier_bytes")
        assert blocks.value(tier="host") == 4  # 16 tokens / block_size 4
        assert nbytes.value(tier="host") > 0
        assert blocks.value(tier="disk") == 0
        assert blocks.value(tier="device") == len(eng.connector.device.blocks)
        assert pkg.analyzer.check_metrics_reconcile(eng.events, eng.metrics).passed
        return observe(eng, [], [claim], blocks=blocks.as_dict())


def test_tier_gauges_track_occupancy(pkgs):
    both(pkgs, _tier_gauges)


def _perfetto(pkg):
    ch, tr = pkg.chaos, TRACING[pkg.name]
    plan = ch.FaultPlan(seed=17)
    with pkg.make(fault_plan=plan, quarantine_after=None) as eng:
        claim = _offloaded_claim(pkg, eng)
        plan.schedule(ch.FaultSpec(ch.TRIGGER_PERMANENT, boundary="host_to_device",
                                   claim_id=claim.claim_id))
        r = eng.run(eng.submit(PREFIX + (40, 41), max_new_tokens=1))
        assert r.status == "refused"
        trace = tr.to_perfetto(eng.events)
        assert tr.validate_perfetto(trace) == []
        evs = trace["traceEvents"]
        names = {e["name"] for e in evs}
        assert {"request", "refusal", "transfer", "offload", "restore"} <= names
        assert any(e["name"] == "process_name" for e in evs if e["ph"] == "M")
        statuses = {e["args"].get("status") for e in evs
                    if e["ph"] == "X" and e["name"] == "request"}
        assert statuses == {"FINISHED_OK", "FINISHED_ERROR"}
        stages = [e for e in evs if e["ph"] == "X" and e["name"].startswith("stage:")]
        assert stages and all(e["dur"] > 0 for e in stages)
        return observe(eng, [r], [claim], names=sorted(names),
                       phases=sorted((e["ph"], e["name"]) for e in evs
                                     if not e["name"].startswith("stage:")))


def test_perfetto_export_valid_and_covers_both_outcomes(pkgs):
    both(pkgs, _perfetto)

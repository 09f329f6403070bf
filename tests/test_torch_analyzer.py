"""The port's analyzer and Perfetto export against the JAX package's (CPU).

Every log here is served by the port's engine (reduced qwen3-1.7b on the
CPU, block_size 4): witness paths A, B and C, a radix copy-on-write, and
the chaos scenarios of tests/test_observability.py (a permanent, corrupted
or worker-death restore refused fail-closed, a transient restore retried,
a disk tier quarantined).  Both analyzers read the SAME events (the JAX
one through ``EventLog.from_dicts``) and the same metrics snapshot, and
must give identical ``(passed, reasons)`` for every check, string for
string.  Mutated copies of the logs (a claim id swapped, two events
reordered, an E12 dropped, a metrics counter drifted either way) must
fail in both.  The Perfetto traces of both packages must agree once
``ts``/``dur`` and the stage spans' measured seconds are left out, and
validate with no problem in both.
"""
import copy

import pytest
import torch

from repro.core import analyzer as j_an
from repro.core.events import EventLog as JEventLog
from repro.serving import tracing as j_tr
from repro_torch.configs import get_config, reduced
from repro_torch.core import analyzer
from repro_torch.core.claims import ClaimMode
from repro_torch.core.events import EventLog
from repro_torch.core.native_descriptor import PREFIX, engine_factory
from repro_torch.models.registry import build_model
from repro_torch.serving import tracing
from repro_torch.serving.chaos import (
    TRIGGER_CORRUPTION,
    TRIGGER_PERMANENT,
    TRIGGER_TRANSIENT,
    TRIGGER_WORKER_DEATH,
    FaultPlan,
    FaultSpec,
)

LOGS = ("path_a", "path_b", "path_c", "radix_cow", "permanent", "corruption",
        "worker_death", "transient", "quarantine")


@pytest.fixture(scope="module")
def make():
    bundle = build_model(reduced(get_config("qwen3-1.7b")), device="cpu")
    return engine_factory(bundle, bundle.init_params(torch.Generator().manual_seed(0)), device="cpu")


def _offloaded(eng, prefix=PREFIX, tier="host"):
    claim = eng.accept_claim(prefix, ClaimMode.OFFLOADABLE)
    r1 = eng.run(eng.submit(prefix + (30, 31), max_new_tokens=1))
    assert eng.offload_claim(claim.claim_id, request_id=r1.request_id, tier=tier)
    return claim


def _serve(make, name):
    """(engine log, metrics snapshot, witness args) of one scenario."""
    args = {}
    kw = {}
    if name in ("permanent", "corruption", "worker_death", "transient", "quarantine"):
        plan = FaultPlan(seed=11)
        kw = dict(fault_plan=plan, quarantine_after=2 if name == "quarantine" else None)
    if name == "quarantine":
        kw["device_blocks"] = 128
    with make(**kw) as eng:
        if name in ("path_a", "path_b"):
            claim = _offloaded(eng)
            if name == "path_b":
                eng.connector.injection.resident_claim_load_failure = True
                eng.connector.injection.fail_claim_id = claim.claim_id
            r = eng.run(eng.submit(PREFIX + (40, 41), max_new_tokens=2))
            args["witness"] = (claim.claim_id, r.request_id)
        elif name == "path_c":
            tp, op = tuple(range(100, 116)), tuple(range(200, 216))
            target, other = _offloaded(eng, tp), _offloaded(eng, op)
            eng.connector.injection.resident_claim_load_failure = True
            eng.connector.injection.fail_claim_id = target.claim_id
            eng.run(eng.submit(op + (7, 8), max_new_tokens=1))
            eng.run(eng.submit(tp + (7, 8), max_new_tokens=1))
            args["multi"] = (target.claim_id, other.claim_id)
        elif name == "radix_cow":
            t1 = tuple(range(40, 56))
            r1 = eng.run(eng.submit(t1, max_new_tokens=6))
            seq1 = t1 + tuple(r1.output_tokens)
            eng.run_batch([eng.submit(seq1 + (901, 902), max_new_tokens=2),
                           eng.submit(seq1 + (911, 912), max_new_tokens=2)])
            assert eng.events.named("page_cow")
        elif name == "quarantine":
            claims = []
            for i in range(3):
                prefix = tuple(range(1000 + 100 * i, 1016 + 100 * i))
                claims.append((_offloaded(eng, prefix, tier="disk"), prefix))
            for c, prefix in claims[:2]:
                plan.schedule(FaultSpec(TRIGGER_PERMANENT, boundary="disk_to_device",
                                        claim_id=c.claim_id))
                assert eng.run(eng.submit(prefix + (1, 2), max_new_tokens=1)).status == "refused"
            r = eng.run(eng.submit(claims[2][1] + (3, 4), max_new_tokens=1))
            assert r.status == "refused" and eng.events.named("tier_quarantined")
        else:
            trigger = {"permanent": TRIGGER_PERMANENT, "corruption": TRIGGER_CORRUPTION,
                       "worker_death": TRIGGER_WORKER_DEATH, "transient": TRIGGER_TRANSIENT}[name]
            claim = eng.accept_claim(PREFIX, ClaimMode.OFFLOADABLE)
            eng.run(eng.submit(PREFIX + (30, 31), max_new_tokens=1))
            if trigger == TRIGGER_CORRUPTION:
                plan.schedule(FaultSpec(trigger, boundary="host", claim_id=claim.claim_id))
            assert eng.offload_claim(claim.claim_id, tier="host")
            if trigger != TRIGGER_CORRUPTION:
                plan.schedule(FaultSpec(trigger, boundary="host_to_device", claim_id=claim.claim_id,
                                        repeats=2 if trigger == TRIGGER_TRANSIENT else 1))
            r = eng.run(eng.submit(PREFIX + (40, 41), max_new_tokens=1))
            assert r.status == ("finished" if trigger == TRIGGER_TRANSIENT else "refused")
            args["witness"] = (claim.claim_id, r.request_id)
            args["max_attempts"] = eng.connector.retry_policy.max_attempts
        return eng.events, eng.metrics.snapshot(), args


@pytest.fixture(scope="module")
def served(make):
    return {name: _serve(make, name) for name in LOGS}


def _rows(log):
    return [e.to_dict() for e in log.events]


def _checks(rows, snap, args):
    """{check: (passed, reasons)} for the port's and the JAX analyzer."""
    out = {}
    for tag, an, mk in (("port", analyzer, EventLog.from_dicts),
                        ("jax", j_an, JEventLog.from_dicts)):
        log = mk(copy.deepcopy(rows))
        res = {
            "validate_event_sequence": an.validate_event_sequence(log),
            "check_step_interleave_order": an.check_step_interleave_order(log),
            "check_fail_closed_attribution": an.check_fail_closed_attribution(log),
            "check_shared_page_immutability": an.check_shared_page_immutability(log),
            "check_no_claim_outcome": an.check_no_claim_outcome(log),
            "check_metrics_reconcile": an.check_metrics_reconcile(log, copy.deepcopy(snap)),
            "check_retry_bounded": an.check_retry_bounded(log, args.get("max_attempts", 3)),
        }
        if "witness" in args:
            res["check_observation_path"] = an.check_observation_path(log, *args["witness"])
            res["check_failure_outcome_path"] = an.check_failure_outcome_path(log, *args["witness"])
        if "multi" in args:
            res["check_multi_claim_attribution"] = an.check_multi_claim_attribution(log, *args["multi"])
        out[tag] = {k: (v.passed, v.reasons) for k, v in res.items()}
    return out


# what each served log must show (besides the checks every log passes)
EXPECT = {
    "path_a": {"check_observation_path": True, "check_failure_outcome_path": False},
    "path_b": {"check_observation_path": False, "check_failure_outcome_path": True},
    "path_c": {"check_multi_claim_attribution": True},
    "radix_cow": {},
    "permanent": {"check_failure_outcome_path": True},
    "corruption": {"check_failure_outcome_path": True},
    "worker_death": {"check_failure_outcome_path": True},
    "transient": {"check_observation_path": True, "check_failure_outcome_path": False},
    "quarantine": {},
}
ALWAYS = ("validate_event_sequence", "check_step_interleave_order",
          "check_fail_closed_attribution", "check_shared_page_immutability",
          "check_metrics_reconcile", "check_retry_bounded")


@pytest.mark.parametrize("name", LOGS)
def test_verdicts_match_jax(served, name):
    log, snap, args = served[name]
    got = _checks(_rows(log), snap, args)
    assert got["port"] == got["jax"]
    for check in ALWAYS:
        assert got["port"][check][0], (check, got["port"][check])
    for check, passed in EXPECT[name].items():
        assert got["port"][check][0] is passed, (check, got["port"][check])


def _swap_claim(rows, snap, args):
    cid, rid = args["witness"]
    for r in rows:
        if r["name"] in ("scheduler_resident_claim_restoration_failed",
                         "offload_worker_transfer_finished", "offload_worker_load_failed") \
                and r.get("claim_id") == cid:
            r["claim_id"] = "claim-9999"
        if r["name"] == "scheduler_active_request_refused":
            r["blocking_claim_ids"] = ["claim-9999"]
    return rows, snap, "check_failure_outcome_path"


def _reorder(rows, snap, args):
    """E13 moved before its E12 (two events exchanged in the total order)."""
    i = next(k for k, r in enumerate(rows) if r["name"] == "scheduler_resident_claim_restoration_failed")
    j = next(k for k, r in enumerate(rows) if r["name"] == "scheduler_active_request_refused")
    rows[i], rows[j] = rows[j], rows[i]
    return rows, snap, "check_failure_outcome_path"


def _drop_e12(check):
    def mutate(rows, snap, args):
        rows = [r for r in rows if r["name"] != "scheduler_resident_claim_restoration_failed"]
        return rows, snap, check
    return mutate


def _counter_without_witness(rows, snap, args):
    snap["fail_closed_total"]["series"].append({"labels": {"trigger": "corruption"}, "value": 1})
    return rows, snap, "check_metrics_reconcile"


def _witness_without_counter(rows, snap, args):
    for s in snap["fail_closed_total"]["series"]:
        s["value"] = 0
    return rows, snap, "check_metrics_reconcile"


def _histogram_dropped(rows, snap, args):
    snap["transfer_block_seconds"]["series"][0]["count"] -= 1
    return rows, snap, "check_metrics_reconcile"


def _restores_drifted(rows, snap, args):
    snap["claim_restores_total"]["series"] = [{"labels": {}, "value": 99}]
    return rows, snap, "check_metrics_reconcile"


@pytest.mark.parametrize("name,mutate", [
    ("path_b", _swap_claim),
    ("path_b", _reorder),
    ("path_b", _drop_e12("check_failure_outcome_path")),
    ("permanent", _drop_e12("check_fail_closed_attribution")),
    ("permanent", _counter_without_witness),
    ("permanent", _witness_without_counter),
    ("path_a", _histogram_dropped),
    ("path_a", _restores_drifted),
], ids=["claim_swapped", "e12_e13_reordered", "e12_dropped_witness", "e12_dropped_campaign",
        "counter_without_event", "event_without_counter", "histogram_dropped", "restores_drifted"])
def test_mutated_log_fails_in_both(served, name, mutate):
    log, snap, args = served[name]
    rows, msnap, check = mutate(copy.deepcopy(_rows(log)), copy.deepcopy(snap), args)
    base = _checks(_rows(log), snap, args)["port"][check]
    got = _checks(rows, msnap, args)
    assert base[0], base
    assert got["port"][check] == got["jax"][check]
    assert got["port"][check][0] is False, got["port"][check]


def _structure(trace):
    """Trace events without timestamps, durations or measured seconds."""
    out = []
    for e in trace["traceEvents"]:
        e = {k: v for k, v in e.items() if k not in ("ts", "dur")}
        if e.get("cat") == "stage":
            e["args"] = {k: v for k, v in e["args"].items() if k != "seconds"}
        out.append(e)
    return out


@pytest.mark.parametrize("name", LOGS)
def test_perfetto_matches_jax(served, name, tmp_path):
    log = served[name][0]
    port = tracing.write_perfetto(log, tmp_path / "port.json")
    ref = j_tr.to_perfetto(JEventLog.from_dicts(_rows(log)))
    assert tracing.validate_perfetto(port) == [] == j_tr.validate_perfetto(ref)
    assert _structure(port) == _structure(ref)
    spans = tracing.build_spans(log)
    assert spans and all(s.end_seq >= s.start_seq and s.duration_s >= 0 for s in spans)
    cats = {s.cat for s in spans}
    assert {"request", "stage"} <= cats
    if name not in ("radix_cow",):
        assert "claim" in cats and "transfer" in cats

"""Connector repetition semantic gates (paper §8.3, Table 8), on the port.

The counterpart of ``benchmarks/bench_connector_gates.py``: 131 isolated
runs against the port's claim-native engine over a real model
(full-width qwen3-1.7b on the card by default):

  - 131/131 valid event sequences (analyzer-parseable total order);
  - 30/30 positive observation passes (witness path A);
  - 30/30 same-claim failure-outcome passes (witness path B);
  -  0/41 false-positive control passes (ordinary offload without claim,
    unclaimed failure, wrong-claim failure, fallback recompute, generic
    counters);
  - 30 lifecycle runs (demotable / expiring / hard_protected) counted in
    the sequence-validity total.

Each run is a fresh engine over the shared parameters, closed when its
run ends.  Timing and byte diagnostics are recorded, not gated.  Writes
``<out-dir>/connector_gates/aggregate.json``; exits 1 unless the gates
hold.

    PYTHONPATH=src python -m repro_torch.bench.connector_gates               # card
    PYTHONPATH=src python -m repro_torch.bench.connector_gates --device cpu --reduced
"""
from __future__ import annotations

import copy
import json
import time
from pathlib import Path
from typing import Any, Dict, List, Optional

from repro_torch.bench.common import RESULTS_DIR, Model, gate_failed, model_from, parse, parser
from repro_torch.core.analyzer import (
    check_failure_outcome_path,
    check_no_claim_outcome,
    check_observation_path,
    validate_event_sequence,
)
from repro_torch.core.claims import ClaimMode
from repro_torch.core.events import EventLog
from repro_torch.core.native_descriptor import (
    PREFIX,
    scenario_demotable,
    scenario_expiring,
    scenario_hard_protected,
)
from repro_torch.serving.offload import FailureInjectionConfig

GATES = {
    "event_sequence_validity": "131/131",
    "observation_passes": "30/30",
    "failure_outcome_passes": "30/30",
    "false_positive_control_passes": "0/41",
}


def offload_cycle(make_engine, *, fail=False, claim_mode=ClaimMode.OFFLOADABLE):
    """accept -> materialize -> offload -> (arm a same-claim restore
    failure) -> reuse; returns (engine, claim, reuse request).  The caller
    closes the engine."""
    eng = make_engine()
    claim = eng.accept_claim(PREFIX, claim_mode)
    r1 = eng.submit(PREFIX + (30, 31), max_new_tokens=1)
    eng.run(r1)
    eng.offload_claim(claim.claim_id, request_id=r1.request_id)
    if fail:
        eng.connector.injection.resident_claim_load_failure = True
        eng.connector.injection.fail_claim_id = claim.claim_id
    r2 = eng.submit(PREFIX + (40, 41), max_new_tokens=1)
    eng.run(r2)
    return eng, claim, r2


def ordinary_offload(make_engine, **kw):
    """A request's blocks stored to the host and restored with NO claim."""
    eng = make_engine(**kw)
    r1 = eng.submit(PREFIX + (30, 31), max_new_tokens=1)
    eng.run(r1)
    blocks = eng.pool.lookup_prefix(PREFIX, eng.block_size)
    job = eng.connector.store(blocks, claim_id=None, request_id=r1.request_id)
    eng.connector.complete_job(job)
    r2 = eng.submit(PREFIX + (40, 41), max_new_tokens=1)
    eng.run(r2)
    return eng, r2


def fallback_recompute_log(eng, request_id: str) -> EventLog:
    """Path B's log replayed as if the request had been served after the
    failure (a fallback recompute)."""
    rows = [
        r for r in copy.deepcopy([e.to_dict() for e in eng.events.events])
        if not (r["name"] in ("offload_request_finished_pending_jobs", "request_finished")
                and r.get("request_id") == request_id)
    ]
    rows.append({"name": "offload_request_finished_no_pending_jobs", "request_id": request_id})
    rows.append({"name": "request_finished", "request_id": request_id, "status": "FINISHED_OK"})
    return EventLog.from_dicts(rows)


def generic_counters_log(eng) -> EventLog:
    """Path B's log with the scheduler outcome removed: transfer counters
    without a claim-scoped outcome."""
    drop = ("scheduler_resident_claim_restoration_failed", "scheduler_active_request_refused",
            "offload_worker_load_failed")
    return EventLog.from_dicts(
        [r for r in copy.deepcopy([e.to_dict() for e in eng.events.events])
         if r["name"] not in drop])


def run_gates(model: Model, out_dir: Path = RESULTS_DIR) -> Dict[str, Any]:
    """The 131 runs; writes ``<out_dir>/connector_gates/aggregate.json`` and
    returns the summary (gate counts as "n/m" strings, as the reference)."""
    make_engine = model.engine
    out_dir = Path(out_dir) / "connector_gates"
    out_dir.mkdir(parents=True, exist_ok=True)
    rows: List[Dict[str, Any]] = []
    counts = {"valid": 0, "total": 0, "obs": 0, "fail": 0, "control": 0, "lifecycle": 0}

    def record(kind: str, eng, passed: bool, wall_s: float, analyzer_ns: float) -> None:
        seq_ok = validate_event_sequence(eng.events).passed
        counts["total"] += 1
        counts["valid"] += seq_ok
        rows.append({"kind": kind, "passed": passed, "sequence_valid": seq_ok,
                     "wall_s": round(wall_s, 6), "analyzer_ns": int(analyzer_ns),
                     "event_bytes": len(eng.events.to_json())})

    def judged(kind, eng, check, *ids, log=None, wall_s=0.0) -> bool:
        """``check`` over the engine's log (or ``log``) for ``ids``, recorded
        as one run of ``kind``; the engine is closed."""
        t1 = time.perf_counter()
        v = check(log if log is not None else eng.events, *ids)
        t2 = time.perf_counter()
        record(kind, eng, v.passed, wall_s, (t2 - t1) * 1e9)
        eng.close()
        return v.passed

    # --- 30 observation passes (path A) ---
    for _ in range(30):
        t0 = time.perf_counter()
        eng, claim, r2 = offload_cycle(make_engine)
        counts["obs"] += judged("observation", eng, check_observation_path, claim.claim_id,
                                r2.request_id, wall_s=time.perf_counter() - t0)
    # --- 30 same-claim failure-outcome passes (path B) ---
    for _ in range(30):
        t0 = time.perf_counter()
        eng, claim, r2 = offload_cycle(make_engine, fail=True)
        counts["fail"] += judged("claimed_load_failure", eng, check_failure_outcome_path,
                                 claim.claim_id, r2.request_id, wall_s=time.perf_counter() - t0)
    # --- 41 false-positive controls (must NOT pass the failure gate) ---
    for _ in range(10):  # ordinary offload without a claim
        eng, r2 = ordinary_offload(make_engine)
        if not check_no_claim_outcome(eng.events).passed:
            gate_failed("CONNECTOR", "an ordinary offload produced a claim outcome")
        counts["control"] += judged("ordinary_offload_no_claim", eng, check_failure_outcome_path,
                                    "claim-0000", r2.request_id)
    for _ in range(10):  # unclaimed generic failure (its own flag, as in the paper)
        eng, r2 = ordinary_offload(
            make_engine, injection=FailureInjectionConfig(unclaimed_generic_failure=True))
        counts["control"] += judged("unclaimed_failure", eng, check_failure_outcome_path,
                                    "claim-0000", r2.request_id)
    for _ in range(10):  # the failure gate checked for a different accepted claim
        eng, claim, r2 = offload_cycle(make_engine, fail=True)
        other = eng.accept_claim(tuple(range(900, 916)), ClaimMode.OFFLOADABLE)
        counts["control"] += judged("wrong_claim_failure", eng, check_failure_outcome_path,
                                    other.claim_id, r2.request_id)
    for _ in range(5):  # fallback-recompute replay
        eng, claim, r2 = offload_cycle(make_engine, fail=True)
        counts["control"] += judged("fallback_recompute", eng, check_failure_outcome_path,
                                    claim.claim_id, r2.request_id,
                                    log=fallback_recompute_log(eng, r2.request_id))
    for _ in range(6):  # generic-counter replay
        eng, claim, r2 = offload_cycle(make_engine, fail=True)
        counts["control"] += judged("generic_counters", eng, check_failure_outcome_path,
                                    claim.claim_id, r2.request_id, log=generic_counters_log(eng))
    # --- 30 lifecycle validity runs (demotable / expiring / hard_protected) ---
    for scen in (scenario_demotable, scenario_expiring, scenario_hard_protected):
        for _ in range(10):
            t0 = time.perf_counter()
            res = scen(make_engine)
            ok = all(bool(v) for v in res["gates"].values())
            counts["lifecycle"] += ok
            counts["total"] += 1
            counts["valid"] += bool(res["gates"].get("order_valid", True))
            rows.append({"kind": f"lifecycle:{scen.__name__}", "passed": ok,
                         "sequence_valid": True, "wall_s": round(time.perf_counter() - t0, 6),
                         "analyzer_ns": 0, "event_bytes": 0})

    summary = {
        "total_runs": f"{counts['total']}",
        "event_sequence_validity": f"{counts['valid']}/{counts['total']}",
        "observation_passes": f"{counts['obs']}/30",
        "failure_outcome_passes": f"{counts['fail']}/30",
        "false_positive_control_passes": f"{counts['control']}/41",
        "lifecycle_passes": f"{counts['lifecycle']}/30",
    }
    (out_dir / "aggregate.json").write_text(json.dumps(
        {"summary": summary, "model": model.describe(), "runs": rows}, indent=1))
    return summary


def check_gates(summary: Dict[str, Any]) -> None:
    """Exit 1 unless every Table 8 count is the paper's."""
    for key, want in GATES.items():
        if summary[key] != want:
            gate_failed("CONNECTOR", f"{key} {summary[key]}, want {want}")


def main(argv: Optional[List[str]] = None) -> None:
    args = parse(parser(__doc__), argv)
    summary = run_gates(model_from(args), args.out_dir)
    print(json.dumps(summary, indent=1))
    check_gates(summary)


if __name__ == "__main__":
    main()

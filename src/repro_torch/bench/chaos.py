"""Chaos campaign on the port: randomized-but-seeded fault plans against
the serving stack.

The counterpart of ``benchmarks/bench_chaos.py``, with its seed, rounds
and gates.  EVERY injected runtime failure must surface as an ordered,
claim-scoped fail-closed outcome: never a crash, never a cross-claim blast
radius, never an unattributed refusal.  The campaign drives >= 200
injected faults (>= 40 with ``--fast``) through a seeded ``FaultPlan``
(scheduled ``FaultSpec``s only, so the expected outcome of every round is
known in advance) and gates on:

  - zero crashes (every round's engine calls return; faults become events);
  - zero order violations: ``validate_event_sequence``,
    ``check_fail_closed_attribution``, ``check_retry_bounded``,
    ``check_metrics_reconcile`` and ``check_step_interleave_order`` pass
    on every engine's full trace;
  - zero cross-claim contamination: bystanders batched with faulted
    victims all finish with full output;
  - exact attribution: each engine's ``fail_closed_total()`` equals the
    schedule-derived counters EXACTLY (transient faults recover through
    bounded retry and move no counter);
  - plan exhaustion: every armed spec was consumed.

Then the quarantine phase: three consecutive permanent restore failures
against disk quarantine the tier; a fourth disk-resident claim is refused
with trigger ``tier_quarantined`` without a disk read, while a
host-resident claim keeps serving.  That engine's trace (refused and
successful claims) is exported as a Perfetto trace, a Prometheus
exposition and a metrics snapshot (``<out-dir>/chaos_trace.json``,
``chaos_metrics.prom``, ``chaos_metrics.json``), each validated.  The
summary merges into ``<out-dir>/BENCH_serving.json`` under
``chaos_campaign``; a failed gate exits 1.

    PYTHONPATH=src python -m repro_torch.bench.chaos [--fast]            # card
    PYTHONPATH=src python -m repro_torch.bench.chaos --fast --device cpu --reduced
"""
from __future__ import annotations

import json
import random
import time
from pathlib import Path
from typing import Any, Dict, List, Optional

from repro_torch.bench.common import (
    RESULTS_DIR,
    SERVING_JSON,
    Model,
    gate_failed,
    merge_json,
    model_from,
    parse,
    parser,
    pcts_ms,
)
from repro_torch.core.analyzer import (
    check_fail_closed_attribution,
    check_metrics_reconcile,
    check_retry_bounded,
    check_step_interleave_order,
    validate_event_sequence,
)
from repro_torch.core.claims import ClaimMode
from repro_torch.serving.chaos import (
    TRIGGER_CAPACITY,
    TRIGGER_CORRUPTION,
    TRIGGER_PERMANENT,
    TRIGGER_QUARANTINE,
    TRIGGER_TRANSIENT,
    TRIGGER_WORKER_DEATH,
    FaultPlan,
    FaultSpec,
)

SEED = 20260808
ROUNDS_PER_ENGINE = 12  # a fresh engine per group keeps the device pool comfortable
CAMPAIGN_KW = dict(quarantine_after=None, device_blocks=256, cache_len=64)


def _fail(msg: str) -> None:
    gate_failed("CHAOS", msg)


def _check_engine_trace(eng, max_attempts: int, violations: list) -> None:
    for name, verdict in (
        ("sequence", validate_event_sequence(eng.events)),
        ("fail_closed_attribution", check_fail_closed_attribution(eng.events)),
        ("retry_bounded", check_retry_bounded(eng.events, max_attempts)),
        ("metrics_reconcile", check_metrics_reconcile(eng.events, eng.metrics)),
        ("step_interleave_order", check_step_interleave_order(eng.events)),
    ):
        if not verdict.passed:
            violations.append(f"{name}: {verdict.reasons}")


def _collect_latencies(eng, acc: dict) -> None:
    """Pool each engine's stage and transfer latency samples (host seconds
    around steps that end in a device sync) for the percentiles."""
    for stage in ("prefill", "prefill_chunk", "decode_step", "restore"):
        xs = eng.stage_seconds.samples(stage=stage)
        if xs:
            acc.setdefault(stage, []).extend(xs)
    xs = eng.connector._m_transfer.samples()
    if xs:
        acc.setdefault("transfer", []).extend(xs)


def build_rounds(rng: random.Random, fast: bool) -> List[tuple]:
    """The deterministic round schedule: (kind, tier, repeats, bystander)
    per round, scheduled specs only."""
    scale = 5 if fast else 1
    mix = (
        [TRIGGER_TRANSIENT] * (35 // scale)
        + [TRIGGER_PERMANENT] * (45 // scale)
        + [TRIGGER_CORRUPTION] * (35 // scale)
        + [TRIGGER_WORKER_DEATH] * (25 // scale)
        + [TRIGGER_CAPACITY] * (25 // scale)
    )
    rng.shuffle(mix)
    rounds = []
    for i, kind in enumerate(mix):
        tier = "disk" if i % 2 else "host"
        repeats = rng.randint(1, 3)  # <= max_attempts - 1: retry always recovers
        bystander = rng.random() < 0.34
        rounds.append((kind, tier, repeats, bystander))
    return rounds


def _round(eng, plan: FaultPlan, base: int, kind: str, tier: str, repeats: int,
           bystander: bool, expected: dict, outcomes: dict) -> None:
    if kind == TRIGGER_CAPACITY:
        plan.schedule(FaultSpec(TRIGGER_CAPACITY))
        r = eng.submit(tuple(range(base, base + 8)), max_new_tokens=1)
        eng.run(r)
        if r.status != "refused" or TRIGGER_CAPACITY not in (r.error or ""):
            _fail(f"capacity round not refused with attribution: {r.status} {r.error}")
        expected[TRIGGER_CAPACITY] = expected.get(TRIGGER_CAPACITY, 0) + 1
        outcomes["refused"] += 1
        return

    prefix = tuple(range(base, base + 16))  # 4 blocks at block_size 4
    claim = eng.accept_claim(prefix, ClaimMode.OFFLOADABLE)
    eng.run(eng.submit(prefix + (base + 900,), max_new_tokens=1))
    if kind == TRIGGER_CORRUPTION:  # corrupt at rest when the bytes land (post-checksum)
        plan.schedule(FaultSpec(TRIGGER_CORRUPTION, boundary=tier, claim_id=claim.claim_id))
    if not eng.offload_claim(claim.claim_id, tier=tier):
        _fail(f"offload to {tier} failed in {kind} round")
    boundary = f"{tier}_to_device"
    if kind == TRIGGER_TRANSIENT:
        plan.schedule(FaultSpec(TRIGGER_TRANSIENT, boundary=boundary, claim_id=claim.claim_id,
                                repeats=repeats))
    elif kind in (TRIGGER_PERMANENT, TRIGGER_WORKER_DEATH):
        plan.schedule(FaultSpec(kind, boundary=boundary, claim_id=claim.claim_id))

    reuse = eng.submit(prefix + (base + 901, base + 902), max_new_tokens=1)
    if bystander:
        by = eng.submit(tuple(range(base + 500, base + 512)), max_new_tokens=1)
        eng.run_batch([reuse, by])
        if by.status != "finished" or len(by.output_tokens) != 1:
            _fail(f"bystander contaminated in {kind} round: {by.status}")
        outcomes["finished_bystanders"] += 1
    else:
        eng.run(reuse)

    if kind == TRIGGER_TRANSIENT:
        if reuse.status != "finished":
            _fail(f"transient round did not recover: {reuse.status} {reuse.error}")
        if reuse.cached_tokens != len(prefix):
            _fail(f"transient recovery lost restored tokens: {reuse.cached_tokens}")
        outcomes["recovered"] += 1
        return
    if reuse.status != "refused":
        _fail(f"{kind} round not refused: {reuse.status}")
    e13 = [e for e in eng.events.named("scheduler_active_request_refused")
           if e.request_id == reuse.request_id]
    if not e13 or e13[-1].payload.get("blocking_claim_ids") != [claim.claim_id]:
        _fail(f"{kind} refusal not attributed to the faulted claim")
    expected[kind] = expected.get(kind, 0) + 1
    outcomes["refused"] += 1


def run_campaign(model: Model, *, fast: bool, latency_acc: dict) -> Dict[str, Any]:
    rounds = build_rounds(random.Random(SEED), fast)
    plan = FaultPlan(seed=SEED)
    expected_total: dict = {}
    violations: list = []
    outcomes = {"recovered": 0, "refused": 0, "finished_bystanders": 0}
    retry_histogram: dict = {}
    n_retries = 0
    base = 10_000
    for group_start in range(0, len(rounds), ROUNDS_PER_ENGINE):
        # quarantine off in the mix phase: permanent faults against one tier
        # stay per-claim outcomes and do not tip the tier for later rounds
        with model.engine(fault_plan=plan, **CAMPAIGN_KW) as eng:
            expected: dict = {}
            for kind, tier, repeats, bystander in rounds[group_start: group_start + ROUNDS_PER_ENGINE]:
                base += 2_000
                _round(eng, plan, base, kind, tier, repeats, bystander, expected, outcomes)
            got = eng.fail_closed_total()
            if got != dict(sorted(expected.items())):
                _fail(f"counter mismatch: got {got}, expected {expected}")
            for k, v in expected.items():
                expected_total[k] = expected_total.get(k, 0) + v
            _check_engine_trace(eng, eng.connector.retry_policy.max_attempts, violations)
            _collect_latencies(eng, latency_acc)
            for att, n in eng.connector.retry_histogram.items():
                retry_histogram[att] = retry_histogram.get(att, 0) + n
            n_retries += eng.connector.queue.retries_performed + sum(
                eng.connector.retry_histogram.values())
    if plan.armed_remaining:
        _fail(f"{plan.armed_remaining} armed specs never consumed")
    if violations:
        _fail(f"order violations: {violations}")
    return {
        "rounds": len(rounds),
        "injected_faults": dict(sorted(plan.stats.injected.items())),
        "injected_total": plan.stats.total,
        "fail_closed_total": dict(sorted(expected_total.items())),
        "outcomes": outcomes,
        "retry_histogram": {str(k): v for k, v in sorted(retry_histogram.items())},
        "refusal_rate": round(outcomes["refused"] / max(1, len(rounds)), 3),
    }


def run_quarantine_phase(model: Model, *, latency_acc: dict,
                         artifacts_dir: Optional[Path] = None) -> Dict[str, Any]:
    """Permanent restore failures quarantine disk; the engine keeps serving
    host-resident chains and refuses offload-dependent admissions with
    ``tier_quarantined`` attribution.  Its trace (refused and successful
    claims) is exported to ``artifacts_dir`` when given."""
    plan = FaultPlan(seed=SEED + 1)
    with model.engine(fault_plan=plan, quarantine_after=3, device_blocks=256,
                      cache_len=64) as eng:
        base = 900_000
        claims = []
        for i in range(4):  # A, B, C fault; D rides out the quarantine
            prefix = tuple(range(base + 2_000 * i, base + 2_000 * i + 16))
            c = eng.accept_claim(prefix, ClaimMode.OFFLOADABLE)
            eng.run(eng.submit(prefix + (base + 900 + i,), max_new_tokens=1))
            if not eng.offload_claim(c.claim_id, tier="disk"):
                _fail("quarantine phase: disk offload failed")
            claims.append((c, prefix))
        host_prefix = tuple(range(base + 50_000, base + 50_016))
        host_claim = eng.accept_claim(host_prefix, ClaimMode.OFFLOADABLE)
        eng.run(eng.submit(host_prefix + (base + 999,), max_new_tokens=1))
        if not eng.offload_claim(host_claim.claim_id, tier="host"):
            _fail("quarantine phase: host offload failed")

        for c, prefix in claims[:3]:
            plan.schedule(FaultSpec(TRIGGER_PERMANENT, boundary="disk_to_device",
                                    claim_id=c.claim_id))
            r = eng.submit(prefix + (1, 2), max_new_tokens=1)
            eng.run(r)
            if r.status != "refused":
                _fail(f"quarantine phase: permanent restore not refused ({r.status})")
        q_events = eng.events.named("tier_quarantined")
        if len(q_events) != 1 or q_events[0].payload.get("tier") != "disk":
            _fail(f"disk not quarantined after 3 failing jobs: {q_events}")

        reads_before = eng.connector.disk.bytes_read  # the 4th claim: no disk read
        c4, p4 = claims[3]
        r4 = eng.submit(p4 + (3, 4), max_new_tokens=1)
        eng.run(r4)
        if r4.status != "refused" or "tier_quarantined:disk" not in (r4.error or ""):
            _fail(f"quarantined restore not refused with attribution: {r4.status} {r4.error}")
        if eng.connector.disk.bytes_read != reads_before:
            _fail("quarantined tier was read during the refused restore")

        rh = eng.submit(host_prefix + (5, 6), max_new_tokens=1)
        eng.run(rh)
        if rh.status != "finished" or rh.cached_tokens != len(host_prefix):
            _fail(f"host-resident claim stopped serving under disk quarantine: {rh.status}")

        expected = {TRIGGER_PERMANENT: 3, TRIGGER_QUARANTINE: 1}
        got = eng.fail_closed_total()
        if got != dict(sorted(expected.items())):
            _fail(f"quarantine counters mismatch: got {got}, expected {expected}")
        violations: list = []
        _check_engine_trace(eng, eng.connector.retry_policy.max_attempts, violations)
        if violations:
            _fail(f"quarantine phase order violations: {violations}")
        if plan.armed_remaining:
            _fail("quarantine phase: armed specs never consumed")
        _collect_latencies(eng, latency_acc)
        artifacts = export_artifacts(eng, Path(artifacts_dir)) if artifacts_dir else {}
    return {
        "injected_faults": dict(sorted(plan.stats.injected.items())),
        "fail_closed_total": got,
        "quarantined_tier": "disk",
        "host_served_through_quarantine": True,
        "disk_untouched_after_quarantine": True,
        **({"artifacts": artifacts} if artifacts else {}),
    }


def export_artifacts(eng, out_dir: Path) -> Dict[str, Any]:
    """Write one engine's Perfetto trace, Prometheus exposition and metrics
    snapshot; the trace must validate and cover at least one refused and
    one successful claim-backed request."""
    from repro_torch.serving.tracing import build_spans, validate_perfetto, write_perfetto

    out_dir.mkdir(parents=True, exist_ok=True)
    trace_path = out_dir / "chaos_trace.json"
    trace = write_perfetto(eng.events, trace_path)
    problems = validate_perfetto(trace)
    if problems:
        _fail(f"exported Perfetto trace invalid: {problems}")
    spans = build_spans(eng.events)
    statuses = {s.args.get("status") for s in spans if s.name == "request"}
    n_refusals = sum(1 for s in spans if s.name == "refusal")
    if "FINISHED_OK" not in statuses or n_refusals == 0:
        _fail(f"trace must cover >=1 successful and >=1 refused claim "
              f"(statuses={statuses}, refusals={n_refusals})")
    prom = eng.metrics.prometheus_text()
    exposed = {}
    for line in prom.splitlines():
        if line.startswith("fail_closed_total{"):
            labels, value = line.rsplit(" ", 1)
            exposed[labels.split('trigger="', 1)[1].split('"', 1)[0]] = int(value)
    if exposed != eng.fail_closed_total():
        _fail(f"Prometheus exposition {exposed} differs from fail_closed_total()")
    prom_path = out_dir / "chaos_metrics.prom"
    prom_path.write_text(prom)
    snap_path = out_dir / "chaos_metrics.json"
    snap_path.write_text(eng.metrics.to_json())
    return {
        "perfetto_trace": str(trace_path),
        "trace_events": len(trace["traceEvents"]),
        "trace_refusal_spans": n_refusals,
        "prometheus": str(prom_path),
        "metrics_snapshot": str(snap_path),
    }


def run(model: Model, out_dir: Path = RESULTS_DIR, *, fast: bool = False) -> Dict[str, Any]:
    """The campaign and the quarantine phase; merges the summary into
    ``<out_dir>/BENCH_serving.json`` and returns it.  A failed gate exits 1."""
    latency_acc: dict = {}
    t0 = time.perf_counter()
    campaign = run_campaign(model, fast=fast, latency_acc=latency_acc)
    quarantine = run_quarantine_phase(model, latency_acc=latency_acc, artifacts_dir=out_dir)
    wall_s = round(time.perf_counter() - t0, 1)
    total_injected = campaign["injected_total"] + sum(quarantine["injected_faults"].values())
    min_faults = 40 if fast else 200
    if total_injected < min_faults:
        _fail(f"only {total_injected} faults injected (< {min_faults})")
    summary = {
        "seed": SEED,
        "fast": fast,
        "model": model.describe(),
        "wall_s": wall_s,
        "total_injected_faults": total_injected,
        "campaign": campaign,
        "quarantine_phase": quarantine,
        "latency_percentiles_ms": {k: pcts_ms(v) for k, v in sorted(latency_acc.items())},
        "gates": {
            "zero_crashes": True,
            "zero_order_violations": True,
            "zero_cross_claim_contamination": True,
            "exact_counter_attribution": True,
            "metrics_reconcile": True,
            "zero_interleave_violations": True,
            "min_injected_faults": min_faults,
        },
    }
    merge_json(Path(out_dir) / SERVING_JSON, "chaos_campaign", summary)
    return summary


def main(argv: Optional[List[str]] = None) -> None:
    args = parse(parser(__doc__), argv)
    summary = run(model_from(args), args.out_dir, fast=args.fast)
    print(json.dumps(summary, indent=1))
    print("CHAOS CAMPAIGN OK")


if __name__ == "__main__":
    main()

"""Witness-path analyzer: order, claim identity, outcome attribution.

The analyzer supplies NO runtime behavior (paper §7's trust separation): it
only checks order, claim match, and controls after the run.  It accepts the
decisive positive sequences (witness paths A and B, multi-claim path C) and
rejects the false-positive families the paper enumerates: ordinary offload
without claim, unclaimed failure, wrong-claim failure, fallback recompute,
and generic transfer counters.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional, Sequence

from repro_torch.core.events import ALL_EVENT_NAMES, Event, EventLog


@dataclass
class Verdict:
    passed: bool
    reasons: List[str] = field(default_factory=list)

    @staticmethod
    def fail(reason: str) -> "Verdict":
        return Verdict(False, [reason])

    def __bool__(self) -> bool:  # pragma: no cover - convenience
        return self.passed


def _matches(e: Event, k: str, v) -> bool:
    """Match an event field/payload value; callables act as predicates
    (used e.g. to accept any ``*_to_device`` restore direction)."""
    actual = getattr(e, k, None)
    if actual is None:
        actual = e.payload.get(k)
    if callable(v):
        return bool(v(actual))
    return actual == v


def _first(events: Sequence[Event], name: str, after: int = -1, **match) -> Optional[Event]:
    for e in events:
        if e.name != name or e.seq <= after:
            continue
        if all(_matches(e, k, v) for k, v in match.items()):
            return e
    return None


def _restore_direction(source_tier: Optional[str] = None):
    """Direction matcher for restores into the device pool.

    ``None`` accepts a restore from ANY tier (host_to_device,
    disk_to_device, ...); a tier name pins the boundary.
    """
    if source_tier is not None:
        expected = f"{source_tier}_to_device"
        return lambda d: d == expected
    return lambda d: isinstance(d, str) and d.endswith("_to_device")


def validate_event_sequence(log: EventLog) -> Verdict:
    """Every event parseable, names known, total order strictly monotonic."""
    last = -1
    for e in log.events:
        if e.name not in ALL_EVENT_NAMES:
            return Verdict.fail(f"unknown event {e.name!r}")
        if e.seq <= last:
            return Verdict.fail(f"non-monotonic sequence at {e.seq}")
        last = e.seq
    return Verdict(True, [f"{len(log)} events, total order valid"])


def check_observation_path(
    log: EventLog,
    claim_id: str,
    reuse_request_id: str,
    source_tier: Optional[str] = None,
) -> Verdict:
    """Witness path A: successful offload/load observation.

    Required order: accept -> materialized -> store(E2, E3, E4 ok) -> E5 ->
    reuse E0 -> E1 hit -> E6 -> E7 -> E3 -> E4 ok -> E8 -> E9 -> E10.

    ``source_tier`` pins the restore boundary (e.g. "disk"); by default any
    tier's restore into the device pool satisfies the path.
    """
    ev = log.events
    reasons = []

    acc = _first(ev, "resident_claim_accepted", claim_id=claim_id)
    if acc is None:
        return Verdict.fail("claim was never accepted (no responsibility boundary)")
    mat = _first(ev, "claim_materialized", after=acc.seq, claim_id=claim_id)
    if mat is None:
        return Verdict.fail("no claim-scoped materialization event")
    store = _first(ev, "offload_store_job_created", after=mat.seq, claim_id=claim_id)
    if store is None:
        return Verdict.fail("no claim-scoped store job")
    t_ok = _first(ev, "offload_worker_transfer_finished", after=store.seq, claim_id=claim_id, ok=True)
    if t_ok is None:
        return Verdict.fail("no successful claim-scoped store transfer")
    off = _first(ev, "resident_claim_offloaded", after=t_ok.seq, claim_id=claim_id)
    if off is None:
        return Verdict.fail("no resident_claim_offloaded after store success")

    reuse = _first(ev, "request_initialized", after=off.seq, request_id=reuse_request_id)
    if reuse is None:
        return Verdict.fail("no reuse request after offload")
    lookup = _first(ev, "offload_lookup_result", after=reuse.seq, request_id=reuse_request_id)
    if lookup is None or lookup.payload.get("hit_tokens", 0) <= 0:
        return Verdict.fail("reuse lookup did not hit the offloaded claim footprint")
    rr = _first(ev, "resident_claim_restore_required", after=lookup.seq, claim_id=claim_id)
    if rr is None:
        return Verdict.fail("restoration was not required before reuse (no E6)")
    load = _first(ev, "offload_load_job_created", after=rr.seq, claim_id=claim_id)
    if load is None:
        return Verdict.fail("no claim-scoped load job")
    l_ok = _first(
        ev,
        "offload_worker_transfer_finished",
        after=load.seq,
        claim_id=claim_id,
        ok=True,
        direction=_restore_direction(source_tier),
    )
    if l_ok is None:
        return Verdict.fail("no successful tier->device transfer for the claim")
    restored = _first(ev, "resident_claim_restored", after=l_ok.seq, claim_id=claim_id)
    if restored is None:
        return Verdict.fail("claim not restored before reuse completion")
    done = _first(ev, "offload_job_completed", after=restored.seq, claim_id=claim_id)
    if done is None:
        return Verdict.fail("load job not completed after restoration")
    fin = _first(
        ev, "offload_request_finished_no_pending_jobs", after=done.seq, request_id=reuse_request_id
    )
    if fin is None:
        return Verdict.fail("reuse request did not finish cleanly after restore")
    reasons.append(
        "ordered accept->materialize->offload->restore_required->restore->reuse verified"
    )
    return Verdict(True, reasons)


def check_failure_outcome_path(
    log: EventLog,
    claim_id: str,
    reuse_request_id: str,
    source_tier: Optional[str] = None,
) -> Verdict:
    """Witness path B: same-claim restoration failure -> fail-closed outcome.

    The decisive sequence (paper §7): accepted claim exists, same claim
    offloaded, reuse hits and requires restore, the matching restore-into-
    device load fails ("CPU -> GPU" in the paper's two-tier world; any
    ``*_to_device`` boundary here, or exactly ``source_tier`` when given),
    E11, E12 (claim match, FINISHED_ERROR), E13 (blocking_claim_ids=[C]),
    E14 after E12/E13, all before terminal request handling.
    """
    ev = log.events
    acc = _first(ev, "resident_claim_accepted", claim_id=claim_id)
    if acc is None:
        return Verdict.fail("failure without an accepted claim is not a claim outcome")
    off = _first(ev, "resident_claim_offloaded", after=acc.seq, claim_id=claim_id)
    if off is None:
        return Verdict.fail("claim was never offloaded; failure cannot be restoration failure")
    reuse = _first(ev, "request_initialized", after=off.seq, request_id=reuse_request_id)
    if reuse is None:
        return Verdict.fail("no reuse request")
    lookup = _first(ev, "offload_lookup_result", after=reuse.seq, request_id=reuse_request_id)
    if lookup is None or lookup.payload.get("hit_tokens", 0) <= 0:
        return Verdict.fail("reuse lookup did not hit the claim footprint")
    rr = _first(ev, "resident_claim_restore_required", after=lookup.seq, claim_id=claim_id)
    if rr is None:
        return Verdict.fail("no ordered restore-required event")
    t_fail = _first(
        ev,
        "offload_worker_transfer_finished",
        after=rr.seq,
        claim_id=claim_id,
        ok=False,
        direction=_restore_direction(source_tier),
    )
    if t_fail is None:
        return Verdict.fail("no same-claim tier->device transfer failure")
    e11 = _first(ev, "offload_worker_load_failed", after=t_fail.seq, claim_id=claim_id)
    if e11 is None:
        return Verdict.fail("invalid-KV-load path has no affected-block evidence (E11)")
    e12 = _first(
        ev,
        "scheduler_resident_claim_restoration_failed",
        after=e11.seq,
        claim_id=claim_id,
        request_id=reuse_request_id,
    )
    if e12 is None:
        return Verdict.fail("no scheduler-boundary claim-scoped restoration failure (E12)")
    if e12.payload.get("request_status") != "FINISHED_ERROR":
        return Verdict.fail("E12 not tied to FINISHED_ERROR status")
    e13 = _first(ev, "scheduler_active_request_refused", after=e12.seq, request_id=reuse_request_id)
    if e13 is None:
        return Verdict.fail("no fail-closed active outcome (E13)")
    blocking = e13.payload.get("blocking_claim_ids", [])
    if claim_id not in blocking:
        return Verdict.fail("refusal not attributed to the blocking claim")
    e14 = _first(
        ev, "offload_request_finished_pending_jobs", after=e13.seq, request_id=reuse_request_id
    )
    if e14 is None:
        return Verdict.fail("scheduler outcome not ordered before terminal handling (no E14)")
    term = _first(ev, "request_finished", after=e14.seq, request_id=reuse_request_id)
    if term is None or term.payload.get("status") != "FINISHED_ERROR":
        return Verdict.fail("request did not terminate in FINISHED_ERROR after the outcome")
    # fallback-recompute rejection: the reuse request must NOT have served
    # output after the failure (success would mean recompute masked the loss)
    ok_fin = _first(
        ev, "offload_request_finished_no_pending_jobs", after=e12.seq, request_id=reuse_request_id
    )
    if ok_fin is not None:
        return Verdict.fail("request served output after claim failure (fallback recompute)")
    return Verdict(
        True,
        ["ordered same-claim failure -> E11 -> E12 -> E13(blocking) -> E14 -> terminal verified"],
    )


def check_multi_claim_attribution(
    log: EventLog, target_claim: str, other_claim: str
) -> Verdict:
    """Witness path C: failure/refusal attribution names ONLY the target."""
    ev = log.events
    restored_other = _first(ev, "resident_claim_restored", claim_id=other_claim)
    if restored_other is None:
        return Verdict.fail("non-target claim did not restore successfully")
    for e in ev:
        if e.name in ("scheduler_resident_claim_restoration_failed",):
            if e.claim_id != target_claim:
                return Verdict.fail(f"failure attributed to non-target claim {e.claim_id}")
        if e.name == "scheduler_active_request_refused":
            blocking = e.payload.get("blocking_claim_ids", [])
            if blocking != [target_claim]:
                return Verdict.fail(f"blocking ids {blocking} != [{target_claim}]")
    e12 = _first(ev, "scheduler_resident_claim_restoration_failed", claim_id=target_claim)
    e13 = _first(ev, "scheduler_active_request_refused")
    if e12 is None or e13 is None:
        return Verdict.fail("target claim did not receive the scheduler-boundary outcome")
    return Verdict(True, ["target-only attribution; non-target restored cleanly"])


# -- chaos-campaign conformance checks ----------------------------------------


def check_fail_closed_attribution(log: EventLog) -> Verdict:
    """Every fail-closed outcome in the trace is ordered and attributed.

    Campaign-wide invariants (any number of claims/requests in one log):

      * every E12 is preceded by a same-claim E11 (affected-block evidence
        exists before the scheduler boundary fires);
      * every E13 names a non-empty ``blocking_claim_ids`` and each named
        claim has an earlier E12 for the SAME request (no unattributed or
        cross-request refusals);
      * after a request's E13 there is a terminal ``request_finished`` with
        FINISHED_ERROR status, and the request never serves output (no E10)
        after its E12;
      * every E4 failure whose reason marks a quarantined tier is ordered
        AFTER the ``tier_quarantined`` event for that tier.
    """
    ev = log.events
    reasons: List[str] = []

    e11_seqs: dict = {}  # claim_id -> list of E11 seqs
    e12_by_req: dict = {}  # request_id -> {claim_id: seq}
    quarantined_at: dict = {}  # tier -> seq of tier_quarantined
    for e in ev:
        if e.name == "offload_worker_load_failed":
            e11_seqs.setdefault(e.claim_id, []).append(e.seq)
        elif e.name == "tier_quarantined":
            tier = e.payload.get("tier")
            if tier not in quarantined_at:
                quarantined_at[tier] = e.seq

    n_e12 = n_e13 = 0
    for e in ev:
        if e.name == "scheduler_resident_claim_restoration_failed":
            n_e12 += 1
            if not any(s < e.seq for s in e11_seqs.get(e.claim_id, [])):
                return Verdict.fail(
                    f"E12 for claim {e.claim_id} without a prior same-claim E11"
                )
            e12_by_req.setdefault(e.request_id, {})[e.claim_id] = e.seq
        elif e.name == "scheduler_active_request_refused":
            n_e13 += 1
            blocking = e.payload.get("blocking_claim_ids", [])
            if not blocking:
                return Verdict.fail(f"E13 for {e.request_id} with empty blocking_claim_ids")
            for cid in blocking:
                if e12_by_req.get(e.request_id, {}).get(cid) is None:
                    return Verdict.fail(
                        f"E13 blocking claim {cid} has no earlier E12 for request {e.request_id}"
                    )
            term = _first(
                ev, "request_finished", after=e.seq, request_id=e.request_id
            )
            if term is None or term.payload.get("status") != "FINISHED_ERROR":
                return Verdict.fail(
                    f"refused request {e.request_id} did not terminate FINISHED_ERROR"
                )
        elif e.name == "offload_worker_transfer_finished" and not e.payload.get("ok", True):
            reason = e.payload.get("reason", "")
            if isinstance(reason, str) and reason.startswith("tier_quarantined:"):
                tier = reason.split(":", 1)[1].split(":", 1)[0]
                q = quarantined_at.get(tier)
                if q is None or q > e.seq:
                    return Verdict.fail(
                        f"quarantine-attributed failure on {tier!r} precedes tier_quarantined"
                    )
    # fallback-recompute rejection, campaign-wide: no request serves output
    # after its claim-scoped restoration failure
    for rid, claims in e12_by_req.items():
        first_e12 = min(claims.values())
        ok_fin = _first(
            ev, "offload_request_finished_no_pending_jobs", after=first_e12, request_id=rid
        )
        if ok_fin is not None:
            return Verdict.fail(f"request {rid} served output after restoration failure")
    reasons.append(f"{n_e12} E12 / {n_e13} E13 outcomes ordered and attributed")
    return Verdict(True, reasons)


def check_retry_bounded(log: EventLog, max_attempts: int) -> Verdict:
    """Transient retries are bounded and terminate.

    Every ``transfer_retry_scheduled`` must carry ``attempt < max_attempts``,
    and each retried (block, direction) pair must reach a terminal E4 (ok or
    not) ordered after its LAST retry — a retry loop that never concludes is
    an order violation, not a liveness hope.
    """
    ev = log.events
    last_retry: dict = {}  # (block_id, direction) -> seq
    n_retries = 0
    for e in ev:
        if e.name != "transfer_retry_scheduled":
            continue
        n_retries += 1
        att = e.payload.get("attempt", 0)
        if not isinstance(att, int) or att >= max_attempts:
            return Verdict.fail(
                f"retry attempt {att} not below max_attempts={max_attempts}"
            )
        key = (e.payload.get("block_id"), e.payload.get("direction"))
        last_retry[key] = e.seq
    for (block_id, direction), seq in last_retry.items():
        term = _first(
            ev,
            "offload_worker_transfer_finished",
            after=seq,
            block_id=block_id,
            direction=direction,
        )
        if term is None:
            return Verdict.fail(
                f"retried block {block_id} ({direction}) has no terminal E4 after last retry"
            )
    return Verdict(True, [f"{n_retries} retries bounded below {max_attempts}, all terminal"])


def check_step_interleave_order(log: EventLog, require_terminal: bool = True) -> Verdict:
    """Unified-scheduler interleave conformance: replay the event log and
    reject any cross-request reordering of the lifecycle grammar.

    The step scheduler (serving/scheduler_loop.py) interleaves many
    requests' lifecycle events in one totally ordered log; the contract is
    that each request's PROJECTION is exactly the single-request stream.
    For every request id, over the grammar-relevant request-scoped events
    (E0, admission refusals, fail_closed_refused, E12, E13, E14, E10,
    request_finished):

      * exactly one E0, ordered before every other grammar event;
      * at most one terminal ``request_finished``, ordered last (a missing
        terminal fails unless ``require_terminal=False`` — parity probes
        like prefill_logits leave requests legally un-terminated);
      * FINISHED_OK  <=> E10 present and NO refusal/error witness
        (E12/E13/E14/scheduler_admission_refused/fail_closed_refused);
      * FINISHED_ERROR => no E10, a fail-closed witness (E13 or
        fail_closed_refused) before E14 before the terminal, and any E13 is
        preceded by a same-request E12 (restore-failure attribution order);
      * REFUSED_ADMISSION => a prior ``scheduler_admission_refused`` and
        neither E10 nor E14.

    Step-level accounting (``step_scheduled``) must be engine-scoped
    (``request_id=None``): a request-scoped step event would make one
    request's projection depend on its batch-mates, which is exactly the
    reordering this check exists to reject.
    """
    GRAMMAR = (
        "request_initialized",
        "scheduler_admission_refused",
        "fail_closed_refused",
        "scheduler_resident_claim_restoration_failed",
        "scheduler_active_request_refused",
        "offload_request_finished_pending_jobs",
        "offload_request_finished_no_pending_jobs",
        "request_finished",
    )
    per_req: dict = {}
    n_steps = 0
    for e in log.events:
        if e.name == "step_scheduled":
            n_steps += 1
            if e.request_id is not None:
                return Verdict.fail(
                    f"step_scheduled at seq {e.seq} is request-scoped "
                    f"({e.request_id}); step accounting must be engine-scoped"
                )
            continue
        if e.name in GRAMMAR and e.request_id is not None:
            per_req.setdefault(e.request_id, []).append(e)

    def _names(proj, name):
        return [e for e in proj if e.name == name]

    for rid, proj in per_req.items():
        e0s = _names(proj, "request_initialized")
        if len(e0s) != 1 or proj[0] is not e0s[0]:
            return Verdict.fail(f"request {rid}: E0 not unique/first in projection")
        terms = _names(proj, "request_finished")
        if len(terms) > 1:
            return Verdict.fail(f"request {rid}: multiple terminal request_finished")
        if not terms:
            if require_terminal:
                return Verdict.fail(f"request {rid}: no terminal request_finished")
            continue
        term = terms[0]
        if proj[-1] is not term:
            stray = proj[-1]
            return Verdict.fail(
                f"request {rid}: {stray.name} (seq {stray.seq}) ordered after terminal"
            )
        status = term.payload.get("status")
        e10 = _names(proj, "offload_request_finished_no_pending_jobs")
        e14 = _names(proj, "offload_request_finished_pending_jobs")
        e13 = _names(proj, "scheduler_active_request_refused")
        e12 = _names(proj, "scheduler_resident_claim_restoration_failed")
        adm = _names(proj, "scheduler_admission_refused")
        fcr = _names(proj, "fail_closed_refused")
        if status == "FINISHED_OK":
            if not e10:
                return Verdict.fail(f"request {rid}: FINISHED_OK without E10")
            if e12 or e13 or e14 or adm or fcr:
                return Verdict.fail(
                    f"request {rid}: FINISHED_OK carries a refusal/error witness"
                )
        elif status == "FINISHED_ERROR":
            if e10:
                return Verdict.fail(f"request {rid}: FINISHED_ERROR served output (E10)")
            if not e14:
                return Verdict.fail(f"request {rid}: FINISHED_ERROR without E14")
            witnesses = e13 + fcr
            if not any(w.seq < e14[0].seq for w in witnesses):
                return Verdict.fail(
                    f"request {rid}: no fail-closed witness ordered before E14"
                )
            if e13 and not (e12 and e12[0].seq < e13[0].seq):
                return Verdict.fail(
                    f"request {rid}: E13 without a preceding same-request E12"
                )
        elif status == "REFUSED_ADMISSION":
            if e10 or e14:
                return Verdict.fail(
                    f"request {rid}: REFUSED_ADMISSION carries terminal-path events"
                )
            if not adm:
                return Verdict.fail(
                    f"request {rid}: REFUSED_ADMISSION without scheduler_admission_refused"
                )
        else:
            return Verdict.fail(f"request {rid}: unknown terminal status {status!r}")
    return Verdict(
        True,
        [
            f"{len(per_req)} request projections conform over {n_steps} scheduler steps"
        ],
    )


# -- metric <-> event reconciliation ------------------------------------------

# Refusal events whose ``trigger`` payload is the ordered witness for a
# ``fail_closed_total{trigger}`` increment.  Every increment site in the
# engines emits exactly one of these with the same trigger, so the tally
# must match the counter in BOTH directions.
FAIL_CLOSED_WITNESS_EVENTS = (
    "scheduler_active_request_refused",
    "scheduler_admission_refused",
    "fail_closed_refused",
)


def _metrics_snapshot(metrics) -> dict:
    """Accept either a serving.metrics.MetricsRegistry or its snapshot() dict.

    Duck-typed on purpose: the analyzer (core/) must not import serving/."""
    snap = metrics.snapshot() if hasattr(metrics, "snapshot") else metrics
    if not isinstance(snap, dict):
        raise TypeError(f"expected MetricsRegistry or snapshot dict, got {type(metrics)!r}")
    return snap


def _counter_series(snap: dict, name: str) -> dict:
    """{label-values-tuple: value} for a counter family (empty if absent)."""
    fam = snap.get(name)
    if fam is None:
        return {}
    return {
        tuple(sorted(s.get("labels", {}).items())): s.get("value", 0)
        for s in fam.get("series", [])
    }


def _histogram_counts(snap: dict, name: str) -> dict:
    fam = snap.get(name)
    if fam is None:
        return {}
    return {
        tuple(sorted(s.get("labels", {}).items())): s.get("count", 0)
        for s in fam.get("series", [])
    }


def check_metrics_reconcile(log: EventLog, metrics) -> Verdict:
    """Fail-closed metric<->event reconciliation (observability != containment).

    The metrics registry is a derived view over the SAME run the event log
    witnesses; any drift between the two means the telemetry has invented or
    dropped an outcome.  Six rules, each checked in both directions:

      1. ``fail_closed_total{trigger}`` equals the tally of ``trigger``
         payloads across the refusal events (E13, admission refusals, and
         ``fail_closed_refused`` — the ordered witnesses of every counter
         increment site).  A counter value with no witness events, or
         refusal events with no counter movement, both fail.
      2. ``transfer_block_seconds`` total observation count equals the
         number of E3->E4 pairs, replayed with the same pending-dict rule
         the instrumentation uses: E3 opens (a retry's re-submission
         re-opens) a ``(block_id, direction)`` slot, E4 consumes it;
         an E4 with no open slot (e.g. a quarantined-tier refusal that
         never submitted) contributes no observation.
      3. ``claim_restores_total`` equals the count of E8
         ``resident_claim_restored`` events.
      4. ``transfer_retries_total`` (summed over directions) equals the
         count of ``transfer_retry_scheduled`` events.
      5. ``stage_seconds{stage}`` observation counts equal the per-stage
         tally of ``stage_latency`` events.
      6. ``scheduler_step_tokens`` total observation count equals the
         number of ``step_scheduled`` events (one histogram sample per
         unified scheduler step, engines without a step loop hold 0 == 0).
      7. ``prefix_reuse_hits_total`` equals the count of ``prefix_reuse``
         events (one per admission that found resident prefix pages).
      8. ``cow_copies_total`` equals the count of ``page_cow`` events (one
         per copy-on-write at a shared-page divergence point).

    ``metrics`` may be a live ``serving.metrics.MetricsRegistry`` or its
    ``snapshot()`` dict (the serialized form the CI artifacts carry).
    """
    snap = _metrics_snapshot(metrics)
    ev = log.events
    reasons: List[str] = []

    # rule 1: fail_closed_total{trigger} <-> refusal-event trigger tally
    witnessed: dict = {}
    for e in ev:
        if e.name in FAIL_CLOSED_WITNESS_EVENTS:
            trig = e.payload.get("trigger")
            if trig is not None:
                witnessed[trig] = witnessed.get(trig, 0) + 1
    counted = {
        dict(k).get("trigger"): v
        for k, v in _counter_series(snap, "fail_closed_total").items()
        if v  # zero-valued series reconcile against zero events
    }
    witnessed = {k: v for k, v in witnessed.items() if v}
    if counted != witnessed:
        only_counter = {k: v for k, v in counted.items() if witnessed.get(k) != v}
        only_events = {k: v for k, v in witnessed.items() if counted.get(k) != v}
        return Verdict.fail(
            "fail_closed_total drifts from refusal events: "
            f"counter={only_counter} events={only_events}"
        )
    reasons.append(f"fail_closed_total == refusal-event tally ({sum(witnessed.values())})")

    # rule 2: transfer_block_seconds count <-> E3->E4 pair replay
    pending: dict = {}
    pairs = 0
    for e in ev:
        if e.name == "offload_worker_transfer_submitted":
            pending[(e.payload.get("block_id"), e.payload.get("direction"))] = e.seq
        elif e.name == "offload_worker_transfer_finished":
            if pending.pop((e.payload.get("block_id"), e.payload.get("direction")), None) is not None:
                pairs += 1
    observed = sum(_histogram_counts(snap, "transfer_block_seconds").values())
    if observed != pairs:
        return Verdict.fail(
            f"transfer_block_seconds count {observed} != E3->E4 pair count {pairs}"
        )
    reasons.append(f"transfer_block_seconds count == E3->E4 pairs ({pairs})")

    # rule 3: claim_restores_total <-> E8 count
    n_e8 = len(log.named("resident_claim_restored"))
    restores = sum(_counter_series(snap, "claim_restores_total").values())
    if restores != n_e8:
        return Verdict.fail(f"claim_restores_total {restores} != E8 count {n_e8}")
    reasons.append(f"claim_restores_total == E8 count ({n_e8})")

    # rule 4: transfer_retries_total <-> retry events
    n_retry_ev = len(log.named("transfer_retry_scheduled"))
    n_retry_m = sum(_counter_series(snap, "transfer_retries_total").values())
    if n_retry_m != n_retry_ev:
        return Verdict.fail(
            f"transfer_retries_total {n_retry_m} != transfer_retry_scheduled count {n_retry_ev}"
        )
    reasons.append(f"transfer_retries_total == retry events ({n_retry_ev})")

    # rule 5: stage_seconds{stage} <-> stage_latency tally
    stage_ev: dict = {}
    for e in ev:
        if e.name == "stage_latency":
            s = e.payload.get("stage")
            stage_ev[s] = stage_ev.get(s, 0) + 1
    stage_m = {
        dict(k).get("stage"): v
        for k, v in _histogram_counts(snap, "stage_seconds").items()
        if v
    }
    stage_ev = {k: v for k, v in stage_ev.items() if v}
    if stage_m != stage_ev:
        return Verdict.fail(
            f"stage_seconds counts drift from stage_latency events: "
            f"metrics={stage_m} events={stage_ev}"
        )
    reasons.append(f"stage_seconds == stage_latency tally ({sum(stage_ev.values())})")

    # rule 6: scheduler_step_tokens count <-> step_scheduled events (the
    # unified scheduler's per-step accounting; engines without the step
    # loop reconcile 0 == 0)
    n_step_ev = len(log.named("step_scheduled"))
    n_step_obs = sum(_histogram_counts(snap, "scheduler_step_tokens").values())
    if n_step_obs != n_step_ev:
        return Verdict.fail(
            f"scheduler_step_tokens count {n_step_obs} != step_scheduled count {n_step_ev}"
        )
    reasons.append(f"scheduler_step_tokens count == step_scheduled events ({n_step_ev})")

    # rule 7: prefix_reuse_hits_total <-> prefix_reuse events (engines
    # without the radix index registered reconcile 0 == 0)
    n_reuse_ev = len(log.named("prefix_reuse"))
    n_reuse_m = sum(_counter_series(snap, "prefix_reuse_hits_total").values())
    if n_reuse_m != n_reuse_ev:
        return Verdict.fail(
            f"prefix_reuse_hits_total {n_reuse_m} != prefix_reuse count {n_reuse_ev}"
        )
    reasons.append(f"prefix_reuse_hits_total == prefix_reuse events ({n_reuse_ev})")

    # rule 8: cow_copies_total <-> page_cow events
    n_cow_ev = len(log.named("page_cow"))
    n_cow_m = sum(_counter_series(snap, "cow_copies_total").values())
    if n_cow_m != n_cow_ev:
        return Verdict.fail(
            f"cow_copies_total {n_cow_m} != page_cow count {n_cow_ev}"
        )
    reasons.append(f"cow_copies_total == page_cow events ({n_cow_ev})")

    return Verdict(True, reasons)


def check_shared_page_immutability(log: EventLog) -> Verdict:
    """A shared page is never mutated in place.

    Replays page-slot occupancy from the ordered witnesses:

      - ``block_stored`` with a ``page_index`` occupies that slot for its
        block (a slot still occupied by a DIFFERENT live block is an
        aliasing violation);
      - ``block_removed`` frees whatever slot its block held;
      - ``page_extend`` is the ONLY legal in-place page mutation and must
        carry ``refcount <= 1`` (the extender is the sole holder) and hit
        the slot its own block occupies;
      - ``page_cow`` must land the copy on a DIFFERENT slot than the
        source (``new_page_index != page_index``).

    Events without a page index (owned-array payloads) are outside the
    page store and skipped.
    """
    slot_of: dict = {}  # block_id -> page_index
    occupant: dict = {}  # page_index -> block_id
    n_extends = n_cows = 0
    for e in log.events:
        if e.name == "block_stored":
            bid = e.payload.get("block_id")
            pi = e.payload.get("page_index")
            old = slot_of.pop(bid, None)
            if old is not None and occupant.get(old) == bid:
                del occupant[old]  # re-store of a known block moves it
            if pi is None:
                continue
            cur = occupant.get(pi)
            if cur is not None and cur != bid:
                return Verdict.fail(
                    f"page {pi} stored for block {bid} while occupied by "
                    f"live block {cur} (seq {e.seq})"
                )
            occupant[pi] = bid
            slot_of[bid] = pi
        elif e.name == "block_removed":
            bid = e.payload.get("block_id")
            pi = slot_of.pop(bid, None)
            if pi is not None and occupant.get(pi) == bid:
                del occupant[pi]
        elif e.name == "page_extend":
            n_extends += 1
            ref = e.payload.get("refcount", 0)
            if ref is not None and ref > 1:
                return Verdict.fail(
                    f"page_extend on block {e.payload.get('block_id')} with "
                    f"refcount {ref} > 1 (shared page mutated, seq {e.seq})"
                )
            pi = e.payload.get("page_index")
            bid = e.payload.get("block_id")
            if pi is not None and occupant.get(pi) != bid:
                return Verdict.fail(
                    f"page_extend wrote slot {pi} not occupied by its block "
                    f"{bid} (seq {e.seq})"
                )
        elif e.name == "page_cow":
            n_cows += 1
            pi = e.payload.get("page_index")
            npi = e.payload.get("new_page_index")
            if pi is not None and npi is not None and pi == npi:
                return Verdict.fail(
                    f"page_cow landed on its own source slot {pi} (seq {e.seq})"
                )
    return Verdict(
        True,
        [
            f"page occupancy consistent over {len(log)} events "
            f"({n_extends} extends, {n_cows} cows, {len(occupant)} slots live)"
        ],
    )


# -- false-positive control checks (the analyzer must REJECT these) -----------


def check_no_claim_outcome(log: EventLog) -> Verdict:
    """Control: a run with no accepted claim must contain zero claim outcomes."""
    for name in (
        "scheduler_resident_claim_restoration_failed",
        "scheduler_active_request_refused",
        "resident_claim_restoration_failed",
        "resident_claim_offloaded",
        "resident_claim_restored",
        "claim_materialized",
    ):
        if log.named(name):
            return Verdict.fail(f"claim outcome {name} emitted without an accepted claim")
    return Verdict(True, ["no claim outcomes for unclaimed run"])

"""Ordered lifecycle event log — the paper's E0–E14 vocabulary plus the
native-runtime extensions (acceptance, demotion, expiry, harm, routing).

The paper's exact artifact event names (§7) are preserved so the witness
tables in EXPERIMENTS.md read one-to-one against the paper:

  E0  request_initialized
  E1  offload_lookup_result
  E2  offload_store_job_created
  E3  offload_worker_transfer_submitted
  E4  offload_worker_transfer_finished
  E5  resident_claim_offloaded
  E6  resident_claim_restore_required
  E7  offload_load_job_created
  E8  resident_claim_restored
  E9  offload_job_completed
  E10 offload_request_finished_no_pending_jobs
  E11 offload_worker_load_failed
  E12 scheduler_resident_claim_restoration_failed
  E13 scheduler_active_request_refused
  E14 offload_request_finished_pending_jobs

Ordering is total (a monotonic sequence number assigned at emission); the
analyzer (core/analyzer.py) consumes the order, never wall-clock time.
Each event also carries a monotonic wall-clock ``ts`` (time.monotonic() at
emission) used ONLY by the tracing layer (serving/tracing.py) to give spans
duration — conformance checks never order by ``ts``.
"""
from __future__ import annotations

import itertools
import json
import threading
import time
from dataclasses import dataclass, field
from typing import Any, Dict, Iterable, List, Optional

# --- the paper's event aliases ------------------------------------------------
E = {
    "E0": "request_initialized",
    "E1": "offload_lookup_result",
    "E2": "offload_store_job_created",
    "E3": "offload_worker_transfer_submitted",
    "E4": "offload_worker_transfer_finished",
    "E5": "resident_claim_offloaded",
    "E6": "resident_claim_restore_required",
    "E7": "offload_load_job_created",
    "E8": "resident_claim_restored",
    "E9": "offload_job_completed",
    "E10": "offload_request_finished_no_pending_jobs",
    "E11": "offload_worker_load_failed",
    "E12": "scheduler_resident_claim_restoration_failed",
    "E13": "scheduler_active_request_refused",
    "E14": "offload_request_finished_pending_jobs",
}

# --- native-runtime extension vocabulary --------------------------------------
NATIVE_EVENTS = (
    "resident_claim_accepted",
    "resident_claim_rejected",
    "claim_materialized",
    "resident_claim_demoted",
    "resident_claim_expired",
    "resident_claim_harmed",
    "allocator_victim_excluded",
    "scheduler_admission_refused",
    "claim_footprint_accounted",
    "block_stored",
    "block_removed",
    "request_finished",
    "route_decision",
    "route_placement",
    "route_reuse_attributed",
    "pressure_eviction",
    # tiered transfer backend (serving/tiers.py, serving/offload.py)
    "transfer_job_enqueued",
    "transfer_batch_executed",
    "offload_tier_spill",
    "offload_tier_promote",
    # continuous batching (serving/engine.py): batch_scheduled marks one
    # run_batch submission (ANY batch size, including 1 — span tracing and
    # metrics reconciliation never special-case singletons); step_scheduled
    # marks one unified scheduler step (engine-scoped, request_id=None so
    # per-request projections stay byte-identical across batch compositions)
    # carrying the step's token accounting: decode/feed rows + at most one
    # in-flight prefill chunk under the max_tokens_per_step budget
    "batch_scheduled",
    "step_scheduled",
    # fault handling (serving/chaos.py, serving/offload.py): a bounded
    # transient retry is visible in the trace, and tier quarantine is an
    # explicit boundary event ordered before any quarantine-attributed refusal
    "transfer_retry_scheduled",
    "tier_quarantined",
    # observability (serving/metrics.py, serving/tracing.py): a measured
    # stage duration (request-scoped where applicable, payload carries
    # stage + seconds), and a fail-closed refusal at a boundary that has
    # no dedicated refusal event of its own (offload refusal, unclaimed
    # load failure) so every fail_closed_total increment has exactly one
    # ordered witness event — the reconciliation invariant
    "stage_latency",
    "fail_closed_refused",
    # pool-wide radix prefix sharing (serving/kv_cache.py, serving/engine.py):
    # prefix_reuse marks ONE admission that found resident prefix pages
    # (full blocks and/or a partial decode-tail block) — the ordered witness
    # for prefix_reuse_hits_total; page_extend marks an in-place append to
    # an UNSHARED partial page (refcount must be <= 1 — the analyzer's
    # shared-page-immutability check rejects anything else); page_cow marks
    # a copy-on-write at the divergence block of a SHARED page — the ordered
    # witness for cow_copies_total
    "prefix_reuse",
    "page_extend",
    "page_cow",
)

ALL_EVENT_NAMES = frozenset(E.values()) | frozenset(NATIVE_EVENTS)

# --- per-event payload schemas ------------------------------------------------
# ``EventLog.emit`` validates the payload keyword set at runtime (below).
# Keys listed here are PAYLOAD keys — ``request_id``/``claim_id``/``ts`` are
# dedicated Event fields, never payload.  ``object_id`` IS payload: the claim
# ledger's ``mark`` helper threads it through ``**payload``.
#
# ``PAYLOAD_SCHEMA[name]`` holds the required keys; ``PAYLOAD_OPTIONAL[name]``
# the additional keys an emit site may carry (variant shapes of the same
# boundary, e.g. the pool-pressure admission refusal carries its accounting).
PAYLOAD_SCHEMA: Dict[str, frozenset] = {
    # paper events E0–E14
    "request_initialized": frozenset({"n_tokens", "claim_metadata"}),
    "offload_lookup_result": frozenset({"hit_tokens", "hit_blocks", "tier_hits"}),
    "offload_store_job_created": frozenset({"job_id", "block_ids", "tier"}),
    "offload_worker_transfer_submitted": frozenset(
        {"block_id", "direction", "nbytes", "attempt"}
    ),
    "offload_worker_transfer_finished": frozenset({"block_id", "direction", "ok", "reason"}),
    "resident_claim_offloaded": frozenset({"object_id", "n_blocks", "tier"}),
    "resident_claim_restore_required": frozenset({"object_id", "predicate"}),
    "offload_load_job_created": frozenset({"job_id", "block_ids"}),
    "resident_claim_restored": frozenset({"object_id"}),
    "offload_job_completed": frozenset({"job_id", "ok"}),
    "offload_request_finished_no_pending_jobs": frozenset(),
    "offload_worker_load_failed": frozenset({"block_id", "reason"}),
    "scheduler_resident_claim_restoration_failed": frozenset(
        {"object_id", "reason", "trigger"}
    ),
    "scheduler_active_request_refused": frozenset({"blocking_claim_ids", "reason", "trigger"}),
    "offload_request_finished_pending_jobs": frozenset(),
    # native-runtime extensions
    "resident_claim_accepted": frozenset(
        {"object_id", "predicate", "mode", "priority", "duration_s"}
    ),
    "resident_claim_rejected": frozenset({"object_id", "reason"}),
    "claim_materialized": frozenset(
        {"object_id", "observation_point", "predicate", "materialized_tokens"}
    ),
    "resident_claim_demoted": frozenset({"object_id", "before_loss", "trigger"}),
    "resident_claim_expired": frozenset({"object_id", "boundary", "age_s"}),
    "resident_claim_harmed": frozenset({"object_id", "cause", "predicate"}),
    "allocator_victim_excluded": frozenset({"block_id", "protected_by"}),
    "scheduler_admission_refused": frozenset({"blocking_claim_ids", "conflict_action", "trigger"}),
    "claim_footprint_accounted": frozenset({"footprint_bytes", "n_blocks"}),
    "block_stored": frozenset({"block_id", "chain", "n_tokens"}),
    "block_removed": frozenset({"block_id", "chain", "reason"}),
    "request_finished": frozenset({"status"}),
    "route_decision": frozenset({"worker", "route_cost_tokens", "overlap_scores"}),
    "route_placement": frozenset({"worker", "reason"}),
    "route_reuse_attributed": frozenset({"worker", "reuse_hit_tokens", "success"}),
    "pressure_eviction": frozenset({"block_id", "priority"}),
    "transfer_job_enqueued": frozenset({"job_id", "kind", "n_blocks"}),
    "transfer_batch_executed": frozenset({"job_id", "n_blocks", "nbytes"}),
    "offload_tier_spill": frozenset({"block_id", "from_tier", "to_tier", "nbytes"}),
    "offload_tier_promote": frozenset({"block_id", "from_tier", "to_tier"}),
    "batch_scheduled": frozenset({"batch_size", "request_ids"}),
    "step_scheduled": frozenset(
        {
            "step",
            "n_rows",
            "n_decode",
            "n_feed",
            "prefill_rows",
            "prefill_tokens",
            "step_tokens",
            "budget",
        }
    ),
    "transfer_retry_scheduled": frozenset(
        {"job_id", "block_id", "direction", "attempt", "max_attempts", "delay_s", "reason"}
    ),
    "tier_quarantined": frozenset({"tier", "consecutive_failures", "trigger"}),
    "stage_latency": frozenset({"stage", "seconds"}),
    "fail_closed_refused": frozenset({"scope", "trigger", "reason"}),
    "prefix_reuse": frozenset({"n_blocks", "n_tokens", "partial_tokens"}),
    "page_extend": frozenset({"block_id", "page_index", "n_valid", "refcount"}),
    "page_cow": frozenset(
        {"block_id", "new_block_id", "page_index", "new_page_index", "refcount"}
    ),
}

PAYLOAD_OPTIONAL: Dict[str, frozenset] = {
    # pool-pressure refusal carries the allocator accounting; the claim- and
    # shape-conflict refusals carry the stage that refused instead.
    "scheduler_admission_refused": frozenset(
        {"stage", "needed_blocks", "free_blocks", "evictable_blocks"}
    ),
    # restoration failure at a terminal request carries the request status.
    "scheduler_resident_claim_restoration_failed": frozenset({"request_status"}),
    # only the pending-job variant of E14 knows which job was pending.
    "offload_request_finished_pending_jobs": frozenset({"job_id"}),
    # claim-registration placements carry the claim predicate.
    "route_placement": frozenset({"predicate"}),
    # page-resident stores carry their slot so the shared-page-immutability
    # replay (core/analyzer.py) can track occupancy; owned-array payloads
    # (shape drift, dense snapshots) legally omit it.
    "block_stored": frozenset({"page_index"}),
}

assert frozenset(PAYLOAD_SCHEMA) == ALL_EVENT_NAMES, "every event name needs a payload schema"


@dataclass(frozen=True)
class Event:
    seq: int
    name: str
    request_id: Optional[str] = None
    claim_id: Optional[str] = None
    payload: Dict[str, Any] = field(default_factory=dict)
    # Monotonic wall-clock at emission (time.monotonic()).  Tracing-only:
    # the analyzer orders by seq, never ts (ts ties are legal; seq ties
    # are not).
    ts: float = 0.0

    def to_dict(self) -> Dict[str, Any]:
        return {
            "seq": self.seq,
            "name": self.name,
            "request_id": self.request_id,
            "claim_id": self.claim_id,
            "ts": self.ts,
            **{k: v for k, v in self.payload.items()},
        }


class EventLog:
    """Append-only, totally ordered event log (the trace anchor source)."""

    def __init__(self) -> None:
        self._events: List[Event] = []
        self._counter = itertools.count()
        self._lock = threading.Lock()

    def emit(
        self,
        name: str,
        *,
        request_id: Optional[str] = None,
        claim_id: Optional[str] = None,
        ts: Optional[float] = None,
        _validate: bool = True,
        **payload: Any,
    ) -> Event:
        if name not in ALL_EVENT_NAMES:
            raise ValueError(f"unknown event name {name!r}")
        if _validate:
            required = PAYLOAD_SCHEMA[name]
            provided = frozenset(payload)
            missing = required - provided
            if missing:
                raise ValueError(
                    f"event {name!r} payload missing required keys {sorted(missing)} "
                    f"(got {sorted(provided)})"
                )
            unknown = provided - required - PAYLOAD_OPTIONAL.get(name, frozenset())
            if unknown:
                raise ValueError(
                    f"event {name!r} payload carries undeclared keys {sorted(unknown)} "
                    f"— extend PAYLOAD_SCHEMA/PAYLOAD_OPTIONAL in core/events.py"
                )
        with self._lock:
            ev = Event(
                next(self._counter),
                name,
                request_id,
                claim_id,
                payload,
                ts=time.monotonic() if ts is None else float(ts),
            )
            self._events.append(ev)
        return ev

    @property
    def events(self) -> List[Event]:
        return list(self._events)

    def named(self, name: str) -> List[Event]:
        return [e for e in self._events if e.name == name]

    def for_claim(self, claim_id: str) -> List[Event]:
        return [e for e in self._events if e.claim_id == claim_id]

    def for_request(self, request_id: str) -> List[Event]:
        return [e for e in self._events if e.request_id == request_id]

    def to_json(self) -> str:
        return json.dumps([e.to_dict() for e in self._events], indent=1)

    @staticmethod
    def from_dicts(rows: Iterable[Dict[str, Any]]) -> "EventLog":
        log = EventLog()
        for r in rows:
            r = dict(r)
            # Replay path: names/payloads come from serialized (possibly
            # deliberately mutated) traces, so the payload schema is NOT
            # re-validated — replayed logs are analyzed, never trusted.
            log.emit(  # lint: allow[emit-site] replay of serialized traces; name/payload dynamic by design, schema enforced at the original emission
                r.pop("name"),
                request_id=r.pop("request_id", None),
                claim_id=r.pop("claim_id", None),
                ts=r.pop("ts", None),
                _validate=False,
                **{k: v for k, v in r.items() if k != "seq"},
            )
        return log

    def __len__(self) -> int:
        return len(self._events)

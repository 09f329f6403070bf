"""Lifecycle span tracing: derive per-request / per-claim spans from the
ordered event log and export Chrome/Perfetto trace-event JSON.

Spans are a VIEW over the event log, never a second source of truth: span
derivation consumes the exact E0–E14 (+native) events the analyzer checks,
so a span exists iff its witness events exist.  Two clocks ride on every
event (core/events.Event):

  - ``seq``  — the total order.  The ONLY thing pairing/containment logic
    uses; the analyzer never reads ``ts``.
  - ``ts``   — monotonic wall-clock at emission.  Used ONLY to give spans
    duration on the exported timeline; ties and tiny skews are legal.

Span vocabulary (``Span.name`` / ``cat``):

  request       E0 ``request_initialized``  -> ``request_finished``
  admission     E0 -> the admission decision (first of
                ``scheduler_admission_refused`` | E1 lookup | terminal)
  transfer      one E3 -> E4 pair per (block, direction) — the LAST E3
                before the E4 opens the span (a retried block's earlier
                submissions appear as ``transfer_retry`` instants), the
                same pairing rule the transfer_block_seconds histogram and
                ``check_metrics_reconcile`` use
  transfer_job  ``transfer_job_enqueued`` -> E9 ``offload_job_completed``
  offload       E2 ``offload_store_job_created`` -> E5
                ``resident_claim_offloaded`` (per claim)
  restore       E6 ``resident_claim_restore_required`` -> E8
                ``resident_claim_restored`` or E12 restoration-failed
  refusal       the refusal event (``scheduler_active_request_refused`` |
                ``scheduler_admission_refused`` | ``fail_closed_refused``)
                -> the request's terminal event; ``args.trigger`` carries
                the fail-closed attribution
  stage:<s>     a ``stage_latency`` event unfolded backward by its
                measured ``seconds`` (engine-scoped slices: prefill,
                prefill_chunk, decode_step, restore)

Instants: ``tier_quarantined`` and ``transfer_retry_scheduled`` render as
Perfetto instant events on their track; ``batch_scheduled`` and the unified
scheduler's per-step ``step_scheduled`` accounting render on a dedicated
``scheduler`` track (step, token load, decode/feed/prefill split, budget).

Export format: the Chrome trace-event JSON object form —
``{"traceEvents": [...]}`` with ``"X"`` complete events (ts/dur in
microseconds), ``"i"`` instants, and ``"M"`` process/thread name metadata —
loadable directly in Perfetto UI / chrome://tracing.
"""
from __future__ import annotations

import json
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

from repro_torch.core.events import Event, EventLog

__all__ = [
    "Span",
    "Instant",
    "build_spans",
    "build_instants",
    "to_perfetto",
    "write_perfetto",
    "validate_perfetto",
]

REFUSAL_EVENTS = (
    "scheduler_active_request_refused",
    "scheduler_admission_refused",
    "fail_closed_refused",
)


@dataclass
class Span:
    name: str
    cat: str
    track: str  # timeline row: "req:<id>", "claim:<id>", "transfers", "stages"
    start_ts: float
    end_ts: float
    start_seq: int
    end_seq: int
    args: Dict[str, Any] = field(default_factory=dict)

    @property
    def duration_s(self) -> float:
        return max(0.0, self.end_ts - self.start_ts)


@dataclass
class Instant:
    name: str
    cat: str
    track: str
    ts: float
    seq: int
    args: Dict[str, Any] = field(default_factory=dict)


def _req_track(request_id: str) -> str:
    return f"req:{request_id}"


def _claim_track(claim_id: str) -> str:
    return f"claim:{claim_id}"


def build_spans(log: EventLog) -> List[Span]:
    """Derive the span set from an event log (pairing by seq, duration by ts)."""
    ev = sorted(log.events, key=lambda e: e.seq)
    spans: List[Span] = []

    # -- per-request: request / admission / refusal ----------------------------
    starts: Dict[str, Event] = {}
    admission_open: Dict[str, Event] = {}
    refusal_open: Dict[str, Event] = {}
    for e in ev:
        rid = e.request_id
        if e.name == "request_initialized" and rid is not None:
            starts[rid] = e
            admission_open[rid] = e
        elif rid in admission_open and e.name in (
            "scheduler_admission_refused",
            "offload_lookup_result",
            "request_finished",
        ):
            a = admission_open.pop(rid)
            spans.append(
                Span(
                    "admission",
                    "request",
                    _req_track(rid),
                    a.ts,
                    e.ts,
                    a.seq,
                    e.seq,
                    {"decision": e.name},
                )
            )
        if e.name in REFUSAL_EVENTS and rid is not None and rid not in refusal_open:
            refusal_open[rid] = e
        if e.name == "request_finished" and rid is not None:
            s = starts.pop(rid, None)
            if s is not None:
                spans.append(
                    Span(
                        "request",
                        "request",
                        _req_track(rid),
                        s.ts,
                        e.ts,
                        s.seq,
                        e.seq,
                        {"status": e.payload.get("status"), "request_id": rid},
                    )
                )
            r = refusal_open.pop(rid, None)
            if r is not None:
                spans.append(
                    Span(
                        "refusal",
                        "refusal",
                        _req_track(rid),
                        r.ts,
                        e.ts,
                        r.seq,
                        e.seq,
                        {
                            "trigger": r.payload.get("trigger"),
                            "via": r.name,
                            "reason": r.payload.get("reason", ""),
                            "blocking_claim_ids": r.payload.get("blocking_claim_ids"),
                        },
                    )
                )

    # -- per-claim: offload / restore -----------------------------------------
    offload_open: Dict[str, Event] = {}
    restore_open: Dict[str, Event] = {}
    for e in ev:
        cid = e.claim_id
        if cid is None:
            continue
        if e.name == "offload_store_job_created":
            offload_open.setdefault(cid, e)
        elif e.name == "resident_claim_offloaded" and cid in offload_open:
            s = offload_open.pop(cid)
            spans.append(
                Span(
                    "offload", "claim", _claim_track(cid), s.ts, e.ts, s.seq, e.seq,
                    {"claim_id": cid, "tier": e.payload.get("tier")},
                )
            )
        elif e.name == "resident_claim_restore_required":
            restore_open.setdefault(cid, e)
        elif cid in restore_open and e.name in (
            "resident_claim_restored",
            "scheduler_resident_claim_restoration_failed",
        ):
            s = restore_open.pop(cid)
            ok = e.name == "resident_claim_restored"
            spans.append(
                Span(
                    "restore", "claim", _claim_track(cid), s.ts, e.ts, s.seq, e.seq,
                    {
                        "claim_id": cid,
                        "ok": ok,
                        "trigger": None if ok else e.payload.get("trigger"),
                    },
                )
            )

    # -- transfers: E3 -> E4 pairs (the reconciliation pairing rule) ----------
    pending: Dict[Tuple[Optional[int], str], Event] = {}
    job_open: Dict[Any, Event] = {}
    for e in ev:
        if e.name == "offload_worker_transfer_submitted":
            key = (e.payload.get("block_id"), e.payload.get("direction"))
            pending[key] = e  # a retry's re-submission overwrites
        elif e.name == "offload_worker_transfer_finished":
            key = (e.payload.get("block_id"), e.payload.get("direction"))
            s = pending.pop(key, None)
            if s is not None:
                spans.append(
                    Span(
                        "transfer",
                        "transfer",
                        "transfers",
                        s.ts,
                        e.ts,
                        s.seq,
                        e.seq,
                        {
                            "block_id": e.payload.get("block_id"),
                            "direction": e.payload.get("direction"),
                            "ok": e.payload.get("ok"),
                            "reason": e.payload.get("reason", ""),
                            "claim_id": e.claim_id,
                        },
                    )
                )
        elif e.name == "transfer_job_enqueued":
            job_open[e.payload.get("job_id")] = e
        elif e.name == "offload_job_completed":
            s = job_open.pop(e.payload.get("job_id"), None)
            if s is not None:
                spans.append(
                    Span(
                        "transfer_job",
                        "transfer",
                        "transfers",
                        s.ts,
                        e.ts,
                        s.seq,
                        e.seq,
                        {
                            "job_id": e.payload.get("job_id"),
                            "kind": s.payload.get("kind"),
                            "n_blocks": s.payload.get("n_blocks"),
                            "ok": e.payload.get("ok"),
                        },
                    )
                )

    # -- engine stage slices ---------------------------------------------------
    for e in ev:
        if e.name != "stage_latency":
            continue
        dur = float(e.payload.get("seconds", 0.0))
        spans.append(
            Span(
                f"stage:{e.payload.get('stage')}",
                "stage",
                "stages",
                e.ts - dur,
                e.ts,
                e.seq,
                e.seq,
                {"stage": e.payload.get("stage"), "seconds": dur},
            )
        )

    spans.sort(key=lambda s: (s.start_seq, s.end_seq))
    return spans


def build_instants(log: EventLog) -> List[Instant]:
    out: List[Instant] = []
    for e in sorted(log.events, key=lambda e: e.seq):
        if e.name == "tier_quarantined":
            out.append(
                Instant(
                    f"tier_quarantined:{e.payload.get('tier')}",
                    "quarantine",
                    "transfers",
                    e.ts,
                    e.seq,
                    {
                        "tier": e.payload.get("tier"),
                        "trigger": e.payload.get("trigger"),
                        "consecutive_failures": e.payload.get("consecutive_failures"),
                    },
                )
            )
        elif e.name == "transfer_retry_scheduled":
            out.append(
                Instant(
                    "transfer_retry",
                    "transfer",
                    "transfers",
                    e.ts,
                    e.seq,
                    {
                        "block_id": e.payload.get("block_id"),
                        "direction": e.payload.get("direction"),
                        "attempt": e.payload.get("attempt"),
                        "delay_s": e.payload.get("delay_s"),
                    },
                )
            )
        elif e.name == "step_scheduled":
            out.append(
                Instant(
                    "step_scheduled",
                    "scheduler",
                    "scheduler",
                    e.ts,
                    e.seq,
                    {
                        "step": e.payload.get("step"),
                        "step_tokens": e.payload.get("step_tokens"),
                        "n_decode": e.payload.get("n_decode"),
                        "n_feed": e.payload.get("n_feed"),
                        "prefill_tokens": e.payload.get("prefill_tokens"),
                        "budget": e.payload.get("budget"),
                    },
                )
            )
        elif e.name == "batch_scheduled":
            out.append(
                Instant(
                    "batch_scheduled",
                    "scheduler",
                    "scheduler",
                    e.ts,
                    e.seq,
                    {
                        "batch_size": e.payload.get("batch_size"),
                        "request_ids": e.payload.get("request_ids"),
                    },
                )
            )
    return out


def to_perfetto(log: EventLog, process_name: str = "repro-serving") -> Dict[str, Any]:
    """Chrome trace-event JSON (object form) for one engine's event log."""
    spans = build_spans(log)
    instants = build_instants(log)
    if not spans and not instants:
        t_base = 0.0
    else:
        t_base = min(
            [s.start_ts for s in spans] + [i.ts for i in instants]
        )

    pid = 1
    tids: Dict[str, int] = {"stages": 1, "transfers": 2}

    def tid_of(track: str) -> int:
        if track not in tids:
            tids[track] = len(tids) + 1
        return tids[track]

    def us(t: float) -> float:
        return round((t - t_base) * 1e6, 3)

    events: List[Dict[str, Any]] = []
    for s in spans:
        events.append(
            {
                "ph": "X",
                "pid": pid,
                "tid": tid_of(s.track),
                "ts": us(s.start_ts),
                "dur": max(round(s.duration_s * 1e6, 3), 0.001),
                "name": s.name,
                "cat": s.cat,
                "args": {k: v for k, v in s.args.items() if v is not None},
            }
        )
    for i in instants:
        events.append(
            {
                "ph": "i",
                "pid": pid,
                "tid": tid_of(i.track),
                "ts": us(i.ts),
                "s": "t",  # thread-scoped instant
                "name": i.name,
                "cat": i.cat,
                "args": {k: v for k, v in i.args.items() if v is not None},
            }
        )
    meta: List[Dict[str, Any]] = [
        {
            "ph": "M",
            "pid": pid,
            "tid": 0,
            "name": "process_name",
            "args": {"name": process_name},
        }
    ]
    for track, tid in sorted(tids.items(), key=lambda kv: kv[1]):
        meta.append(
            {
                "ph": "M",
                "pid": pid,
                "tid": tid,
                "name": "thread_name",
                "args": {"name": track},
            }
        )
    return {"traceEvents": meta + events, "displayTimeUnit": "ms"}


def write_perfetto(log: EventLog, path) -> Dict[str, Any]:
    trace = to_perfetto(log)
    with open(path, "w") as f:
        json.dump(trace, f, indent=1)
    return trace


def validate_perfetto(trace: Dict[str, Any]) -> List[str]:
    """Structural validation of a trace-event JSON object; returns a list of
    problems (empty = valid).  Checks the subset Perfetto requires to load:
    the ``traceEvents`` array, per-event ``ph``/``pid``/``tid``/``name``,
    numeric non-negative ``ts``, and non-negative ``dur`` on "X" events."""
    problems: List[str] = []
    evs = trace.get("traceEvents")
    if not isinstance(evs, list) or not evs:
        return ["traceEvents missing or empty"]
    for i, e in enumerate(evs):
        if not isinstance(e, dict):
            problems.append(f"event {i} not an object")
            continue
        ph = e.get("ph")
        if ph not in ("X", "i", "M", "B", "E"):
            problems.append(f"event {i}: unsupported ph {ph!r}")
        if not isinstance(e.get("name"), str) or not e["name"]:
            problems.append(f"event {i}: missing name")
        if not isinstance(e.get("pid"), int) or not isinstance(e.get("tid"), int):
            problems.append(f"event {i}: pid/tid not ints")
        if ph in ("X", "i"):
            ts = e.get("ts")
            if not isinstance(ts, (int, float)) or ts < 0:
                problems.append(f"event {i}: bad ts {ts!r}")
        if ph == "X":
            dur = e.get("dur")
            if not isinstance(dur, (int, float)) or dur < 0:
                problems.append(f"event {i}: bad dur {dur!r}")
    try:
        json.dumps(trace)
    except (TypeError, ValueError) as exc:  # lint: allow[fail-closed-except] structural validator: the problem string IS the fail-closed outcome its caller gates on
        problems.append(f"not JSON-serializable: {exc}")
    return problems

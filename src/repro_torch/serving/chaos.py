"""Deterministic chaos/fault-injection subsystem for the serving stack.

The paper's conformance claim is adversarial by nature: a lowering is only
fail-closed if EVERY runtime failure surfaces as an ordered, claim-scoped
outcome.  ``offload.FailureInjectionConfig`` can stage one hand-picked
failure; this module supplies the systematic counterpart — a seeded,
reproducible ``FaultPlan`` consulted at every spill/store/restore/promotion
boundary, injecting:

  - ``transient_io``   — a tier I/O error that clears after k repeats
                         (recovered by the transfer queue's bounded
                         retry/backoff, never a claim outcome);
  - ``permanent_io``   — a tier I/O error that does not clear (escalates
                         into the ordered lifecycle as a claim-scoped
                         refusal with trigger attribution);
  - ``corruption``     — payload bytes flipped at rest AFTER the per-block
                         checksum was written at spill; detected by
                         checksum verification at restore, surfacing as a
                         claim-scoped refusal (never bad logits);
  - ``worker_death``   — the transfer worker thread dies mid-job; the job
                         is poisoned, queued jobs drain with errors, the
                         waiter unblocks, and the failure becomes a
                         claim-scoped refusal (satellite: no stranded
                         ``TransferJob.wait()``);
  - ``capacity_pressure`` — admission-time pool pressure, refused with
                         attribution before any allocation.

Determinism contract: faults come either from an explicit ``schedule`` of
``FaultSpec``s (consumed at the first matching boundary crossing — exact
expected-outcome accounting for campaigns) or from seeded background
``rates`` drawn STATELESSLY per (seed, site) via sha256, so one request's
faults never perturb a bucket-mate's draw stream (zero cross-claim blast
radius is testable byte-for-byte).

The module is a leaf: no serving imports, so every layer (tiers, queue,
connector, engines) can depend on it without cycles.
"""
from __future__ import annotations

import hashlib
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Set, Tuple

import torch

# --- trigger vocabulary (the fail_closed_total{trigger=...} label set) --------
TRIGGER_TRANSIENT = "transient_io"
TRIGGER_TRANSIENT_EXHAUSTED = "transient_exhausted"
TRIGGER_PERMANENT = "permanent_io"
TRIGGER_CORRUPTION = "corruption"
TRIGGER_WORKER_DEATH = "worker_death"
TRIGGER_CAPACITY = "capacity_pressure"
TRIGGER_QUARANTINE = "tier_quarantined"
TRIGGER_INJECTED = "injected_load_failure"  # legacy FailureInjectionConfig

FAULT_TRIGGERS = (
    TRIGGER_TRANSIENT,
    TRIGGER_PERMANENT,
    TRIGGER_CORRUPTION,
    TRIGGER_WORKER_DEATH,
    TRIGGER_CAPACITY,
)


# --- fault exceptions ---------------------------------------------------------
class TransientTransferFault(RuntimeError):
    """A retryable tier I/O fault: the transfer queue backs off and re-runs
    the job fn (which resumes at the faulted block and redraws)."""

    def __init__(self, reason: str, block_id: Optional[int] = None, direction: str = ""):
        super().__init__(reason)
        self.reason = reason
        self.block_id = block_id
        self.direction = direction


class WorkerKilled(BaseException):
    """Raised ON the transfer worker thread: the worker poisons the current
    job, drains queued jobs with errors, and exits.  Derives from
    BaseException so job fns cannot accidentally swallow it."""

    def __init__(self, reason: str, block_id: Optional[int] = None, direction: str = ""):
        super().__init__(reason)
        self.reason = reason
        self.block_id = block_id
        self.direction = direction


class TransferWorkerDied(RuntimeError):
    """Surfaced to a joining engine thread whose job was poisoned (or
    drained unstarted) by a worker death.  The engine converts it into the
    ordered claim-scoped fail-closed outcome — never a crash."""

    def __init__(self, reason: str, block_id: Optional[int] = None, direction: str = ""):
        super().__init__(reason)
        self.reason = reason
        self.block_id = block_id
        self.direction = direction


# --- checksums (corruption detection) -----------------------------------------
def payload_checksum(k, v) -> str:
    """Content checksum over a block's k/v payload bytes, written at spill
    and verified at restore — corruption at rest surfaces as a fail-closed
    refusal, never as silently wrong logits.  Hashes the raw bytes of each
    tensor plus a stable dtype name and its shape."""
    h = hashlib.sha256()
    for a in (k, v):
        if a is None:
            h.update(b"\x00none")
            continue
        a = a.detach().contiguous().cpu()
        h.update(str(a.dtype).removeprefix("torch.").encode())
        h.update(str(tuple(a.shape)).encode())
        h.update(a.view(torch.uint8).numpy().tobytes())
    return h.hexdigest()[:32]


def corrupted_copy(a: torch.Tensor) -> torch.Tensor:
    """Return an owned copy of ``a`` with one byte flipped (never mutates
    the input — a page-store view must not contaminate other tenants)."""
    out = a.detach().contiguous().clone()
    buf = out.view(-1).view(torch.uint8)
    if buf.numel():
        buf[0] ^= 0xFF
    return out


# --- fault plan ---------------------------------------------------------------
@dataclass
class FaultSpec:
    """One planned fault, armed on a ``FaultPlan`` and consumed at the first
    matching boundary crossing.

    ``boundary``: an exact transfer direction (``"disk_to_device"``,
    ``"host_to_disk"``...), a tier name for corruption-at-rest specs, or
    None = any restore into the device pool (``*_to_device``).
    ``repeats``: for transient specs, how many consecutive attempts fail
    before the site recovers (the retry loop redraws per attempt).
    """

    trigger: str
    boundary: Optional[str] = None
    claim_id: Optional[str] = None
    repeats: int = 1
    consumed: bool = False


@dataclass
class FaultDecision:
    trigger: str
    reason: str
    transient: bool = False


@dataclass
class FaultStats:
    """Every injected failing decision, by trigger — the campaign's ground
    truth for 'counters exactly match the injected plan'."""

    injected: Dict[str, int] = field(default_factory=dict)
    records: List[Tuple[str, str, Optional[int]]] = field(default_factory=list)
    # optional chaos_faults_injected_total{trigger} mirror (a
    # metrics.CounterFamily bound by the engine owning this plan)
    _counter: object = field(default=None, repr=False, compare=False)

    @property
    def total(self) -> int:
        return sum(self.injected.values())

    def bind_metrics(self, counter) -> None:
        """Mirror every future record into a registry counter family."""
        self._counter = counter

    def record(self, trigger: str, site: str, block_id: Optional[int]) -> None:
        self.injected[trigger] = self.injected.get(trigger, 0) + 1
        self.records.append((trigger, site, block_id))
        if self._counter is not None:
            # lint: allow[metric-drift] family bound at runtime via bind_metrics(); registered as chaos_faults_injected_total in core_engine
            self._counter.increment(trigger)


class FaultPlan:
    """Seeded, reproducible fault source consulted at every tier boundary.

    Scheduled specs give campaigns exact accounting; background ``rates``
    (probability per trigger) are drawn statelessly per (seed, site, attempt)
    so the decision at one site is independent of every other draw —
    injecting a fault against one claim cannot shift a bucket-mate's faults.
    """

    def __init__(
        self,
        seed: int = 0,
        rates: Optional[Dict[str, float]] = None,
        max_transient_repeats: int = 2,
    ) -> None:
        self.seed = int(seed)
        self.rates = dict(rates or {})
        self.max_transient_repeats = max_transient_repeats
        self.stats = FaultStats()
        self._armed: List[FaultSpec] = []
        # (block_id, direction) -> remaining consecutive transient failures
        self._transient_pending: Dict[Tuple[Optional[int], str], int] = {}

    # -- arming ---------------------------------------------------------------
    def schedule(self, *specs: FaultSpec) -> "FaultPlan":
        self._armed.extend(specs)
        return self

    @property
    def armed_remaining(self) -> int:
        return sum(1 for s in self._armed if not s.consumed)

    # -- stateless background draws ------------------------------------------
    def _u(self, *key) -> float:
        # sha256, not crc32: crc's linearity makes adjacent seeds produce
        # near-identical draw streams (a one-byte seed change XORs every
        # site's value by the same constant)
        tag = ":".join(str(k) for k in (self.seed,) + key)
        h = hashlib.sha256(tag.encode()).digest()
        return int.from_bytes(h[:8], "big") / 2**64

    def _match(self, trigger_filter, boundary: str, claim_ids: Set[str]) -> Optional[FaultSpec]:
        for spec in self._armed:
            if spec.consumed or spec.trigger not in trigger_filter:
                continue
            if spec.boundary is not None:
                if spec.boundary != boundary:
                    continue
            elif not boundary.endswith("_to_device"):
                continue
            if spec.claim_id is not None and spec.claim_id not in claim_ids:
                continue
            spec.consumed = True
            return spec
        return None

    # -- boundary draws -------------------------------------------------------
    def draw_transfer(
        self, direction: str, claim_ids: Set[str], block_id: int, attempt: int = 1
    ) -> Optional[FaultDecision]:
        """Consulted once per block transfer attempt at every boundary."""
        key = (block_id, direction)
        if key in self._transient_pending:
            # a previously armed transient site: keep failing until it clears
            self._transient_pending[key] -= 1
            if self._transient_pending[key] <= 0:
                del self._transient_pending[key]
            self.stats.record(TRIGGER_TRANSIENT, direction, block_id)
            return FaultDecision(
                TRIGGER_TRANSIENT, f"chaos:{TRIGGER_TRANSIENT}@{direction}", transient=True
            )
        spec = self._match(
            (TRIGGER_TRANSIENT, TRIGGER_PERMANENT, TRIGGER_WORKER_DEATH),
            direction,
            claim_ids,
        )
        if spec is not None:
            if spec.trigger == TRIGGER_TRANSIENT:
                if spec.repeats > 1:
                    self._transient_pending[key] = spec.repeats - 1
                self.stats.record(TRIGGER_TRANSIENT, direction, block_id)
                return FaultDecision(
                    TRIGGER_TRANSIENT, f"chaos:{TRIGGER_TRANSIENT}@{direction}", transient=True
                )
            self.stats.record(spec.trigger, direction, block_id)
            return FaultDecision(spec.trigger, f"chaos:{spec.trigger}@{direction}")
        # stateless background rates (first-match in fixed trigger order)
        for trig in (TRIGGER_TRANSIENT, TRIGGER_PERMANENT, TRIGGER_WORKER_DEATH):
            p = self.rates.get(trig, 0.0)
            if p > 0.0 and self._u(trig, direction, block_id, attempt) < p:
                if trig == TRIGGER_TRANSIENT:
                    # bounded repeats so retry always recovers the site
                    reps = 1 + int(
                        self._u("reps", direction, block_id) * self.max_transient_repeats
                    )
                    if attempt <= reps:
                        self.stats.record(trig, direction, block_id)
                        return FaultDecision(
                            trig, f"chaos:{trig}@{direction}", transient=True
                        )
                    continue
                self.stats.record(trig, direction, block_id)
                return FaultDecision(trig, f"chaos:{trig}@{direction}")
        return None

    def draw_corruption(self, tier_name: str, claim_ids: Set[str], block_id: int) -> bool:
        """Consulted at tier put (data lands at rest): corrupt AFTER the
        checksum was computed, so restore-side verification catches it."""
        spec = None
        for s in self._armed:
            if s.consumed or s.trigger != TRIGGER_CORRUPTION:
                continue
            if s.boundary is not None and s.boundary != tier_name:
                continue
            if s.claim_id is not None and s.claim_id not in claim_ids:
                continue
            s.consumed = True
            spec = s
            break
        hit = spec is not None or (
            self.rates.get(TRIGGER_CORRUPTION, 0.0) > 0.0
            and self._u(TRIGGER_CORRUPTION, tier_name, block_id)
            < self.rates[TRIGGER_CORRUPTION]
        )
        if hit:
            self.stats.record(TRIGGER_CORRUPTION, tier_name, block_id)
        return hit

    def draw_capacity(self, request_id: str) -> bool:
        """Consulted at admission: injected pool/capacity pressure refuses
        the request fail-closed with attribution (no allocation happens)."""
        spec = None
        for s in self._armed:
            if not s.consumed and s.trigger == TRIGGER_CAPACITY:
                s.consumed = True
                spec = s
                break
        hit = spec is not None or (
            self.rates.get(TRIGGER_CAPACITY, 0.0) > 0.0
            and self._u(TRIGGER_CAPACITY, request_id) < self.rates[TRIGGER_CAPACITY]
        )
        if hit:
            self.stats.record(TRIGGER_CAPACITY, request_id, None)
        return hit


# Fail-closed outcomes are counted by the ``fail_closed_total{trigger}``
# CounterFamily in serving/metrics.py — one counting path.

# --- tier quarantine ----------------------------------------------------------
class TierHealth:
    """Per-tier degradation tracker: ``quarantine_after`` consecutive failing
    JOBS (not blocks — one multi-block job counts once) quarantine the tier.
    A quarantined tier is never touched again: restores from it refuse
    fail-closed with attribution, new offloads to it are refused, spills
    into it stay up-tier — the engine keeps serving device/host-resident
    chains instead of wedging."""

    def __init__(self, quarantine_after: Optional[int] = 3) -> None:
        self.quarantine_after = quarantine_after
        self._consecutive: Dict[str, int] = {}
        self.quarantined: Set[str] = set()

    def is_quarantined(self, tier_name: str) -> bool:
        return tier_name in self.quarantined

    def record_job_failure(self, tier_name: str) -> bool:
        """Record one failing job outcome; True iff this crossing newly
        quarantines the tier (the caller emits the boundary event)."""
        if tier_name in self.quarantined or self.quarantine_after is None:
            return False
        n = self._consecutive.get(tier_name, 0) + 1
        self._consecutive[tier_name] = n
        if n >= self.quarantine_after:
            self.quarantined.add(tier_name)
            return True
        return False

    def record_job_success(self, tier_name: str) -> None:
        self._consecutive[tier_name] = 0

    def consecutive_failures(self, tier_name: str) -> int:
        return self._consecutive.get(tier_name, 0)

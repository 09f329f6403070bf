"""ResidentClaim contract objects: identity, predicate, acceptance, registry.

A ResidentClaim is an *accepted future-reuse responsibility* over
(cache identity, reusable object, materialization predicate, footprint,
mode, ordered outcome) — not a knob name (paper §1, §3).  Acceptance is the
responsibility boundary: hints that were never accepted can never produce
claim outcomes, and acceptance itself fails closed (e.g. a leading-prefix
predicate deeper than a sliding-window cache is rejected at accept time).
"""
from __future__ import annotations

import itertools
import time
from dataclasses import dataclass, field
from enum import Enum
from typing import Dict, List, Optional


class ClaimMode(str, Enum):
    BEST_EFFORT = "best_effort"
    SOFT_PRIORITY = "soft_priority"
    HARD_PROTECTED = "hard_protected"
    DEMOTABLE = "demotable"
    EXPIRING = "expiring"
    OFFLOADABLE = "offloadable"
    ROUTED_REUSE = "routed_reuse"


class ClaimState(str, Enum):
    ACCEPTED = "accepted"
    MATERIALIZED = "materialized"
    OFFLOADED = "offloaded"
    RESTORE_REQUIRED = "restore_required"
    RESTORED = "restored"
    RESTORATION_FAILED = "restoration_failed"
    DEMOTED = "demoted"
    EXPIRED = "expired"
    HARMED = "harmed"
    RELEASED = "released"


# Legal ordered lifecycle transitions (the analyzer re-derives order from the
# event log; the registry enforces it at mutation time — fail closed).
_TRANSITIONS = {
    ClaimState.ACCEPTED: {ClaimState.MATERIALIZED, ClaimState.DEMOTED, ClaimState.EXPIRED, ClaimState.RELEASED, ClaimState.HARMED},
    ClaimState.MATERIALIZED: {ClaimState.OFFLOADED, ClaimState.DEMOTED, ClaimState.EXPIRED, ClaimState.HARMED, ClaimState.RELEASED},
    ClaimState.OFFLOADED: {ClaimState.RESTORE_REQUIRED, ClaimState.DEMOTED, ClaimState.EXPIRED, ClaimState.RELEASED},
    ClaimState.RESTORE_REQUIRED: {ClaimState.RESTORED, ClaimState.RESTORATION_FAILED},
    ClaimState.RESTORED: {ClaimState.OFFLOADED, ClaimState.MATERIALIZED, ClaimState.RELEASED, ClaimState.DEMOTED, ClaimState.EXPIRED},
    ClaimState.RESTORATION_FAILED: {ClaimState.RELEASED, ClaimState.HARMED},
    ClaimState.DEMOTED: {ClaimState.RELEASED},
    ClaimState.EXPIRED: {ClaimState.RELEASED},
    ClaimState.HARMED: {ClaimState.RELEASED},
    ClaimState.RELEASED: set(),
}


@dataclass(frozen=True)
class CacheIdentity:
    """Join scope for claim evidence (paper Table 5: fixed cache identity)."""

    model: str
    tokenizer_hash: str
    runtime: str = "repro-torch"
    namespace: str = "default"
    block_size: int = 16

    def compatible(self, other: "CacheIdentity") -> bool:
        return self == other


@dataclass(frozen=True)
class MaterializationPredicate:
    """Named predicate over the reusable object's useful state."""

    kind: str  # "leading_prefix_at_least" | "state_at_token"
    k: int

    def evaluate(self, materialized_tokens: int) -> bool:
        return materialized_tokens >= self.k

    @property
    def name(self) -> str:
        return f"{self.kind}({self.k})"


@dataclass
class ResidentClaim:
    claim_id: str
    object_id: str  # reusable cache object (prefix hash / state snapshot id)
    predicate: MaterializationPredicate
    mode: ClaimMode
    cache_identity: CacheIdentity
    priority: int = 0
    duration_s: Optional[float] = None  # expiring mode
    footprint_bytes: int = 0
    state: ClaimState = ClaimState.ACCEPTED
    accepted_at: float = 0.0
    history: List[ClaimState] = field(default_factory=list)

    def transition(self, new: ClaimState) -> None:
        if new not in _TRANSITIONS[self.state]:
            raise InvalidClaimTransition(
                f"claim {self.claim_id}: illegal transition {self.state.value} -> {new.value}"
            )
        self.history.append(self.state)
        self.state = new


class InvalidClaimTransition(RuntimeError):
    pass


class ClaimRejected(RuntimeError):
    pass


class ClaimRegistry:
    """Accepted-claim state: the acceptance boundary of the runtime.

    Registration is *pre-registration* in the paper's telemetry-join sense:
    claims exist (with stable ids distinct from request ids) before the
    lifecycle events that will be attributed to them.
    """

    def __init__(self, event_log, cache_identity: CacheIdentity, clock=time.monotonic):
        self._claims: Dict[str, ResidentClaim] = {}
        self._by_object: Dict[str, List[str]] = {}
        self._events = event_log
        self._identity = cache_identity
        self._clock = clock
        self._ids = itertools.count()

    # -- acceptance ---------------------------------------------------------
    def accept(
        self,
        object_id: str,
        predicate: MaterializationPredicate,
        mode: ClaimMode,
        *,
        priority: int = 0,
        duration_s: Optional[float] = None,
        footprint_bytes: int = 0,
        max_prefix_window: Optional[int] = None,
    ) -> ResidentClaim:
        """Accept (or fail-closed reject) a future-reuse responsibility."""
        claim_id = f"claim-{next(self._ids):04d}"
        if mode == ClaimMode.EXPIRING and duration_s is None:
            self._reject(claim_id, object_id, "expiring claim without duration")
        if predicate.k <= 0:
            self._reject(claim_id, object_id, "non-positive predicate depth")
        if (
            max_prefix_window is not None
            and predicate.kind == "leading_prefix_at_least"
            and predicate.k > max_prefix_window
        ):
            # sliding-window cache cannot hold a deeper leading prefix:
            # accepting would create an unsatisfiable responsibility.
            self._reject(
                claim_id,
                object_id,
                f"predicate depth {predicate.k} exceeds attention window {max_prefix_window}",
            )
        claim = ResidentClaim(
            claim_id=claim_id,
            object_id=object_id,
            predicate=predicate,
            mode=mode,
            cache_identity=self._identity,
            priority=priority,
            duration_s=duration_s,
            footprint_bytes=footprint_bytes,
            accepted_at=self._clock(),
        )
        self._claims[claim_id] = claim
        self._by_object.setdefault(object_id, []).append(claim_id)
        self._events.emit(
            "resident_claim_accepted",
            claim_id=claim_id,
            object_id=object_id,
            predicate=predicate.name,
            mode=mode.value,
            priority=priority,
            duration_s=duration_s,
        )
        return claim

    def _reject(self, claim_id: str, object_id: str, reason: str) -> None:
        self._events.emit(
            "resident_claim_rejected", claim_id=claim_id, object_id=object_id, reason=reason
        )
        raise ClaimRejected(reason)

    # -- lookup ---------------------------------------------------------------
    def get(self, claim_id: str) -> ResidentClaim:
        return self._claims[claim_id]

    def maybe_get(self, claim_id: Optional[str]) -> Optional[ResidentClaim]:
        return self._claims.get(claim_id) if claim_id else None

    def claims_for_object(self, object_id: str) -> List[ResidentClaim]:
        return [self._claims[c] for c in self._by_object.get(object_id, ())]

    def all_claims(self) -> List[ResidentClaim]:
        return list(self._claims.values())

    def active_claims(self) -> List[ResidentClaim]:
        terminal = {ClaimState.RELEASED, ClaimState.EXPIRED, ClaimState.DEMOTED, ClaimState.HARMED}
        return [c for c in self._claims.values() if c.state not in terminal]

    # -- lifecycle helpers (ordered: transition first, then the event) --------
    def mark(self, claim: ResidentClaim, new_state: ClaimState, event: str, **payload) -> None:
        claim.transition(new_state)
        # lint: allow[emit-site] state-transition helper: event name varies with the target ClaimState; runtime PAYLOAD_SCHEMA validation still applies
        self._events.emit(event, claim_id=claim.claim_id, object_id=claim.object_id, **payload)

    # -- expiry ----------------------------------------------------------------
    def expire_due(self, now: Optional[float] = None) -> List[ResidentClaim]:
        """Emit the claim-scoped expiry boundary for claims past duration.

        The ordered boundary where responsibility ends BEFORE any later loss
        (paper: claim_expired_boundary).
        """
        now = self._clock() if now is None else now
        expired = []
        for c in self.active_claims():
            if c.mode == ClaimMode.EXPIRING and c.duration_s is not None:
                if now - c.accepted_at >= c.duration_s:
                    self.mark(
                        c,
                        ClaimState.EXPIRED,
                        "resident_claim_expired",
                        boundary="duration_elapsed",
                        age_s=now - c.accepted_at,
                    )
                    expired.append(c)
        return expired

"""Claim-attributed KV-aware router (the routed_reuse obligation bundle).

Dynamo-style KV-aware routing scores worker overlap; the paper's boundary is
that routing alone lacks *claim-scoped* route cost, placement attribution and
later reuse attribution.  This router supplies exactly those: every route
decision, placement and later reuse hit/miss is attributed to the accepted
claim id and its materialization predicate in the ordered event log.

In the port each replica is an engine with its own pool on its own explicit
device (replicas may share a card or sit on different ones, as the JAX
package's router accepts any replicas); the router itself is host-side
bookkeeping over their pools and never moves a tensor between them.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

from repro_torch.core.claims import ClaimMode, MaterializationPredicate, ResidentClaim
from repro_torch.core.events import EventLog
from repro_torch.serving.engine import Request, ServingEngine


@dataclass
class RouteRecord:
    request_id: str
    worker: int
    claim_id: Optional[str]
    route_cost_tokens: int
    overlap_scores: Dict[int, int]


class KVAwareRouter:
    """Routes requests across engine replicas with claim attribution."""

    def __init__(self, engines: List[ServingEngine], event_log: Optional[EventLog] = None):
        self.engines = engines
        self.events = event_log or EventLog()
        self._claim_worker: Dict[str, int] = {}
        self._claim_prefix: Dict[str, Tuple[int, ...]] = {}
        self.records: List[RouteRecord] = []

    # -- claims -----------------------------------------------------------------
    def accept_claim(
        self, prefix_tokens: Sequence[int], *, priority: int = 0, worker: Optional[int] = None
    ) -> ResidentClaim:
        prefix = tuple(int(t) for t in prefix_tokens)
        w = worker if worker is not None else min(
            range(len(self.engines)), key=lambda i: self.engines[i].pool.used
        )
        claim = self.engines[w].accept_claim(prefix, ClaimMode.ROUTED_REUSE, priority=priority)
        self._claim_worker[claim.claim_id] = w
        self._claim_prefix[claim.claim_id] = prefix
        self.events.emit(
            "route_placement",
            claim_id=claim.claim_id,
            worker=w,
            predicate=claim.predicate.name,
            reason="claim_registration",
        )
        return claim

    # -- routing -----------------------------------------------------------------
    def _overlap(self, engine: ServingEngine, tokens: Tuple[int, ...]) -> int:
        """Reusable-token overlap on a worker, across ALL storage tiers
        (device pool first, then the host/disk hierarchy)."""
        dev = engine.pool.lookup_prefix(tokens, engine.block_size)
        off = (
            engine.connector.offloaded_lookup_prefix(tokens, engine.block_size)
            if not dev
            else []
        )
        return sum(len(b.tokens) for b in dev) + sum(len(b.tokens) for b in off)

    def _claim_for(self, tokens: Tuple[int, ...]) -> Optional[str]:
        for cid, prefix in self._claim_prefix.items():
            if tokens[: len(prefix)] == prefix:
                return cid
        return None

    def submit_and_run(self, tokens: Sequence[int], max_new_tokens: int = 2) -> Tuple[Request, RouteRecord]:
        toks = tuple(int(t) for t in tokens)
        claim_id = self._claim_for(toks)
        scores = {i: self._overlap(e, toks) for i, e in enumerate(self.engines)}
        worker = max(scores, key=lambda i: (scores[i], -i))
        route_cost = len(toks) - scores[worker]  # tokens that must be prefilled
        self.events.emit(
            "route_decision",
            claim_id=claim_id,
            worker=worker,
            route_cost_tokens=route_cost,
            overlap_scores={str(k): v for k, v in scores.items()},
        )
        self.events.emit(
            "route_placement", claim_id=claim_id, worker=worker, reason="kv_overlap"
        )
        eng = self.engines[worker]
        req = eng.submit(toks, max_new_tokens=max_new_tokens)
        eng.run(req)
        # later reuse success/failure attributed to the routed claim path
        self.events.emit(
            "route_reuse_attributed",
            claim_id=claim_id,
            request_id=req.request_id,
            worker=worker,
            reuse_hit_tokens=req.cached_tokens + req.restored_tokens,
            success=req.status == "finished",
        )
        rec = RouteRecord(req.request_id, worker, claim_id, route_cost, scores)
        self.records.append(rec)
        return req, rec

"""The claim lifecycle behind the serving engine, implemented once.

The ordered, claim-scoped fail-closed path —

  accept(C, P, predicate) -> materialized(C) -> offloaded(C) ->
  restore_required(C) -> same-claim load failure ->
  scheduler_resident_claim_restoration_failed(C) ->
  scheduler_active_request_refused(blocking_claim_ids=[C]) ->
  ... before terminal request-finished handling

— lives in ``EngineCore``: accept / materialize / offload / restore-or-
fail-closed, parameterized by a ``CacheObjectKind``
(serving/cache_object.py).  ``ServingEngine`` adds the KV-chain execution
plumbing on top.  The scheduler (admission, invalid-KV-load boundary,
pressure with ordered demotion-before-loss) also lives here.
"""
from __future__ import annotations

import itertools
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Set, Tuple

import numpy as np
import torch

from repro_torch.core.claims import (
    CacheIdentity,
    ClaimMode,
    ClaimRegistry,
    ClaimState,
    ResidentClaim,
)
from repro_torch.core.events import EventLog
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.serving.chaos import (
    FaultPlan,
    TRIGGER_INJECTED,
)
from repro_torch.serving.kv_cache import BlockPool, KVBlock, PoolExhausted
from repro_torch.serving.metrics import MetricsRegistry
from repro_torch.serving.offload import FailureInjectionConfig, OffloadingConnector
from repro_torch.serving.scheduler_loop import device_sync
from repro_torch.serving.tiers import DiskTier, HostTier
from repro_torch.serving.transfer_queue import RetryPolicy


@dataclass
class Request:
    request_id: str
    tokens: Tuple[int, ...]
    max_new_tokens: int = 4
    status: str = "pending"  # pending | running | finished | refused | error
    output_tokens: List[int] = field(default_factory=list)
    error: str = ""
    cached_tokens: int = 0
    restored_tokens: int = 0
    # monotonic wall-clock when the FIRST output token was appended (TTFT
    # measurement surface for the step scheduler and bench_scheduler)
    first_token_ts: Optional[float] = None


@dataclass
class SchedulerOutcome:
    """Claim-scoped outcome record attached to a terminal request state."""

    kind: str
    claim_ids: List[str] = field(default_factory=list)
    reason: str = ""


class Scheduler:
    """Claim-aware admission + invalid-KV-load outcome boundary."""

    def __init__(self, registry: ClaimRegistry, pool: BlockPool, events: EventLog):
        self.registry = registry
        self.pool = pool
        self._events = events

    def protected_claim_ids(self) -> Set[str]:
        return {
            c.claim_id
            for c in self.registry.active_claims()
            if c.mode == ClaimMode.HARD_PROTECTED
        }

    # -- explicit active/resident conflict action (hard_protected) -----------
    def admission_check(self, request: Request, needed_blocks: int) -> Optional[SchedulerOutcome]:
        free = self.pool.free_slots
        if free >= needed_blocks:
            return None
        protected = self.protected_claim_ids()
        evictable = len(self.pool.victim_candidates(protected))
        if free + evictable >= needed_blocks:
            return None
        blocking = sorted(
            {
                c
                for blk in self.pool.blocks.values()
                if blk.ref == 0
                for c in blk.claim_ids & protected
            }
        )
        self._events.emit(
            "scheduler_admission_refused",
            request_id=request.request_id,
            blocking_claim_ids=blocking,
            needed_blocks=needed_blocks,
            free_blocks=free,
            evictable_blocks=evictable,
            conflict_action="refuse",
            trigger="admission_conflict",
        )
        return SchedulerOutcome("admission_refused", blocking, "active/resident conflict")

    # -- the invalid-KV-load boundary (witness path B, E12/E13) ----------------
    def on_invalid_kv_load(
        self,
        request: Request,
        failed_claims: List[ResidentClaim],
        reason: str,
        trigger: Optional[str] = None,
    ) -> SchedulerOutcome:
        blocking = []
        for claim in failed_claims:
            claim.transition(ClaimState.RESTORATION_FAILED)
            self._events.emit(
                "scheduler_resident_claim_restoration_failed",
                request_id=request.request_id,
                claim_id=claim.claim_id,
                object_id=claim.object_id,
                reason=reason,
                trigger=trigger,
                request_status="FINISHED_ERROR",
            )
            blocking.append(claim.claim_id)
        self._events.emit(
            "scheduler_active_request_refused",
            request_id=request.request_id,
            blocking_claim_ids=blocking,
            reason=reason,
            trigger=trigger,
        )
        return SchedulerOutcome("active_request_refused", blocking, reason)

    # -- pressure with ordered demotion-before-loss ------------------------------
    def apply_pressure(self, n_blocks: int) -> List[KVBlock]:
        protected = self.protected_claim_ids()
        victims = self.pool.victim_candidates(protected)[:n_blocks]
        if len(victims) < n_blocks:
            blocking = sorted(
                {
                    c
                    for blk in self.pool.blocks.values()
                    if blk.ref == 0
                    for c in blk.claim_ids & protected
                }
            )
            raise PoolExhausted(f"pressure needs {n_blocks} blocks", blocking)
        # ordered: demote demotable claims BEFORE their blocks are lost
        demoted: Set[str] = set()
        for blk in victims:
            for cid in sorted(blk.claim_ids):
                claim = self.registry.maybe_get(cid)
                if claim and claim.mode == ClaimMode.DEMOTABLE and cid not in demoted:
                    if claim.state in (ClaimState.ACCEPTED, ClaimState.MATERIALIZED, ClaimState.RESTORED):
                        self.registry.mark(
                            claim,
                            ClaimState.DEMOTED,
                            "resident_claim_demoted",
                            before_loss=True,
                            trigger="pressure",
                        )
                        demoted.add(cid)
        out = []
        for blk in victims:
            self._events.emit(
                "pressure_eviction",
                block_id=blk.block_id,
                priority=blk.priority,
                claim_id=sorted(blk.claim_ids)[0] if blk.claim_ids else None,
            )
            out.append(self.pool.remove(blk.block_id, reason="pressure"))
        # harm attribution: predicate-breaking loss of still-responsible claims
        lost_claims: Set[str] = {c for blk in out for c in blk.claim_ids}
        for cid in sorted(lost_claims):
            claim = self.registry.maybe_get(cid)
            if claim and claim.state == ClaimState.MATERIALIZED:
                self.registry.mark(
                    claim,
                    ClaimState.HARMED,
                    "resident_claim_harmed",
                    predicate=claim.predicate.name,
                    cause="pressure_eviction",
                )
        return out

    def sweep_expiry(self, now: Optional[float] = None) -> List[ResidentClaim]:
        return self.registry.expire_due(now)


class EngineCore:
    """Shared engine substrate: registry, pools, tiers, connector, scheduler,
    and the claim lifecycle (implemented here and ONLY here).

    Subclasses supply ``kind`` (a CacheObjectKind) plus the model-execution
    plumbing, and implement ``_claim_device_blocks`` — "which device blocks
    embody this claim's object right now".

    ``device`` is where the model and the transfer kernels run: CUDA unless
    the caller passes ``device="cpu"`` (``repro_torch.device``).
    """

    kind = None  # set by subclass

    def __init__(
        self,
        bundle,
        params,
        *,
        block_size: int,
        device_blocks: int,
        cache_len: int = 128,
        event_log: Optional[EventLog] = None,
        injection: Optional[FailureInjectionConfig] = None,
        namespace: str = "default",
        host_blocks: Optional[int] = None,
        disk_dir=None,
        fault_plan: Optional[FaultPlan] = None,
        retry_policy: Optional[RetryPolicy] = None,
        quarantine_after: Optional[int] = 3,
        device: DeviceLike = None,
    ):
        self.device = resolve_device(device)
        self.bundle = bundle
        self.cfg = bundle.cfg
        self.params = params
        self.block_size = block_size
        self.cache_len = cache_len
        self.events = event_log or EventLog()
        self.identity = CacheIdentity(
            model=self.cfg.name,
            tokenizer_hash="synthetic-tokenizer-v1",
            namespace=namespace,
            block_size=block_size,
        )
        self.registry = ClaimRegistry(self.events, self.identity)
        self.pool = BlockPool(device_blocks, self.events, device=self.device)
        self.host = HostTier(host_blocks)
        self.disk = DiskTier(disk_dir)
        self.fault_plan = fault_plan
        # Engine-scoped metrics registry: one per engine (campaigns spin up
        # hundreds and must never share counter state).  Every family here
        # is reconcilable against the ordered event log —
        # core/analyzer.check_metrics_reconcile fails the suite on drift.
        self.metrics = MetricsRegistry()
        # fail_closed_total{trigger=...}: every fail-closed outcome of this
        # engine increments exactly one trigger label (ROADMAP item 5),
        # paired 1:1 with an ordered refusal event carrying the same trigger
        self.fail_closed = self.metrics.counter(
            "fail_closed_total",
            "Fail-closed outcomes by trigger (refusals, errored unclaimed loads)",
            labels=("trigger",),
        )
        self.stage_seconds = self.metrics.histogram(
            "stage_seconds",
            "Per-stage latency (prefill, prefill_chunk, decode_step, restore)",
            labels=("stage",),
        )
        self.claim_restores = self.metrics.counter(
            "claim_restores_total",
            "Claims restored into the device pool (one per resident_claim_restored event)",
        )
        if fault_plan is not None:
            fault_plan.stats.bind_metrics(
                self.metrics.counter(
                    "chaos_faults_injected_total",
                    "Injected failing fault decisions by trigger (chaos plan ground truth)",
                    labels=("trigger",),
                )
            )
        self.connector = OffloadingConnector(
            self.pool,
            self.host,
            self.events,
            injection,
            disk_pool=self.disk,
            fault_plan=fault_plan,
            retry_policy=retry_policy,
            quarantine_after=quarantine_after,
            metrics=self.metrics,
            device=self.device,
        )
        self.scheduler = Scheduler(self.registry, self.pool, self.events)
        self._req_ids = itertools.count()
        self.requests: Dict[str, Request] = {}
        self._claim_prefixes: Dict[str, Tuple[int, ...]] = {}
        # the dense-cache step pair (the JAX package's _jitted_steps; eager)
        self._step_prefill = lambda p, batch: bundle.prefill_fn(p, batch, cache_len)
        self._step_decode = bundle.decode_fn

    # ---------------------------------------------------------------- teardown
    def close(self) -> None:
        """Explicit engine teardown: stop the transfer worker and remove the
        disk tier's spill directory.  Idempotent; also usable as a context
        manager (``with ServingEngine(...) as eng: ...``)."""
        self.connector.queue.shutdown()
        self.disk.close()

    def __enter__(self) -> "EngineCore":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def fail_closed_total(self) -> Dict[str, int]:
        """Exported counter view: trigger label -> count.  Backed by the
        ``fail_closed_total{trigger}`` registry family — exactly what the
        Prometheus exposition reports."""
        return self.fail_closed.as_dict()

    def _observe_stage(self, stage: str, seconds: float) -> None:
        """One measured stage duration: histogram observation + its ordered
        witness event, emitted together so the per-stage histogram count
        always equals the per-stage event count (reconciliation rule).

        The event is engine-scoped (``request_id=None``): stage durations
        are wall-clock and batch-wide, so binding them to a request would
        break the byte-identity blast-radius comparisons that project
        per-request (name, payload) streams."""
        self.stage_seconds.observe(seconds, stage=stage)
        self.events.emit("stage_latency", stage=stage, seconds=seconds)

    # ------------------------------------------------------------------ claims
    def accept_claim(
        self,
        prefix_tokens: Sequence[int],
        mode: ClaimMode,
        *,
        predicate_k: Optional[int] = None,
        priority: int = 0,
        duration_s: Optional[float] = None,
    ) -> ResidentClaim:
        """Accept (or fail-closed reject) a claim over this engine's object kind."""
        prefix = tuple(int(t) for t in prefix_tokens)
        claim = self.registry.accept(
            self.kind.object_id(prefix, self.block_size),
            self.kind.predicate(prefix, self.block_size, predicate_k),
            mode,
            priority=priority,
            duration_s=duration_s,
            max_prefix_window=self.kind.window_limit(self.cfg),
        )
        self._claim_prefixes[claim.claim_id] = prefix
        return claim

    def _matching_claims(self, tokens: Tuple[int, ...]) -> List[ResidentClaim]:
        """Active claims whose prefix is a leading prefix of ``tokens``."""
        out = []
        for c in self.registry.active_claims():
            prefix = self._claim_prefixes.get(c.claim_id)
            if prefix is not None and tokens[: len(prefix)] == prefix:
                out.append(c)
        return out

    def _claims_on_chain(self, chains: Sequence[str]) -> List[ResidentClaim]:
        """Claims whose object chain terminates in one of these block chains."""
        chain_set = set(chains)
        return [
            c
            for c in self.registry.all_claims()
            if self.kind.object_id(self._claim_prefixes.get(c.claim_id, ()), self.block_size)
            in chain_set
        ]

    # ---------------------------------------------------------------- requests
    def _new_request(self, tokens: Sequence[int], max_new_tokens: int) -> Request:
        """Create + register a request and emit E0 with its claim metadata."""
        req = Request(
            request_id=f"req-{next(self._req_ids):04d}",
            tokens=tuple(int(t) for t in tokens),
            max_new_tokens=max_new_tokens,
        )
        self.requests[req.request_id] = req
        claims = sorted(c.claim_id for c in self._matching_claims(req.tokens))
        self.events.emit(
            "request_initialized",
            request_id=req.request_id,
            n_tokens=len(req.tokens),
            claim_metadata=claims,
        )
        return req

    # -------------------------------------------------------------- materialize
    def _materialize_claim(
        self,
        claim: ResidentClaim,
        *,
        materialized_tokens: int,
        n_blocks: int,
        footprint_bytes: int,
        request_id: Optional[str] = None,
    ) -> None:
        """Claim-scoped materialization at this kind's named observation point."""
        claim.footprint_bytes = footprint_bytes
        self.registry.mark(
            claim,
            ClaimState.MATERIALIZED,
            "claim_materialized",
            predicate=claim.predicate.name,
            observation_point=self.kind.observation_point,
            materialized_tokens=materialized_tokens,
            request_id=request_id,
        )
        self.events.emit(
            "claim_footprint_accounted",
            claim_id=claim.claim_id,
            footprint_bytes=claim.footprint_bytes,
            n_blocks=n_blocks,
        )

    # ---------------------------------------------------------------- offload
    def _claim_device_blocks(self, claim: ResidentClaim) -> Optional[List[KVBlock]]:
        """Device blocks embodying the claim's object, or None if incomplete."""
        raise NotImplementedError

    def offload_claim(
        self, claim_id: str, request_id: Optional[str] = None, tier: str = "host"
    ) -> bool:
        """Move a materialized claim's blocks device -> off-device tier
        (witness step 2).  ``tier`` may target "disk" directly."""
        claim = self.registry.get(claim_id)
        blocks = self._claim_device_blocks(claim)
        if not blocks:
            return False
        job = self.connector.store(
            blocks, claim_id=claim_id, request_id=request_id, tier=tier
        )
        if job.ok:
            self.registry.mark(
                claim,
                ClaimState.OFFLOADED,
                "resident_claim_offloaded",
                n_blocks=len(blocks),
                request_id=request_id,
                tier=tier,
            )
        else:
            # fail-closed store: the claim is NOT marked offloaded (its
            # device blocks that did move are simply absent down-tier) and
            # the outcome is counted with trigger attribution — e.g. a
            # quarantined target tier refuses new offload-dependent work.
            # The refusal event is the counter's ordered witness: without it
            # this increment would be unreconcilable against the log.
            trigger = job.failure_trigger or TRIGGER_INJECTED
            self.events.emit(
                "fail_closed_refused",
                request_id=request_id,
                claim_id=claim_id,
                scope="offload",
                trigger=trigger,
                reason=job.failure_reason,
            )
            self.fail_closed.increment(trigger)
        self.connector.complete_job(job)
        return job.ok

    # ----------------------------------------------- restore-before-reuse path
    def _restore_for_request(
        self,
        req: Request,
        hit_blocks: List[KVBlock],
        restore_claims: Optional[List[ResidentClaim]] = None,
    ) -> bool:
        """THE fail-closed restoration boundary (witness paths A and B).

        Marks restore_required, runs the load job, and on a same-claim
        failure drives the scheduler's invalid-KV-load outcome (E11 -> E12 ->
        E13 with blocking_claim_ids -> E14) strictly before terminal request
        handling.  An unclaimed failure errors the request WITHOUT claim
        outcomes (fail closed).  Returns True iff the restore succeeded;
        on False the request is already terminal.
        """
        if restore_claims is None:
            restore_claims = [
                c
                for c in self._claims_on_chain([b.chain for b in hit_blocks])
                if c.state == ClaimState.OFFLOADED
            ]
        for claim in restore_claims:
            self.registry.mark(
                claim,
                ClaimState.RESTORE_REQUIRED,
                "resident_claim_restore_required",
                request_id=req.request_id,
                predicate=claim.predicate.name,
            )
        t0 = time.monotonic()
        job = self.connector.load(
            hit_blocks,
            claim_id=restore_claims[0].claim_id if restore_claims else None,
            request_id=req.request_id,
            protected_claims=self.scheduler.protected_claim_ids(),
        )
        if not job.ok:
            # per-job attribution: the first failing block's (reason,
            # trigger) drives both the refusal reason and the counter label
            reason = job.failure_reason or self.connector.injection.failure_reason
            trigger = job.failure_trigger or TRIGGER_INJECTED
            if restore_claims:
                # scheduler invalid-KV-load boundary: claim-scoped,
                # fail-closed, ordered BEFORE terminal handling (path B)
                outcome = self.scheduler.on_invalid_kv_load(
                    req,
                    [c for c in restore_claims if c.state == ClaimState.RESTORE_REQUIRED],
                    reason=reason,
                    trigger=trigger,
                )
                req.status = "refused"
                req.error = outcome.reason
                self.fail_closed.increment(trigger)
            else:
                # unclaimed generic failure: NOT a claim outcome (fail closed);
                # the request errors without claim-scoped scheduler events.
                # The generic refusal event keeps the counter reconcilable
                # without adding any claim-scoped evidence.
                req.status = "error"
                req.error = "unclaimed_load_failure"
                self.events.emit(
                    "fail_closed_refused",
                    request_id=req.request_id,
                    scope="unclaimed_load",
                    trigger="unclaimed_load_failure",
                    reason=reason,
                )
                self.fail_closed.increment("unclaimed_load_failure")
            self.events.emit(
                "offload_request_finished_pending_jobs",
                request_id=req.request_id,
                job_id=job.job_id,
            )
            self.events.emit(
                "request_finished", request_id=req.request_id, status="FINISHED_ERROR"
            )
            return False
        self._observe_stage("restore", time.monotonic() - t0)
        for claim in restore_claims:
            self.registry.mark(
                claim,
                ClaimState.RESTORED,
                "resident_claim_restored",
                request_id=req.request_id,
            )
        self.claim_restores.inc(n=len(restore_claims))
        req.restored_tokens = sum(len(b.tokens) for b in hit_blocks)
        self.connector.complete_job(job)
        return True

    def _fail_closed_error(
        self, req: Request, *, scope: str, trigger: str, reason: str
    ) -> None:
        """Convert a launch/store failure into the ordered fail-closed
        terminal outcome for ONE request: witness refusal with trigger
        attribution -> E14 -> request_finished FINISHED_ERROR.  This is the
        step-loop/decode hardening boundary shared by every engine kind —
        an execution exception never strands a request in a non-terminal
        status (and never escapes run_batch/serve_batch)."""
        req.status = "error"
        req.error = f"{trigger}: {reason}"
        self.events.emit(
            "fail_closed_refused",
            request_id=req.request_id,
            scope=scope,
            trigger=trigger,
            reason=reason,
        )
        self.fail_closed.increment(trigger)
        self.events.emit(
            "offload_request_finished_pending_jobs", request_id=req.request_id
        )
        self.events.emit(
            "request_finished", request_id=req.request_id, status="FINISHED_ERROR"
        )

    # ------------------------------------------------------------ shared decode
    def _greedy_decode_loop(self, reqs, state, logits, pos, step):
        """Ragged batched greedy decode: ONE step per token position for the
        whole batch.

        ``step(state, tokens [B], pos [B]) -> (logits [B, V], state)`` is the
        kind-specific transition (the dense-cache step here).  Finished rows
        re-feed their last token at a frozen position — a no-op replay that
        keeps the batch dense.  Each step's launch-to-result time is one
        ``decode_step`` stage observation.
        """
        B = int(logits.shape[0])
        pos = np.array(pos, np.int32)
        max_steps = max(r.max_new_tokens for r in reqs)
        last_tok = np.zeros(B, np.int32)
        dev = self.device
        for s in range(max_steps):
            toks = torch.argmax(logits, dim=-1).to(torch.int32).cpu().numpy().copy()
            for i, r in enumerate(reqs):
                if s < r.max_new_tokens:
                    r.output_tokens.append(int(toks[i]))
                    if r.first_token_ts is None:
                        r.first_token_ts = time.monotonic()
                    last_tok[i] = toks[i]
                else:
                    toks[i] = last_tok[i]
            t0 = time.monotonic()
            logits, state = step(
                state, torch.from_numpy(toks).to(dev), torch.from_numpy(pos.copy()).to(dev)
            )
            device_sync(dev)
            self._observe_stage("decode_step", time.monotonic() - t0)
            for i, r in enumerate(reqs):
                if s + 1 < r.max_new_tokens:
                    pos[i] += 1
        return state

    # ---------------------------------------------------------------- terminal
    def _release_claim_blocks(self, claims) -> None:
        """Claim-scoped release of pool residency after expiry.

        A shared page carries the union of its sharers' claim ids; the end
        of ONE claim's lifetime (TTL expiry, `claim_expired_boundary`) only
        removes THAT claim's membership and priority boost — it never
        invalidates the bytes a live sharer's accepted obligation still
        covers.  The block itself stays resident and becomes an ordinary
        eviction candidate once the last protecting claim is gone."""
        gone = {c.claim_id for c in claims}
        if not gone:
            return
        for blk in self.pool.blocks.values():
            if not (blk.claim_ids & gone):
                continue
            blk.claim_ids -= gone
            blk.priority = max(
                (
                    self.registry.maybe_get(c).priority
                    for c in blk.claim_ids
                    if self.registry.maybe_get(c) is not None
                ),
                default=0,
            )

    def _finish_ok(self, req: Request) -> Request:
        req.status = "finished"
        self.events.emit(
            "offload_request_finished_no_pending_jobs", request_id=req.request_id
        )
        self.events.emit("request_finished", request_id=req.request_id, status="FINISHED_OK")
        return req

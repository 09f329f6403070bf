"""Tiered transfer backend: store/load jobs, async worker, fault handling.

Mirrors the shape of vLLM's OffloadingConnector (store/load job creation,
worker transfer submission/completion, failed-load propagation) as described
in the paper §7, extended from the original device↔host pair to a tier
hierarchy (device / host DRAM / disk — see serving/tiers.py):

  - stores target a named tier ("host" by default, "disk" to spill deep);
  - a capacity-bounded host tier spills its oldest blocks down to disk
    (``offload_tier_spill``) instead of dropping them — offloaded claim
    bytes are never silently lost to tier pressure (fail-closed);
  - loads restore from whichever tier holds the chain; a disk hit promotes
    straight to the device pool (``offload_tier_promote``);
  - every job's payload movement is batched through ONE ``kv_block_copy``
    kernel gather per payload side (k, v) on the engine's device, run on the
    async transfer queue (serving/transfer_queue.py) instead of per-block
    copies.

Fault semantics (chaos.py; the legacy one-shot FailureInjectionConfig is
kept and classified as ``injected_load_failure``):

  - **transient_io**: the per-block attempt raises
    ``TransientTransferFault``; the transfer queue backs off and re-runs
    the (resumable) job fn, which redraws at the faulted block.  After
    ``retry_policy.max_attempts`` attempts the block escalates to a
    permanent failure with trigger ``transient_exhausted``.
  - **permanent_io / corruption / injected**: the block fails once and for
    good — E4(ok=False) + E11 for loads, and the JOB carries the first
    failure's (reason, trigger) so the engine's invalid-KV-load boundary
    can attribute the claim-scoped refusal exactly.
  - **worker_death**: raised THROUGH the job fn; the queue poisons the job
    and the engine-side join converts ``TransferWorkerDied`` into the same
    ordered fail-closed path (E4 fail + E11 emitted at the join, still
    strictly before any lifecycle event).
  - **checksum verification**: every restored payload is verified against
    the checksum written at first spill (tiers.py); a mismatch is a
    ``corruption`` failure — the bytes never reach the device pool.
  - **quarantine** (``TierHealth``): ``quarantine_after`` consecutive
    failing jobs against one tier mark it degraded (``tier_quarantined``
    boundary event).  From then on the tier is never touched: restores
    from it fail immediately with trigger ``tier_quarantined`` (claim-
    scoped refusal upstream), stores targeting it are refused, and spills
    into it keep the blocks up-tier (fail-closed, not lost).
"""
from __future__ import annotations

import itertools
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Set, Tuple

import torch

from repro_torch.serving.chaos import (
    FaultPlan,
    TierHealth,
    TransientTransferFault,
    WorkerKilled,
    payload_checksum,
    TRIGGER_CORRUPTION,
    TRIGGER_INJECTED,
    TRIGGER_QUARANTINE,
    TRIGGER_TRANSIENT_EXHAUSTED,
    TRIGGER_WORKER_DEATH,
)
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.kernels.kv_block_copy import gather_payloads
from repro_torch.serving.kv_cache import BlockPool, KVBlock, chain_hash
from repro_torch.serving.metrics import MetricsRegistry
from repro_torch.serving.tiers import DiskTier, HostTier, TieredStore
from repro_torch.serving.transfer_queue import (
    DEFAULT_RETRY_POLICY,
    RetryPolicy,
    TransferJob,
    TransferQueue,
    TransferWorkerDied,
)


@dataclass
class FailureInjectionConfig:
    resident_claim_load_failure: bool = False  # master flag (claim-scoped)
    fail_claim_id: Optional[str] = None  # filter: only this claim fails
    unclaimed_generic_failure: bool = False  # separate flag for unclaimed loads
    fail_tier_boundary: Optional[str] = None  # pin to one boundary, e.g. "disk_to_device"
    failure_reason: str = "F0:injected_cpu_to_gpu_load_failure"

    def should_fail(self, direction: str, claim_ids: Set[str]) -> bool:
        if self.fail_tier_boundary is not None:
            if direction != self.fail_tier_boundary:
                return False
        elif not direction.endswith("_to_device"):
            # default hook: restores into the device pool, any source tier
            return False
        if claim_ids:
            if not self.resident_claim_load_failure:
                return False
            if self.fail_claim_id is not None:
                return self.fail_claim_id in claim_ids
            return True
        return self.unclaimed_generic_failure


@dataclass
class TransferResult:
    ok: bool
    reason: str = ""
    trigger: Optional[str] = None
    transient: bool = False


@dataclass
class OffloadJob:
    job_id: int
    kind: str  # "store" | "load"
    block_ids: List[int]
    claim_id: Optional[str]
    request_id: Optional[str]
    done: bool = False
    ok: bool = True
    tier: str = "host"
    # first per-block failure wins: the engine attributes the claim-scoped
    # outcome (refusal reason + fail_closed_total trigger) from these
    failure_reason: str = ""
    failure_trigger: Optional[str] = None
    retries: int = 0


class OffloadingConnector:
    """Tiered block mover with ordered lifecycle events and batched transfers."""

    def __init__(
        self,
        device_pool: BlockPool,
        host_pool: Optional[HostTier] = None,
        event_log=None,
        injection: Optional[FailureInjectionConfig] = None,
        *,
        disk_pool: Optional[DiskTier] = None,
        queue: Optional[TransferQueue] = None,
        fault_plan: Optional[FaultPlan] = None,
        retry_policy: Optional[RetryPolicy] = None,
        quarantine_after: Optional[int] = 3,
        metrics: Optional[MetricsRegistry] = None,
        device: DeviceLike = None,
    ):
        from repro_torch.core.events import EventLog

        # the device whose kv_block_copy kernel moves job payloads
        self.copy_device = resolve_device(device)
        self.device = device_pool
        self.host = host_pool if host_pool is not None else HostTier()
        self.disk = disk_pool if disk_pool is not None else DiskTier()
        self.tiers = TieredStore(self.host, self.disk)
        self._events = event_log if event_log is not None else EventLog()
        self.injection = injection or FailureInjectionConfig()
        self.metrics = metrics if metrics is not None else MetricsRegistry()
        self.queue = queue or TransferQueue(metrics=self.metrics)
        self.plan = fault_plan
        for tier in self.tiers.tiers:
            tier.fault_plan = fault_plan  # corruption draws at tier put
        self.retry_policy = retry_policy or DEFAULT_RETRY_POLICY
        self.health = TierHealth(quarantine_after)
        self.retry_histogram: Dict[int, int] = {}  # attempt# -> count
        self._job_ids = itertools.count()
        self.jobs: Dict[int, OffloadJob] = {}
        # -- telemetry (reconciled against the event log by
        #    analyzer.check_metrics_reconcile) --------------------------------
        # transfer_block_seconds observes exactly the E3->E4 pairs: the LAST
        # E3 for a (block, direction) opens the measurement, the E4 that
        # follows closes it.  A refusal that never submits (quarantined
        # tier: E4 with no E3) is deliberately not an observation.
        self._pending_submit: Dict[Tuple[Optional[int], str], float] = {}
        self._m_transfer = self.metrics.histogram(
            "transfer_block_seconds",
            "Per-block transfer latency, E3 submission to E4 finish",
            labels=("direction", "ok"),
        )
        self._m_retries = self.metrics.counter(
            "transfer_retries_total",
            "Transient per-block retries scheduled (one per transfer_retry_scheduled event)",
            labels=("direction",),
        )
        self._m_tier_blocks = self.metrics.gauge(
            "tier_blocks", "Blocks resident per storage tier", labels=("tier",)
        )
        self._m_tier_bytes = self.metrics.gauge(
            "tier_bytes", "Payload bytes resident per storage tier", labels=("tier",)
        )
        self._m_tier_quarantined = self.metrics.gauge(
            "tier_quarantined", "1 if the tier is quarantined, else 0", labels=("tier",)
        )
        self._update_tier_gauges()

    # -- lookup ------------------------------------------------------------------
    def lookup(
        self,
        tokens: Sequence[int],
        block_size: int,
        request_id: str,
        *,
        skip_blocks: int = 0,
        start_chain: str = "",
    ) -> List[KVBlock]:
        """Off-device prefix lookup across all tiers; emits offload_lookup_result (E1).

        ``skip_blocks``/``start_chain`` let the walk continue past a
        device-resident leading prefix.
        """
        hit: List[KVBlock] = []
        tier_hits: Dict[str, int] = {}
        h = start_chain
        nb = len(tokens) // block_size
        for i in range(skip_blocks, nb):
            h = chain_hash(h, tokens[i * block_size : (i + 1) * block_size])
            blk = self.tiers.find_chain(h)
            if blk is None:
                break
            hit.append(blk)
            tier_hits[blk.location] = tier_hits.get(blk.location, 0) + 1
        self._events.emit(
            "offload_lookup_result",
            request_id=request_id,
            hit_tokens=sum(len(b.tokens) for b in hit) + skip_blocks * block_size,
            hit_blocks=len(hit),
            tier_hits=tier_hits,
        )
        return hit

    def lookup_chain(self, chain: str, request_id: str, n_tokens: int) -> Optional[KVBlock]:
        """Exact-chain lookup (state-snapshot objects); emits E1."""
        blk = self.tiers.find_chain(chain)
        self._events.emit(
            "offload_lookup_result",
            request_id=request_id,
            hit_tokens=n_tokens if blk is not None else 0,
            hit_blocks=1 if blk is not None else 0,
            tier_hits={blk.location: 1} if blk is not None else {},
        )
        return blk

    def offloaded_lookup_prefix(self, tokens: Sequence[int], block_size: int) -> List[KVBlock]:
        """Event-free prefix walk over off-device tiers (router overlap scoring)."""
        out: List[KVBlock] = []
        h = ""
        for i in range(0, len(tokens) - len(tokens) % block_size, block_size):
            h = chain_hash(h, tokens[i * block_size : (i + 1) * block_size])
            blk = self.tiers.find_chain(h)
            if blk is None:
                break
            out.append(blk)
        return out

    # -- store (device -> host|disk): offload -----------------------------------
    def store(
        self,
        blocks: List[KVBlock],
        *,
        claim_id: Optional[str],
        request_id: Optional[str],
        tier: str = "host",
    ) -> OffloadJob:
        job = OffloadJob(
            next(self._job_ids), "store", [b.block_id for b in blocks], claim_id, request_id, tier=tier
        )
        self.jobs[job.job_id] = job
        self._events.emit(
            "offload_store_job_created",
            request_id=request_id,
            claim_id=claim_id,
            job_id=job.job_id,
            block_ids=job.block_ids,
            tier=tier,
        )

        # resumable state: a transient fault re-runs this fn and it
        # continues at the faulted block (see transfer_queue retry loop)
        st = {"i": 0, "results": [], "finalized": False, "attempts": {}, "spill_attempts": {}}

        def _run() -> None:
            target = self.tiers.by_name(tier)
            direction = f"device_to_{tier}"
            while st["i"] < len(blocks):
                blk = blocks[st["i"]]
                if self.health.is_quarantined(tier):
                    res = TransferResult(
                        False, f"tier_quarantined:{tier}", trigger=TRIGGER_QUARANTINE
                    )
                else:
                    res = self._attempt_block(blk, direction, job, st["attempts"])
                st["results"].append(res)
                if not res.ok:
                    job.ok = False
                    self._record_job_failure(job, res)
                st["i"] += 1
            if not st["finalized"]:
                st["finalized"] = True
                self._finish_store(blocks, st["results"], direction, job, target)
                self._record_tier_outcome(job, tier)
            if self.host.over_capacity:
                self._spill_overflow(job, st["spill_attempts"])
            job.done = True

        self._submit_and_join(job, _run)
        return job

    def _finish_store(self, blocks, results, direction, job, target_tier) -> None:
        """Batched copy + E4 emissions + pool moves for a store job."""
        survivors = [b for b, r in zip(blocks, results) if r.ok]
        self._batched_copy(survivors, job)
        for blk, res in zip(blocks, results):
            self._emit_transfer_finished(job, blk.block_id, direction, res.ok, res.reason)
            if res.ok:
                if blk.block_id in self.device.blocks:
                    self.device.remove(blk.block_id, reason="offloaded")
                target_tier.put(blk)

    def complete_job(self, job: OffloadJob) -> None:
        """Emit the job-completion boundary (E9) — ordered AFTER the engine's
        claim-scoped lifecycle event (E5/E8), matching witness paths A/B."""
        self._events.emit(
            "offload_job_completed",
            request_id=job.request_id,
            claim_id=job.claim_id,
            job_id=job.job_id,
            ok=job.ok,
        )

    # -- telemetry ----------------------------------------------------------------
    def _emit_transfer_finished(
        self, job: OffloadJob, block_id, direction: str, ok: bool, reason: str
    ) -> None:
        """The ONE E4 emission point: every transfer-finished event also
        closes its E3->E4 latency observation (when a submission opened one),
        so the histogram count structurally equals the event-log pair count —
        the reconciliation invariant, enforced by construction."""
        ev = self._events.emit(
            "offload_worker_transfer_finished",
            request_id=job.request_id,
            claim_id=job.claim_id,
            block_id=block_id,
            direction=direction,
            ok=ok,
            reason=reason,
        )
        t0 = self._pending_submit.pop((block_id, direction), None)
        if t0 is not None:
            self._m_transfer.observe(
                max(0.0, ev.ts - t0), direction=direction, ok=str(bool(ok)).lower()
            )

    def _update_tier_gauges(self) -> None:
        """Refresh occupancy/quarantine gauges after each joined job."""
        self._m_tier_blocks.set(len(self.device.blocks), tier="device")
        self._m_tier_bytes.set(
            sum(b.nbytes for b in self.device.blocks.values()), tier="device"
        )
        for tier in self.tiers.tiers:
            self._m_tier_blocks.set(tier.used, tier=tier.name)
            self._m_tier_bytes.set(tier.resident_bytes, tier=tier.name)
            self._m_tier_quarantined.set(
                1 if self.health.is_quarantined(tier.name) else 0, tier=tier.name
            )

    # -- load (host|disk -> device): restore --------------------------------------
    def load(
        self,
        blocks: List[KVBlock],
        *,
        claim_id: Optional[str],
        request_id: Optional[str],
        protected_claims: Optional[Set[str]] = None,
    ) -> OffloadJob:
        job = OffloadJob(
            next(self._job_ids), "load", [b.block_id for b in blocks], claim_id, request_id
        )
        self.jobs[job.job_id] = job
        self._events.emit(
            "offload_load_job_created",
            request_id=request_id,
            claim_id=claim_id,
            job_id=job.job_id,
            block_ids=job.block_ids,
        )

        st = {
            "i": 0,
            "survivors": [],
            "finalized": False,
            "attempts": {},
            "tiers": set(),       # every source tier this job touched
            "tier_fail": set(),   # source tiers with >= 1 failing block
        }

        def _run() -> None:
            while st["i"] < len(blocks):
                blk = blocks[st["i"]]
                src = self.tiers.tier_of_block(blk.block_id)
                src_name = src.name if src is not None else "host"
                direction = f"{src_name}_to_device"
                st["tiers"].add(src_name)
                if self.health.is_quarantined(src_name):
                    # degraded tier: fail the block WITHOUT touching it
                    self._fail_load_block(
                        job,
                        blk,
                        direction,
                        TransferResult(
                            False,
                            f"tier_quarantined:{src_name}",
                            trigger=TRIGGER_QUARANTINE,
                        ),
                    )
                    st["tier_fail"].add(src_name)
                    st["i"] += 1
                    continue
                res = self._attempt_block(blk, direction, job, st["attempts"])
                if not res.ok:
                    self._fail_load_block(job, blk, direction, res)
                    st["tier_fail"].add(src_name)
                    st["i"] += 1
                    continue
                st["survivors"].append((blk, src_name))
                st["i"] += 1

            if st["finalized"]:
                job.done = True
                return
            st["finalized"] = True
            # pop from source tiers (a disk pop re-reads the spilled
            # bytes), verify integrity, then move every payload in ONE
            # batched gather
            popped = []
            for blk, src_name in st["survivors"]:
                tier = self.tiers.by_name(src_name)
                blk = tier.pop(blk.block_id)
                if blk.checksum is not None and payload_checksum(blk.k, blk.v) != blk.checksum:
                    # corruption at rest: the bytes NEVER reach the device
                    # pool — claim-scoped refusal upstream, not bad logits
                    self._fail_load_block(
                        job,
                        blk,
                        f"{src_name}_to_device",
                        TransferResult(
                            False,
                            f"chaos:{TRIGGER_CORRUPTION}@{src_name}:checksum_mismatch",
                            trigger=TRIGGER_CORRUPTION,
                        ),
                    )
                    st["tier_fail"].add(src_name)
                    continue
                popped.append((blk, src_name))
            self._batched_copy([b for b, _ in popped], job)
            for blk, src_name in popped:
                direction = f"{src_name}_to_device"
                if src_name != "host":
                    self._events.emit(
                        "offload_tier_promote",
                        claim_id=job.claim_id,
                        block_id=blk.block_id,
                        from_tier=src_name,
                        to_tier="device",
                    )
                if self.device.free_slots <= 0:
                    self.device.evict(1, protected_claims=protected_claims or set())
                # restore lands the BLOCK in a device page slot: the
                # payload becomes attendable in place through block
                # tables, with no dense-slab assembly step
                blk.checksum = None  # verified; device-resident again
                self.device.readmit(blk)
                self._emit_transfer_finished(job, blk.block_id, direction, True, "")
                self._events.emit(
                    "block_stored",
                    block_id=blk.block_id,
                    chain=blk.chain,
                    n_tokens=len(blk.tokens),
                    page_index=blk.page_index,
                )
            # per-tier health: failure for tiers with failing blocks,
            # success for tiers whose blocks ALL made it
            for src_name in sorted(st["tier_fail"]):
                self._record_tier_failure(job, src_name)
            for src_name in sorted(st["tiers"] - st["tier_fail"]):
                self.health.record_job_success(src_name)
            job.done = True

        self._submit_and_join(job, _run)
        return job

    def _fail_load_block(
        self, job: OffloadJob, blk: KVBlock, direction: str, res: TransferResult
    ) -> None:
        """Per-block load failure: E4(ok=False) + E11, job attribution.
        The failed bytes never reach the device pool — the KV is absent.

        A block can be covered by SEVERAL claims (a radix-shared page under
        nested claim prefixes): every covering claim gets its OWN E11, so
        each sharer's E12 has same-claim affected-block evidence in its own
        ordered stream — one shared event would leave the other sharers'
        fail-closed outcomes unattributed."""
        job.ok = False
        self._record_job_failure(job, res)
        self._emit_transfer_finished(job, blk.block_id, direction, False, res.reason)
        affected = sorted(set(blk.claim_ids) | ({job.claim_id} if job.claim_id else set()))
        for cid in affected or [None]:
            self._events.emit(
                "offload_worker_load_failed",
                request_id=job.request_id,
                claim_id=cid,
                block_id=blk.block_id,
                reason=res.reason,
            )

    @staticmethod
    def _record_job_failure(job: OffloadJob, res: TransferResult) -> None:
        if job.failure_trigger is None:
            job.failure_trigger = res.trigger or TRIGGER_INJECTED
            job.failure_reason = res.reason

    def _record_tier_outcome(self, job: OffloadJob, tier_name: str) -> None:
        """Job-level health accounting (one multi-block job counts once):
        crossing the consecutive-failure threshold quarantines the tier."""
        if tier_name == "device":
            return
        if job.ok:
            self.health.record_job_success(tier_name)
        else:
            self._record_tier_failure(job, tier_name)

    def _record_tier_failure(self, job: OffloadJob, tier_name: str) -> None:
        if tier_name == "device":
            return
        if self.health.record_job_failure(tier_name):
            self._events.emit(
                "tier_quarantined",
                claim_id=job.claim_id,
                tier=tier_name,
                consecutive_failures=self.health.consecutive_failures(tier_name),
                trigger=job.failure_trigger,
            )

    # -- worker internals ---------------------------------------------------------
    def _submit_and_join(self, job: OffloadJob, fn) -> None:
        """Enqueue on the async worker and join before returning: the engine's
        next event must be ordered after every transfer event of this job.

        A worker death (or retry-budget backstop) surfaces HERE — converted
        into per-job failure attribution so the caller's lifecycle handling
        stays the one ordered fail-closed path, never a crash."""
        self._events.emit(
            "transfer_job_enqueued",
            request_id=job.request_id,
            claim_id=job.claim_id,
            job_id=job.job_id,
            kind=job.kind,
            n_blocks=len(job.block_ids),
        )
        tjob = TransferJob(job.job_id, job.kind, self._on_caller_stream(fn),
                           policy=self.retry_policy)
        self.queue.submit(tjob)
        try:
            tjob.wait()
        except TransferWorkerDied as e:
            self._job_fault_at_join(
                job, e.block_id, e.direction, str(e), TRIGGER_WORKER_DEATH
            )
        except TransientTransferFault as e:  # queue's runaway backstop
            self._job_fault_at_join(
                job, e.block_id, e.direction, str(e), TRIGGER_TRANSIENT_EXHAUSTED
            )
        self._update_tier_gauges()

    def _on_caller_stream(self, fn):
        """``fn`` run on the submitting thread's current stream of the copy
        device.  The worker's device work (payload gathers, copies into
        page slots) is then queued on the stream the engine launches on, so
        the next launch that reads a restored slot is ordered after the
        write, whichever thread made it.  The copies are blocking (no
        pinned staging), so none is still in flight at the join."""
        if self.copy_device.type != "cuda":
            return fn
        stream = torch.cuda.current_stream(self.copy_device)

        def on_stream() -> None:
            with torch.cuda.stream(stream):
                fn()

        return on_stream

    def _job_fault_at_join(
        self, job: OffloadJob, block_id, direction, reason: str, trigger: str
    ) -> None:
        """Terminalize a job whose fn did not run to completion: emit the
        failure evidence (E4 fail, and E11 for loads) at the join point —
        still strictly before any engine lifecycle event."""
        job.ok = False
        self._record_job_failure(job, TransferResult(False, reason, trigger=trigger))
        self._emit_transfer_finished(job, block_id, direction or "", False, reason)
        if job.kind == "load":
            # same per-sharer attribution as _fail_load_block: the faulted
            # block may be covered by several claims (radix-shared page)
            tier = self.tiers.tier_of_block(block_id) if block_id is not None else None
            blk = tier.blocks.get(block_id) if tier is not None else None
            covering = set(blk.claim_ids) if blk is not None else set()
            if job.claim_id:
                covering.add(job.claim_id)
            for cid in sorted(covering) or [None]:
                self._events.emit(
                    "offload_worker_load_failed",
                    request_id=job.request_id,
                    claim_id=cid,
                    block_id=block_id,
                    reason=reason,
                )
        if direction and job.kind == "load":
            self._record_tier_failure(job, direction.split("_to_")[0])
        job.done = True

    def _attempt_block(
        self, blk: KVBlock, direction: str, job: OffloadJob, attempts: Dict[int, int]
    ) -> TransferResult:
        """One per-block transfer attempt with transient-retry escalation.

        Transient faults below the retry budget raise
        ``TransientTransferFault`` (the queue backs off and re-runs the
        resumable fn); at budget they escalate to a permanent
        ``transient_exhausted`` failure.  Worker-death faults raise
        ``WorkerKilled`` through the queue."""
        att = attempts.get(blk.block_id, 0) + 1
        attempts[blk.block_id] = att
        res = self._worker_submit(blk, direction, job.claim_id, job.request_id, attempt=att)
        if res.ok or not res.transient:
            return res
        if att < self.retry_policy.max_attempts:
            job.retries += 1
            self.retry_histogram[att] = self.retry_histogram.get(att, 0) + 1
            self._m_retries.increment(direction)
            self._events.emit(
                "transfer_retry_scheduled",
                request_id=job.request_id,
                claim_id=job.claim_id,
                job_id=job.job_id,
                block_id=blk.block_id,
                direction=direction,
                attempt=att,
                max_attempts=self.retry_policy.max_attempts,
                delay_s=self.retry_policy.delay_s(att),
                reason=res.reason,
            )
            raise TransientTransferFault(res.reason, blk.block_id, direction)
        return TransferResult(
            False,
            f"{res.reason}:exhausted_after_{att}_attempts",
            trigger=TRIGGER_TRANSIENT_EXHAUSTED,
        )

    def _worker_submit(
        self,
        blk: KVBlock,
        direction: str,
        claim_id: Optional[str],
        request_id: Optional[str],
        *,
        attempt: int = 1,
    ) -> TransferResult:
        """Emit the per-block submission event (E3) and decide injection."""
        ev = self._events.emit(
            "offload_worker_transfer_submitted",
            request_id=request_id,
            claim_id=claim_id,
            block_id=blk.block_id,
            direction=direction,
            nbytes=blk.nbytes,
            attempt=attempt,
        )
        # open (or re-open, on a retry) the E3->E4 latency measurement
        self._pending_submit[(blk.block_id, direction)] = ev.ts
        claim_ids = set(blk.claim_ids) | ({claim_id} if claim_id else set())
        if self.injection.should_fail(direction, claim_ids):
            return TransferResult(
                False, self.injection.failure_reason, trigger=TRIGGER_INJECTED
            )
        if self.plan is not None:
            fault = self.plan.draw_transfer(direction, claim_ids, blk.block_id, attempt)
            if fault is not None:
                if fault.trigger == TRIGGER_WORKER_DEATH:
                    raise WorkerKilled(fault.reason, blk.block_id, direction)
                return TransferResult(
                    False, fault.reason, trigger=fault.trigger, transient=fault.transient
                )
        return TransferResult(True)

    def _batched_copy(self, blocks: List[KVBlock], job: OffloadJob) -> None:
        """Materialize fresh payload buffers for a job's surviving blocks via
        one batched kernel gather per side on the engine's device (the
        restoration hot path).  The buffers stay there: a restore's land
        in their page slots (``BlockPool.readmit``), an offload's are
        copied down by the tier that takes them."""
        with_payload = [b for b in blocks if b.k is not None and b.k.numel() > 0]
        if with_payload:
            new_k = gather_payloads([b.k for b in with_payload], self.copy_device)
            for blk, nk in zip(with_payload, new_k):
                blk.k = nk
            with_v = [b for b in with_payload if b.v is not None and b.v.numel() > 0]
            if with_v:
                new_v = gather_payloads([b.v for b in with_v], self.copy_device)
                for blk, nv in zip(with_v, new_v):
                    blk.v = nv
        if len(blocks) > 0:
            self._events.emit(
                "transfer_batch_executed",
                claim_id=job.claim_id,
                request_id=job.request_id,
                job_id=job.job_id,
                n_blocks=len(blocks),
                nbytes=sum(b.nbytes for b in blocks),
            )

    # -- spill policy (host overflow -> disk) -------------------------------------
    def _spill_overflow(self, job: OffloadJob, attempts: Optional[Dict[int, int]] = None) -> None:
        """Demote the host tier's oldest blocks to disk until within capacity.

        A spill failure is fail-closed for the block: it stays resident in
        the host tier (over capacity) rather than being dropped.  The loop
        is resumable by construction — already-spilled blocks are no longer
        candidates, and a permanently-failed block is skipped per pass.
        Spills into a quarantined disk tier are refused up front (the
        blocks stay host-resident)."""
        if self.health.is_quarantined("disk"):
            for blk in self.tiers.spill_candidates():
                self._emit_transfer_finished(
                    job, blk.block_id, "host_to_disk", False, "tier_quarantined:disk"
                )
            return
        if attempts is None:
            attempts = {}
        for blk in self.tiers.spill_candidates():
            res = self._attempt_block(blk, "host_to_disk", job, attempts)
            self._emit_transfer_finished(
                job, blk.block_id, "host_to_disk", res.ok, res.reason
            )
            if not res.ok:
                continue
            moved = self.host.pop(blk.block_id)
            self.disk.put(moved)
            self._events.emit(
                "offload_tier_spill",
                claim_id=sorted(moved.claim_ids)[0] if moved.claim_ids else None,
                block_id=moved.block_id,
                from_tier="host",
                to_tier="disk",
                nbytes=moved.nbytes,
            )

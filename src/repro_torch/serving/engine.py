"""Claim-native KV serving engine (PyTorch/CUDA port): paged zero-copy
decode + continuous batching over the shared core.

This is the runtime the paper's patched-vLLM witness *demonstrates the
implementability of* — here built natively (DESIGN.md §2).  The decisive
property is the ordered, claim-scoped path:

  accept(C, P, leading_prefix_at_least(k)) -> materialized(C) ->
  offloaded(C) -> restore_required(C) -> same-claim load failure ->
  scheduler_resident_claim_restoration_failed(C) ->
  scheduler_active_request_refused(blocking_claim_ids=[C]) ->
  ... before terminal request-finished handling.

The claim lifecycle itself lives in ``core_engine.EngineCore``; this
module adds what is specific to KV block chains and the execution strategy:

**Paged decode (default).**  Block payloads live in the pool's
page store (kv_cache.BlockPool, on the engine's device) and decode attends
over them IN PLACE through per-request block tables
(models/transformer.paged_decode_step; on the GPU the CUDA kernel behind
kernels/paged_attention.py), reading the store itself.  No dense
per-request cache is ever assembled: a reused or restored block is consumed at its page slot,
shared prefixes occupy their pages ONCE across the whole batch, and context
length is bounded by pool pages — not by a per-request cache shape.  Only
the in-flight tail (trailing partial block + decoded tokens) is per-request
state.  ``decode_mode="dense"`` keeps the gather-to-dense path (the parity
anchor): each request's prefix blocks are copied from the page store
into a per-request [cache_len] cache, a fresh prompt runs one full-length
prefill (on the GPU the flash-attention kernel behind
kernels/flash_attention.py), and decode attends that cache.

**Batched prefill.**  ``run_batch`` groups fresh prompts into same-bucket
launches (padded to the bucket length and masked by per-row valid lengths),
so N same-bucket prompts cost ONE prefill compilation/launch instead of N.

**Chunked prefill (``prefill_chunk=``).**  Buckets longer than the chunk
run chunk-by-chunk: each launch attends already-written pool pages (via
carried block tables) plus the in-flight chunk (causal), and completed
blocks land in page slots before the next chunk
(models/transformer.prefill_chunk; on the GPU the CUDA kernel behind
kernels/paged_attention.paged_prefill_attention).  Peak prefill KV
is O(chunk_len) — the monolithic [L, B, S, KV, Dh] collect buffer never
exists — so admissible prompt length is bounded by pool pages, not by the
prefill launch.  Chains stay PINNED across chunks (mid-prefill allocations
cannot evict a live chain) and a mid-prefill store failure fails closed
with allocation attribution, exactly like the monolithic path.

**Continuous batching (unified step scheduler).**  ``run_batch`` (paged
mode) drives the token-budget step loop in ``scheduler_loop.StepLoop``:
every scheduler step carries ALL live decode/feed rows in one mixed launch
plus at most one in-flight prefill chunk under ``max_tokens_per_step``,
waiting requests are admitted/restored between steps, and a request that
completes mid-stream frees its pages immediately.  Decode rows launch
every step — admission bursts never stall in-flight decodes behind a full
prefill.  ``run(req)`` is ``run_batch([req])``; dense mode keeps the
phased prefill-then-decode path (parity anchor).

``prefill_chunk`` is ON BY DEFAULT (``DEFAULT_PREFILL_CHUNK``): the chunk
graph is chunk-size-invariant (bitwise — every chunk size stores the same
page bytes and yields the same entry logits), so chunked-vs-full and
restored-vs-cold parity is structural.  Pass ``prefill_chunk=0`` for the
legacy monolithic O(S) collect launch (the ceiling-benchmark anchor).

The engine runs a REAL model: cached/restored page payloads are the
bytes decode attends over, so a failed restore genuinely leaves the request
without its claimed KV (no fallback recompute is attempted for claim-scoped
restoration failure — that is the fail-closed semantics).
"""
from __future__ import annotations

import math
import time
from typing import Any, Dict, List, Optional, Sequence, Set, Tuple

import numpy as np
import torch

from repro_torch.core.claims import ClaimState, ResidentClaim
from repro_torch.device import DeviceLike
from repro_torch.serving.cache_object import KVChainKind
from repro_torch.serving.chaos import TRIGGER_CAPACITY
from repro_torch.serving.core_engine import (
    EngineCore,
    Request,
    Scheduler,
    SchedulerOutcome,
)
from repro_torch.serving.kv_cache import (
    KVBlock,
    PoolExhausted,
    chain_hash,
    pin_chain,
    unpin_chain,
)
from repro_torch.serving.offload import FailureInjectionConfig
from repro_torch.serving.scheduler_loop import (
    BATCH_PAD,
    DEFAULT_MAX_TOKENS_PER_STEP,
    PrefillJob,
    StepLoop,
    _round_up,
    device_sync,
)

__all__ = [
    "BATCH_PAD",
    "DEFAULT_MAX_TOKENS_PER_STEP",
    "DEFAULT_PREFILL_CHUNK",
    "Request",
    "Scheduler",
    "SchedulerOutcome",
    "ServingEngine",
    "_round_up",
]

# Chunked prefill default (tokens per chunk): O(chunk) peak prefill KV and
# decode-interleavable prefill launches.  Structural parity makes the flip
# safe: the chunk graph stores bitwise-identical page bytes for EVERY chunk
# size (including one chunk covering the whole prompt), so defaulting it on
# moves no logits surface.  Explicit prefill_chunk=0 restores the monolithic
# O(S) collect launch.
DEFAULT_PREFILL_CHUNK = 32


class ServingEngine(EngineCore):
    """Claim-native engine over KV block chains: paged decode + batching."""

    kind = KVChainKind()

    def __init__(
        self,
        bundle,
        params,
        *,
        block_size: int = 8,
        device_blocks: int = 64,
        cache_len: int = 128,
        event_log=None,
        injection: Optional[FailureInjectionConfig] = None,
        namespace: str = "default",
        host_blocks: Optional[int] = None,
        disk_dir=None,
        decode_mode: str = "paged",
        prefill_chunk: Optional[int] = None,
        max_tokens_per_step: int = DEFAULT_MAX_TOKENS_PER_STEP,
        fault_plan=None,
        retry_policy=None,
        quarantine_after: Optional[int] = 3,
        prefix_sharing: bool = True,
        device: DeviceLike = None,
    ):
        if decode_mode not in ("paged", "dense"):
            raise ValueError(f"decode_mode={decode_mode!r}: expected 'paged' or 'dense'")
        super().__init__(
            bundle,
            params,
            block_size=block_size,
            device_blocks=device_blocks,
            cache_len=cache_len,
            event_log=event_log,
            injection=injection,
            namespace=namespace,
            host_blocks=host_blocks,
            disk_dir=disk_dir,
            fault_plan=fault_plan,
            retry_policy=retry_policy,
            quarantine_after=quarantine_after,
            device=device,
        )
        if params["embed"].device != self.device:
            raise ValueError(
                f"params live on {params['embed'].device}, the engine runs on {self.device}"
            )
        if decode_mode == "paged" and bundle.paged_decode_fn is None:
            decode_mode = "dense"  # int8 / non-transformer bundles have no paged entry points
        self.decode_mode = decode_mode
        self._step_prefill_collect = bundle.prefill_collect_fn
        self._step_paged_decode = bundle.paged_decode_fn
        self._step_prefill_chunk = bundle.prefill_chunk_fn
        # one launch for the decode rows and the prefill chunk of a step
        # (StepLoop's fused route; None for bundles without it)
        self._step_mixed = bundle.mixed_step_fn
        # prefill_chunk bounds peak prefill KV at O(chunk): every fresh
        # bucket runs chunk-by-chunk, each completed chunk's blocks landing
        # in pool pages before the next chunk launches.  None -> the
        # default (chunked ON); explicit 0 -> the legacy single full-length
        # collect launch.
        if prefill_chunk is None:
            prefill_chunk = DEFAULT_PREFILL_CHUNK
        self.prefill_chunk = (
            _round_up(prefill_chunk, block_size) if prefill_chunk else 0
        )
        # unified step-scheduler budget: live rows (1 token each) + at most
        # one prefill chunk (chunk_len x bucket rows) per step
        self.max_tokens_per_step = max_tokens_per_step
        # step-scheduler observability (registered unconditionally so the
        # reconcile rule step_tokens.count == |step_scheduled| holds 0==0
        # for dense/idle engines too)
        self.step_tokens = self.metrics.histogram(
            "scheduler_step_tokens",
            "tokens carried per unified scheduler step (decode+feed rows + prefill chunk)",
            buckets=(1, 2, 4, 8, 16, 32, 64, 128, 256, 512, 1024),
        )
        self.step_occupancy = self.metrics.gauge(
            "scheduler_step_occupancy",
            "last step's token load as a fraction of max_tokens_per_step",
        )
        # lint: allow[metric-drift] the route of each chunk step has no event witness: the events are the reference's, whichever route ran
        self.chunk_routes = self.metrics.counter(
            "scheduler_chunk_steps_total",
            "steps that ran a prefill chunk, by route: 'fused' (one launch with the "
            "decode rows), else why the chunk ran in its own launch",
            labels=("route",),
        )
        self.decode_stalls = self.metrics.counter(
            "decode_stall_steps_total",
            "scheduler steps where live decode rows did NOT launch (must stay 0)",
        )
        # pool-wide radix prefix sharing.  Gated on the cache-object kind:
        # a KV chain is position-sliceable, so any block-aligned prefix of
        # it is reusable by any request; a recurrent state snapshot
        # summarizes its exact prefix and is not (shareable = False).
        # prefix_sharing=False salts every chain with the request id —
        # request-private chains, the measured no-sharing baseline of
        # benchmarks/bench_radix.py.
        self.prefix_sharing = bool(
            prefix_sharing and getattr(self.kind, "shareable", False)
        )
        self.prefix_reuse_hits = self.metrics.counter(
            "prefix_reuse_hits_total",
            "admissions that found resident prefix pages (radix hit)",
        )
        self.cow_copies = self.metrics.counter(
            "cow_copies_total",
            "copy-on-write page copies at shared-page divergence points",
        )
        self.pages_shared = self.metrics.gauge(
            "pages_shared",
            "device pages currently referenced by more than one holder",
        )
        # the pool invokes this once per page_cow emit (metric witness 1:1)
        self.pool.on_cow = self.cow_copies.inc

    # ------------------------------------------------------------------ claims
    def _chain_root(self, req: Request) -> str:
        """Root hash for a request's block chains.  Sharing ON -> "" (the
        pool-wide radix root: content-equal prefixes collide on the same
        chain hashes and reuse each other's pages).  Sharing OFF -> a
        per-request salt, making every chain request-private.  Claims bind
        to root-"" chains (``_claims_covering_block`` walks from ""), so
        claim offload/restore requires sharing on; the salted mode exists
        as the measured no-sharing baseline."""
        return "" if self.prefix_sharing else "!" + req.request_id

    def _claims_covering_block(self, chain: str, block_index: int) -> Set[str]:
        """Claim ids whose prefix includes the block at this chain position."""
        out = set()
        for cid, prefix in self._claim_prefixes.items():
            nblocks = len(prefix) // self.block_size
            if block_index < nblocks:
                h = ""
                for i in range(block_index + 1):
                    h = chain_hash(h, prefix[i * self.block_size : (i + 1) * self.block_size])
                if h == chain:
                    out.add(cid)
        return out

    def _claim_device_blocks(self, claim: ResidentClaim) -> Optional[List[KVBlock]]:
        prefix = self._claim_prefixes[claim.claim_id]
        blocks = self.pool.lookup_prefix(prefix, self.block_size)
        nblocks = len(prefix) // self.block_size
        if len(blocks) < nblocks:
            return None
        return blocks[:nblocks]

    # ---------------------------------------------------------------- requests
    def submit(self, tokens: Sequence[int], max_new_tokens: int = 4) -> Request:
        return self._new_request(tokens, max_new_tokens)

    # ------------------------------------------------------------ cache plumbing
    def _dense_cache(self, blocks: List[KVBlock], batch: int = 1):
        """Gather-to-dense assembly (decode_mode="dense" only): copies every
        block payload from the page store into row 0 of a fresh cache
        on the engine's device.  A prefix longer than the cache (possible
        only on a sliding-window ring) raises ValueError, as the JAX
        package's scatter does; nothing is truncated.  Under an int8 cache
        the blocks hold the int8 values only, so the reused prefix's
        ``k_scale``/``v_scale`` stay zero and it dequantizes to zeros: the
        JAX package does the same (ROADMAP Queue 3), and the port keeps it."""
        cache = self.bundle.make_cache(batch, self.cache_len)
        if not blocks:
            return cache, 0
        k = torch.cat([b.k for b in blocks], dim=1)  # [L, n_tok, KV, Dh]
        v = torch.cat([b.v for b in blocks], dim=1)
        pos = np.concatenate([b.positions for b in blocks])
        n = k.shape[1]
        Sc = cache["k"].shape[2]
        # on a ring, blocks stored from a long prefill hold fewer payload
        # rows than positions, so both lengths are checked
        if max(n, len(pos)) > Sc:
            raise ValueError(
                f"dense cache of {Sc} slots cannot hold a cached prefix of {len(pos)} positions"
            )
        dev = self.device
        cache["k"][:, 0, :n] = k.to(dev)
        cache["v"][:, 0, :n] = v.to(dev)
        cache["pos"][0, : len(pos)] = torch.from_numpy(pos.astype(np.int32)).to(dev)
        return cache, n

    def _device_pages(self) -> Tuple[torch.Tensor, torch.Tensor]:
        """The page store the paged kernels read: the pool's own
        ``k_pages``/``v_pages``, which live on the engine's device (the
        reference's "on the TPU target the page store IS device memory and
        this is the identity").  Nothing is copied, so live decode states
        and every later page write share one pair of tensors at fixed
        addresses; ``kv_cache.BlockPool`` says why no write lands in a slot
        a live block table reads.  Before the first page exists, a one-page
        zero store stands in (no block table references a page yet).  A
        store on another device than the engine's raises: the engine never
        serves from a host store."""
        pool = self.pool
        if pool.k_pages is None:
            cfg = self.cfg
            z = torch.zeros(
                (cfg.num_layers, cfg.num_kv_heads, 1, self.block_size, cfg.resolved_head_dim),
                dtype=self.params["embed"].dtype,
                device=self.device,
            )
            return z, z
        if pool.k_pages.device != self.device:
            raise RuntimeError(
                f"page store on {pool.k_pages.device}, the engine serves on {self.device}"
            )
        return pool.k_pages, pool.v_pages

    def _store_prefix_blocks(
        self, req: Request, ck, cv, upto: int, *, start: int = 0, pin: bool = True,
        reserved: Optional[Dict[int, int]] = None, written: bool = False,
    ) -> List[KVBlock]:
        """Slice a request's KV into reusable pool pages.

        ck/cv: [L, S, KV, Dh] tensors on the engine's device — the
        request's KV for token positions ``start..upto`` (``start`` must be
        block-aligned; blocks before it are assumed resident and are skipped, their chain hashes
        still folded in).

        With ``pin=True`` returns the stored/reused blocks from ``start``
        onward, every block PINNED (ref+1): a later allocation in the same
        batch must not evict a page this request's block table will attend.
        The caller unpins after decode.  Chunked prefill calls this once
        per chunk (``start`` = the chunk's first token) and accumulates the
        returned segments into one pinned chain; claim metadata is bound
        identically on every chunk — ``_claims_covering_block`` walks the
        same chain hashes and the protected set whichever chunk stores the
        block, so a claim accepted before prefill covers its blocks from
        the FIRST chunk onward.  On PoolExhausted the partial pins of THIS
        call are unwound before re-raising (a chunked caller unwinds its
        accumulated chain).

        ``reserved`` maps a block index to the slot ``BlockPool.reserve_pages``
        took for it (a fused step's chunk); ``written``: the launch wrote
        the block's bytes into that slot of the pool's own store, so the
        block adopts it without a copy.
        """
        chain: List[KVBlock] = []
        h = self._chain_root(req)
        protected = self.scheduler.protected_claim_ids()
        try:
            for bi in range(upto // self.block_size):
                lo, hi = bi * self.block_size, (bi + 1) * self.block_size
                btoks = req.tokens[lo:hi]
                parent, h = h, chain_hash(h, btoks)
                if lo < start:
                    continue
                bid = self.pool.prefix_index.get(h)
                blk = self.pool.blocks.get(bid) if bid is not None else None
                if blk is not None and blk.chain == h and not blk.partial:
                    pass  # already resident (shared prefix)
                else:
                    claim_ids = self._claims_covering_block(h, bi)
                    prio = max(
                        [self.registry.get(c).priority for c in claim_ids],
                        default=0,
                    )
                    blk = self.pool.add_block(
                        btoks,
                        h,
                        ck[:, lo - start : hi - start],
                        cv[:, lo - start : hi - start],
                        np.arange(lo, hi),
                        priority=prio,
                        claim_ids=claim_ids,
                        protected_claims=protected,
                        parent=parent,
                        page=None if reserved is None else reserved.get(bi),
                        page_written=written,
                    )
                if pin:
                    pin_chain((blk,))
                    chain.append(blk)
        except PoolExhausted:
            unpin_chain(chain)
            raise
        return chain

    def _fold_sequence_blocks(
        self,
        req: Request,
        seq: Sequence[int],
        tail_k: torch.Tensor,
        tail_v: torch.Tensor,
        plen: int,
        *,
        held_blocks: Sequence[KVBlock] = (),
        trailing_partial: bool = False,
        best_effort: bool = False,
    ) -> None:
        """Fold a request's computed KV back into pool pages along its
        radix path.

        ``seq`` is the request's token sequence (prompt, optionally plus
        generated output); ``tail_k``/``tail_v`` ([L, T, KV, Dh] on the
        engine's device) hold the KV computed through the in-flight tail
        for positions ``plen..plen+T``.  Resident full blocks are skipped (radix
        descent); a matching partial block is EXTENDED — in place while
        this caller is its only holder (``held_blocks``), copy-on-write
        once shared; missing blocks are cut from the tail.  With
        ``trailing_partial`` the sub-block remainder is folded too, so
        decode tails become reusable prefix.  ``best_effort`` (retirement
        readmission) never evicts and never raises: it stops at the first
        allocation that would need a page the pool doesn't have free —
        readmitted blocks are an opportunistic cache fill, not an
        obligation anyone accepted.
        """
        bs = self.block_size
        tail_len = int(tail_k.shape[1]) if tail_k is not None else 0
        protected = self.scheduler.protected_claim_ids()
        held_ids = {id(b) for b in held_blocks}
        h = self._chain_root(req)
        seq = tuple(int(t) for t in seq)
        upto = len(seq) if trailing_partial else len(seq) - len(seq) % bs
        bi = 0
        lo = 0
        while lo < upto:
            hi = min(lo + bs, upto)
            btoks = seq[lo:hi]
            parent, h = h, chain_hash(h, btoks)
            is_full = hi - lo == bs
            bid = self.pool.prefix_index.get(h) if is_full else None
            blk = self.pool.blocks.get(bid) if bid is not None else None
            if blk is not None and blk.chain == h and not blk.partial:
                bi += 1
                lo = hi
                continue
            claim_ids = self._claims_covering_block(h, bi) if is_full else set()
            prio = max(
                [self.registry.get(c).priority for c in claim_ids], default=0
            )
            pb = self.pool.lookup_partial(parent, btoks)
            if pb is not None and len(pb.tokens) == len(btoks):
                return  # identical partial already resident (remainder)
            if pb is not None:
                ext_lo = lo + len(pb.tokens)
                if ext_lo < plen or hi - plen > tail_len:
                    return  # extension KV not covered by this tail
                held = 1 if id(pb) in held_ids else 0
                if best_effort and pb.ref > held and self.pool.free_slots <= 0:
                    return  # COW would need a page; never evict here
                self.pool.extend_block(
                    pb,
                    seq[ext_lo:hi],
                    tail_k[:, ext_lo - plen : hi - plen],
                    tail_v[:, ext_lo - plen : hi - plen],
                    block_size=bs,
                    held=held,
                    priority=prio,
                    claim_ids=claim_ids,
                    protected_claims=protected,
                )
            else:
                if lo < plen or hi - plen > tail_len:
                    return  # KV for these positions not covered by this tail
                if best_effort and self.pool.free_slots <= 0:
                    return
                ks = tail_k[:, lo - plen : hi - plen]
                vs = tail_v[:, lo - plen : hi - plen]
                pos = np.arange(lo, hi)
                if is_full:
                    self.pool.add_block(
                        btoks, h, ks, vs, pos,
                        priority=prio, claim_ids=claim_ids,
                        protected_claims=protected, parent=parent,
                    )
                else:
                    self.pool.add_partial_block(
                        btoks, parent, ks, vs, pos,
                        block_size=bs, priority=prio,
                        protected_claims=protected,
                    )
            bi += 1
            lo = hi

    def _readmit_decode_tail(
        self,
        req: Request,
        blocks: Sequence[KVBlock],
        plen: int,
        tail_k: torch.Tensor,
        tail_v: torch.Tensor,
    ) -> None:
        """Fold a finished request's decode tail back into the page store:
        generated tokens become reusable prefix for ANY later request (the
        next turn of the same conversation descends onto them like any
        other radix path).  Best-effort by design — readmitted blocks
        arrive unpinned and claimless (claims bind at prefill observation
        points, never retroactively), so they are ordinary eviction
        victims and a full pool skips readmission rather than evict."""
        if not (self.prefix_sharing and self.decode_mode == "paged"):
            return
        seq = tuple(req.tokens) + tuple(int(t) for t in req.output_tokens)
        self._fold_sequence_blocks(
            req, seq, tail_k, tail_v, plen,
            held_blocks=blocks, trailing_partial=True, best_effort=True,
        )

    def _materialize_claims(self, req: Request, materialized_tokens: int) -> None:
        """Named observation point: prefill_complete."""
        for claim in self._matching_claims(req.tokens):
            if claim.state != ClaimState.ACCEPTED:
                continue
            if claim.predicate.evaluate(materialized_tokens):
                prefix = self._claim_prefixes[claim.claim_id]
                nblocks = len(prefix) // self.block_size
                bytes_per_block = next(
                    (b.nbytes for b in self.pool.blocks.values()), 0
                )
                self._materialize_claim(
                    claim,
                    materialized_tokens=materialized_tokens,
                    n_blocks=nblocks,
                    footprint_bytes=nblocks * bytes_per_block,
                    request_id=req.request_id,
                )

    # ---------------------------------------------------------------- admission
    def _admit_and_restore(self, req: Request) -> Optional[List[KVBlock]]:
        """Admission + restore-before-reuse for one request.

        Returns the device-resident prefix blocks (possibly empty) when the
        request may proceed to prefill/decode, or None when it already
        terminated (admission refusal or fail-closed restoration outcome).
        The claim lifecycle here is entirely the shared EngineCore
        implementation.
        """
        req.status = "running"

        # --- injected pool/capacity pressure (chaos): refuse at admission,
        # attributed, before any allocation touches the pool ---
        if self.fault_plan is not None and self.fault_plan.draw_capacity(req.request_id):
            req.status = "refused"
            req.error = f"chaos:{TRIGGER_CAPACITY}"
            self.events.emit(
                "scheduler_admission_refused",
                request_id=req.request_id,
                blocking_claim_ids=[],
                conflict_action="refuse",
                stage="capacity_pressure",
                trigger=TRIGGER_CAPACITY,
            )
            self.fail_closed.increment(TRIGGER_CAPACITY)
            self.events.emit(
                "request_finished", request_id=req.request_id, status="REFUSED_ADMISSION"
            )
            return None

        # --- dense cache-shape ceiling (fail closed, not silent truncation) ---
        # The dense path writes prefill KV into a fixed [cache_len] cache;
        # a longer prompt would silently drop leading KV (make_cache keeps
        # the trailing slice) and decode would overwrite the last slot.
        # Refuse instead — the paged path has no such shape: context is
        # bounded by pool pages (SWA rings are exempt: the window is the
        # contract there).
        if (
            self.decode_mode != "paged"
            and not self.cfg.sliding_window
            and len(req.tokens) + req.max_new_tokens > self.cache_len
        ):
            req.status = "refused"
            req.error = (
                f"dense_cache_overflow: {len(req.tokens)} prompt + "
                f"{req.max_new_tokens} new tokens > cache_len={self.cache_len}"
            )
            self.events.emit(
                "scheduler_admission_refused",
                request_id=req.request_id,
                blocking_claim_ids=[],
                conflict_action="refuse",
                stage="cache_shape",
                trigger="dense_cache_overflow",
            )
            self.fail_closed.increment("dense_cache_overflow")
            self.events.emit(
                "request_finished", request_id=req.request_id, status="REFUSED_ADMISSION"
            )
            return None

        # --- device-resident prefix reuse (radix descent from this
        # request's chain root) ---
        root = self._chain_root(req)
        dev_blocks = self.pool.lookup_prefix(req.tokens, self.block_size, root=root)

        # --- explicit active/resident conflict action (admission) ---
        if self.decode_mode == "paged":
            # paged: decode tokens live in the tail, not in pool pages, and
            # already-resident blocks are shared — only missing full prompt
            # blocks need pages
            needed = len(req.tokens) // self.block_size - len(dev_blocks)
        else:
            needed = math.ceil((len(req.tokens) + req.max_new_tokens) / self.block_size)
        refusal = self.scheduler.admission_check(req, needed)
        if refusal is not None:
            req.status = "refused"
            req.error = refusal.reason
            self.fail_closed.increment("admission_conflict")
            self.events.emit(
                "request_finished", request_id=req.request_id, status="REFUSED_ADMISSION"
            )
            return None

        # --- off-device (offloaded) continuation: restore-before-reuse ---
        hit_blocks = self.connector.lookup(
            req.tokens,
            self.block_size,
            req.request_id,
            skip_blocks=len(dev_blocks),
            start_chain=dev_blocks[-1].chain if dev_blocks else root,
        )
        if hit_blocks:
            if not self._restore_for_request(req, hit_blocks):
                return None
            dev_blocks = self.pool.lookup_prefix(
                req.tokens, self.block_size, root=root
            )

        # --- sub-block (decode-tail) reuse: the longest partial child under
        # the full-block hit.  Paged only — the partial page relies on
        # prefix_len masking past its valid length; dense assembly needs
        # contiguous full payloads. ---
        partial_tokens = 0
        if self.decode_mode == "paged":
            covered = len(dev_blocks) * self.block_size
            pb = self.pool.lookup_partial(
                dev_blocks[-1].chain if dev_blocks else root,
                req.tokens[covered:],
            )
            if pb is not None:
                partial_tokens = len(pb.tokens)
                dev_blocks = dev_blocks + [pb]

        req.cached_tokens = sum(len(b.tokens) for b in dev_blocks)
        if self.prefix_sharing and req.cached_tokens:
            self.events.emit(
                "prefix_reuse",
                request_id=req.request_id,
                n_blocks=len(dev_blocks),
                n_tokens=req.cached_tokens,
                partial_tokens=partial_tokens,
            )
            self.prefix_reuse_hits.inc()
        return dev_blocks

    # ------------------------------------------------------------- paged phase
    def _make_paged_state(
        self,
        blocks_per_req: List[List[KVBlock]],
        plens: List[int],
        tail_cap: int,
        tails: Optional[List[Optional[Dict[str, Any]]]] = None,
        pages: Optional[Tuple[Any, Any]] = None,
        page_tables: Optional[List[List[int]]] = None,
    ) -> Dict[str, Any]:
        """Assemble the paged-decode state on the engine's device: pool pages
        + per-request block tables + in-flight tails (``tails``' tensors
        may already sit there: they are copied on the device).

        ``pages`` is the ``_device_pages()`` pair the caller holds for the
        batch (the pool's own store).  ``page_tables``, when given, are the
        rows' tables (a row that joins in a fused step names slots its
        blocks will adopt); else each row's blocks give its table.
        """
        B = len(blocks_per_req)
        jk, jv = pages if pages is not None else self._device_pages()
        L, KV, _, page, Dh = jk.shape
        if page_tables is None:
            page_tables = [self.pool.page_table(bl) for bl in blocks_per_req]
        P = _round_up(max((len(pt) for pt in page_tables), default=0), 4)
        bt = np.zeros((B, P), np.int32)
        for i, pt in enumerate(page_tables):
            bt[i, : len(pt)] = pt
        dev = self.device
        tk = torch.zeros((L, B, tail_cap, KV, Dh), dtype=jk.dtype, device=dev)
        tv = torch.zeros_like(tk)
        tpos = np.full((B, tail_cap), -1, np.int32)
        if tails is not None:
            for i, t in enumerate(tails):
                if t is None:
                    continue
                n = t["k"].shape[1]
                tk[:, i, :n] = t["k"]
                tv[:, i, :n] = t["v"]
                tpos[i, :n] = t["pos"]
        return {
            "k_pages": jk,
            "v_pages": jv,
            "block_tables": torch.from_numpy(bt).to(dev),
            "prefix_len": torch.tensor(plens, dtype=torch.int32, device=dev),
            "k_tail": tk,
            "v_tail": tv,
            "tail_pos": torch.from_numpy(tpos).to(dev),
        }

    def _paged_entry(self, req: Request, blocks: List[KVBlock], plen: int,
                     tail_k, tail_v, tail_pos, logits) -> Dict[str, Any]:
        # blocks arrive PINNED (ref already held by the caller the moment
        # each block became part of the request's chain); run_batch unpins
        # after decode
        return {
            "req": req,
            "blocks": blocks,
            "plen": plen,
            "tail_k": tail_k,  # [L, t, KV, Dh] on the engine's device (may be empty)
            "tail_v": tail_v,
            "tail_pos": tail_pos,  # [t] absolute positions
            "logits": logits,  # [V]
            "pos": len(req.tokens),
        }

    def _continue_paged(
        self,
        req: Request,
        dev_blocks: List[KVBlock],
        pages: Optional[Tuple[Any, Any]] = None,
    ) -> Dict[str, Any]:
        """Prefill-continuation over a (restored) block prefix: feed the
        uncached tokens through the paged step — reused pages are consumed
        IN PLACE, nothing is re-assembled or recomputed."""
        toks = req.tokens
        n = len(toks)
        cached = sum(len(b.tokens) for b in dev_blocks)
        blocks = list(dev_blocks)
        # pin the chain BEFORE any allocation below: a same-batch store must
        # not evict a page this request's block table attends
        pin_chain(blocks)
        try:
            if cached == n:
                # exact-prefix hit: replay the last token through the tail
                # (its logits pick the first output token) and mask it out
                # of the page side so the position is not double-counted
                plen, feed = n - 1, toks[n - 1 :]
            else:
                plen, feed = cached, toks[cached:]
            tail_cap = _round_up(n - plen + req.max_new_tokens, 8)
            state = self._make_paged_state(
                [blocks] * BATCH_PAD, [plen] * BATCH_PAD, tail_cap, pages=pages
            )
            logits = None
            dev = self.device
            for i, tok in enumerate(feed):
                lg, state = self._step_paged_decode(
                    self.params,
                    state,
                    torch.full((BATCH_PAD,), tok, dtype=torch.int32, device=dev),
                    torch.full((BATCH_PAD,), plen + i, dtype=torch.int32, device=dev),
                )
                logits = lg[0]
            t_used = n - plen
            tail_k = state["k_tail"][:, 0, :t_used]
            tail_v = state["v_tail"][:, 0, :t_used]
            tail_pos = np.arange(plen, n)
            if cached < n:
                # freshly computed KV folds back into pool pages along the
                # radix path: full blocks are cut from the tail, and a
                # matched partial block grows in place (or COWs if shared)
                self._fold_sequence_blocks(
                    req, toks, tail_k, tail_v, plen, held_blocks=blocks
                )
            # the named observation point applies to exact-prefix hits too:
            # a claim accepted after its prefix became resident must still
            # materialize here (matching the dense path)
            self._materialize_claims(req, n - n % self.block_size)
        except BaseException:
            unpin_chain(blocks)
            raise
        return self._paged_entry(req, blocks, plen, tail_k, tail_v, tail_pos, logits)

    def _prefill_bucket(self, reqs: List[Request]) -> List[Dict[str, Any]]:
        """ONE shared prefill launch for a bucket of fresh prompts: padded to
        the bucket length, masked by per-row valid lengths.

        When ``prefill_chunk`` is set (the default) EVERY bucket runs
        through the chunked path — the chunk graph is chunk-size-invariant
        (one chunk covering the whole prompt is the same computation), so
        there is exactly ONE default prefill graph and chunked-vs-full
        parity is structural.  Explicit ``prefill_chunk=0`` keeps this
        monolithic O(S) collect launch (the ceiling-benchmark anchor)."""
        B = _round_up(len(reqs), BATCH_PAD)  # padding rows replicate row 0
        lens = [len(r.tokens) for r in reqs]
        lens += [lens[0]] * (B - len(reqs))
        if self.prefill_chunk:
            return self._prefill_bucket_chunked(reqs, lens, B)
        S = _round_up(max(lens), self.block_size)
        tokens = np.zeros((B, S), np.int32)
        for i in range(B):
            r = reqs[i] if i < len(reqs) else reqs[0]
            tokens[i, : len(r.tokens)] = r.tokens
        t0 = time.monotonic()
        logits, ck, cv = self._step_prefill_collect(
            self.params,
            {
                "tokens": torch.from_numpy(tokens).to(self.device),
                "valid_len": torch.tensor(lens, dtype=torch.int32, device=self.device),
            },
        )
        device_sync(self.device)
        self._observe_stage("prefill", time.monotonic() - t0)
        # ck/cv: [L, B, S, KV, Dh] on the device, sliced into the store there
        stored: List[Tuple[Request, List[KVBlock]]] = []
        for i, req in enumerate(reqs):
            n = lens[i]
            try:
                blocks = self._store_prefix_blocks(req, ck[:, i], cv[:, i], n)
            except PoolExhausted as e:
                self._refuse_allocation(req, e)
                continue
            self._materialize_claims(req, n - n % self.block_size)
            stored.append((req, blocks))
        # Entry state (tail KV + pre-decode logits) comes from the SAME
        # paged feed the continuation path uses, over the just-stored pages.
        # A fresh prefill and a later restored continuation of the same
        # prompt therefore run the SAME executable over bitwise-identical
        # pages — restored-vs-cold greedy parity is structural, not a
        # numerical accident of prefill-vs-decode GEMM rounding.
        entries = []
        pages = self._device_pages() if stored else None
        for req, blocks in stored:
            try:
                entries.append(self._continue_paged(req, blocks, pages))
            finally:
                unpin_chain(blocks)  # release store-time pins; the entry holds its own
        return entries

    def _prefill_bucket_chunked(
        self, reqs: List[Request], lens: List[int], B: int
    ) -> List[Dict[str, Any]]:
        """Chunked paged prefill for one bucket: the prompt runs CHUNK BY
        CHUNK through ``prefill_chunk`` — each launch attends the pages
        already written for its rows (carried block tables, full attention)
        plus the in-flight chunk (causal), and each completed chunk's
        blocks land in pool page slots before the next chunk launches.

        Peak prefill KV is O(chunk_len): the monolithic [L, B, S, KV, Dh]
        collect buffer never exists, so admissible prompt length is bounded
        by pool pages (the claim substrate), not by what one launch can
        hold — the last dense-shaped memory cliff in the serving stack.

        Invariants:
        - chunks are block-aligned and the bucket guarantees every row's
          full blocks cover every chunk start, so ``prefix_len`` is uniform
          per chunk and the chunk contract (queries at prefix_len + c)
          holds for every row;
        - each row's chain is PINNED as it grows (``pin_chain`` semantics
          via ``_store_prefix_blocks``): a bucket-mate's store in a later
          chunk can never evict a page a live block table attends;
        - a mid-prefill store failure (PoolExhausted) unwinds THAT row's
          pins and refuses it with allocation attribution
          (``scheduler_admission_refused`` stage=allocation) — the same
          ordered claim-scoped outcome the monolithic path yields; bucket
          mates continue untouched;
        - claims materialize at ``prefill_complete`` after the final
          chunk, with metadata bound from the first chunk's stores, and
          the decode entry (tail + logits) comes from the SAME paged feed
          executable as continuations (parity stays structural).
        """
        # The per-chunk mechanics (carried block tables, per-chunk stores,
        # pinning, PoolExhausted refusal, launch-failure abort) live in
        # scheduler_loop.PrefillJob — the SAME object the unified step loop
        # advances one chunk per step.  Here (prefill_logits / entry-based
        # callers) the job runs to completion synchronously.
        bs = self.block_size
        job = PrefillJob(self, reqs)
        while not job.done:
            job.advance()
        entries = []
        alive = list(job.alive)
        pages = self._device_pages() if alive else None
        for i in alive:
            req = reqs[i]
            self._materialize_claims(req, lens[i] - lens[i] % bs)
            try:
                entries.append(self._continue_paged(req, job.chains[i], pages))
            finally:
                unpin_chain(job.chains[i])  # the entry holds its own pins
        return entries

    def _prefill_collect_store(
        self, reqs: List[Request]
    ) -> List[Tuple[Request, List[KVBlock], int]]:
        """Step-loop entry for the legacy monolithic collect graph
        (``prefill_chunk=0``): ONE padded+masked [B, S] launch, stores, and
        returns (req, pinned_chain, cached_tokens) triples — the step loop
        feeds/materializes them through the same mixed launches as chunked
        rows.  PoolExhausted refuses per-row; other launch exceptions
        propagate for the caller's fail-closed boundary."""
        B = _round_up(len(reqs), BATCH_PAD)
        lens = [len(r.tokens) for r in reqs]
        lens += [lens[0]] * (B - len(reqs))
        S = _round_up(max(lens), self.block_size)
        tokens = np.zeros((B, S), np.int32)
        for i in range(B):
            r = reqs[i] if i < len(reqs) else reqs[0]
            tokens[i, : len(r.tokens)] = r.tokens
        t0 = time.monotonic()
        logits, ck, cv = self._step_prefill_collect(
            self.params,
            {
                "tokens": torch.from_numpy(tokens).to(self.device),
                "valid_len": torch.tensor(lens, dtype=torch.int32, device=self.device),
            },
        )
        device_sync(self.device)
        self._observe_stage("prefill", time.monotonic() - t0)
        stored: List[Tuple[Request, List[KVBlock], int]] = []
        for i, req in enumerate(reqs):
            n = lens[i]
            try:
                blocks = self._store_prefix_blocks(req, ck[:, i], cv[:, i], n)
            except PoolExhausted as e:
                self._refuse_allocation(req, e)
                continue
            stored.append((req, blocks, n - n % self.block_size))
        return stored

    # ------------------------------------------------------------- dense phase
    def _prepare_dense(self, req: Request, dev_blocks: List[KVBlock]) -> Dict[str, Any]:
        """Dense-assembly prefill (decode_mode="dense"): a fresh prompt runs
        one full-length prefill; a cached prefix is gathered into a
        contiguous per-request cache and the uncached suffix (or, for an
        exact-prefix hit, the last prompt token) is replayed one token at a
        time through the decode step."""
        cached = req.cached_tokens
        dev = self.device
        tok = lambda t: torch.tensor([t], dtype=torch.int32, device=dev)
        pin_chain(dev_blocks)
        try:
            if cached == 0:
                t0 = time.monotonic()
                logits, cache = self._step_prefill(
                    self.params, {"tokens": torch.tensor([req.tokens], dtype=torch.int32, device=dev)}
                )
                device_sync(dev)
                self._observe_stage("prefill", time.monotonic() - t0)
                logits = logits[0]
            else:
                cache, _n = self._dense_cache(dev_blocks)
                logits = None
                for i, t in enumerate(req.tokens[cached:]):
                    lg, cache = self._step_decode(self.params, cache, tok(t), tok(cached + i))
                    logits = lg[0]
                if logits is None:  # full prefix cached: replay last token
                    n = len(req.tokens)
                    lg, cache = self._step_decode(
                        self.params, cache, tok(req.tokens[-1]), tok(n - 1)
                    )
                    logits = lg[0]
            ck = cache["k"][:, 0]  # [L, Sc, KV, Dh], copied into pages on the device
            cv = cache["v"][:, 0]
            # dense decode owns a private cache copy, so the pins taken by
            # the store (to protect the chain mid-store) release right away
            unpin_chain(self._store_prefix_blocks(req, ck, cv, len(req.tokens)))
            self._materialize_claims(
                req, len(req.tokens) - len(req.tokens) % self.block_size
            )
        finally:
            unpin_chain(dev_blocks)
        return {"req": req, "cache": cache, "logits": logits, "pos": len(req.tokens)}

    @staticmethod
    def _stack_caches(caches: List[Dict[str, torch.Tensor]]) -> Dict[str, torch.Tensor]:
        """Stack B single-request dense caches into one [B]-batched cache:
        ``pos`` is [B, Sc] (batch axis 0); ``k``/``v`` (and an int8 cache's
        ``k_scale``/``v_scale``) carry the batch on axis 1."""
        return {
            key: torch.cat([c[key] for c in caches], dim=0 if key == "pos" else 1)
            for key in caches[0]
        }

    def _decode_dense(self, entries: List[Dict[str, Any]]) -> None:
        reqs = [e["req"] for e in entries]
        cache = self._stack_caches([e["cache"] for e in entries])
        logits = torch.stack([e["logits"] for e in entries])  # [B, V]
        step = lambda c, t, p: self._step_decode(self.params, c, t, p)
        self._greedy_decode_loop(reqs, cache, logits, [e["pos"] for e in entries], step)

    # ---------------------------------------------------------------- execution
    def _refuse_allocation(self, req: Request, e: PoolExhausted) -> None:
        """Mid-prefill allocation hit protected-claim blocks: refuse THIS
        request with blocking-claim attribution (per-request isolation)."""
        req.status = "refused"
        req.error = str(e)
        self.fail_closed.increment("allocation_conflict")
        self.events.emit(
            "scheduler_admission_refused",
            request_id=req.request_id,
            blocking_claim_ids=e.blocking_claim_ids,
            conflict_action="refuse",
            stage="allocation",
            trigger="allocation_conflict",
        )
        self.events.emit(
            "request_finished",
            request_id=req.request_id,
            status="REFUSED_ADMISSION",
        )

    def run(self, req: Request) -> Request:
        """Execute a request to completion (prefill + greedy decode)."""
        return self.run_batch([req])[0]

    def prefill_logits(self, tokens: Sequence[int], max_new_tokens: int = 1) -> np.ndarray:
        """Admission + restore + prefill for one request, returning its
        pre-decode logits [V] as float32 numpy — the comparison surface for
        parity tests and benches.  Block pins are balanced internally; the
        request is left un-decoded."""
        req = self.submit(tokens, max_new_tokens=max_new_tokens)
        dev = self._admit_and_restore(req)
        if dev is None:
            raise RuntimeError(f"request terminated: {req.status} ({req.error})")
        if self.decode_mode != "paged":
            entry = self._prepare_dense(req, dev)
            return entry["logits"].float().cpu().numpy()
        if req.cached_tokens:
            entry = self._continue_paged(req, dev)
        else:
            entries = self._prefill_bucket([req])
            if not entries:  # refused at the allocation stage
                raise RuntimeError(f"request terminated: {req.status} ({req.error})")
            entry = entries[0]
        unpin_chain(entry["blocks"])
        return entry["logits"].float().cpu().numpy()

    def run_batch(self, reqs: Sequence[Request]) -> List[Request]:
        """Continuous batching through the unified token-budget step loop
        (scheduler_loop.StepLoop): requests enter the waiting queue in
        submission order and are admitted FIFO; every scheduler step
        carries all live decode/feed rows plus at most one prefill chunk
        under ``max_tokens_per_step``; completion mid-stream frees pages
        immediately.

        Per-request event ordering (E0 .. terminal) is exactly the
        single-request stream (check_step_interleave_order enforces the
        grammar over any interleaving); claim-scoped admission refusals and
        fail-closed restoration outcomes drop a request from the batch
        without affecting the others (PoolExhausted attribution and
        blocking_claim_ids are per-request, as in witness path C), and a
        launch failure terminates its rows through the fail-closed boundary
        (``_fail_closed_error``) instead of escaping with requests stranded
        non-terminal.  Dense mode runs phased instead: every request is
        admitted and prefilled in turn, then one batched greedy decode runs
        them together; its launch failure fails every row closed.
        """
        reqs = list(reqs)
        # --- expiry boundary sweep precedes scheduling; an expired claim's
        # blocks lose that claim's membership (and its priority boost) but
        # stay resident for their remaining sharers ---
        self._release_claim_blocks(self.scheduler.sweep_expiry())
        # uniform for EVERY batch size (including 1): span tracing and
        # metrics reconciliation never special-case singletons
        self.events.emit(
            "batch_scheduled",
            batch_size=len(reqs),
            request_ids=[r.request_id for r in reqs],
        )
        if self.decode_mode == "paged":
            StepLoop(self, reqs).run()
            return reqs
        # --- dense mode: phased prefill-then-decode (parity anchor) ---
        entries: List[Dict[str, Any]] = []
        for req in reqs:
            try:
                dev_blocks = self._admit_and_restore(req)
                if dev_blocks is None:
                    continue
                entries.append(self._prepare_dense(req, dev_blocks))
            except PoolExhausted as e:
                self._refuse_allocation(req, e)
                continue
        if entries:
            try:
                self._decode_dense(entries)
            except Exception as e:  # noqa: BLE001 — launch boundary fails closed
                reason = f"{type(e).__name__}: {e}"
                for entry in entries:
                    self._fail_closed_error(
                        entry["req"], scope="decode_step",
                        trigger="decode_launch_failure", reason=reason,
                    )
                return reqs
        for entry in entries:
            self._finish_ok(entry["req"])
        return reqs

"""Unified token-budget step scheduler: mixed prefill+decode engine steps.

``ServingEngine.run_batch`` used to run three strictly separate phases —
admission/restore, prefill buckets, decode — so a burst of new admissions
stalled every in-flight decode stream for the full prefill.  This module
replaces the phased execution with a Sarathi/vLLM-style continuous-batching
step loop (ROADMAP item 1):

  * every scheduler step carries ALL live rows (decoding requests and
    prompt-feeding continuations) in ONE mixed ``paged_decode`` launch,
    plus at most ONE in-flight prefill chunk
    (``models/transformer.prefill_chunk``) under a configurable
    ``max_tokens_per_step`` budget; beside live rows the chunk rides the
    rows' launch (``models/transformer.paged_mixed_step``: one launch a
    step) when its new blocks get free slots without an eviction, and
    runs in its own launch otherwise;
  * waiting requests are admitted/restored BETWEEN steps (claim-scoped
    admission, restore-before-reuse — the shared EngineCore boundary);
  * a request that completes mid-stream leaves the batch immediately, its
    chain unpinned (pages freed for reuse) while the others keep stepping;
  * decode rows are NEVER held back: the budget gates only the prefill
    chunk, so a decode step happens every scheduler step — zero decode
    stalls by construction (``decode_stall_steps_total`` stays 0 and is
    gated in benchmarks/bench_scheduler.py).

Per-request event order is IDENTICAL to the single-request stream: all
step-level events (``step_scheduled``, ``stage_latency``) are engine-scoped
(``request_id=None``) so per-request (name, payload) projections are
byte-identical across batch compositions, and
``core/analyzer.check_step_interleave_order`` replays any log and rejects
cross-request reordering of the E0 -> ... -> terminal grammar.

Bitwise launch parity with the phased path (single request, CPU): a lone
request's chunk launches, feed launches and decode launches carry exactly
the operands the phased path produced — padding rows replicate row 0 with
the same token/position choices ``_continue_paged`` and
``_greedy_decode_loop`` made — so flipping the scheduler does not move any
logits-parity surface.

Fail-closed hardening (launch boundary): a decode- or prefill-launch
exception used to escape ``run_batch`` after the ``finally`` unpin and
strand requests in a non-terminal status.  Here every launch failure is
converted into per-request fail-closed refusals with trigger attribution
(``decode_launch_failure`` / ``prefill_launch_failure``) — ordered
``fail_closed_refused`` -> E14 -> ``request_finished`` FINISHED_ERROR,
chains unpinned, loop continues for unrelated requests.
"""
from __future__ import annotations

import time
from collections import deque
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.serving.kv_cache import KVBlock, PoolExhausted, chain_hash, unpin_chain

__all__ = [
    "BATCH_PAD",
    "DEFAULT_MAX_TOKENS_PER_STEP",
    "FusedChunk",
    "PrefillJob",
    "Row",
    "StepLoop",
    "_round_up",
    "device_sync",
]


def _round_up(n: int, m: int) -> int:
    """Round n up to a multiple of m (minimum m) — bounds the set of launch
    shapes across batches by bucketing block-table / tail shapes."""
    return max(m, ((n + m - 1) // m) * m)


def device_sync(device: torch.device) -> None:
    """Wait for the device: a launch's faults surface inside the caller's
    fail-closed boundary, and stage timings cover the work, not the enqueue."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)


# Batch-width bucket: every prefill launch and decode batch is padded to a
# multiple of this, so sequential (B=1) and batched execution run at the
# SAME widths.  The attention kernels compute each row independently of the
# width, but ``torch.matmul`` may pick another kernel per width; sharing
# widths keeps batched-vs-sequential parity within one set of shapes.
BATCH_PAD = 4

# Per-step token budget default: all live decode/feed rows (1 token each)
# plus at most one prefill chunk (chunk_len x live bucket rows) must fit,
# unless no decode rows are live (livelock guard: a chunk larger than the
# budget still runs when it is the only work).
DEFAULT_MAX_TOKENS_PER_STEP = 256


def _gather_rebuild(k, v, pos, lg, idx, fresh):
    """Device-side membership rebuild: permute the old batched tail state
    (and carried logits) into the new row order, zero-filling rows that
    were not members before (a fresh row has no written tail — zeros and
    position sentinel -1 are exactly what the full state assembly
    produces for it).  Gather copies bytes verbatim, so this path is
    bitwise-identical to the full rebuild — in a few launches instead of
    one copy per row."""
    idx = idx.long()
    fm = fresh[None, :, None, None, None]
    return (
        torch.where(fm, torch.zeros((), dtype=k.dtype, device=k.device), k[:, idx]),
        torch.where(fm, torch.zeros((), dtype=v.dtype, device=v.device), v[:, idx]),
        torch.where(fresh[:, None], torch.full((), -1, dtype=pos.dtype, device=pos.device), pos[idx]),
        torch.where(fresh[:, None], torch.zeros((), dtype=lg.dtype, device=lg.device), lg[idx]),
    )


class Row:
    """One live request in the step loop.

    A row is born from either a restored continuation or a completed
    prefill job, always with a non-empty ``feed`` queue (the uncached
    prompt suffix, or the replayed last token on an exact-prefix hit —
    the same entry rule ``_continue_paged`` applies).  Feed tokens are
    consumed one per step through the SAME mixed launch as decode; when
    the queue empties the row's freshly computed full blocks are stored
    into pool pages and its claims materialize, then greedy decode begins.

    ``blocks`` arrives PINNED (the chain's ref was taken when it became
    this request's prefix) and is unpinned exactly once when the row
    exits — completion, refusal, or launch-failure abort.  A row that
    joins in a fused step rides its first launch before its blocks are
    stored: until ``PrefillJob.take_rows`` hands it its chain, ``pages``
    is its block table (slots its blocks will adopt).
    """

    __slots__ = ("req", "blocks", "plen", "cached", "pos", "feed", "pages")

    def __init__(self, req, blocks: List[KVBlock], cached: int):
        toks = req.tokens
        n = len(toks)
        if cached == n:
            # exact-prefix hit: replay the last token through the tail (its
            # logits pick the first output token) and mask it out of the
            # page side so the position is not double-counted
            plen, feed = n - 1, toks[n - 1 :]
        else:
            plen, feed = cached, toks[cached:]
        self.req = req
        self.blocks = blocks
        self.plen = plen
        self.cached = cached
        self.pos = plen  # next absolute launch position
        self.feed = list(feed)
        self.pages: Optional[List[int]] = None

    @property
    def need(self) -> int:
        """Tail slots this row can ever use: uncached feed + decode output."""
        return (len(self.req.tokens) - self.plen) + self.req.max_new_tokens

    @property
    def decoding(self) -> bool:
        return not self.feed


class FusedChunk:
    """A chunk planned into a step's fused launch (``PrefillJob.plan_fused``):
    ``reserved`` maps each bucket row to {block index: slot} for the blocks
    it stores first, ``slots`` lists the reserved slots in reservation
    order, ``joining`` holds the rows that join in this launch when the
    chunk is the job's last (each with its block table after the chunk as
    ``pages``), and ``operands`` is the chunk's part of the launch
    (``transformer.paged_mixed_step``'s ``chunk``)."""

    __slots__ = ("reserved", "slots", "joining", "operands", "error")

    def __init__(self, reserved, slots, joining, operands):
        self.reserved = reserved
        self.slots = slots
        self.joining = joining
        self.operands = operands
        self.error: Optional[Exception] = None  # the fused launch's, carried to its handling


class PrefillJob:
    """At most one in-flight chunked prefill bucket.

    Carries the exact per-chunk semantics of the run-to-completion chunked
    path (``engine._prefill_bucket_chunked``): block-aligned [B, C]
    launches over carried block tables, per-row stores landing in pool
    pages between launches, chains pinned as they grow, per-row
    PoolExhausted refusal with allocation attribution.  The step loop
    advances it ONE chunk per scheduler step (budget permitting) so decode
    rows interleave with prefill instead of stalling behind it: in its own
    launch (``advance``), or inside the decode rows' launch
    (``plan_fused``, then ``commit`` after ``StepLoop._fused_step``'s
    launch).
    """

    def __init__(self, eng, reqs: Sequence[Any]):
        self.eng = eng
        self.reqs = list(reqs)
        bs = eng.block_size
        self.C = eng.prefill_chunk
        # single-request buckets launch unpadded [1, C] chunks — the
        # latency-sensitive admission case (a lone prompt riding next to
        # live decode rows) pays 1x compute per contended step, not
        # BATCH_PAD x; multi-request buckets pad to BATCH_PAD to bound the
        # executable count (padding rows replicate row 0)
        n_reqs = len(self.reqs)
        B = n_reqs if n_reqs == 1 else _round_up(n_reqs, BATCH_PAD)
        lens = [len(r.tokens) for r in self.reqs]
        lens += [lens[0]] * (B - len(self.reqs))
        # chunk-align the bucket so every launch sees [B, C] tokens (bounds
        # recompiles); right-padding stays causally masked and unstored
        S = _round_up(_round_up(max(lens), bs), self.C)
        tokens = np.zeros((B, S), np.int32)
        for i in range(B):
            r = self.reqs[i] if i < len(self.reqs) else self.reqs[0]
            tokens[i, : len(r.tokens)] = r.tokens
        self.lens = lens
        self.B = B
        self.S = S
        self.tokens = tokens
        # ONE block-table width for the whole bucket: columns beyond the
        # current prefix are masked by prefix_len, so every chunk shares a
        # single compiled executable instead of recompiling as P grows
        self.P = _round_up(S // bs, 4)
        self.chains: List[List[KVBlock]] = [[] for _ in self.reqs]
        self.alive = list(range(len(self.reqs)))
        self.lo = 0

    @property
    def done(self) -> bool:
        return self.lo >= self.S or not self.alive

    @property
    def chunk_tokens(self) -> int:
        """Prefill tokens the next chunk launch contributes to the step
        budget (live bucket rows x chunk length; padding rows are free)."""
        return self.C * len(self.alive)

    def _upto(self, i: int) -> int:
        """End of row ``i``'s full blocks that the next chunk completes."""
        bs = self.eng.block_size
        return min(self.lo + self.C, self.lens[i] - self.lens[i] % bs)

    def _operands(self) -> Dict[str, Any]:
        """The next chunk's launch operands on the device: its [B, C]
        tokens and positions, and its prefix's block tables (the pages
        written so far)."""
        eng = self.eng
        lo, hi = self.lo, self.lo + self.C
        bt = np.zeros((self.B, self.P), np.int32)
        for i in range(self.B):
            # padding rows replicate row 0; refused rows keep their (empty)
            # chain — their outputs are never stored anyway
            pt = eng.pool.page_table(
                self.chains[i] if i < len(self.reqs) else self.chains[0]
            )
            bt[i, : len(pt)] = pt
        dev = eng.device
        return {
            "tokens": torch.from_numpy(np.ascontiguousarray(self.tokens[:, lo:hi])).to(dev),
            "positions": torch.arange(lo, hi, dtype=torch.int32, device=dev)[None].expand(
                self.B, self.C),
            "block_tables": torch.from_numpy(bt).to(dev),
            "prefix_len": torch.full((self.B,), lo, dtype=torch.int32, device=dev),
        }

    def advance(self) -> None:
        """Run ONE chunk in its own launch: a [B, C] launch over the pages
        written so far, then land each row's completed blocks in pool page
        slots (``commit``).

        This runs INSIDE a mixed step next to live decode rows, so its
        host<->device traffic stays small: four small per-chunk operands
        up, and nothing down — the chunk's (k, v) pair is cut into page
        slots on the device.  Per-chunk overhead is what decode ITL pays on
        every contended step."""
        eng = self.eng
        jk, jv = eng._device_pages()
        ops = self._operands()
        state = {
            "k_pages": jk,
            "v_pages": jv,
            "block_tables": ops["block_tables"],
            "prefix_len": ops["prefix_len"],
        }
        t0 = time.monotonic()
        try:
            ck, cv = eng._step_prefill_chunk(eng.params, state, ops["tokens"], ops["positions"])
            device_sync(eng.device)
        except Exception as e:  # noqa: BLE001 — launch boundary fails closed
            self.abort("prefill_launch_failure", f"{type(e).__name__}: {e}")
            return
        eng._observe_stage("prefill_chunk", time.monotonic() - t0)
        self.commit(ck, cv)

    def join_rows(self) -> Dict[int, Row]:
        """The rows that join when the next chunk is the job's last, made
        before their blocks are stored (``take_rows`` hands them their
        chains); none otherwise."""
        if self.lo + self.C < self.S:
            return {}
        bs = self.eng.block_size
        return {i: Row(self.reqs[i], [], self.lens[i] - self.lens[i] % bs) for i in self.alive}

    def plan_fused(self, joining: Dict[int, Row]) -> Optional[FusedChunk]:
        """Plan the next chunk into the step's fused launch, or return None
        when the pool would have to evict for its blocks (the chunk then
        runs in its own launch, as the reference's).  ``joining``: the
        rows of ``join_rows``; each gets its table after the chunk as
        ``pages``.

        Walks the blocks the chunk completes as ``commit`` will store them:
        a block already resident (or stored first by a bucket mate in this
        chunk) keeps that page; each other block gets a free slot from
        ``BlockPool.reserve_pages`` — the slot ``add_block`` would take, in
        its order — which the launch writes and the block adopts at
        ``commit``.  Reserving emits nothing."""
        eng = self.eng
        pool = eng.pool
        bs = eng.block_size
        lo = self.lo
        per_chunk = self.C // bs
        entries: Dict[int, List[Any]] = {}  # row -> resident pages or new-block numbers
        first: Dict[str, int] = {}  # chain hash -> new-block number
        new: List[Tuple[int, int]] = []  # (row, block index), in store order
        for i in self.alive:
            req = self.reqs[i]
            table: List[Any] = list(pool.page_table(self.chains[i]))
            h = eng._chain_root(req)
            for bi in range(self._upto(i) // bs):
                h = chain_hash(h, req.tokens[bi * bs : (bi + 1) * bs])
                if bi * bs < lo:
                    continue
                bid = pool.prefix_index.get(h)
                blk = pool.blocks.get(bid) if bid is not None else None
                if blk is not None and blk.chain == h and not blk.partial:
                    table.append(blk.page_index)
                elif h in first:
                    table.append(("new", first[h]))
                else:
                    first[h] = len(new)
                    table.append(("new", len(new)))
                    new.append((i, bi))
            entries[i] = table
        if len(new) > pool.free_slots:
            return None
        slots: List[int] = []
        if new:
            cfg = eng.cfg
            shape = (cfg.num_layers, bs, cfg.num_kv_heads, cfg.resolved_head_dim)
            slots = pool.reserve_pages(len(new), shape, eng.params["embed"].dtype)
        reserved: Dict[int, Dict[int, int]] = {}
        for (i, bi), slot in zip(new, slots):
            reserved.setdefault(i, {})[bi] = slot
        for i, row in joining.items():
            row.pages = [slots[e[1]] if isinstance(e, tuple) else e for e in entries[i]]
        dev = eng.device
        ops = self._operands()
        blocks = [i * per_chunk + bi - lo // bs for i, bi in new]
        ops["write_blocks"] = (None if blocks == list(range(self.B * per_chunk))
                               else torch.tensor(blocks, dtype=torch.long, device=dev))
        ops["write_pages"] = torch.tensor(slots, dtype=torch.long, device=dev)
        ops["rows_join"] = bool(joining)
        return FusedChunk(reserved, slots, joining, ops)

    def commit(self, ck, cv, fused: Optional[FusedChunk] = None, written: bool = False) -> None:
        """Land each row's completed blocks of the chunk just launched in
        pool page slots, then move on to the next chunk.  ck/cv: [L, B, C,
        KV, Dh] on the device — the chunk, not O(S).  After a fused launch
        (``fused``) each new block takes its reserved slot, adopting the
        bytes the launch wrote there when ``written`` (the launch wrote
        the pool's own store), and any slot left over is given back."""
        eng = self.eng
        lo, hi = self.lo, self.lo + self.C
        for i in list(self.alive):
            req = self.reqs[i]
            upto = self._upto(i)
            if upto <= lo:
                continue
            try:
                self.chains[i].extend(
                    eng._store_prefix_blocks(
                        req, ck[:, i], cv[:, i], upto, start=lo,
                        reserved=None if fused is None else fused.reserved.get(i, {}),
                        written=written,
                    )
                )
            except PoolExhausted as e:
                # fail closed mid-prefill: unwind THIS row's pinned chain;
                # its already-shared pages stay owned by the bucket mates
                # that also pinned them
                unpin_chain(self.chains[i])
                self.chains[i] = []
                eng._refuse_allocation(req, e)
                self.alive.remove(i)
        if fused is not None and fused.slots:
            taken = {b.page_index for b in eng.pool.blocks.values()}
            eng.pool.release_pages([p for p in fused.slots if p not in taken])
        self.lo = hi

    def abort(self, trigger: str, reason: str) -> None:
        """Launch failure: every live row of THIS job fails closed with
        trigger attribution; chains unpinned; the job terminates."""
        for i in self.alive:
            unpin_chain(self.chains[i])
            self.chains[i] = []
            self.eng._fail_closed_error(
                self.reqs[i], scope="prefill_chunk", trigger=trigger, reason=reason
            )
        self.alive = []
        self.lo = self.S

    def take_rows(self, joining: Optional[Dict[int, Row]] = None) -> List[Row]:
        """Job complete: materialize claims at prefill_complete and hand the
        surviving rows (pinned chains transfer) to the step loop.  A row
        that already rode a fused launch (``joining``) receives its chain
        in place of its provisional table."""
        eng = self.eng
        bs = eng.block_size
        rows = []
        for i in self.alive:
            req = self.reqs[i]
            n = self.lens[i]
            eng._materialize_claims(req, n - n % bs)
            row = (joining or {}).get(i)
            if row is None:
                row = Row(req, self.chains[i], n - n % bs)
            else:
                row.blocks, row.pages = self.chains[i], None
            rows.append(row)
        self.alive = []
        return rows


class StepLoop:
    """The unified continuous-batching executor behind ``run_batch``
    (paged mode).  One instance per run_batch call; requests submitted
    together enter the waiting queue in order and are admitted FIFO.

    A step that runs a prefill chunk beside live rows runs both as ONE
    launch (``_fused_step``, ``transformer.paged_mixed_step``) when the
    chunk's new blocks get free slots without an eviction; any other
    chunk step runs the reference's launches (the chunk alone, then the
    decode rows).  The route is chosen before launching and counted on
    ``scheduler_chunk_steps_total{route}``; the events, tokens and
    refusals are the reference's on either route."""

    def __init__(self, eng, reqs: Sequence[Any]):
        self.eng = eng
        self.waiting = deque(reqs)
        self.pending_fresh: List[Any] = []  # admitted fresh prompts, FIFO
        self.rows: List[Row] = []
        self.job: Optional[PrefillJob] = None
        self.step_idx = 0
        # device-state cache across steps (rebuilt only on membership change)
        self._state: Optional[Dict[str, Any]] = None
        self._logits = None  # [W, V] device array aligned with _members
        self._members: List[Row] = []  # rows the current state was built for
        self._tail_cap = 0
        self._pad_pos: Optional[int] = None  # frozen pad-row position (decode)

    # ------------------------------------------------------------- admission
    def _admit(self) -> None:
        """Drain the waiting queue (between steps): continuations join the
        live rows immediately (restore-before-reuse ran, chain pinned);
        fresh prompts queue FIFO for the next prefill job slot."""
        eng = self.eng
        while self.waiting:
            req = self.waiting.popleft()
            try:
                dev_blocks = eng._admit_and_restore(req)
            except PoolExhausted as e:
                eng._refuse_allocation(req, e)
                continue
            if dev_blocks is None:
                continue  # terminated at the admission/restore boundary
            if req.cached_tokens == 0:
                self.pending_fresh.append(req)
            else:
                # pin immediately: a later store (chunk or feed) must not
                # evict this request's prefix before its turn comes
                from repro_torch.serving.kv_cache import pin_chain

                # lint: allow[pin-balance] ownership transfers to the Row: released in _retire, _store_row's handlers, and the decode-launch failure path
                pin_chain(dev_blocks)
                self.rows.append(Row(req, dev_blocks, req.cached_tokens))

    def _start_job(self) -> None:
        """FIFO job admission: the oldest pending fresh prompt opens the
        next prefill bucket, pulling its same-bucket mates forward (bucket
        sharing: N same-bucket prompts ride ONE [B, C] launch sequence)."""
        if self.job is not None or not self.pending_fresh:
            return
        eng = self.eng
        head = self.pending_fresh[0]
        key = _round_up(len(head.tokens), eng.block_size)
        bucket = [
            r
            for r in self.pending_fresh
            if _round_up(len(r.tokens), eng.block_size) == key
        ]
        self.pending_fresh = [r for r in self.pending_fresh if r not in bucket]
        if eng.prefill_chunk:
            self.job = PrefillJob(eng, bucket)
        else:
            # legacy monolithic collect launch (prefill_chunk=0 opt-out):
            # runs synchronously between steps, unbudgeted — kept for the
            # O(S) ceiling benchmark and cross-graph parity anchors
            try:
                stored = eng._prefill_collect_store(bucket)
            except Exception as e:  # noqa: BLE001 — launch boundary fails closed
                for req in bucket:
                    if req.status == "running":
                        eng._fail_closed_error(
                            req,
                            scope="prefill_collect",
                            trigger="prefill_launch_failure",
                            reason=f"{type(e).__name__}: {e}",
                        )
                return
            self.rows.extend(Row(req, blocks, cached) for req, blocks, cached in stored)

    # ------------------------------------------------------------ step state
    def _table(self, row: Row) -> List[int]:
        return row.pages if row.pages is not None else self.eng.pool.page_table(row.blocks)

    def _sync_state(self, pages: Tuple[Any, Any]) -> None:
        """(Re)build the batched device state when row membership changed;
        otherwise just swap in the step's ``pages``.

        ``pages`` is the ``_device_pages()`` pair taken at the START of the
        step: the pool's own store, which this step's chunk then writes in
        place.  The decode rows pin every page they reference, so pages
        stored (or evicted slots reused) later in the same step are slots
        no live block table reads (``kv_cache.BlockPool``).  The swap
        matters only on the step that allocates the store: until then the
        pair is a one-page stand-in."""
        eng = self.eng
        rows = self.rows
        if self._state is not None and self._members == rows:
            jk, jv = pages
            self._state["k_pages"] = jk
            self._state["v_pages"] = jv
            return
        tail_cap = _round_up(max(r.need for r in rows), 8)
        W = _round_up(len(rows), BATCH_PAD)
        pad = W - len(rows)
        old_index = {id(r): i for i, r in enumerate(self._members)}
        tables = [self._table(r) for r in rows]
        tables += [tables[0]] * pad
        blocks_per = [r.blocks for r in rows] + [rows[0].blocks] * pad
        plens = [r.plen for r in rows] + [rows[0].plen] * pad
        if (
            self._state is not None
            and self._logits is not None
            and tail_cap == self._tail_cap
        ):
            # membership-only change at the same tail capacity (the common
            # mid-stream join/leave): permute tails + carried logits in one
            # gather instead of a state assembly row by row — this rebuild
            # sits on the contended step's critical path, right where
            # admitted rows enter the batch
            idx_rows = [old_index.get(id(r), 0) for r in rows]
            fresh = [id(r) not in old_index for r in rows]
            idx = np.asarray(idx_rows + [idx_rows[0]] * pad, np.int32)
            fm = np.asarray(fresh + [fresh[0]] * pad, bool)
            d_idx = torch.from_numpy(idx).to(eng.device)
            d_fm = torch.from_numpy(fm).to(eng.device)
            gk, gv, gpos, glg = _gather_rebuild(
                self._state["k_tail"],
                self._state["v_tail"],
                self._state["tail_pos"],
                self._logits,
                d_idx,
                d_fm,
            )
            P = _round_up(max(len(t) for t in tables), 4)
            bt = np.zeros((W, P), np.int32)
            for i, pt in enumerate(tables):
                bt[i, : len(pt)] = pt
            jk, jv = pages
            d_bt = torch.from_numpy(bt).to(eng.device)
            d_plens = torch.tensor(plens, dtype=torch.int32, device=eng.device)
            self._state = {
                "k_pages": jk,
                "v_pages": jv,
                "block_tables": d_bt,
                "prefix_len": d_plens,
                "k_tail": gk,
                "v_tail": gv,
                "tail_pos": gpos,
            }
            self._logits = glg
        else:
            old_k = old_v = old_lg = None
            if self._state is not None:  # the old tails, copied on the device
                old_k = self._state["k_tail"]
                old_v = self._state["v_tail"]
                old_lg = self._logits
            tails: List[Optional[Dict[str, Any]]] = []
            for r in rows:
                t = r.pos - r.plen  # written tail slots
                oi = old_index.get(id(r))
                if t == 0 or oi is None or old_k is None:
                    tails.append(None)
                else:
                    tails.append(
                        {
                            "k": old_k[:, oi, :t],
                            "v": old_v[:, oi, :t],
                            "pos": np.arange(r.plen, r.pos),
                        }
                    )
            tails = tails + [tails[0]] * pad  # padding rows replicate row 0
            self._state = eng._make_paged_state(
                blocks_per, plens, tail_cap, tails=tails, pages=pages, page_tables=tables
            )
            # surviving decode rows keep their pre-rebuild logits (a copy,
            # bitwise); rows that have not launched yet are still feeding
            # and never consume a logits slot before their first launch
            if old_lg is not None:
                idx_rows = [old_index.get(id(r)) for r in rows]
                idx = np.asarray([0 if oi is None else oi for oi in idx_rows], np.int32)
                fm = np.asarray([oi is None for oi in idx_rows], bool)
                idx = np.concatenate([idx, np.repeat(idx[:1], pad)])
                fm = np.concatenate([fm, np.repeat(fm[:1], pad)])
                d_fm = torch.from_numpy(fm).to(eng.device)
                self._logits = torch.where(
                    d_fm[:, None],
                    torch.zeros((), dtype=old_lg.dtype, device=old_lg.device),
                    old_lg[torch.from_numpy(idx).to(eng.device).long()],
                )
            else:
                self._logits = None
        self._members = list(rows)
        self._tail_cap = tail_cap
        # pad rows mirror row 0 while it feeds; once row 0 decodes they
        # freeze at its build-time position (exactly _decode_paged's pads)
        self._pad_pos = rows[0].pos if rows[0].decoding else None

    # ------------------------------------------------------------ mixed step
    def _carried_tokens(self) -> np.ndarray:
        """Every state row's greedy token from the carried logits (zeros
        while every row feeds)."""
        W = _round_up(len(self.rows), BATCH_PAD)
        if self._logits is not None:
            return torch.argmax(self._logits, dim=-1).to(torch.int32).cpu().numpy()
        return np.zeros(W, np.int32)

    def _consume(self, toks: np.ndarray):
        """The step's effect on its rows: a feeding row gives up its next
        prompt token, a decoding row takes its greedy token ``toks[i]`` as
        output.  Returns (fed {id(row): token}, finishing [(i, row)] whose
        feed empties now, n_decode, n_feed)."""
        fed: Dict[int, int] = {}
        finishing: List[Tuple[int, Row]] = []
        n_feed = n_dec = 0
        now = time.monotonic()
        for i, row in enumerate(self.rows):
            if row.feed:
                fed[id(row)] = row.feed.pop(0)
                n_feed += 1
                if not row.feed:
                    finishing.append((i, row))
            else:
                row.req.output_tokens.append(int(toks[i]))
                if row.req.first_token_ts is None:
                    row.req.first_token_ts = now
                n_dec += 1
        return fed, finishing, n_dec, n_feed

    def _operands(self, toks: np.ndarray, fed: Dict[int, int], row0_feeding: bool):
        """The decode launch's (tokens, positions) [W]: fed tokens for
        feeding rows, ``toks`` for decoding ones, each row at its
        position; padding rows replicate row 0's launch while it feeds
        (the _continue_paged feed form), else take their own argmax at a
        frozen position (the _greedy_decode_loop pad form)."""
        rows = self.rows
        toks = toks.copy()
        poss = np.zeros(len(toks), np.int32)
        for i, row in enumerate(rows):
            if id(row) in fed:
                toks[i] = fed[id(row)]
            poss[i] = row.pos
        if row0_feeding:
            toks[len(rows) :] = toks[0]
            poss[len(rows) :] = poss[0]
        else:
            if self._pad_pos is None:
                self._pad_pos = rows[0].pos
            poss[len(rows) :] = self._pad_pos
        return toks, poss

    def _begin_step(self) -> bool:
        """Completion check BEFORE launching: a row that already served
        its max_new_tokens (e.g. max_new_tokens=0 edge) exits without a
        launch.  True when rows are left."""
        for row in list(self.rows):
            if row.decoding and len(row.req.output_tokens) >= row.req.max_new_tokens:
                self._retire(row)
        return bool(self.rows)

    def _mixed_step(self, pages: Tuple[Any, Any]) -> Tuple[int, int]:
        """ONE launch carrying every live row — decode rows consume their
        argmax, feeding rows consume the next prompt token.  Returns
        (n_decode, n_feed) row counts for the step accounting."""
        if not self._begin_step():
            return (0, 0)
        self._sync_state(pages)
        toks = self._carried_tokens()
        row0_feeding = bool(self.rows[0].feed)
        fed, finishing, n_dec, n_feed = self._consume(toks)
        self._launch_decode(*self._operands(toks, fed, row0_feeding), finishing)
        return (n_dec, n_feed)

    def _launch_decode(self, toks: np.ndarray, poss: np.ndarray,
                       finishing: List[Tuple[int, Row]]) -> None:
        """The decode rows' own launch, then its commit; a launch failure
        fails every row closed."""
        eng = self.eng
        t0 = time.monotonic()
        try:
            lg, state = eng._step_paged_decode(
                eng.params,
                self._state,
                torch.from_numpy(toks).to(eng.device),
                torch.from_numpy(poss).to(eng.device),
            )
            device_sync(eng.device)
        except Exception as e:  # noqa: BLE001 — launch boundary fails closed
            reason = f"{type(e).__name__}: {e}"
            for row in self.rows:
                unpin_chain(row.blocks)
                eng._fail_closed_error(
                    row.req, scope="decode_step", trigger="decode_launch_failure",
                    reason=reason,
                )
            self._drop_state()
            return
        eng._observe_stage("decode_step", time.monotonic() - t0)
        self._commit_decode(lg, state, finishing)

    def _drop_state(self) -> None:
        self.rows = []
        self._state = None
        self._logits = None
        self._members = []

    def _commit_decode(self, lg, state, finishing: List[Tuple[int, Row]]) -> None:
        self._state = state
        self._logits = lg
        for row in self.rows:
            row.pos += 1
        # rows whose feed just emptied: store freshly computed full blocks
        # into pool pages and materialize claims (the prefill_complete
        # observation point) before their first decode step
        for i, row in finishing:
            self._finish_feed(i, row)
        # rows that served their final token ride this launch out, then free
        # their pages immediately (mid-stream completion)
        for row in list(self.rows):
            if row.decoding and len(row.req.output_tokens) >= row.req.max_new_tokens:
                self._retire(row)

    # ------------------------------------------------------------ fused step
    def _plan_chunk(self) -> Optional[FusedChunk]:
        """Choose the route of a step whose chunk runs, before launching,
        and count it: ``fused`` when the step has live rows, the bundle has
        the fused entry, no row retires before launching and the chunk's
        new blocks get free slots without an eviction (slots reserved
        then); else the chunk runs in its own launch, as the reference."""
        eng = self.eng
        plan = None
        joining = self.job.join_rows()
        if not self.rows:
            route = "alone"
        elif eng._step_mixed is None:
            route = "no_fused_entry"
        elif any(r.decoding and len(r.req.output_tokens) >= r.req.max_new_tokens
                 for r in self.rows + list(joining.values())):
            # the reference retires such a row before its decode launch,
            # after the chunk's stores (an empty prompt that asks for no
            # token joins that way)
            route = "retiring_row"
        else:
            plan = self.job.plan_fused(joining)
            route = "eviction" if plan is None else "fused"
        eng.chunk_routes.inc(route=route)
        return plan

    def _fused_step(self, plan: FusedChunk) -> Tuple[int, int]:
        """The decode rows and the job's chunk in ONE launch
        (``transformer.paged_mixed_step``), then the reference's order:
        the chunk's stores (adopting the reserved slots) and refusals, the
        joining rows' claims, then the decode rows' feed completion and
        retirement.  On the job's last chunk its rows join this launch
        already, their tables naming the reserved slots, as the
        reference's rows join the decode launch after the chunk's.

        A launch that raises fails closed by the side whose code raised
        (``transformer.MixedStepError``), never retried as a split step:
        the chunk side aborts the job (``prefill_launch_failure``) and the
        decode rows run in their own launch, as after a failed chunk; the
        decode side runs the chunk in its own launch and commits it, then
        fails the rows (``decode_launch_failure``); shared code fails both,
        the chunk's rows first.  Returns (n_decode, n_feed)."""
        eng, job = self.eng, self.job
        old_rows = list(self.rows)
        joining = plan.joining
        saved = (self._state, self._logits, self._members, self._tail_cap, self._pad_pos)
        self.rows = old_rows + list(joining.values())
        pages = eng._device_pages()
        self._sync_state(pages)
        toks = self._carried_tokens()
        row0_feeding = bool(self.rows[0].feed)
        fed, finishing, n_dec, n_feed = self._consume(toks)
        d_toks, d_poss = self._operands(toks, fed, row0_feeding)
        t0 = time.monotonic()
        try:
            lg, state, ck, cv = eng._step_mixed(
                eng.params, self._state, torch.from_numpy(d_toks).to(eng.device),
                torch.from_numpy(d_poss).to(eng.device), plan.operands,
            )
            device_sync(eng.device)
        except Exception as e:  # noqa: BLE001 — carried to _fail_fused, which fails closed
            plan.error = e
        if plan.error is not None:
            self.rows = old_rows
            finishing = [(i, row) for i, row in finishing if row in old_rows]
            n_feed -= len(joining)
            n_feed += self._fail_fused(plan, pages, saved, fed, row0_feeding, finishing)
            return (n_dec, n_feed)
        eng._observe_stage("mixed_step", time.monotonic() - t0)
        job.commit(ck, cv, plan, written=pages[0] is eng.pool.k_pages)
        if job.done:
            job.take_rows(joining)
            self.job = None
        # a joining row refused at its store never joined
        gone = [r for r in joining.values() if r.pages is not None]
        if gone:
            self.rows = [r for r in self.rows if r not in gone]
            finishing = [(i, r) for i, r in finishing if r not in gone]
            n_feed -= len(gone)
        self._commit_decode(lg, state, finishing)
        return (n_dec, n_feed)

    def _fail_fused(self, plan: FusedChunk, pages, saved, fed, row0_feeding, finishing) -> int:
        """Fail a fused launch closed by the side whose code raised
        (``MixedStepError.side``; anything else is shared code), releasing
        the reserved slots first.  ``self.rows`` holds the rows that were
        live before the step.  Returns the rows that joined (they fed in
        the reference's decode launch)."""
        from repro_torch.models.transformer import MixedStepError

        eng, job, err = self.eng, self.job, plan.error
        side = err.side if isinstance(err, MixedStepError) else "shared"
        if isinstance(err, MixedStepError):
            err = err.error
        reason = f"{type(err).__name__}: {err}"
        eng.pool.release_pages(plan.slots)
        if side == "chunk":
            # a failed chunk: the job fails closed and the decode rows run
            # in their own launch over the state they had before the step
            job.abort("prefill_launch_failure", reason)
            self.job = None
            self._state, self._logits, self._members, self._tail_cap, self._pad_pos = saved
            self._sync_state(pages)
            self._launch_decode(*self._operands(self._carried_tokens(), fed, row0_feeding),
                                finishing)
            return 0
        if side == "decode":
            # the chunk ran before the decode launch in the reference: it
            # runs in its own launch and commits, its rows join, and every
            # row then fails with the decode launch
            job.advance()
        else:
            job.abort("prefill_launch_failure", reason)
        joined = job.take_rows() if job.done else []
        if job.done:
            self.job = None
        self.rows.extend(joined)
        for row in self.rows:
            unpin_chain(row.blocks)
            eng._fail_closed_error(
                row.req, scope="decode_step", trigger="decode_launch_failure", reason=reason,
            )
        self._drop_state()
        return len(joined)

    def _finish_feed(self, idx: int, row: Row) -> None:
        eng = self.eng
        req = row.req
        n = len(req.tokens)
        bs = eng.block_size
        try:
            if row.cached < n:
                # freshly computed KV folds back into pool pages along the
                # radix path: full blocks are cut from the tail, a matched
                # partial block grows in place (or COWs if shared)
                tk = self._state["k_tail"][:, idx]
                tv = self._state["v_tail"][:, idx]
                eng._fold_sequence_blocks(
                    req, req.tokens, tk, tv, row.plen, held_blocks=row.blocks
                )
            # the named observation point applies to exact-prefix hits too
            eng._materialize_claims(req, n - n % bs)
        except PoolExhausted as e:
            unpin_chain(row.blocks)
            eng._refuse_allocation(req, e)
            self.rows.remove(row)
        except Exception as e:  # noqa: BLE001 — store boundary fails closed
            unpin_chain(row.blocks)
            eng._fail_closed_error(
                req, scope="prefill_store", trigger="prefill_store_failure",
                reason=f"{type(e).__name__}: {e}",
            )
            self.rows.remove(row)

    def _retire(self, row: Row) -> None:
        # fold the finished row's decode tail back into pool pages BEFORE
        # the unpin: generated tokens become reusable radix prefix for any
        # later request (best-effort — a full pool skips it).  Only
        # possible while the row's tail still sits in the batched state.
        if self._state is not None and row in self._members:
            idx = self._members.index(row)
            t = row.pos - row.plen
            if t > 0:
                tk = self._state["k_tail"][:, idx, :t]
                tv = self._state["v_tail"][:, idx, :t]
                self.eng._readmit_decode_tail(row.req, row.blocks, row.plen, tk, tv)
        unpin_chain(row.blocks)
        self.eng._finish_ok(row.req)
        self.rows.remove(row)

    # ------------------------------------------------------------------ drive
    def run(self) -> None:
        eng = self.eng
        budget = eng.max_tokens_per_step
        while self.waiting or self.pending_fresh or self.rows or self.job:
            self._admit()
            self._start_job()
            # the page store for this step (the pool's own tensors; the
            # chunk below writes into it in slots no live table reads, see
            # _sync_state)
            pages = eng._device_pages()
            prefill_tokens = 0
            prefill_rows = 0
            stalled = bool(self.rows)
            counts = None
            # chunk side: at most one in-flight prefill chunk per step, only
            # when it fits the budget next to the live rows — unless there
            # are no live rows (livelock guard: an oversized chunk still
            # runs as the only work of the step)
            if self.job is not None:
                cost = self.job.chunk_tokens
                if not self.rows or len(self.rows) + cost <= budget:
                    prefill_rows = len(self.job.alive)
                    prefill_tokens = cost
                    plan = self._plan_chunk()
                    if plan is not None:
                        counts = self._fused_step(plan)
                    else:
                        self.job.advance()
                        if self.job.done:
                            self.rows.extend(self.job.take_rows())
                            self.job = None
                            # the joined rows feed THIS step and their block
                            # tables reference the job's freshly stored
                            # pages: the store exists now even if it did not
                            # at the step's start
                            pages = eng._device_pages()
            # decode side: every live row launches every step — the budget
            # never holds a decode row back (zero decode stalls)
            if counts is None:
                stalled = bool(self.rows)
                counts = self._mixed_step(pages) if self.rows else (0, 0)
            n_dec, n_feed = counts
            launched_mixed = (n_dec + n_feed) > 0
            if stalled and not launched_mixed and prefill_tokens == 0:
                # structurally unreachable; counted (and gated to 0 in
                # bench_scheduler) rather than assumed
                eng.decode_stalls.inc()
            if launched_mixed or prefill_tokens:
                step_tokens = n_dec + n_feed + prefill_tokens
                eng.step_tokens.observe(step_tokens)
                eng.step_occupancy.set(step_tokens / budget)
                eng.events.emit(
                    "step_scheduled",
                    step=self.step_idx,
                    n_rows=n_dec + n_feed,
                    n_decode=n_dec,
                    n_feed=n_feed,
                    prefill_rows=prefill_rows,
                    prefill_tokens=prefill_tokens,
                    step_tokens=step_tokens,
                    budget=budget,
                )
                self.step_idx += 1
            # point-in-time sharing gauge (reconcile-exempt by nature)
            eng.pages_shared.set(eng.pool.shared_page_count())

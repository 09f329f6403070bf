"""Unified token-budget step scheduler: mixed prefill+decode engine steps.

``ServingEngine.run_batch`` used to run three strictly separate phases —
admission/restore, prefill buckets, decode — so a burst of new admissions
stalled every in-flight decode stream for the full prefill.  This module
replaces the phased execution with a Sarathi/vLLM-style continuous-batching
step loop (ROADMAP item 1):

  * every scheduler step carries ALL live rows (decoding requests and
    prompt-feeding continuations) in ONE mixed ``paged_decode`` launch,
    plus at most ONE in-flight chunked-prefill launch
    (``models/transformer.prefill_chunk``) under a configurable
    ``max_tokens_per_step`` budget;
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

from repro_torch.serving.kv_cache import KVBlock, PoolExhausted, unpin_chain

__all__ = [
    "BATCH_PAD",
    "DEFAULT_MAX_TOKENS_PER_STEP",
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
    exits — completion, refusal, or launch-failure abort.
    """

    __slots__ = ("req", "blocks", "plen", "cached", "pos", "feed")

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

    @property
    def need(self) -> int:
        """Tail slots this row can ever use: uncached feed + decode output."""
        return (len(self.req.tokens) - self.plen) + self.req.max_new_tokens

    @property
    def decoding(self) -> bool:
        return not self.feed


class PrefillJob:
    """At most one in-flight chunked prefill bucket.

    Carries the exact per-chunk semantics of the run-to-completion chunked
    path (``engine._prefill_bucket_chunked``): block-aligned [B, C]
    launches over carried block tables, per-row stores landing in pool
    pages between launches, chains pinned as they grow, per-row
    PoolExhausted refusal with allocation attribution.  The step loop
    advances it ONE chunk per scheduler step (budget permitting) so decode
    rows interleave with prefill instead of stalling behind it.
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

    def advance(self) -> None:
        """Run ONE chunk: a [B, C] launch over the pages written so far,
        then land each row's completed blocks in pool page slots.

        This runs INSIDE a mixed step next to live decode rows, so its
        host<->device traffic stays small: four small per-chunk operands
        up, and nothing down — the chunk's (k, v) pair is cut into page
        slots on the device.  Per-chunk overhead is what decode ITL pays on
        every contended step."""
        eng = self.eng
        bs = eng.block_size
        lo, hi = self.lo, self.lo + self.C
        jk, jv = eng._device_pages()
        bt = np.zeros((self.B, self.P), np.int32)
        for i in range(self.B):
            # padding rows replicate row 0; refused rows keep their (empty)
            # chain — their outputs are never stored anyway
            pt = eng.pool.page_table(
                self.chains[i] if i < len(self.reqs) else self.chains[0]
            )
            bt[i, : len(pt)] = pt
        dev = eng.device
        d_bt = torch.from_numpy(bt).to(dev)
        d_prefix = torch.full((self.B,), lo, dtype=torch.int32, device=dev)
        d_toks = torch.from_numpy(np.ascontiguousarray(self.tokens[:, lo:hi])).to(dev)
        d_pos = torch.arange(lo, hi, dtype=torch.int32, device=dev)[None].expand(self.B, self.C)
        state = {
            "k_pages": jk,
            "v_pages": jv,
            "block_tables": d_bt,
            "prefix_len": d_prefix,
        }
        t0 = time.monotonic()
        try:
            ck, cv = eng._step_prefill_chunk(eng.params, state, d_toks, d_pos)
            device_sync(dev)
        except Exception as e:  # noqa: BLE001 — launch boundary fails closed
            self.abort("prefill_launch_failure", f"{type(e).__name__}: {e}")
            return
        eng._observe_stage("prefill_chunk", time.monotonic() - t0)
        # ck/cv: [L, B, C, KV, Dh] on the device — the chunk, not O(S)
        for i in list(self.alive):
            req = self.reqs[i]
            upto = min(hi, self.lens[i] - self.lens[i] % bs)
            if upto <= lo:
                continue
            try:
                self.chains[i].extend(
                    eng._store_prefix_blocks(req, ck[:, i], cv[:, i], upto, start=lo)
                )
            except PoolExhausted as e:
                # fail closed mid-prefill: unwind THIS row's pinned chain;
                # its already-shared pages stay owned by the bucket mates
                # that also pinned them
                unpin_chain(self.chains[i])
                self.chains[i] = []
                eng._refuse_allocation(req, e)
                self.alive.remove(i)
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

    def take_rows(self) -> List[Row]:
        """Job complete: materialize claims at prefill_complete and hand the
        surviving rows (pinned chains transfer) to the step loop."""
        eng = self.eng
        bs = eng.block_size
        rows = []
        for i in self.alive:
            req = self.reqs[i]
            n = self.lens[i]
            eng._materialize_claims(req, n - n % bs)
            rows.append(Row(req, self.chains[i], n - n % bs))
        self.alive = []
        return rows


class StepLoop:
    """The unified continuous-batching executor behind ``run_batch``
    (paged mode).  One instance per run_batch call; requests submitted
    together enter the waiting queue in order and are admitted FIFO."""

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
            P = _round_up(max(len(bl) for bl in blocks_per), 4)
            bt = np.zeros((W, P), np.int32)
            for i, bl in enumerate(blocks_per):
                pt = eng.pool.page_table(bl)
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
                blocks_per, plens, tail_cap, tails=tails, pages=pages
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
    def _mixed_step(self, pages: Tuple[Any, Any]) -> Tuple[int, int]:
        """ONE launch carrying every live row — decode rows consume their
        argmax, feeding rows consume the next prompt token.  Returns
        (n_decode, n_feed) row counts for the step accounting."""
        eng = self.eng
        # completion check BEFORE launching: a row that already served its
        # max_new_tokens (e.g. max_new_tokens=0 edge) exits without a launch
        for row in list(self.rows):
            if row.decoding and len(row.req.output_tokens) >= row.req.max_new_tokens:
                self._retire(row)
        if not self.rows:
            return (0, 0)
        self._sync_state(pages)
        rows = self.rows
        W = _round_up(len(rows), BATCH_PAD)
        if self._logits is not None:
            toks = torch.argmax(self._logits, dim=-1).to(torch.int32).cpu().numpy()
        else:
            toks = np.zeros(W, np.int32)  # every row is feeding
        poss = np.zeros(W, np.int32)
        row0_feeding = bool(rows[0].feed)
        finishing: List[Tuple[int, Row]] = []
        n_feed = n_dec = 0
        now = time.monotonic()
        for i, row in enumerate(rows):
            if row.feed:
                toks[i] = row.feed.pop(0)
                n_feed += 1
                if not row.feed:
                    finishing.append((i, row))
            else:
                row.req.output_tokens.append(int(toks[i]))
                if row.req.first_token_ts is None:
                    row.req.first_token_ts = now
                n_dec += 1
            poss[i] = row.pos
        # padding rows replicate row 0's launch while it feeds (the
        # _continue_paged feed form); once row 0 decodes they take their own
        # argmax at a frozen position (the _greedy_decode_loop pad form)
        if row0_feeding:
            toks[len(rows) :] = toks[0]
            poss[len(rows) :] = poss[0]
        else:
            if self._pad_pos is None:
                self._pad_pos = rows[0].pos
            poss[len(rows) :] = self._pad_pos
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
            for row in rows:
                unpin_chain(row.blocks)
                eng._fail_closed_error(
                    row.req, scope="decode_step", trigger="decode_launch_failure",
                    reason=reason,
                )
            self.rows = []
            self._state = None
            self._logits = None
            self._members = []
            return (n_dec, n_feed)
        eng._observe_stage("decode_step", time.monotonic() - t0)
        self._state = state
        self._logits = lg
        for row in rows:
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
        return (n_dec, n_feed)

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
            # chunk side: at most one in-flight prefill chunk per step, only
            # when it fits the budget next to the live rows — unless there
            # are no live rows (livelock guard: an oversized chunk still
            # runs as the only work of the step)
            if self.job is not None:
                cost = self.job.chunk_tokens
                if not self.rows or len(self.rows) + cost <= budget:
                    prefill_rows = len(self.job.alive)
                    self.job.advance()
                    prefill_tokens = cost
                    if self.job.done:
                        self.rows.extend(self.job.take_rows())
                        self.job = None
                        # the joined rows feed THIS step and their block
                        # tables reference the job's freshly stored pages:
                        # the store exists now even if it did not at the
                        # step's start
                        pages = eng._device_pages()
            # decode side: every live row launches every step — the budget
            # never holds a decode row back (zero decode stalls)
            stalled = bool(self.rows)
            n_dec, n_feed = self._mixed_step(pages) if self.rows else (0, 0)
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

"""tests/test_radix_properties.py over the port's ``BlockPool``, side by side
with the reference's.

The same operation stream (insert, lookup, pin, unpin, evict, copy-on-write
extension, offload-readmit), drawn from one seeded generator, drives a JAX
package pool and a port pool of the same capacity and clock.  After every
operation both pools must satisfy the reference's invariants (refcounts
equal to the harness's pins, no pinned block evicted, copy-on-write leaving
the sharer's tokens and bytes untouched on another page, the radix index
consistent, the event log passing the shared-page-immutability check), and
their observable states must be equal: every block's id, tokens, chain,
parent, refcount, partial flag, page slot and payload bytes; the radix
index and partial children; the free-page list; and the event stream.  The
four deterministic regressions of the reference's corpus run on both pools
with the same comparison.  A hypothesis state machine drives the same pair
where hypothesis is installed.
"""
import itertools

import numpy as np
import pytest
import torch

import repro.serving.kv_cache as j_kv
import repro_torch.serving.kv_cache as t_kv
from repro.core.analyzer import check_shared_page_immutability as j_immutable
from repro.core.events import EventLog as JEventLog
from repro_torch.core.analyzer import check_shared_page_immutability as t_immutable
from repro_torch.core.events import EventLog

BS = 4  # block size
L, KV, DH = 1, 1, 2  # tiny payload geometry
CAP = 12
SIDES = {
    "jax": (j_kv, JEventLog, j_immutable, lambda a: a, lambda a: np.array(a)),
    "port": (t_kv, EventLog, t_immutable, torch.from_numpy, lambda a: a.numpy().copy()),
}
# the port's pool names the device of its page store
STORE = {"jax": {}, "port": {"device": "cpu"}}


def _counter():
    """A deterministic clock: both pools see the same LRU order."""
    c = itertools.count()
    return lambda: float(next(c))


class RadixOps:
    """The reference's operation vocabulary and invariants over one side's
    pool; payloads come from a numpy generator and enter the pool as that
    side's arrays."""

    def __init__(self, side, capacity=CAP, seed=0):
        self.kv, log_cls, self.immutable, self.arr, self.np = SIDES[side]
        self.log = log_cls()
        self.pool = self.kv.BlockPool(capacity, self.log, clock=_counter(), **STORE[side])
        self.rng = np.random.default_rng(seed)
        self.pins = []

    def _payload(self, n):
        k = self.rng.normal(size=(L, n, KV, DH)).astype(np.float32)
        v = self.rng.normal(size=(L, n, KV, DH)).astype(np.float32)
        return self.arr(k), self.arr(v)

    def insert(self, seq):
        """The engine's radix fold (claimless): resident full blocks are
        skipped, a matching partial is extended (COW if shared), missing
        blocks are added, a full pool stops the fold."""
        pool, seq, kv = self.pool, tuple(seq), self.kv
        h, lo = "", 0
        while lo < len(seq):
            hi = min(lo + BS, len(seq))
            btoks = tuple(seq[lo:hi])
            parent, h = h, kv.chain_hash(h, btoks)
            is_full = hi - lo == BS
            bid = pool.prefix_index.get(h) if is_full else None
            blk = pool.blocks.get(bid) if bid is not None else None
            if blk is not None and blk.chain == h and not blk.partial:
                lo = hi
                continue
            pb = pool.lookup_partial(parent, btoks)
            if pb is not None and len(pb.tokens) == len(btoks):
                return
            if pb is not None:
                ext = btoks[len(pb.tokens):]
                if pb.ref > 0 and pool.free_slots <= 0:
                    return
                k, v = self._payload(len(ext))
                pool.extend_block(pb, ext, k, v, block_size=BS, held=0, protected_claims=set())
            else:
                if pool.free_slots <= 0:
                    return
                k, v = self._payload(hi - lo)
                if is_full:
                    pool.add_block(btoks, h, k, v, np.arange(lo, hi), protected_claims=set(),
                                   parent=parent)
                else:
                    pool.add_partial_block(btoks, parent, k, v, np.arange(lo, hi), block_size=BS,
                                           protected_claims=set())
            lo = hi

    def lookup(self, seq):
        blocks = self.pool.lookup_prefix(tuple(seq), BS)
        h, covered = "", 0
        for b in blocks:
            assert not b.partial
            assert b.tokens == tuple(seq[covered:covered + BS])
            h = self.kv.chain_hash(h, b.tokens)
            assert b.chain == h
            covered += BS
        return [b.block_id for b in blocks]

    def pin(self, seq):
        blocks = self.pool.lookup_prefix(tuple(seq), BS)
        if blocks:
            self.kv.pin_chain(blocks)
            self.pins.append([b.block_id for b in blocks])

    def unpin(self, i):
        if not self.pins:
            return
        ids = self.pins.pop(i % len(self.pins))
        blocks = [self.pool.blocks.get(b) for b in ids]
        assert all(b is not None for b in blocks), (ids, blocks)
        self.kv.unpin_chain(blocks)

    def evict_one(self):
        try:
            return [b.block_id for b in self.pool.evict(1, protected_claims=set())]
        except self.kv.PoolExhausted:
            assert all(b.ref > 0 for b in self.pool.blocks.values())
            return "exhausted"

    def cow_write(self, seq, i):
        partials = [b for b in self.pool.blocks.values() if b.partial]
        if not partials or self.pool.free_slots <= 0:
            return
        pb = partials[i % len(partials)]
        self.kv.pin_chain((pb,))
        try:
            before_tokens, before_k = pb.tokens, self.np(pb.k)
            ext = tuple(seq[:BS - len(pb.tokens)]) or (0,)
            k, v = self._payload(len(ext))
            nb = self.pool.extend_block(pb, ext, k, v, block_size=BS, held=0,
                                        protected_claims=set())
        finally:
            self.kv.unpin_chain((pb,))
        assert nb is not pb
        assert pb.tokens == before_tokens
        assert np.array_equal(self.np(pb.k), before_k)
        if pb.page_index is not None and nb.page_index is not None:
            assert nb.page_index != pb.page_index

    def readmit_cycle(self, i):
        cands = [b for b in self.pool.blocks.values() if b.ref == 0]
        if not cands:
            return
        blk = cands[i % len(cands)]
        k, v, pos = self.arr(self.np(blk.k)), self.arr(self.np(blk.v)), np.array(blk.positions)
        self.pool.remove(blk.block_id, reason="offloaded")
        blk.location = "host"
        blk.restore_payload(k, v, pos)
        self.pool.readmit(blk)
        self.log.emit("block_stored", block_id=blk.block_id, chain=blk.chain,
                      n_tokens=len(blk.tokens), page_index=blk.page_index)

    def check(self):
        self.pool.assert_consistent()
        held = {}
        for ids in self.pins:
            for b in ids:
                held[b] = held.get(b, 0) + 1
        for bid, blk in self.pool.blocks.items():
            assert blk.ref == held.get(bid, 0), (bid, blk.ref, held.get(bid, 0))
        v = self.immutable(self.log)
        assert v.passed, v.reasons

    def state(self):
        """Everything observable about the pool and its log."""
        pool = self.pool
        blocks = []
        for bid in sorted(pool.blocks):
            b = pool.blocks[bid]
            payload = None if b.k is None else (self.np(b.k).tobytes(), self.np(b.v).tobytes())
            blocks.append((bid, b.tokens, b.chain, b.parent, b.ref, b.partial, b.page_index,
                           b.location, tuple(np.asarray(b.positions).tolist()), payload))
        return dict(
            blocks=blocks,
            prefix_index=dict(pool.prefix_index),
            partial_children={k: list(v) for k, v in pool.partial_children.items()},
            free_pages=list(pool._free_pages),
            events=[(e.name, e.request_id, e.claim_id, dict(e.payload)) for e in self.log.events],
        )


class Pair:
    """A reference pool and a port pool driven by the same operations."""

    def __init__(self, capacity=CAP, seed=0):
        self.sides = {s: RadixOps(s, capacity, seed) for s in SIDES}

    def do(self, op, *args):
        out = {s: getattr(ops, op)(*args) for s, ops in self.sides.items()}
        assert out["port"] == out["jax"], (op, out)
        for ops in self.sides.values():
            ops.check()
        want, got = self.sides["jax"].state(), self.sides["port"].state()
        for key in want:
            assert got[key] == want[key], (op, key)


def _seq(rng):
    return [int(t) for t in rng.integers(0, 6, size=int(rng.integers(1, 3 * BS + 1)))]


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_random_interleaving_matches_reference(seed):
    """The reference's seeded interleaving (120 operations), every invariant and
    the two pools' states compared after every operation."""
    pair = Pair()
    rng = np.random.default_rng(100 + seed)
    names = ["insert", "lookup", "pin", "unpin", "evict", "cow", "readmit"]
    counts = dict.fromkeys(names, 0)
    for _ in range(120):
        op = names[int(rng.integers(len(names)))]
        seq = _seq(rng)
        i = int(rng.integers(64))
        counts[op] += 1
        if op == "insert":
            pair.do("insert", seq)
        elif op == "lookup":
            pair.do("lookup", seq)
        elif op == "pin":
            pair.do("pin", seq)
        elif op == "unpin":
            pair.do("unpin", i)
        elif op == "evict":
            pair.do("evict_one")
        elif op == "cow":
            pair.do("cow_write", seq, i)
        elif op == "readmit":
            pair.do("readmit_cycle", i)
    assert all(counts.values())
    assert pair.sides["port"].pool.blocks  # the stream did real work


# ------------------------------------------------ deterministic regression corpus


def _regression(side, body):
    kv, log_cls, immutable, arr, to_np = SIDES[side]
    log = log_cls()
    pool = kv.BlockPool(8, log, clock=_counter(), **STORE[side])
    rng = np.random.default_rng(1)

    def payload(n):
        return (arr(rng.normal(size=(L, n, KV, DH)).astype(np.float32)),
                arr(rng.normal(size=(L, n, KV, DH)).astype(np.float32)))

    out = body(kv, pool, payload, to_np, arr)
    pool.assert_consistent()
    assert immutable(log).passed
    ops = RadixOps.__new__(RadixOps)
    ops.pool, ops.log, ops.np = pool, log, to_np
    return out, ops.state()


def _both_regressions(body):
    want = _regression("jax", body)
    got = _regression("port", body)
    assert got[0] == want[0]
    for key in want[1]:
        assert got[1][key] == want[1][key], key


def _readmit_overwrite(kv, pool, payload, to_np, arr):
    toks = (1, 2, 3, 4)
    h = kv.chain_hash("", toks)
    k, v = payload(BS)
    twin = pool.add_block(toks, h, k, v, np.arange(BS), protected_claims=set())
    kb, vb, pb = to_np(twin.k), to_np(twin.v), np.array(twin.positions)
    pool.remove(twin.block_id, reason="offloaded")
    twin.location = "host"
    twin.restore_payload(arr(kb), arr(vb), pb)
    k2, v2 = payload(BS)
    live = pool.add_block(toks, h, k2, v2, np.arange(BS), protected_claims=set())
    pool.readmit(twin)
    assert pool.prefix_index[h] == live.block_id, "first resident wins"
    pool.remove(twin.block_id, reason="evicted")
    got = [b.block_id for b in pool.lookup_prefix(toks, BS)]
    assert got == [live.block_id]
    return got


def test_regression_readmit_overwrite_keeps_live_holder():
    _both_regressions(_readmit_overwrite)


def _stale_entry(kv, pool, payload, to_np, arr):
    toks = (1, 2, 3, 4)
    h = kv.chain_hash("", toks)
    pool.prefix_index[h] = 999
    assert pool.lookup_prefix(toks, BS) == []
    other = (9, 9, 9, 9)
    k, v = payload(BS)
    blk = pool.add_block(other, kv.chain_hash("", other), k, v, np.arange(BS),
                         protected_claims=set())
    pool.prefix_index[h] = blk.block_id
    assert pool.lookup_prefix(toks, BS) == []
    del pool.prefix_index[h]
    return blk.block_id


def test_regression_stale_entry_never_resolves_freed_or_foreign_slot():
    _both_regressions(_stale_entry)


def _partial_grows(kv, pool, payload, to_np, arr):
    k, v = payload(2)
    pb = pool.add_partial_block((7, 8), "", k, v, np.arange(2), block_size=BS,
                                protected_claims=set())
    slot = pb.page_index
    ke, ve = payload(2)
    out = pool.extend_block(pb, (9, 10), ke, ve, block_size=BS, held=0, protected_claims=set())
    assert out is pb and not pb.partial
    assert pb.page_index == slot
    assert pool.prefix_index[kv.chain_hash("", (7, 8, 9, 10))] == pb.block_id
    assert pool.partial_children == {}
    assert np.array_equal(to_np(pb.k)[:, 2:4], to_np(ke))
    return slot


def test_regression_partial_grows_to_full_and_is_indexed():
    _both_regressions(_partial_grows)


def _remove_partial(kv, pool, payload, to_np, arr):
    k, v = payload(3)
    pb = pool.add_partial_block((5, 6, 7), "", k, v, np.arange(3), block_size=BS,
                                protected_claims=set())
    pool.remove(pb.block_id, reason="pressure")
    assert pool.partial_children == {}
    assert pool.lookup_partial("", (5, 6, 7, 8)) is None
    return pb.block_id


def test_regression_remove_partial_deregisters_child():
    _both_regressions(_remove_partial)


try:
    from hypothesis import settings
    from hypothesis import strategies as st
    from hypothesis.stateful import RuleBasedStateMachine, invariant, precondition, rule

    HAS_HYPOTHESIS = True
except ImportError:  # the seeded interleaving above still runs
    HAS_HYPOTHESIS = False

if HAS_HYPOTHESIS:

    class RadixPairMachine(RuleBasedStateMachine):
        def __init__(self):
            super().__init__()
            self.pair = Pair()

        seqs = st.lists(st.integers(0, 5), min_size=1, max_size=3 * BS)

        @rule(seq=seqs)
        def insert(self, seq):
            self.pair.do("insert", seq)

        @rule(seq=seqs)
        def lookup(self, seq):
            self.pair.do("lookup", seq)

        @rule(seq=seqs)
        def pin(self, seq):
            self.pair.do("pin", seq)

        @precondition(lambda self: self.pair.sides["jax"].pins)
        @rule(i=st.integers(0, 63))
        def unpin(self, i):
            self.pair.do("unpin", i)

        @rule()
        def evict_one(self):
            self.pair.do("evict_one")

        @rule(seq=seqs, i=st.integers(0, 63))
        def cow_write(self, seq, i):
            self.pair.do("cow_write", seq, i)

        @rule(i=st.integers(0, 63))
        def readmit_cycle(self, i):
            self.pair.do("readmit_cycle", i)

        @invariant()
        def same_pins(self):
            assert self.pair.sides["port"].pins == self.pair.sides["jax"].pins

    TestRadixPair = RadixPairMachine.TestCase
    TestRadixPair.settings = settings(max_examples=20, stateful_step_count=30, deadline=None)

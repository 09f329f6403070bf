"""Paged KV cache substrate: block pool, prefix index, claim-aware eviction.

Blocks are the unit of storage, transfer, eviction and claim footprint.
Each block carries a REAL tensor payload (k/v slabs for every layer) — the
engine's decode consumes these bytes, so offload/restore is actual data
movement, not counters (the paper rejects "generic transfer counters" as
evidence; here a failed restore really does leave the KV absent).

Payloads are torch tensors.  The page store lives in host memory; the
serving engine keeps a version-keyed mirror of it on the engine's device
(``ServingEngine._device_pages``), which is what the paged attention
kernels read.  The off-device tiers sit behind an injectable transfer
layer (see serving/offload.py).
"""
from __future__ import annotations

import hashlib
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Set, Tuple

import numpy as np
import torch


def chain_hash(prev: str, tokens: Sequence[int]) -> str:
    h = hashlib.sha256()
    h.update(prev.encode())
    h.update(np.asarray(tokens, np.int32).tobytes())
    return h.hexdigest()[:16]


def prefix_object_id(tokens: Sequence[int], block_size: int) -> str:
    """Stable reusable-object id for a full token prefix (block-aligned)."""
    h = ""
    for i in range(0, len(tokens) - len(tokens) % block_size, block_size):
        h = chain_hash(h, tokens[i : i + block_size])
    return h or chain_hash("", tokens)


@dataclass
class KVBlock:
    block_id: int
    tokens: Tuple[int, ...]
    chain: str  # hash of the prefix up to and including this block
    k: torch.Tensor  # [L, block_size, KV, Dh]  (None while spilled to disk)
    v: torch.Tensor
    positions: np.ndarray  # [block_size] absolute positions
    location: str = "device"  # "device" | "host" | "disk"
    ref: int = 0
    priority: int = 0
    claim_ids: Set[str] = field(default_factory=set)
    last_use: float = 0.0
    page_index: Optional[int] = None  # slot in the device page store, if paged
    # radix sharing: parent chain hash ("" at the root) and whether the block
    # holds fewer than block_size valid tokens (a decode tail awaiting
    # extension).  Partial blocks are indexed in BlockPool.partial_children,
    # never in prefix_index; their payload is zero-padded to block_size so
    # they occupy normal page slots (decode masks positions beyond the valid
    # length via prefix_len), while ``tokens`` keeps only the valid tokens so
    # footprint arithmetic (sum(len(b.tokens))) stays exact.
    parent: str = ""
    partial: bool = False
    _released_nbytes: int = 0  # payload size while spilled (k/v are None)
    # content checksum written at first spill, verified at restore, cleared
    # on verified readmit (chaos.payload_checksum) — None while device-resident
    checksum: Optional[str] = None

    @property
    def nbytes(self) -> int:
        if self.k is None:
            return self._released_nbytes
        n = self.k.numel() * self.k.element_size()
        if self.v is not None:
            n += self.v.numel() * self.v.element_size()
        return int(n)

    def release_payload(self) -> None:
        """Drop the RAM payload (the bytes now live down-tier)."""
        self._released_nbytes = self.nbytes
        self.k = None
        self.v = None

    def detach_payload(self) -> None:
        """Replace page-store views with owned copies (before the page slot
        is freed for reuse — a stale view would alias the next tenant)."""
        if self.page_index is not None:
            if self.k is not None:
                self.k = self.k.clone(memory_format=torch.contiguous_format)
            if self.v is not None:
                self.v = self.v.clone(memory_format=torch.contiguous_format)
            self.page_index = None

    def restore_payload(self, k: torch.Tensor, v: torch.Tensor, positions: np.ndarray) -> None:
        self.k = k
        self.v = v
        self.positions = np.asarray(positions)
        self._released_nbytes = 0


class PoolExhausted(RuntimeError):
    def __init__(self, msg: str, blocking_claim_ids: List[str]):
        super().__init__(msg)
        self.blocking_claim_ids = blocking_claim_ids


def pin_chain(blocks: Sequence[KVBlock]) -> None:
    """Hold a reference on every block of a chain: a pinned block is never
    a victim candidate, so an allocation elsewhere in the same batch (or a
    later chunk of the same chunked prefill) cannot evict a page a live
    block table attends.  Callers balance with ``unpin_chain``."""
    for b in blocks:
        b.ref += 1


def unpin_chain(blocks: Sequence[KVBlock]) -> None:
    for b in blocks:
        b.ref -= 1


class BlockPool:
    """Device-side block pool with claim-aware victim selection and a paged
    backing store.

    Eviction order: unreferenced blocks sorted by (priority asc, LRU).
    Blocks belonging to *protected* claims are excluded from the victim set
    (victim_exclusion_before_violation); if demand still cannot be met the
    allocator raises ``PoolExhausted`` carrying the blocking claim ids so the
    scheduler can take its explicit conflict action.

    Page store: KV payloads with the canonical [L, block_size, KV, Dh] shape
    live in ONE pair of pool-wide page arrays ``k_pages``/``v_pages`` of
    shape [L, KV, capacity, block_size, Dh] — the layout the paged-attention
    kernel consumes directly (kernels/paged_attention.py).  A block's ``k``/
    ``v`` are zero-copy views of its page slot, so decode attends over the
    pool IN PLACE through per-request block tables: no dense per-request
    cache is ever assembled, and a restored/promoted block is usable the
    moment its payload lands in a slot.  Payloads with other shapes (state
    snapshots) bypass the page store and own their arrays.

    Chunked prefill writes pages AS IT GOES: each completed chunk's blocks
    land here before the next chunk runs (serving/engine.py,
    ``_prefill_bucket_chunked``), pinned via ``pin_chain`` so a later
    chunk's allocation can never evict a page the growing block table
    attends — the pool is the only resident prefill KV, bounding peak
    prefill memory at O(chunk).
    """

    def __init__(self, capacity_blocks: int, event_log, clock=time.monotonic):
        self.capacity = capacity_blocks
        self._events = event_log
        self._clock = clock
        self.blocks: Dict[int, KVBlock] = {}
        self._next_id = 0
        # chain hash -> block_id for device-resident reusable FULL blocks.
        # Together with partial_children this is the pool-wide radix index:
        # every chain hash folds its parent hash, so the mapping is exactly
        # a radix tree over block-granular token paths — walking a prompt
        # block-by-block (lookup_prefix) descends the tree, and any two
        # requests sharing a token prefix converge on the same block ids.
        self.prefix_index: Dict[str, int] = {}
        # parent chain hash -> partial (sub-block) children: decode tails
        # readmitted at request end, grown in place via extend_block while
        # unshared and copy-on-written at the divergence point once shared
        self.partial_children: Dict[str, List[int]] = {}
        # engine hook invoked once per page_cow emit (metric witness 1:1)
        self.on_cow = None
        # paged backing store (lazily shaped from the first block payload)
        self.k_pages: Optional[torch.Tensor] = None  # [L, KV, N, page, Dh], host
        self.v_pages: Optional[torch.Tensor] = None
        self._free_pages: List[int] = []
        self._pages_version = 0  # bumped on any page write (device mirror key)
        # page slots written since the device mirror last synced (the
        # mirror consumer drains this set when it syncs; an empty set means
        # only frees happened and the mirror is re-keyed, not re-uploaded)
        self._dirty_pages: set = set()

    # -- page store -----------------------------------------------------------
    @staticmethod
    def _pageable(k, v) -> bool:
        return (
            isinstance(k, torch.Tensor)
            and isinstance(v, torch.Tensor)
            and k.dim() == 4
            and v.dim() == 4
            and k.shape == v.shape
        )

    def _ensure_pages(self, k: torch.Tensor) -> None:
        if self.k_pages is not None:
            return
        L, bs, KV, Dh = k.shape
        shape = (L, KV, self.capacity, bs, Dh)
        self.k_pages = torch.zeros(shape, dtype=k.dtype, device="cpu")
        self.v_pages = torch.zeros(shape, dtype=k.dtype, device="cpu")
        self._free_pages = list(range(self.capacity - 1, -1, -1))

    def _page_in(self, blk: KVBlock, k: torch.Tensor, v: torch.Tensor) -> None:
        """Land a payload in a free page slot; blk.k/v become views of it."""
        self._ensure_pages(k)
        L, KV, _, bs, Dh = self.k_pages.shape
        if tuple(k.shape) != (L, bs, KV, Dh) or not self._free_pages:
            # shape drift (should not happen within one engine): own arrays
            blk.k, blk.v = k, v
            return
        pi = self._free_pages.pop()
        self.k_pages[:, :, pi] = k.permute(0, 2, 1, 3)
        self.v_pages[:, :, pi] = v.permute(0, 2, 1, 3)
        blk.page_index = pi
        # zero-copy views back in [L, block_size, KV, Dh] layout
        blk.k = self.k_pages[:, :, pi].permute(0, 2, 1, 3)
        blk.v = self.v_pages[:, :, pi].permute(0, 2, 1, 3)
        self._pages_version += 1
        self._dirty_pages.add(pi)

    def _page_out(self, blk: KVBlock) -> None:
        if blk.page_index is not None:
            pi = blk.page_index
            blk.detach_payload()
            self._free_pages.append(pi)
            self._pages_version += 1

    def page_table(self, blocks: Sequence[KVBlock]) -> List[int]:
        """Page indices for a block chain (the per-request block table)."""
        out = []
        for b in blocks:
            if b.page_index is None:
                raise ValueError(f"block {b.block_id} is not page-resident")
            out.append(b.page_index)
        return out

    # -- capacity -------------------------------------------------------------
    @property
    def used(self) -> int:
        return len(self.blocks)

    @property
    def free_slots(self) -> int:
        return self.capacity - self.used

    # -- insert ---------------------------------------------------------------
    def add_block(
        self,
        tokens: Tuple[int, ...],
        chain: str,
        k: torch.Tensor,
        v: torch.Tensor,
        positions: np.ndarray,
        *,
        priority: int = 0,
        claim_ids: Optional[Set[str]] = None,
        protected_claims: Optional[Set[str]] = None,
        evictable_cb=None,
        parent: str = "",
    ) -> KVBlock:
        if self.free_slots <= 0:
            self.evict(1, protected_claims=protected_claims or set(), evictable_cb=evictable_cb)
        blk = KVBlock(
            block_id=self._next_id,
            tokens=tuple(int(t) for t in tokens),
            chain=chain,
            k=None,
            v=None,
            positions=np.asarray(positions),
            priority=priority,
            claim_ids=set(claim_ids or ()),
            last_use=self._clock(),
            parent=parent,
        )
        if self._pageable(k, v):
            self._page_in(blk, k, v)
        else:
            blk.k, blk.v = k, v
        self._next_id += 1
        self.blocks[blk.block_id] = blk
        self.prefix_index[chain] = blk.block_id
        self._events.emit(
            "block_stored",
            block_id=blk.block_id,
            chain=chain,
            n_tokens=len(tokens),
            page_index=blk.page_index,
        )
        return blk

    def add_partial_block(
        self,
        tokens: Sequence[int],
        parent: str,
        k: torch.Tensor,
        v: torch.Tensor,
        positions: np.ndarray,
        *,
        block_size: int,
        priority: int = 0,
        claim_ids: Optional[Set[str]] = None,
        protected_claims: Optional[Set[str]] = None,
        evictable_cb=None,
    ) -> KVBlock:
        """Store a sub-block decode tail as a first-class pool block.

        The payload is zero-padded to ``block_size`` so it occupies a
        normal page slot; ``tokens`` keeps only the valid tokens.  Partial
        blocks hang off their parent chain in ``partial_children`` — never
        in ``prefix_index`` — and grow via ``extend_block``."""
        toks = tuple(int(t) for t in tokens)
        if not 0 < len(toks) < block_size:
            raise ValueError("partial block must hold 1..block_size-1 tokens")
        if self.free_slots <= 0:
            self.evict(1, protected_claims=protected_claims or set(), evictable_cb=evictable_cb)
        if self._pageable(k, v) and k.shape[1] < block_size:
            L, n, KV, Dh = k.shape
            pk = torch.zeros((L, block_size, KV, Dh), dtype=k.dtype, device=k.device)
            pv = torch.zeros_like(pk)
            pk[:, :n] = k
            pv[:, :n] = v
            k, v = pk, pv
        blk = KVBlock(
            block_id=self._next_id,
            tokens=toks,
            chain=chain_hash(parent, toks),
            k=None,
            v=None,
            positions=np.asarray(positions),
            priority=priority,
            claim_ids=set(claim_ids or ()),
            last_use=self._clock(),
            parent=parent,
            partial=True,
        )
        if self._pageable(k, v):
            self._page_in(blk, k, v)
        else:
            blk.k, blk.v = k, v
        self._next_id += 1
        self.blocks[blk.block_id] = blk
        self.partial_children.setdefault(parent, []).append(blk.block_id)
        self._events.emit(
            "block_stored",
            block_id=blk.block_id,
            chain=blk.chain,
            n_tokens=len(toks),
            page_index=blk.page_index,
        )
        return blk

    def extend_block(
        self,
        blk: KVBlock,
        new_tokens: Sequence[int],
        k_ext: torch.Tensor,
        v_ext: torch.Tensor,
        *,
        block_size: int,
        held: int = 0,
        priority: int = 0,
        claim_ids: Optional[Set[str]] = None,
        protected_claims: Optional[Set[str]] = None,
        evictable_cb=None,
    ) -> KVBlock:
        """Append tokens to a partial block; returns the block holding the
        extended content.

        Unshared (ref <= ``held``, the caller's own pins): the page is
        extended IN PLACE — the only legal page mutation, witnessed by a
        ``page_extend`` event the analyzer rejects at refcount > 1.
        Shared: copy-on-write at the divergence point — the sharers keep
        the original page byte-identical; the extension lands on a fresh
        block/page (``page_cow``).  Full blocks never need COW at all:
        chains are content-addressed, so a diverging full block is simply a
        different chain hash and a different page."""
        if not blk.partial:
            raise ValueError(f"block {blk.block_id} is not partial")
        new_toks = tuple(int(t) for t in new_tokens)
        n0, e = len(blk.tokens), len(new_toks)
        if e == 0:
            return blk
        if n0 + e > block_size:
            raise ValueError("extension overflows block_size")
        toks = blk.tokens + new_toks
        chain = chain_hash(blk.parent, toks)
        full = n0 + e == block_size
        p0 = int(blk.positions[0]) if len(blk.positions) else 0
        if blk.ref > held:
            # shared: copy the base payload BEFORE any allocation below —
            # eviction inside add could otherwise free the source page
            base_k = blk.k[:, :n0].clone()
            base_v = blk.v[:, :n0].clone()
            cow_k = torch.cat([base_k, k_ext.to(base_k.device)], dim=1)
            cow_v = torch.cat([base_v, v_ext.to(base_v.device)], dim=1)
            positions = np.arange(p0, p0 + n0 + e)
            if full:
                nb = self.add_block(
                    toks, chain, cow_k, cow_v, positions,
                    priority=priority, claim_ids=claim_ids,
                    protected_claims=protected_claims,
                    evictable_cb=evictable_cb, parent=blk.parent,
                )
            else:
                nb = self.add_partial_block(
                    toks, blk.parent, cow_k, cow_v, positions,
                    block_size=block_size, priority=priority,
                    claim_ids=claim_ids, protected_claims=protected_claims,
                    evictable_cb=evictable_cb,
                )
            self._events.emit(
                "page_cow",
                block_id=blk.block_id,
                new_block_id=nb.block_id,
                page_index=blk.page_index,
                new_page_index=nb.page_index,
                refcount=blk.ref,
            )
            if self.on_cow is not None:
                self.on_cow()
            return nb
        # unshared: in-place append into the zero-padded region
        blk.k[:, n0 : n0 + e] = k_ext
        blk.v[:, n0 : n0 + e] = v_ext
        blk.tokens = toks
        blk.chain = chain
        blk.positions = np.arange(p0, p0 + n0 + e)
        blk.last_use = self._clock()
        if claim_ids:
            blk.claim_ids |= set(claim_ids)
        blk.priority = max(blk.priority, priority)
        if full:
            kids = self.partial_children.get(blk.parent)
            if kids and blk.block_id in kids:
                kids.remove(blk.block_id)
                if not kids:
                    del self.partial_children[blk.parent]
            blk.partial = False
            cur = self.prefix_index.get(chain)
            cur_blk = self.blocks.get(cur) if cur is not None else None
            if cur_blk is None or cur_blk.chain != chain or cur_blk.partial:
                self.prefix_index[chain] = blk.block_id
        if blk.page_index is not None:
            self._pages_version += 1
            self._dirty_pages.add(blk.page_index)
        self._events.emit(
            "page_extend",
            block_id=blk.block_id,
            page_index=blk.page_index,
            n_valid=n0 + e,
            refcount=blk.ref,
        )
        return blk

    def readmit(self, blk: KVBlock) -> KVBlock:
        """Re-admit a restored block: its payload lands directly in a page
        slot (restore lands BLOCKS, not dense slabs) and becomes attendable
        in place via block tables."""
        blk.location = "device"
        blk.last_use = self._clock()
        k, v = blk.k, blk.v
        if self._pageable(k, v):
            self._page_in(blk, k, v)
        self.blocks[blk.block_id] = blk
        if blk.partial:
            kids = self.partial_children.setdefault(blk.parent, [])
            if blk.block_id not in kids:
                kids.append(blk.block_id)
        else:
            # first resident wins: only (re)claim the index entry when no
            # LIVE holder of this chain exists.  Blindly overwriting would
            # orphan the index the moment the readmitted twin is freed —
            # the entry would then resolve a hash to a dead block id (and,
            # transitively, to whatever reuses its page slot).
            cur = self.prefix_index.get(blk.chain)
            cur_blk = self.blocks.get(cur) if cur is not None else None
            if cur_blk is None or cur_blk.chain != blk.chain or cur_blk.partial:
                self.prefix_index[blk.chain] = blk.block_id
        return blk

    def remove(self, block_id: int, reason: str = "evicted") -> KVBlock:
        blk = self.blocks.pop(block_id)
        self._page_out(blk)
        if blk.partial:
            kids = self.partial_children.get(blk.parent)
            if kids and block_id in kids:
                kids.remove(block_id)
                if not kids:
                    del self.partial_children[blk.parent]
        elif self.prefix_index.get(blk.chain) == block_id:
            del self.prefix_index[blk.chain]
        self._events.emit("block_removed", block_id=block_id, chain=blk.chain, reason=reason)
        return blk

    # -- lookup ---------------------------------------------------------------
    def lookup_prefix(
        self, tokens: Sequence[int], block_size: int, *, root: str = ""
    ) -> List[KVBlock]:
        """Longest chain of resident blocks matching the leading prefix
        (a radix descent from ``root``).  Every hit is re-verified against
        the live block's chain: a stale index entry — a hash left pointing
        at a freed id, or an id whose slot was reused by different content
        — terminates the walk instead of resolving to foreign bytes."""
        out: List[KVBlock] = []
        h = root
        for i in range(0, len(tokens) - len(tokens) % block_size, block_size):
            h = chain_hash(h, tokens[i : i + block_size])
            bid = self.prefix_index.get(h)
            if bid is None:
                break
            blk = self.blocks.get(bid)
            if blk is None or blk.chain != h or blk.partial:
                break
            blk.last_use = self._clock()
            out.append(blk)
        return out

    def lookup_partial(self, parent: str, tokens: Sequence[int]) -> Optional[KVBlock]:
        """Longest device-resident partial child of ``parent`` whose valid
        tokens are a leading prefix of ``tokens`` (diverged or stale
        children are skipped; the chain is re-verified from content)."""
        toks = tuple(int(t) for t in tokens)
        best: Optional[KVBlock] = None
        for bid in list(self.partial_children.get(parent, ())):
            blk = self.blocks.get(bid)
            if blk is None or not blk.partial or blk.location != "device":
                continue
            n = len(blk.tokens)
            if n > len(toks) or blk.tokens != toks[:n]:
                continue
            if blk.chain != chain_hash(parent, blk.tokens):
                continue
            if best is None or n > len(best.tokens):
                best = blk
        if best is not None:
            best.last_use = self._clock()
        return best

    def shared_page_count(self) -> int:
        """Device blocks currently referenced by more than one holder."""
        return sum(
            1 for b in self.blocks.values() if b.location == "device" and b.ref > 1
        )

    def assert_consistent(self) -> None:
        """Radix bookkeeping invariants (test/property-suite hook):
        prefix_index maps only to live full chain-matching blocks,
        partial_children only to live children whose chain re-derives from
        (parent, tokens), no two live blocks alias a page slot, page
        accounting balances, and no refcount is negative."""
        for h, bid in self.prefix_index.items():
            blk = self.blocks.get(bid)
            assert blk is not None, f"prefix_index[{h!r}] -> dead block {bid}"
            assert not blk.partial, f"prefix_index[{h!r}] -> partial block {bid}"
            assert blk.chain == h, f"prefix_index[{h!r}] -> chain {blk.chain!r}"
        for parent, kids in self.partial_children.items():
            assert kids, f"partial_children[{parent!r}] is empty"
            for bid in kids:
                blk = self.blocks.get(bid)
                assert blk is not None, f"partial_children[{parent!r}] -> dead {bid}"
                assert blk.partial and blk.parent == parent
                assert blk.chain == chain_hash(parent, blk.tokens)
        pages: Dict[int, int] = {}
        for bid, blk in self.blocks.items():
            assert blk.block_id == bid
            assert blk.ref >= 0, f"block {bid} has negative ref {blk.ref}"
            if blk.page_index is not None:
                other = pages.get(blk.page_index)
                assert other is None, f"page {blk.page_index} aliased by {other} and {bid}"
                pages[blk.page_index] = bid
        if self.k_pages is not None:
            assert not (set(self._free_pages) & set(pages)), "free page in use"
            assert len(self._free_pages) + len(pages) == self.capacity

    # -- eviction ---------------------------------------------------------------
    def victim_candidates(self, protected_claims: Set[str], evictable_cb=None) -> List[KVBlock]:
        cands = []
        for blk in self.blocks.values():
            if blk.ref > 0:
                continue
            protecting = blk.claim_ids & protected_claims
            if protecting:
                self._events.emit(
                    "allocator_victim_excluded",
                    block_id=blk.block_id,
                    claim_id=sorted(protecting)[0],
                    protected_by=sorted(protecting),
                )
                continue
            if evictable_cb is not None and not evictable_cb(blk):
                continue
            cands.append(blk)
        cands.sort(key=lambda b: (b.priority, b.last_use))
        return cands

    def evict(self, n: int, *, protected_claims: Set[str], evictable_cb=None) -> List[KVBlock]:
        victims = self.victim_candidates(protected_claims, evictable_cb)[:n]
        if len(victims) < n:
            blocking = sorted(
                {c for blk in self.blocks.values() if blk.ref == 0 for c in blk.claim_ids & protected_claims}
            )
            raise PoolExhausted(
                f"need {n} blocks, only {len(victims)} evictable", blocking_claim_ids=blocking
            )
        out = []
        for blk in victims:
            self._events.emit(
                "pressure_eviction",
                block_id=blk.block_id,
                priority=blk.priority,
                claim_id=sorted(blk.claim_ids)[0] if blk.claim_ids else None,
            )
            out.append(self.remove(blk.block_id, reason="pressure"))
        return out


# The old single-tier ``HostPool`` was replaced by the tier hierarchy in
# serving/tiers.py (HostTier / DiskTier / TieredStore).

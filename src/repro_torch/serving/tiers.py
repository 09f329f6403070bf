"""Storage tiers behind the transfer backend: host DRAM and disk spill.

The device pool (``kv_cache.BlockPool``) is tier 0; this module supplies the
off-device tiers and the policy glue between them:

  - ``HostTier``  — CPU DRAM block store (the paper's "CPU" offload target),
    optionally capacity-bounded.  When full, the least-recently-stored block
    spills to the next tier instead of being dropped (fail-closed: offloaded
    claim bytes are never silently lost by tier pressure).
  - ``DiskTier``  — file-backed spill tier.  Payloads are serialized to an
    ``.npz`` per block and the in-memory arrays are released; a disk-resident
    block genuinely holds no RAM payload, so a restore really re-reads bytes.
  - ``TieredStore`` — ordered [host, disk] view with chain lookup across
    tiers, the spill policy, and promotion bookkeeping.

Every tier exposes the same minimal surface (``blocks``, ``by_chain``,
``put``, ``pop``) so the connector can treat a transfer between any two
tiers uniformly — which is what lets failure injection work at every tier
boundary (see offload.FailureInjectionConfig).  Chain lookups go through
``TieredStore.find_chain`` (and the connector's prefix walks on top of it).

Integrity: a block's content checksum is written at its FIRST spill off the
device (``chaos.payload_checksum``) and carried down-tier unchanged; the
connector verifies it at restore, so corruption at rest (including the
chaos plan's injected byte flips, which happen AFTER the checksum) becomes
a fail-closed refusal rather than wrong logits.  The connector installs the
engine's ``FaultPlan`` on each tier as ``fault_plan``.
"""
from __future__ import annotations

import shutil
import tempfile
from pathlib import Path
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.serving.chaos import corrupted_copy, payload_checksum
from repro_torch.serving.kv_cache import KVBlock


class HostTier:
    """Host-side (CPU DRAM) block store.  Drop-in for the old ``HostPool``."""

    name = "host"
    fault_plan = None  # installed by the connector when chaos is enabled

    def __init__(self, capacity_blocks: Optional[int] = None) -> None:
        self.capacity = capacity_blocks  # None = unbounded
        self.blocks: Dict[int, KVBlock] = {}
        self.by_chain: Dict[str, int] = {}
        self._order: List[int] = []  # insertion order, oldest first (spill victims)

    @property
    def used(self) -> int:
        return len(self.blocks)

    @property
    def resident_bytes(self) -> int:
        """Occupancy for the tier_bytes gauge (KVBlock.nbytes stays valid
        even for payload-released blocks — it is recorded at release)."""
        return sum(b.nbytes for b in self.blocks.values())

    @property
    def over_capacity(self) -> bool:
        return self.capacity is not None and self.used > self.capacity

    def put(self, blk: KVBlock) -> None:
        # A block arriving from the device pool may still be a view of its
        # (now freed) page slot: take ownership of the bytes host-side.
        blk.detach_payload()
        if blk.checksum is None:
            blk.checksum = payload_checksum(blk.k, blk.v)
        if self.fault_plan is not None and self.fault_plan.draw_corruption(
            self.name, blk.claim_ids, blk.block_id
        ):
            blk.k = corrupted_copy(blk.k)  # at-rest corruption, post-checksum
        blk.location = self.name
        self.blocks[blk.block_id] = blk
        self.by_chain[blk.chain] = blk.block_id
        self._order.append(blk.block_id)

    def pop(self, block_id: int) -> KVBlock:
        blk = self.blocks.pop(block_id)
        if self.by_chain.get(blk.chain) == block_id:
            del self.by_chain[blk.chain]
        if block_id in self._order:
            self._order.remove(block_id)
        return blk

    def spill_victim(self) -> Optional[KVBlock]:
        """Oldest resident block — the candidate to push down-tier."""
        return self.blocks[self._order[0]] if self._order else None


class DiskTier:
    """File-backed spill tier: block payloads live in per-block ``.npz`` files.

    The in-memory ``KVBlock`` keeps only metadata while disk-resident — its
    ``k``/``v`` arrays are released on ``put`` and re-read on ``pop``, so
    disk residency is real byte movement, not a flag.
    """

    name = "disk"
    fault_plan = None  # installed by the connector when chaos is enabled

    def __init__(self, spill_dir: Optional[Path] = None) -> None:
        # Directory creation is lazy: benches spin up hundreds of engines
        # and most never touch disk.
        self._spill_dir = spill_dir
        self._tmp: Optional[str] = None
        self.dir: Optional[Path] = None
        self.blocks: Dict[int, KVBlock] = {}
        self.by_chain: Dict[str, int] = {}
        self._files: Dict[int, Path] = {}
        self.bytes_written = 0
        self.bytes_read = 0

    def _ensure_dir(self) -> Path:
        if self.dir is None:
            if self._spill_dir is None:
                self._tmp = tempfile.mkdtemp(prefix="repro-kv-disk-")
                self.dir = Path(self._tmp)
            else:
                self.dir = Path(self._spill_dir)
                self.dir.mkdir(parents=True, exist_ok=True)
        return self.dir

    def close(self) -> None:
        """Explicit teardown: unlink every spill file and remove the tier's
        own temp directory.  Idempotent; replaces the old ``__del__`` so no
        cleanup ever runs during interpreter shutdown.  Called from
        ``EngineCore.close()`` (or use the tier as a context manager)."""
        for path in self._files.values():
            path.unlink(missing_ok=True)
        self._files.clear()
        self.blocks.clear()
        self.by_chain.clear()
        if self._tmp is not None:
            shutil.rmtree(self._tmp, ignore_errors=True)
            self._tmp = None
        self.dir = None

    def __enter__(self) -> "DiskTier":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    @property
    def used(self) -> int:
        return len(self.blocks)

    @property
    def resident_bytes(self) -> int:
        return sum(b.nbytes for b in self.blocks.values())

    @staticmethod
    def _encode(a: torch.Tensor):
        """Raw-bytes encoding: numpy has no bfloat16, so payloads are stored
        as a uint8 buffer + (dtype name, shape) sidecar — a bf16 round trip
        is bitwise."""
        a = a.detach().contiguous().cpu()
        buf = a.reshape(-1).view(torch.uint8).numpy()
        return buf, str(a.dtype).removeprefix("torch."), tuple(a.shape)

    @staticmethod
    def _decode(buf: np.ndarray, dtype: str, shape) -> torch.Tensor:
        dt = getattr(torch, dtype)
        if not isinstance(dt, torch.dtype):
            raise ValueError(f"unknown payload dtype {dtype!r}")
        raw = torch.from_numpy(np.ascontiguousarray(buf, np.uint8).copy())
        return raw.view(dt).reshape(tuple(int(s) for s in shape))

    def put(self, blk: KVBlock) -> None:
        path = self._ensure_dir() / f"blk-{blk.block_id:06d}-{blk.chain}.npz"
        if blk.checksum is None:
            blk.checksum = payload_checksum(blk.k, blk.v)
        k_buf, k_dt, k_shape = self._encode(blk.k)
        v_buf, v_dt, v_shape = self._encode(blk.v)
        if self.fault_plan is not None and self.fault_plan.draw_corruption(
            self.name, blk.claim_ids, blk.block_id
        ):
            # at-rest corruption, post-checksum (copy: k_buf may view pages)
            if k_buf.size:
                k_buf = k_buf.copy()
                k_buf[0] ^= 0xFF
        np.savez(
            path,
            k=k_buf, k_dtype=k_dt, k_shape=np.asarray(k_shape, np.int64),
            v=v_buf, v_dtype=v_dt, v_shape=np.asarray(v_shape, np.int64),
            positions=np.asarray(blk.positions),
            checksum=np.asarray(blk.checksum),
        )
        self.bytes_written += blk.nbytes
        blk.release_payload()  # record nbytes, drop the RAM arrays
        blk.location = self.name
        self.blocks[blk.block_id] = blk
        self.by_chain[blk.chain] = blk.block_id
        self._files[blk.block_id] = path

    def pop(self, block_id: int) -> KVBlock:
        blk = self.blocks.pop(block_id)
        if self.by_chain.get(blk.chain) == block_id:
            del self.by_chain[blk.chain]
        path = self._files.pop(block_id)
        with np.load(path) as payload:
            blk.restore_payload(
                self._decode(payload["k"], str(payload["k_dtype"]), payload["k_shape"]),
                self._decode(payload["v"], str(payload["v_dtype"]), payload["v_shape"]),
                payload["positions"],
            )
        self.bytes_read += blk.nbytes
        path.unlink(missing_ok=True)
        return blk


class TieredStore:
    """Ordered off-device tier hierarchy (host, then disk).

    Chain lookups fall through tier by tier; the spill policy keeps the host
    tier within capacity by demoting its oldest blocks down-tier.  Actual
    transfers (with events + injection) run through the connector — this
    class only answers "where does chain X live" and "who should spill".
    """

    def __init__(self, host: HostTier, disk: DiskTier) -> None:
        self.host = host
        self.disk = disk
        self.tiers: Tuple = (host, disk)

    def tier_of_block(self, block_id: int):
        for tier in self.tiers:
            if block_id in tier.blocks:
                return tier
        return None

    def find_chain(self, chain: str) -> Optional[KVBlock]:
        for tier in self.tiers:
            bid = tier.by_chain.get(chain)
            if bid is not None:
                return tier.blocks[bid]
        return None

    def by_name(self, name: str):
        for tier in self.tiers:
            if tier.name == name:
                return tier
        raise KeyError(f"unknown tier {name!r}")

    def spill_candidates(self) -> List[KVBlock]:
        """Host blocks that must move down-tier to restore capacity (oldest first)."""
        if self.host.capacity is None or self.host.used <= self.host.capacity:
            return []
        n = self.host.used - self.host.capacity
        return [self.host.blocks[bid] for bid in self.host._order[:n]]

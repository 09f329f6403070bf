"""ResidentClaims over recurrent-state snapshots (SSM / hybrid / xLSTM).

For attention-free and hybrid architectures the reusable cache object is
not a KV block chain but a *state snapshot* — the full recurrent state
(mLSTM (C, n, m) matrices, SSM (h, conv) state, hybrid window-KV + state
pair) after consuming a token prefix.  The ResidentClaim contract binds
identically: identity, acceptance, predicate (``state_at_token(k)``),
ordered lifecycle, restore-before-reuse, and the fail-closed scheduler
outcome on same-claim restoration failure.

The lifecycle is the same code as the KV engine's: ``SnapshotEngine``
subclasses ``core_engine.EngineCore`` with ``kind = StateSnapshotKind()``
and supplies only the snapshot plumbing: packing a state tree into a single
pseudo-block whose payload is the flattened state bytes (a ``uint8``
tensor: packed on the host; a restore leaves it on the engine's device,
where the page-copy kernel wrote it), and unpacking it on reuse.
Transfers ride the same tiered connector, the same batched job queue
(offload and restore move the payload through ``gather_payloads``, the
page-copy kernel on the card), the same failure injection, and the same
scheduler invalid-load boundary the KV witness exercises.  A restored
snapshot is bit-identical state: greedy decode after restore matches the
never-offloaded run.

The payload holds the state's leaves in the JAX package's order (dict keys
sorted, as ``jax.tree.flatten`` orders them) with the same dtypes, so its
bytes, ``nbytes`` and the claim's footprint equal the reference's.
"""
from __future__ import annotations

import time
from functools import lru_cache
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.claims import ClaimState, ResidentClaim
from repro_torch.device import DeviceLike
from repro_torch.models.layers import tree_map
from repro_torch.serving.cache_object import StateSnapshotKind
from repro_torch.serving.core_engine import EngineCore, Request
from repro_torch.serving.kv_cache import KVBlock
from repro_torch.serving.offload import FailureInjectionConfig
from repro_torch.serving.scheduler_loop import BATCH_PAD, _round_up, device_sync


def _flatten(tree, path=()):
    """(path, leaf) pairs in ``jax.tree.flatten``'s order: dict keys sorted."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _flatten(tree[k], path + (k,))
    else:
        yield path, tree


def _pack_state(state) -> Tuple[torch.Tensor, list]:
    """Flatten a state tree into one host ``uint8`` payload + a
    reconstruction spec [(path, shape, dtype)]."""
    leaves = list(_flatten(state))
    spec = [(path, tuple(leaf.shape), leaf.dtype) for path, leaf in leaves]
    payload = torch.cat(
        [leaf.detach().cpu().contiguous().reshape(-1).view(torch.uint8) for _, leaf in leaves]
    )
    return payload, spec


def _unpack_state(payload: torch.Tensor, spec, device) -> Dict[str, Any]:
    """The state tree back on ``device``: the payload crosses once, then
    each leaf is copied out of it (so every leaf starts aligned)."""
    buf = payload.to(device)
    tree: Dict[str, Any] = {}
    off = 0
    for path, shape, dtype in spec:
        n = int(np.prod(shape, dtype=np.int64)) * torch.tensor([], dtype=dtype).element_size()
        leaf = buf[off : off + n].clone().view(dtype).reshape(shape)
        node = tree
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = leaf
        off += n
    return tree


@lru_cache(maxsize=16)
def _state_batch_axes(bundle):
    """Per-leaf batch axis of this bundle's recurrent state, inferred by
    comparing B=1 and B=2 state shapes on the meta device (no memory):
    xLSTM states carry batch on axis 2 behind the [G, n_blocks] stack;
    hybrid caches mix axes 0 and 1."""
    s1 = bundle.make_cache(1, 8, device="meta")
    s2 = bundle.make_cache(2, 8, device="meta")

    def axis(a, b):
        for i, (x, y) in enumerate(zip(a.shape, b.shape)):
            if x != y:
                return i
        return 0

    return tree_map(axis, s1, s2)


class SnapshotEngine(EngineCore):
    """Claim-native serving over recurrent-state snapshots."""

    kind = StateSnapshotKind()

    def __init__(
        self,
        bundle,
        params,
        *,
        device_slots: int = 16,
        event_log=None,
        injection: Optional[FailureInjectionConfig] = None,
        host_blocks: Optional[int] = None,
        disk_dir=None,
        fault_plan=None,
        retry_policy=None,
        quarantine_after: Optional[int] = 3,
        device: DeviceLike = None,
    ):
        # hybrid archs carry a window-KV half alongside the state
        super().__init__(
            bundle,
            params,
            block_size=1,
            device_blocks=device_slots,
            cache_len=bundle.cfg.sliding_window or 1,
            event_log=event_log,
            injection=injection,
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
        self._snapshot_meta: Dict[str, object] = {}  # chain -> reconstruction spec

    # -- claims -------------------------------------------------------------
    def _chain_for(self, prefix: Tuple[int, ...]) -> str:
        return self.kind.object_id(prefix, self.block_size)

    def _claim_device_blocks(self, claim: ResidentClaim):
        chain = self._chain_for(self._claim_prefixes[claim.claim_id])
        bid = self.pool.prefix_index.get(chain)
        if bid is None:
            return None
        return [self.pool.blocks[bid]]

    def _tokens(self, toks) -> Dict[str, torch.Tensor]:
        return {"tokens": torch.tensor([toks], dtype=torch.int32, device=self.device)}

    def _prefill(self, toks):
        """One full-length prefill, timed as a ``prefill`` stage."""
        t0 = time.monotonic()
        logits, state = self._step_prefill(self.params, self._tokens(toks))
        device_sync(self.device)
        self._observe_stage("prefill", time.monotonic() - t0)
        return logits, state

    # -- materialization -----------------------------------------------------
    def materialize_claim(self, claim_id: str) -> KVBlock:
        """Prefill the claim prefix and snapshot the recurrent state."""
        claim = self.registry.get(claim_id)
        prefix = self._claim_prefixes[claim_id]
        req = self._new_request(prefix, 0)
        logits, state = self._prefill(prefix)
        # snapshot = (state, next-token logits): a recurrent state update is
        # NOT idempotent, so exact-prefix reuse must consume the stored
        # logits rather than replaying the last token through the state.
        payload, meta = _pack_state({"state": state, "logits": logits})
        chain = self._chain_for(prefix)
        self._snapshot_meta[chain] = meta
        blk = self.pool.add_block(
            prefix, chain, payload, torch.zeros(0, dtype=torch.uint8), np.arange(len(prefix)),
            claim_ids={claim_id},
        )
        self._materialize_claim(
            claim,
            materialized_tokens=len(prefix),
            n_blocks=1,
            footprint_bytes=blk.nbytes,
            request_id=req.request_id,
        )
        self._finish_ok(req)
        return blk

    # -- serve ------------------------------------------------------------------
    def _prepare_serve(self, req: Request):
        """Restore/prefill for one request: the per-request half of the
        decode pipeline (ordered, claim-scoped events preserved).

        Returns None when the request already terminated at the fail-closed
        restore boundary, else {req, state [B=1 tree], logits [V], pos}.
        """
        toks = req.tokens
        claims = self._matching_claims(toks)

        state = None
        logits = None
        consumed = 0
        if claims:
            claim = claims[0]
            prefix = self._claim_prefixes[claim.claim_id]
            chain = self._chain_for(prefix)
            dev_bid = self.pool.prefix_index.get(chain)
            if dev_bid is None:
                hit = self.connector.lookup_chain(chain, req.request_id, len(prefix))
                if hit is not None:
                    # THE shared restore-before-reuse boundary (EngineCore):
                    # restore_required -> load -> restored, or the fail-closed
                    # scheduler outcome — identical code to the KV path.
                    restore_claims = [claim] if claim.state == ClaimState.OFFLOADED else []
                    if not self._restore_for_request(req, [hit], restore_claims):
                        return None
                    dev_bid = self.pool.prefix_index.get(chain)
            if dev_bid is not None:
                blk = self.pool.blocks[dev_bid]
                snap = _unpack_state(blk.k, self._snapshot_meta[chain], self.device)
                state, logits = snap["state"], snap["logits"][0]
                consumed = len(prefix)
                req.cached_tokens = consumed

        # prefill any uncached part / decode from the (restored) state
        if state is None:
            logits, state = self._prefill(toks)
            logits = logits[0]
        else:
            for i, tok in enumerate(toks[consumed:]):
                lg, state = self._step_decode(
                    self.params, state,
                    torch.tensor([tok], dtype=torch.int32, device=self.device),
                    torch.tensor([consumed + i], dtype=torch.int32, device=self.device),
                )
                logits = lg[0]
        return {"req": req, "state": state, "logits": logits, "pos": len(toks)}

    def _stack_states(self, states: List[Any]):
        """Concatenate B single-request recurrent states along each leaf's
        batch axis (inferred once per bundle)."""
        if len(states) == 1:
            return states[0]
        axes = _state_batch_axes(self.bundle)
        return tree_map(lambda ax, *leaves: torch.cat(leaves, dim=ax), axes, *states)

    def serve(self, tokens: Sequence[int], max_new_tokens: int = 2) -> Request:
        """Serve a request whose prefix may hit a snapshot claim."""
        return self.serve_batch([tokens], max_new_tokens=max_new_tokens)[0]

    def serve_batch(
        self, token_seqs: Sequence[Sequence[int]], max_new_tokens: int = 2
    ) -> List[Request]:
        """Batched snapshot serving: per-request restore/prefill through the
        shared fail-closed boundary, then ONE step per token position for
        all survivors — recurrent states stacked on the batch axis through
        the same ragged greedy loop as the KV engine
        (EngineCore._greedy_decode_loop)."""
        self._release_claim_blocks(self.scheduler.sweep_expiry())
        reqs = [
            self._new_request(tuple(int(t) for t in toks), max_new_tokens)
            for toks in token_seqs
        ]
        # uniform for EVERY batch size (including 1): span tracing and
        # metrics reconciliation never special-case singletons
        self.events.emit(
            "batch_scheduled",
            batch_size=len(reqs),
            request_ids=[r.request_id for r in reqs],
        )
        entries = []
        for req in reqs:
            entry = self._prepare_serve(req)
            if entry is not None:
                entries.append(entry)
        if entries:
            # multi-request batches pad to the batch-width bucket (BATCH_PAD),
            # so every batched width runs one step shape; B=1 keeps its width
            rows = entries
            if len(entries) > 1:
                rows = entries + [entries[0]] * (
                    _round_up(len(entries), BATCH_PAD) - len(entries)
                )
            state = self._stack_states([e["state"] for e in rows])
            logits = torch.stack([e["logits"] for e in rows])  # [B_pad, V]
            step = lambda s, t, p: self._step_decode(self.params, s, t, p)
            try:
                self._greedy_decode_loop(
                    [e["req"] for e in entries],
                    state,
                    logits,
                    [e["pos"] for e in rows],
                    step,
                )
            except Exception as exc:  # noqa: BLE001 — launch boundary fails closed
                reason = f"{type(exc).__name__}: {exc}"
                for e in entries:
                    self._fail_closed_error(
                        e["req"], scope="decode_step",
                        trigger="decode_launch_failure", reason=reason,
                    )
                return reqs
        for e in entries:
            self._finish_ok(e["req"])
        return reqs

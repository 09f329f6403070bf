"""CacheObject kinds: the reusable object a ResidentClaim binds to.

The paper's ResidentClaim contract binds to a *reusable cache object* — the
thing a claim protects, offloads and restores.  The port serves two kinds:

  - ``KVChainKind``       — paged KV block chains (attention families); the
    object id is the block-aligned prefix chain hash, the predicate is
    ``leading_prefix_at_least(k)``, and the object materializes at the
    ``prefill_complete`` observation point.
  - ``StateSnapshotKind`` — recurrent-state snapshots (SSM / hybrid /
    xLSTM); the object id is the per-token chain over the full prefix, the
    predicate is ``state_at_token(k)``, and the object materializes at the
    ``state_snapshot`` observation point.

Everything else — acceptance, materialization events, offload, the
restore-before-reuse boundary, the fail-closed scheduler outcome — is kind-
independent and implemented exactly once in ``core_engine.EngineCore``.
A kind only answers identity questions: "what is this prefix's object id",
"what predicate does a claim over it carry", "what window bound applies".
"""
from __future__ import annotations

from typing import Optional, Tuple

from repro_torch.core.claims import MaterializationPredicate
from repro_torch.serving.kv_cache import prefix_object_id


class KVChainKind:
    """KV block chains: block-aligned prefix hash chains over paged KV."""

    name = "kv_chain"
    observation_point = "prefill_complete"
    # position-sliceable: any block-aligned prefix of a KV chain is a valid
    # KV chain, so pages are shareable across requests via the radix index
    shareable = True

    def object_id(self, prefix: Tuple[int, ...], block_size: int) -> str:
        return prefix_object_id(prefix, block_size)

    def predicate(
        self, prefix: Tuple[int, ...], block_size: int, k: Optional[int] = None
    ) -> MaterializationPredicate:
        usable = len(prefix) - len(prefix) % block_size
        return MaterializationPredicate(
            "leading_prefix_at_least", k if k is not None else usable
        )

    def window_limit(self, cfg) -> Optional[int]:
        # a sliding-window cache cannot hold a deeper leading prefix:
        # acceptance fails closed at the registry (core/claims.py)
        return cfg.sliding_window or None


class StateSnapshotKind:
    """Recurrent-state snapshots: one pseudo-block per materialized prefix."""

    name = "state_snapshot"
    observation_point = "state_snapshot"
    # a recurrent state summarizes its EXACT prefix — it cannot be sliced
    # at a block boundary, so snapshots are never shared across requests
    shareable = False

    def object_id(self, prefix: Tuple[int, ...], block_size: int) -> str:
        return prefix_object_id(prefix, 1)

    def predicate(
        self, prefix: Tuple[int, ...], block_size: int, k: Optional[int] = None
    ) -> MaterializationPredicate:
        return MaterializationPredicate("state_at_token", k if k is not None else len(prefix))

    def window_limit(self, cfg) -> Optional[int]:
        # a state snapshot summarizes the whole prefix regardless of any
        # attention window half (hybrid archs) — no acceptance bound
        return None

"""Deterministic, resumable synthetic token pipeline (a copy of the JAX
package's ``training/data.py``: numpy only, so batches are bitwise equal).

Every batch is a pure function of (seed, step, shard) — so a restarted or
re-sharded job replays the exact token stream from its checkpointed cursor
(the fault-tolerance contract: no data loss or duplication across restarts,
deliverable: checkpoint/restart).  The "corpus" is a mixture of Zipfian
unigrams and deterministic n-gram motifs so the LM loss actually decreases.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Iterator

import numpy as np


@dataclass
class DataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    zipf_a: float = 1.2
    motif_len: int = 8
    n_motifs: int = 64


class SyntheticLM:
    """Stateless batch generator with an explicit integer cursor."""

    def __init__(self, cfg: DataConfig):
        self.cfg = cfg
        base = np.random.default_rng(cfg.seed)
        # fixed motif table: repeated n-grams give the model learnable signal
        self.motifs = base.integers(
            0, cfg.vocab_size, (cfg.n_motifs, cfg.motif_len), dtype=np.int32
        )

    def batch_at(self, step: int) -> Dict[str, np.ndarray]:
        cfg = self.cfg
        rng = np.random.default_rng((cfg.seed, step))
        # Zipf-ish marginals via exponential ranks
        ranks = rng.zipf(cfg.zipf_a, size=(cfg.global_batch, cfg.seq_len))
        tokens = np.minimum(ranks, cfg.vocab_size - 1).astype(np.int32)
        # splice deterministic motifs
        n_splice = cfg.seq_len // (cfg.motif_len * 4)
        for b in range(cfg.global_batch):
            for _ in range(n_splice):
                m = rng.integers(0, cfg.n_motifs)
                pos = rng.integers(0, cfg.seq_len - cfg.motif_len)
                tokens[b, pos : pos + cfg.motif_len] = self.motifs[m]
        return {"tokens": tokens}

    def iterate(self, start_step: int = 0) -> Iterator[Dict[str, np.ndarray]]:
        step = start_step
        while True:
            yield self.batch_at(step)
            step += 1

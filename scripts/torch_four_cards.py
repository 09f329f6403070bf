#!/usr/bin/env python3
"""The port's sharded steps over NCCL with one rank per card, and the
KV-aware router over one serving replica per card.

    python3 scripts/torch_four_cards.py                      # all but the 32k cases, 4 cards
    python3 scripts/torch_four_cards.py --cases router       # the router alone
    python3 scripts/torch_four_cards.py --cases train_moe    # MoE training at full width
    python3 scripts/torch_four_cards.py --cases prefill_32k,decode_32k   # the 32k cells
    python3 scripts/torch_four_cards.py --world 2            # 2 x 1 and 1 x 2 meshes
    python3 scripts/torch_four_cards.py --device cpu --reduced --save DIR   # 4 gloo ranks

One set of ``--world`` processes (``torch.multiprocessing``, spawned) runs
every mesh case in order; each process takes its rank, the world size and a
``tcp://localhost`` port explicitly (nothing is read from a launcher's
environment) and joins a gloo group on the CPU or an NCCL group on its own
card (``launch.mesh.init_group``: rank r on ``cuda:r``).  Fewer cards than
``--world`` raises.  The meshes are (data, model) = (2, world / 2) and
(1, world).  Each case is held against the same step unsharded on one card
(rank 0's, ``cuda:0``) with the same seed-0 parameters and inputs:

  train      qwen3-1.7b ``train_4k``, full depth, 3 steps of 4 x 4096 tokens
             (``SyntheticLM``), lr 3e-5 with 2 warm-up steps, on the
             (2, world / 2) mesh: losses and grad norms within 1e-3 relative
             of ``Trainer``'s (5e-3 at ``--reduced`` on the CPU, the bf16
             bound of ``tests/test_torch_distribution.py``).
  prefill    qwen3-1.7b's sharded prefill of 4 x 2048 tokens on both meshes:
             logits max |d| <= 0.25 with the same greedy token per row, up
             to near-ties (``greedy_held``: two tokens whose one-card
             logits lie within 2 bf16 spacings, which either run's rounding
             may order its own way; each differing token is printed with
             its gap); every
             model rank's attention body launches K5 once per layer, with
             the position its query slice starts at as ``q_offset``.
  decode     qwen3-1.7b's sharded decode of 8 rows over 4096 cache slots, 4
             steps, on the (2, world / 2) mesh, as the prefill, with the
             bf16 weights and again with them in float32 (the KV cache
             stays bf16).
  attention  ``attention_prefill_sharded`` alone on the (1, world) mesh
             (2 x 64 queries, 4 heads over 2, D 16, causal, window 16,
             soft-cap 30, f32) against the unsharded attention: 1e-5.
  psum       ``compressed_psum`` of a different [64, 1000] f32 tensor per
             rank over the world group and over 'data': within 1e-6
             relative of each member's ``compress_roundtrip`` summed in
             group order (max |d| printed).
  moe        ``moe_apply_sharded`` on one layer at full width on the (2,
             world / 2) mesh: grok-1-314b with ``tp``, arctic-480b with
             ``ep`` and ``a2a``, 64 bf16 tokens.  Each rank dispatches its
             own token group with that group's capacity, as the reference's
             ``shard_map`` does (2 groups of 32 on 'data' for tp and ep, 4
             of 16 for a2a), so the one-card step is ``moe_apply_local``
             over each group (``moe_apply_grouped``), aux their mean: 2e-2
             (rtol and atol; 1e-6 in float32), aux 1e-5.
  grok       grok-1-314b's sharded prefill at 4 of its 64 layers (soft-cap
             30), 2 x 512 tokens, on the (1, world) mesh, twice: at grok's
             capacity factor (1.25) the comparison is recorded, with the
             (expert, token) slots each layer's dispatch kept in one run
             and not the other (an expert drops its latest tokens past its
             capacity, and rounding moves which; the compared last tokens
             go first), and held at ``--reduced``; with every expert given
             room for every token (capacity factor E / k, the same weights
             and tokens) it is held as the prefill.
  prefill_32k  ``prefill_32k``'s cell of qwen3-1.7b (28 layers, 16/8 heads, D
             128) and h2o-danube-1.8b (24 layers, 32/8 heads, D 80, window
             4096) at full width and depth, 4 x 32,768 tokens (the shape's
             batch of 32 cut to 4), on both meshes: held as ``prefill``,
             with K5's ``q_offset`` model rank x 32,768 / model ranks, and
             the cache each rank returns (h2o-danube's: the 4096-slot ring)
             equal as ``full()`` to the one-card cache within 0.25.
  decode_32k ``decode_32k``'s cell of both models, 4 rows over 32,768 slots
             (the shape's 128 rows cut to 4) after a 32,764-token prompt, 4
             steps (the last fills the last slot; h2o-danube's positions
             pass its 4096-slot ring), on both meshes, with bf16 weights and
             with them in float32: held as ``decode``; each step's
             all-gather bytes per device below a quarter of the rank's K+V
             cache shard.  Both 32k cases record each rank's step peak
             against the dry run of the same cell (``launch.dryrun`` in
             subprocesses beside the ranks; the bf16 decode held within
             15%) and its collectives beside the dry run's.
  train_moe  ``build_cell``'s train step of grok-1-314b (2 of 64 layers; ep,
             a2a and tp on (1, world), auto on (2, world / 2)) and
             arctic-480b (1 of 35; ep on (1, world)) at full width, with
             the full configs' int8 first moments and 8 micro-batches
             (``build_cell``'s ``opt_cfg`` and ``n_micro``: a depth cut
             would change both), 3 steps of 16 x 4096 tokens at lr 3e-5:
             finite losses starting untrained, grok's one-layer sharded step
             against ``one_card_moe_grads`` on rank 0's card, the strategies
             and meshes against each other (every expert with room for
             every token), the moments' dtypes, no kernel launch on any
             rank, and each rank's step peak within 15% of the dry run of
             the same cell (``launch.dryrun`` in subprocesses beside the
             ranks).  See ``case_train_moe``.

For each case rank 0 records the step's seconds (median of the runs after
the first) beside the one-card step's, every rank its
``torch.cuda.max_memory_allocated``, the per-kind collective counts and
bytes per device (``roofline.analysis.CollectiveCounter``) and the NCCL
kernels' device time in one profiled step (``torch.profiler``).

  router     in this process, after the ranks, with no process group: one
             full-width qwen3-1.7b ``ServingEngine`` per card (each with its
             own copy of the seed-0 weights), while this process's current
             card stays 0.  The ``routed_reuse`` scenario over them, then
             the serving phase's eight requests (four share a 256-token
             prefix, a claim that sits on the last card) through
             ``KVAwareRouter`` (the claim's prefix is prefilled on its card
             first, so the four requests on it reuse it and feed only their
             suffixes through decode steps), then claim witness path A
             (offload and restore through K3) on the third card.  Held: every gate;
             every request's greedy tokens equal to the same routing over
             four replicas that all sit on one card; the restored pages
             bitwise the pages before the offload; K1 and K2 launching for
             every card that served, K3 for the witness's card.

``--reduced`` runs the reduced configs at small sizes (train 4 x 32
tokens, prefill 4 x 64, decode 8 rows over 64 slots, train_moe one layer
at 16 x 128 with grok's four runs that give every expert room,
prefill_32k 4 x 64 and decode_32k 4 rows over 64 slots after a 60-token
prompt: the reduced h2o-danube's 16-key window reaches into the previous
rank's query slice on both meshes, and its decode passes the 16-slot ring).
The MoE layer runs in float32 on the CPU (held to 1e-6), bf16 on the
cards; the attention case in float32 everywhere.  Writes
``<out>/summary.json``; ``--save DIR``
also writes rank 0's inputs and outputs of the mesh cases as numpy
(``DIR/four_cards.npz``, the CPU tests' input).  The program exits 1 if any
case misses its limit or any rank fails, and catches nothing that would let
it exit 0 after a failure.
"""
from __future__ import annotations

import argparse
import gc
import json
import math
import os
import socket
import statistics
import subprocess
import sys
import time
from dataclasses import replace
from pathlib import Path

import numpy as np
import torch
import torch.multiprocessing as mp

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

MESH_CASES = ("train", "prefill", "decode", "attention", "psum", "moe", "grok", "train_moe",
              "prefill_32k", "decode_32k")
LONG_CASES = ("prefill_32k", "decode_32k")
LONG_ARCHS = ("qwen3-1.7b", "h2o-danube-1.8b")
CASES = MESH_CASES + ("router",)
DEFAULT_CASES = tuple(c for c in CASES if c not in LONG_CASES)  # the 32k cases: by name
JOIN_TIMEOUT_S = 1800
ROUTER_SPREAD = 1  # routed_reuse's worker i sits on card (i + 1) % world: w0 off the current card


def sizes(reduced: bool) -> dict:
    """The cases' shapes: full width, or the CPU tests' reduced sizes."""
    if reduced:  # train_moe: one layer (its 8 micro-batches are gloo-latency bound)
        return dict(reduced=True, train=(4, 32), prefill=(4, 64), decode=(8, 64, 16, 4),
                    grok=(2, 64), grok_layers=None, train_moe=(16, 128),
                    moe_layers={"grok-1-314b": 1, "arctic-480b": 1},
                    prefill_32k=(4, 64), decode_32k=(4, 64, 60, 4))
    # the 32k cells: prefill_32k's batch of 32 and decode_32k's 128 rows cut
    # to 4 (decode: ~15 GB of qwen3's cache, ~45 GB during a one-card step)
    return dict(reduced=False, train=(4, 4096), prefill=(4, 2048), decode=(8, 4096, 64, 4),
                grok=(2, 512), grok_layers=4, train_moe=(16, 4096),
                moe_layers={"grok-1-314b": 2, "arctic-480b": 1},
                prefill_32k=(4, 32768), decode_32k=(4, 32768, 32764, 4))


TRAIN_STEPS, TRAIN_LR = 3, 3e-5
MOE_TOKENS = 64
PSUM_SHAPE = (64, 1000)
ATTN = dict(B=2, S=64, H=4, KV=2, D=16)
ATTN_KW = dict(causal=True, window=16, softcap=30.0)


def card_line() -> str:
    """``nvidia-smi``'s name and power limit of the cards in use."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()
    return "; ".join(sorted(set(out)))


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def max_err(a, b) -> float:
    return float((a.float() - b.float()).abs().max())


def rel(a: float, b: float) -> float:
    return abs(a - b) / max(abs(b), 1e-12)


# ---------------------------------------------------------------------------
# one rank
# ---------------------------------------------------------------------------


class Rank:
    """A rank's state: its device, meshes, checks and records."""

    def __init__(self, rank: int, world: int, opts: dict):
        from repro_torch.device import resolve_device
        from repro_torch.launch.mesh import make_debug_mesh

        self.rank, self.world, self.opts = rank, world, opts
        self.cpu = opts["device"] == "cpu"
        self.dev = resolve_device(opts["device"])
        self.sz = sizes(opts["reduced"])
        self.meshes = {"dp": make_debug_mesh(2, world // 2, device=self.dev),
                       "tp": make_debug_mesh(1, world, device=self.dev)}
        self.checks = []
        self.saved = {}

    def mesh_name(self, key: str) -> str:
        m = self.meshes[key]
        return " x ".join(str(n) for n in m.shape)

    def check(self, ok, msg: str) -> None:
        self.checks.append({"ok": bool(ok), "msg": msg})
        print(f"[rank {self.rank}] {'ok  ' if ok else 'MISS'} {msg}", flush=True)

    def sync(self) -> None:
        if not self.cpu:
            torch.cuda.synchronize(self.dev)

    def save(self, name: str, t) -> None:
        """Rank 0's input or output ``name`` for ``--save`` (numpy, f32 for
        floating tensors)."""
        if self.opts["save"] and self.rank == 0:
            t = t.detach().cpu()
            self.saved[name] = (t.float() if t.is_floating_point() else t).numpy()

    def save_tree(self, prefix: str, tree) -> None:
        for k, v in tree.items():
            if isinstance(v, dict):
                self.save_tree(f"{prefix}/{k}", v)
            else:
                self.save(f"{prefix}/{k}", v)

    def timed(self, fn, runs: int):
        """``fn()`` ``runs`` times; (last result, the runs' seconds)."""
        out, secs = None, []
        for _ in range(runs):
            self.sync()
            t0 = time.monotonic()
            out = fn()
            self.sync()
            secs.append(time.monotonic() - t0)
        return out, secs

    def profile(self, fn):
        """``fn()`` once under the profiler: (result, device ms of the NCCL
        kernels, of K5's kernels (``flash`` in the name) and of all kernels,
        and K5's call count; None on the CPU, where nothing is traced)."""
        if self.cpu:
            return fn(), None
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            out = fn()
            self.sync()
        ev = prof.key_averages()
        dt = lambda e: getattr(e, "self_device_time_total", 0.0) / 1e3
        k5 = [e for e in ev if "flash" in e.key.lower()]
        return out, {"nccl_ms": sum(dt(e) for e in ev if "nccl" in e.key.lower()),
                     "k5_ms": sum(dt(e) for e in k5), "k5_calls": sum(e.count for e in k5),
                     "device_ms": sum(dt(e) for e in ev)}

    def step_peak(self, fn, args):
        """``fn()`` once: (result, the step's own peak bytes on this card:
        the shards of ``args`` plus the most the step allocated at once
        beside what was allocated before it, the dry run's ``peak``; None
        on the CPU)."""
        from repro_torch.launch.steps import argument_bytes_per_device

        if self.cpu:
            return fn(), None
        self.sync()
        before = torch.cuda.memory_allocated(self.dev)
        torch.cuda.reset_peak_memory_stats(self.dev)
        out = fn()
        self.sync()
        return out, (torch.cuda.max_memory_allocated(self.dev) - before
                     + argument_bytes_per_device(args))

    def counted(self, fn):
        from repro_torch.roofline.analysis import CollectiveCounter

        with CollectiveCounter() as c:
            out = fn()
        return out, c.summary()

    def free(self) -> None:
        gc.collect()
        if not self.cpu:
            torch.cuda.empty_cache()


def _median_after_first(secs):
    return statistics.median(secs[1:]) if len(secs) > 1 else secs[0]


def case_train(r: Rank) -> dict:
    from repro_torch.configs import ShapeSpec, get_config, reduced
    from repro_torch.launch import steps as st
    from repro_torch.models.registry import build_model
    from repro_torch.sharding.rules import full
    from repro_torch.training.data import DataConfig, SyntheticLM
    from repro_torch.training.optimizer import AdamWConfig, init_opt_state
    from repro_torch.training.train_loop import Trainer
    from repro_torch.training.tree import map_tree

    cfg = get_config("qwen3-1.7b")
    cfg = reduced(cfg) if r.opts["reduced"] else cfg
    B, S = r.sz["train"]
    mesh = r.meshes["dp"]
    opt_cfg = AdamWConfig(lr=TRAIN_LR, warmup_steps=2)
    cell = st.build_cell("qwen3-1.7b", "train_4k", mesh, cfg=cfg, opt_cfg=opt_cfg,
                         shape=ShapeSpec("train_4k", S, B, "train"))
    masters = map_tree(_f32, cell.bundle.init_params(torch.Generator().manual_seed(0)))
    r.save_tree("train/masters", masters)
    params = st.distribute_argument(cell, "params", masters)
    opt = st.distribute_argument(cell, "opt_state", init_opt_state(masters, opt_cfg))
    del masters
    r.free()
    if not r.cpu:  # the steps' own peak, past the full tensors the shards were cut from
        torch.cuda.reset_peak_memory_stats(r.dev)
    data = SyntheticLM(DataConfig(cfg.vocab_size, S, B))
    got, secs = [], []
    for i in range(TRAIN_STEPS):
        batch_np = data.batch_at(i)
        for k, v in batch_np.items():
            r.save(f"train/batch{i}/{k}", torch.from_numpy(v))
        batch = st.distribute_argument(
            cell, "batch", {k: torch.from_numpy(v).to(r.dev) for k, v in batch_np.items()})
        (params, opt, m), dt = r.timed(lambda: st.run_cell(cell, (params, opt, batch)), 1)
        got.append({"loss": float(full(m["loss"])), "grad_norm": float(full(m["grad_norm"]))})
        secs.append(dt[0])
    step_peak = None if r.cpu else torch.cuda.max_memory_allocated(r.dev)
    # two more steps past the compared ones: one counted, one profiled
    (params, opt, _), coll = r.counted(lambda: st.run_cell(cell, (params, opt, batch)))
    (params, opt, _), prof = r.profile(lambda: st.run_cell(cell, (params, opt, batch)))
    del params, opt, cell
    r.free()
    rec = {"mesh": r.mesh_name("dp"), "tokens": [B, S], "layers": cfg.num_layers,
           "sharded": got, "sharded_step_s": secs,
           "sharded_step_s_median": _median_after_first(secs), "collectives": coll,
           "profiled": prof, "step_peak_bytes": step_peak}
    torch.distributed.barrier()
    if r.rank == 0:
        tr = Trainer(build_model(cfg, device=r.dev), data_cfg=DataConfig(cfg.vocab_size, S, B),
                     opt_cfg=opt_cfg, seed=0)
        want = tr.run(TRAIN_STEPS, log_every=0)
        del tr
        r.free()
        rec["one_card"] = [{"loss": w["loss"], "grad_norm": w["grad_norm"]} for w in want]
        rec["one_card_step_s"] = [w["dt_s"] for w in want]
        rec["one_card_step_s_median"] = _median_after_first(rec["one_card_step_s"])
        worst = max(max(rel(g["loss"], w["loss"]), rel(g["grad_norm"], w["grad_norm"]))
                    for g, w in zip(got, want))
        limit = 5e-3 if r.opts["reduced"] else 1e-3
        rec["max_rel"], rec["limit"] = worst, limit
        r.check(all(math.isfinite(g["loss"]) and math.isfinite(g["grad_norm"]) for g in got)
                and worst <= limit,
                f"train {cfg.name} ({cfg.num_layers} layers, {B} x {S}) on {rec['mesh']}: losses "
                f"{[round(g['loss'], 5) for g in got]} vs one card "
                f"{[round(w['loss'], 5) for w in want]}, max relative difference {worst:.3e} "
                f"(limit {limit:g}); step s {rec['sharded_step_s_median']:.3f} vs one card "
                f"{rec['one_card_step_s_median']:.3f}")
    torch.distributed.barrier()
    return rec


def greedy_report(got, want) -> dict:
    """Rows whose greedy token differs between two logit matrices [rows,
    V], each with the one-card logits' gap between the two tokens, in
    units of the bf16 spacing at the one-card maximum (a gap of 0 is an
    exact tie that the other run's rounding breaks the other way)."""
    g, w = got.float(), want.float()
    ga, wa = g.argmax(-1), w.argmax(-1)
    flips = []
    for row in torch.nonzero(ga != wa).flatten().tolist():
        top = float(w[row, wa[row]])
        gap = top - float(w[row, ga[row]])
        ulp = 2.0 ** (math.floor(math.log2(abs(top))) - 7) if top else 2.0 ** -133
        flips.append({"row": row, "gap": gap, "gap_bf16_spacings": gap / ulp})
    return {"rows": int(wa.numel()), "equal": int((ga == wa).sum()), "flips": flips}


NEAR_TIE = 2.0  # bf16 spacings: a greedy token may differ only between two logits this close


def greedy_held(report) -> bool:
    """Every greedy token equal, except between two tokens whose one-card
    logits lie within ``NEAR_TIE`` bf16 spacings (an exact or near tie that
    the other run's rounding, a few spacings at this width, breaks its
    own way)."""
    return all(f["gap_bf16_spacings"] <= NEAR_TIE for f in report["flips"])


class DispatchSpy:
    """Records which (expert, token) slots every MoE dispatch inside its
    ``with`` kept (``models.moe._dispatch``: a token past an expert's
    capacity is dropped), one set per call, in call order (one per layer)."""

    def __enter__(self):
        from repro_torch.models import moe

        self.moe, self.real, self.kept = moe, moe._dispatch, []

        def spy(x, router, k, capacity):
            out = self.real(x, router, k, capacity)
            T = x.shape[-2]
            st = out[0].reshape(-1, *out[0].shape[-2:])[0]  # [E, C] of the first group
            e, c = torch.nonzero(st < T, as_tuple=True)
            self.kept.append(set(zip(e.tolist(), st[e, c].tolist())))
            return out

        moe._dispatch = spy
        return self

    def __exit__(self, *exc):
        self.moe._dispatch = self.real


class OffsetSpy:
    """Records the ``q_offset`` of every ``attention_contiguous`` call (the
    sharded attention body's kernel route) inside its ``with``."""

    def __enter__(self):
        from repro_torch.models import layers

        self.layers, self.real, self.offsets = layers, layers.attention_contiguous, []

        def spy(*a, q_offset=0, **kw):
            self.offsets.append(int(q_offset))
            return self.real(*a, q_offset=q_offset, **kw)

        layers.attention_contiguous = spy
        return self

    def __exit__(self, *exc):
        self.layers.attention_contiguous = self.real


def _sharded_prefill(r: Rank, name: str, arch: str, cfg, params, bundle, tokens, mesh_key,
                     runs: int = 3, hold: bool = True, long: bool = False) -> dict:
    """A sharded prefill cell against ``bundle.prefill_fn`` on rank 0's
    card: logits, K5 launches and query offsets per rank, times; for an
    MoE model the MoE dispatches of both runs compared layer by layer.
    ``hold=False`` records the logits' agreement without holding it.
    ``long`` (the 32k cells) adds the step's own peak on each rank and the
    cache each rank returns, gathered layer by layer (``full()``), against
    the one-card cache: max |d| <= 0.25 per side, the positions equal."""
    from repro_torch.configs import ShapeSpec
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.launch import steps as st
    from repro_torch.sharding.rules import full

    B, S = tokens.shape
    mesh = r.meshes[mesh_key]
    cell = st.build_cell(arch, "prefill_32k", mesh, cfg=cfg,
                         shape=ShapeSpec("prefill_32k", S, B, "prefill"))
    pd = st.distribute_argument(cell, "params", params)
    bd = st.distribute_argument(cell, "batch", {"tokens": tokens})
    step = lambda: st.run_cell(cell, (pd, bd))
    step()  # the first run: excluded from the median
    n0 = fa.flash_attention.launches
    with OffsetSpy() as spy, DispatchSpy() as kept:
        (logits, _), coll = r.counted(step)
    k5 = fa.flash_attention.launches - n0
    (logits, cache), secs = r.timed(step, runs - 1)
    _, prof = r.profile(step)
    logits = full(logits)
    tp_n = dict(zip(mesh.mesh_dim_names, mesh.shape))["model"]
    m_rank = mesh.get_local_rank("model")
    want_off = m_rank * (S // tp_n)
    rec = {"mesh": r.mesh_name(mesh_key), "tokens": [B, S], "layers": cfg.num_layers,
           "model_rank": m_rank, "k5_launches": k5, "q_offsets": sorted(set(spy.offsets)),
           "sharded_step_s_median": statistics.median(secs), "collectives": coll,
           "profiled": prof}
    del cache
    if long:
        (_, cache), rec["step_peak_bytes"] = r.step_peak(step, (pd, bd))
    if not r.cpu:  # on the CPU the body is the plain attention: no kernel, no spy
        r.check(k5 == cfg.num_layers and spy.offsets == [want_off] * cfg.num_layers,
                f"{name} {cfg.name} on {rec['mesh']}: model rank {m_rank} launched K5 {k5} times "
                f"({cfg.num_layers} layers) with q_offset {sorted(set(spy.offsets))} (expected "
                f"{want_off})")
    r.save(f"{name}/{arch}/{rec['mesh']}/logits" if long else f"{name}/{rec['mesh']}/logits",
           logits)
    del cell, pd, bd
    r.free()
    torch.distributed.barrier()
    want_cache = None
    if r.rank == 0:
        with DispatchSpy() as kept1:
            (want, want_cache), usecs = r.timed(
                lambda: bundle.prefill_fn(params, {"tokens": tokens}, S), 1)
        if not long:
            want_cache = None
        _, more = r.timed(lambda: bundle.prefill_fn(params, {"tokens": tokens}, S)[0], runs - 1)
        e = max_err(logits, want)
        greedy = greedy_report(logits, want)
        same = greedy_held(greedy)
        rec.update(max_abs=e, argmax_equal=greedy["equal"] == greedy["rows"], greedy=greedy,
                   one_card_step_s_median=_median_after_first(usecs + more))
        if kept.kept:  # (expert, token) slots kept by one run and not the other, per layer
            rec["moe_slots_differing"] = [len(a ^ b) for a, b in zip(kept.kept, kept1.kept)]
            rec["moe_slots_kept"] = [len(b) for b in kept1.kept]
        ok = bool(torch.isfinite(logits).all()) and tuple(logits.shape) == (B, cfg.vocab_size)
        msg = (f"{name} {cfg.name} {B} x {S} on {rec['mesh']}: logits max|d| {e:.3e} vs one card "
               f"(limit 0.25), greedy tokens equal {greedy['equal']}/{greedy['rows']} (differing "
               f"only at near-ties of <= {NEAR_TIE:g} bf16 spacings: {same}; {greedy['flips']})"
               + (f", MoE slots differing per layer {rec['moe_slots_differing']} of "
                  f"{rec['moe_slots_kept']}" if kept.kept else "")
               + f"; {rec['sharded_step_s_median']:.4f} s vs {rec['one_card_step_s_median']:.4f} s")
        if hold:
            r.check(ok and e <= 0.25 and same, msg)
        else:
            print(f"[rank 0] recorded, not held: {msg}", flush=True)
    if long:
        _cache_against_one_card(r, name, cfg, rec, cache, want_cache)
        del cache, want_cache
        r.free()
    torch.distributed.barrier()
    return rec


def _cache_against_one_card(r: Rank, name: str, cfg, rec: dict, cache, want) -> None:
    """The sharded prefill's cache gathered one layer at a time (every rank
    joins each gather) against rank 0's one-card cache ``want``."""
    from repro_torch.sharding.rules import full

    rec["cache_shard_bytes"] = sum(_local_bytes(cache[k]) for k in ("k", "v"))
    errs = {}
    for key in ("k", "v"):
        errs[key] = 0.0
        for i in range(cfg.num_layers):
            got = full(cache[key][i])
            if want is not None:
                errs[key] = max(errs[key], max_err(got, want[key][i]))
            del got
    pos = full(cache["pos"])
    if want is not None:
        same_pos = torch.equal(pos.to(want["pos"].dtype), want["pos"])
        slots = want["k"].shape[2]
        rec.update(cache_max_abs=errs, cache_pos_equal=same_pos, cache_slots=slots)
        r.check(max(errs.values()) <= 0.25 and same_pos,
                f"{name} {cfg.name} on {rec['mesh']}: the cache every rank returns ({slots} slots, "
                f"{cfg.num_layers} layers) as full() against the one-card cache: k max|d| "
                f"{errs['k']:.3e}, v {errs['v']:.3e} (limit 0.25), positions equal {same_pos}")


def _local_bytes(t) -> int:
    loc = t.to_local() if hasattr(t, "to_local") else t
    return loc.numel() * loc.element_size()


def _model(r: Rank, arch: str = "qwen3-1.7b"):
    """``arch`` at full width and depth (``--reduced``: its reduced config)
    with its seed-0 weights on this rank's device."""
    from repro_torch.configs import get_config, reduced
    from repro_torch.models.registry import build_model

    cfg = get_config(arch)
    cfg = reduced(cfg) if r.opts["reduced"] else cfg
    bundle = build_model(cfg, device=r.dev)
    return cfg, bundle, bundle.init_params(torch.Generator().manual_seed(0))


def case_prefill(r: Rank) -> dict:
    cfg, bundle, params = _model(r)
    r.save_tree("qwen/params", params)
    B, S = r.sz["prefill"]
    rng = np.random.default_rng(18)
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)).to(r.dev)
    r.save("prefill/tokens", tokens)
    return {r.mesh_name(key): _sharded_prefill(r, "prefill", "qwen3-1.7b", cfg, params, bundle,
                                               tokens, key)
            for key in ("dp", "tp")}


def case_decode(r: Rank) -> dict:
    """The sharded decode twice, each held to max |d| <= 0.25 with the
    greedy tokens equal up to near-ties (``greedy_held``): with the model's
    bf16 weights, and with the same weights in float32 (the KV cache stays
    bf16, the config's ``kv_cache_dtype``), which shows how much of the
    difference is bf16 rounding."""
    from repro_torch.training.tree import map_tree

    cfg, bundle, params = _model(r)
    rec = {"bfloat16": _decode(r, cfg, bundle, params)}
    params = map_tree(_f32, params)
    r.free()
    rec["float32"] = _decode(r, cfg, bundle, params)
    return rec


def _cut(r: Rank, case: str, what: str) -> None:
    if r.rank == 0:
        from repro_torch.configs import SHAPES_BY_NAME

        shape = SHAPES_BY_NAME[case]
        print(f"[rank 0] {case}: {what} (the shape's {shape.global_batch} x {shape.seq_len} cut "
              f"in its batch{'; --reduced' if r.opts['reduced'] else ''})", flush=True)


def case_prefill_32k(r: Rank) -> dict:
    """``prefill_32k``'s cell of each of LONG_ARCHS on both meshes (see the
    module's docstring)."""
    B, S = r.sz["prefill_32k"]
    _cut(r, "prefill_32k", f"{B} x {S} tokens")
    rec = {}
    for j, arch in enumerate(LONG_ARCHS):
        cfg, bundle, params = _model(r, arch)
        r.save_tree(f"{arch}/params", params)
        rng = np.random.default_rng(30 + j)
        tokens = torch.from_numpy(rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32))
        tokens = tokens.to(r.dev)
        r.save(f"prefill_32k/{arch}/tokens", tokens)
        rec[arch] = {r.mesh_name(key): _sharded_prefill(r, "prefill_32k", arch, cfg, params,
                                                        bundle, tokens, key, runs=2, long=True)
                     for key in ("dp", "tp")}
        del bundle, params, tokens
        r.free()
    return rec


def case_decode_32k(r: Rank) -> dict:
    """``decode_32k``'s cell of each of LONG_ARCHS on both meshes, with bf16
    weights and with them in float32: each (arch, weights) prefills its
    prompt once on every rank (the one-card cache, kept on the host between
    the meshes: 15 GB of qwen3's at full size), then ``_decode`` on each
    mesh from it."""
    from repro_torch.training.tree import map_tree

    rows, slots, plen, steps = r.sz["decode_32k"]
    _cut(r, "decode_32k", f"{rows} rows over {slots} slots after a {plen}-token prompt, "
                          f"{steps} steps")
    rec = {}
    for j, arch in enumerate(LONG_ARCHS):
        cfg, bundle, params = _model(r, arch)
        r.save_tree(f"{arch}/params", params)
        rng = np.random.default_rng(40 + j)
        prompt = torch.from_numpy(rng.integers(0, cfg.vocab_size, (rows, plen)).astype(np.int32))
        prompt = prompt.to(r.dev)
        r.save(f"decode_32k/{arch}/prompt", prompt)
        rec[arch] = {}
        for dt in ("bfloat16", "float32"):
            if dt == "float32":
                params = map_tree(_f32, params)
                r.free()
            logits, cache = bundle.prefill_fn(params, {"tokens": prompt}, slots)
            host = {k: v.cpu() for k, v in cache.items()}
            del cache
            r.free()
            rec[arch][dt] = {
                r.mesh_name(key): _decode(r, cfg, bundle, params, arch=arch, mesh_key=key,
                                          size="decode_32k", prefilled=(logits, host),
                                          save_as=f"decode_32k/{arch}/{r.mesh_name(key)}")
                for key in ("dp", "tp")}
            del logits, host
        del bundle, params
        r.free()
    return rec


def _f32(t):
    return t.float() if t.is_floating_point() else t


def _decode(r: Rank, cfg, bundle, params, limit: float = 0.25, *, arch: str = "qwen3-1.7b",
            mesh_key: str = "dp", size: str = "decode", prefilled=None,
            save_as: str = "decode") -> dict:
    """``steps`` sharded decode steps of ``size``'s rows and slots on
    ``mesh_key``'s mesh against ``bundle.decode_fn`` from the same cache,
    each fed the one-card step's greedy tokens.  ``prefilled``: the
    prompt's (logits, cache), the cache possibly on the host; by default
    the prompt is drawn here and prefilled.  Records each rank's step peak
    and collectives; ``decode_32k`` also holds the step's all-gather bytes
    below a quarter of this rank's K+V cache shard."""
    from repro_torch.configs import ShapeSpec
    from repro_torch.launch import steps as st
    from repro_torch.sharding.rules import full

    dtype = str(params["embed"].dtype).removeprefix("torch.")
    rows, slots, plen, steps = r.sz[size]
    if prefilled is None:
        rng = np.random.default_rng(19)
        prompt = torch.from_numpy(rng.integers(0, cfg.vocab_size, (rows, plen)).astype(np.int32))
        prompt = prompt.to(r.dev)
        r.save(f"{save_as}/prompt", prompt)
        logits, cache = bundle.prefill_fn(params, {"tokens": prompt}, slots)
    else:
        logits, cache = prefilled[0], {k: v.to(r.dev) for k, v in prefilled[1].items()}
    mesh = r.meshes[mesh_key]
    cell = st.build_cell(arch, "decode_32k", mesh, cfg=cfg,
                         shape=ShapeSpec("decode_32k", slots, rows, "decode"))
    pd = st.distribute_argument(cell, "params", params)
    cd = st.distribute_argument(cell, "cache", cache)
    shard = sum(_local_bytes(cd[k]) for k in ("k", "v"))
    worst, greedy, secs, usecs = 0.0, [], [], []
    for i in range(steps):
        tok = logits.argmax(-1).to(torch.int32)
        pos = torch.full((rows,), plen + i, dtype=torch.int32, device=r.dev)
        if dtype == "bfloat16":
            r.save(f"{save_as}/tokens{i}", tok)
        args = (pd, cd, st.distribute_argument(cell, "tokens", tok),
                st.distribute_argument(cell, "cur_pos", pos))
        (ls, cd), dt = r.timed(lambda: st.run_cell(cell, args), 1)
        secs += dt
        ls = full(ls)
        if dtype == "bfloat16":
            r.save(f"{save_as}/logits{i}", ls)
        (logits, cache), dt = r.timed(lambda: bundle.decode_fn(params, cache, tok, pos), 1)
        usecs += dt
        worst = max(worst, max_err(ls, logits))
        greedy.append(greedy_report(ls, logits))
    # the last step again: once counted, once profiled, once for its peak
    _, coll = r.counted(lambda: st.run_cell(cell, args))
    _, prof = r.profile(lambda: st.run_cell(cell, args))
    _, peak = r.step_peak(lambda: st.run_cell(cell, args), args)
    equal = sum(g["equal"] for g in greedy)
    flips = [dict(f, step=i) for i, g in enumerate(greedy) for f in g["flips"]]
    rec = {"mesh": r.mesh_name(mesh_key), "dtype": dtype, "rows": rows, "slots": slots,
           "cache_slots": int(cd["k"].shape[2]), "prompt": plen, "steps": steps,
           "max_abs": worst, "limit": limit, "greedy_equal": equal, "greedy_flips": flips,
           "sharded_step_s_median": _median_after_first(secs),
           "one_card_step_s_median": _median_after_first(usecs), "collectives": coll,
           "profiled": prof, "step_peak_bytes": peak, "cache_shard_bytes": shard}
    label = f"{size} {cfg.name} {dtype} weights {rows} rows over {slots} slots"
    if r.rank == 0:
        held = worst <= limit and greedy_held({"flips": flips})
        r.check(held, f"{label}, {steps} steps on {rec['mesh']}: logits max|d| {worst:.3e} vs one "
                      f"card (limit {limit:g}); greedy tokens equal {equal}/{rows * steps}, "
                      f"differing only at near-ties of <= {NEAR_TIE:g} bf16 spacings ({flips}); "
                      f"step s {rec['sharded_step_s_median']:.4f} vs "
                      f"{rec['one_card_step_s_median']:.4f}")
    if size == "decode_32k" and not r.opts["reduced"]:  # no gather of the sequence-sharded
        ag = coll["all-gather"]["bytes"]  # cache (a reduced cache is smaller than the activations)
        r.check(ag < shard / 4, f"{label} on {rec['mesh']}: a step's all-gathers move {ag} B per "
                                f"device, below a quarter of this rank's K+V cache shard "
                                f"({shard} B)")
    del cell, pd, cd, cache
    r.free()
    return rec


def case_attention(r: Rank) -> dict:
    """The sharded attention body alone on the (1, world) mesh: each model
    rank's query slice (starts 0, 16, 32, 48 of 64 on four ranks)."""
    from repro_torch.models.layers import attention_prefill, attention_prefill_sharded
    from repro_torch.sharding.rules import distribute

    mesh = r.meshes["tp"]
    B, S, H, KV, D = (ATTN[k] for k in ("B", "S", "H", "KV", "D"))
    rng = np.random.default_rng(5)
    q, k, v = (torch.from_numpy(rng.standard_normal(s).astype(np.float32)).to(r.dev)
               for s in ((B, S, H, D), (B, S, KV, D), (B, S, KV, D)))
    for name, t in (("q", q), ("k", k), ("v", v)):
        r.save(f"attention/{name}", t)
    pos = torch.arange(S, device=r.dev)[None].expand(B, S).contiguous()
    qd = distribute(q, (("data",), "model", None, None), mesh)
    kd = distribute(k, (("data",), None, None, None), mesh)
    vd = distribute(v, (("data",), None, None, None), mesh)
    with OffsetSpy() as spy:
        out = attention_prefill_sharded(qd, kd, vd, q_positions=pos, kv_positions=pos, mesh=mesh,
                                        contiguous=True, **ATTN_KW).full_tensor()
    r.save("attention/out", out)
    want = attention_prefill(q, k, v, q_positions=pos, kv_positions=pos, **ATTN_KW)
    e = max_err(out, want)
    start = mesh.get_local_rank("model") * (S // r.world)
    rec = {"mesh": r.mesh_name("tp"), "slice_start": start, "q_offsets": spy.offsets,
           "max_abs": e}
    r.check(e <= 1e-5 and (r.cpu or spy.offsets == [start]),
            f"attention body on {rec['mesh']}: query slice at {start}, kernel offsets "
            f"{spy.offsets}, max|d| {e:.3e} vs unsharded (limit 1e-5)")
    return rec


def case_psum(r: Rank) -> dict:
    import torch.distributed as dist

    from repro_torch.training.compression import compress_roundtrip, compressed_psum

    mesh = r.meshes["dp"]
    shards = [torch.randn(PSUM_SHAPE, generator=torch.Generator().manual_seed(100 + i))
              for i in range(r.world)]
    mine = shards[r.rank].to(r.dev)
    for i, t in enumerate(shards):
        r.save(f"psum/shard{i}", t)
    rec = {}
    for label, group in (("world", dist.group.WORLD), ("data", mesh.get_group("data"))):
        members = dist.get_process_group_ranks(group)
        compressed_psum(mine, group)  # warm
        r.sync()
        t0 = time.monotonic()
        got, coll = r.counted(lambda: compressed_psum(mine, group))
        r.sync()
        dt = time.monotonic() - t0
        want = None
        for m in members:
            d = compress_roundtrip(shards[m].to(r.dev))
            want = d if want is None else want + d
        e = max_err(got, want)
        bound = float((1e-6 * want.abs()).min())
        ok = bool(((got - want).abs() <= 1e-6 * want.abs()).all())
        rec[label] = {"members": members, "max_abs": e, "seconds": dt, "collectives": coll}
        r.save(f"psum/{label}", got)
        r.check(ok, f"compressed psum over {label} {members}: max|d| {e:.3e} against the members' "
                    f"compress_roundtrip summed in group order (within 1e-6 relative; smallest "
                    f"bound {bound:.1e})")
    return rec


def case_moe(r: Rank) -> dict:
    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch.configs import get_config, reduced
    from repro_torch.models.moe import moe_apply_grouped, moe_apply_sharded, moe_init
    from repro_torch.sharding.rules import distribute, param_pspecs

    mesh = r.meshes["dp"]
    dtype = torch.float32 if r.cpu else torch.bfloat16
    rec = {}
    for arch, strategies in (("grok-1-314b", ("tp",)), ("arctic-480b", ("ep", "a2a"))):
        cfg = get_config(arch)
        cfg = reduced(cfg) if r.opts["reduced"] else cfg
        gen = torch.Generator(device=r.dev).manual_seed(0)
        p = {k: t.to(dtype) if t.is_floating_point() and k != "router" else t
             for k, t in moe_init(gen, cfg).items()}
        x = torch.randn((MOE_TOKENS, cfg.d_model), generator=gen, device=r.dev).to(dtype)
        r.save_tree(f"moe/{arch}/params", p)
        r.save(f"moe/{arch}/x", x)
        nbytes = sum(t.numel() * t.element_size() for k, t in p.items() if k != "router")
        specs = param_pspecs(cfg, {"layers": {"moe": p}}, mesh)["layers"]["moe"]
        pd = {k: distribute(t, specs[k], mesh) for k, t in p.items()}
        if r.rank != 0:
            del p
        r.free()
        for strategy in strategies:
            x_spec = (("data", "model"), None) if strategy == "a2a" else (("data",), None)
            xd = distribute(x, x_spec, mesh)

            def step():
                with implicit_replication(), torch.no_grad():
                    out, a = moe_apply_sharded(pd, xd, cfg, mesh, strategy=strategy)
                    return out.full_tensor(), a.full_tensor()

            step()
            (out, aux), coll = r.counted(step)
            _, secs = r.timed(step, 2)
            _, prof = r.profile(step)
            r.save(f"moe/{arch}/{strategy}/out", out)
            r.save(f"moe/{arch}/{strategy}/aux", aux)
            rec[f"{arch}/{strategy}"] = {"expert_bytes": nbytes,
                                         "sharded_s_median": statistics.median(secs),
                                         "collectives": coll, "profiled": prof}
            torch.distributed.barrier()
            if r.rank == 0:
                groups = r.world if strategy == "a2a" else 2  # 'data' x 'model', or 'data'

                def one_card():
                    with torch.no_grad():
                        o, a = moe_apply_grouped(p, x.reshape(groups, -1, cfg.d_model), cfg)
                        return o.reshape(-1, cfg.d_model), a.mean()

                (want, waux), usecs = r.timed(one_card, 3)
                e, ea = max_err(out, want), abs(float(aux) - float(waux))
                tol = 1e-6 if dtype == torch.float32 else 2e-2
                ok = bool(torch.allclose(out.float(), want.float(), rtol=tol, atol=tol))
                rec[f"{arch}/{strategy}"].update(max_abs=e, aux_abs=ea,
                                                 one_card_s_median=_median_after_first(usecs))
                r.check(ok and ea <= 1e-5,
                        f"moe {cfg.name} layer ({nbytes / 1e9:.2f} GB of experts) {strategy} on "
                        f"{r.mesh_name('dp')}: max|d| {e:.3e} vs moe_apply_local over its "
                        f"{groups} token groups on one card "
                        f"(limit {tol:g}), aux |d| {ea:.2e} (limit 1e-5); "
                        f"{statistics.median(secs):.4f} s vs {_median_after_first(usecs):.4f} s")
            torch.distributed.barrier()
        del pd
        p = None
        r.free()
    return rec


def case_grok(r: Rank) -> dict:
    from repro_torch.configs import get_config, reduced
    from repro_torch.models.registry import build_model

    cfg = get_config("grok-1-314b")
    if r.opts["reduced"]:
        cfg = reduced(cfg)
    else:
        cfg = cfg.replace(num_layers=r.sz["grok_layers"])
    bundle = build_model(cfg, device=r.dev)
    params = bundle.init_params(torch.Generator().manual_seed(0))
    B, S = r.sz["grok"]
    rng = np.random.default_rng(12)
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)).to(r.dev)
    r.save("grok/tokens", tokens)
    r.save_tree("grok/params", params)
    # at grok's capacity factor an expert drops the tokens past its capacity,
    # latest first: which tokens (the compared last ones first) overflow
    # moves with either run's rounding, so that comparison is recorded and
    # the layer-by-layer dispatch difference beside it; the held one gives
    # every expert room for all tokens (capacity factor E / k), the same
    # weights and tokens
    E, k = cfg.moe.num_experts, cfg.moe.experts_per_token
    room = cfg.replace(moe=replace(cfg.moe, capacity_factor=E / k))
    rec = {"capacity_factor": cfg.moe.capacity_factor,
           "model_capacity": _sharded_prefill(r, "grok", "grok-1-314b", cfg, params, bundle,
                                              tokens, "tp", hold=r.opts["reduced"])}
    rec["no_drop"] = _sharded_prefill(r, "grok (every expert with room for every token)",
                                      "grok-1-314b", room, params, build_model(room, device=r.dev),
                                      tokens, "tp")
    return rec


# ---------------------------------------------------------------------------
# MoE training: the reference's build_cell train step at full width
# ---------------------------------------------------------------------------

# (arch, mesh key, MoE strategy, every expert with room for every token)
MOE_RUNS = (("grok-1-314b", "tp", "ep", False),
            ("grok-1-314b", "tp", "ep", True),
            ("grok-1-314b", "tp", "a2a", True),
            ("grok-1-314b", "tp", "tp", True),
            ("grok-1-314b", "dp", "auto", True),
            ("arctic-480b", "tp", "ep", False))
MOE_HOLD = 5e-3  # relative: strategies, meshes and the one-card grad norm (bf16, f32 index_add_)
MOE_ONE_CARD_LOSS = 1e-3  # relative: the sharded one-layer step's first loss against one card
PEAK_HOLD = 0.15  # a rank's step peak against the dry run's prediction


def moe_cfg(arch: str, sz: dict, *, layers=None, room: bool = False):
    """The config a train_moe run trains: full width (``--reduced``: the
    reduced config) cut to the case's depth, ``layers`` cutting further;
    ``room`` gives every expert room for every token (capacity factor E /
    k), so no token drops whatever the grouping and the rounding."""
    from repro_torch.configs import get_config, reduced

    cfg = get_config(arch)
    cfg = (reduced(cfg) if sz["reduced"] else cfg).replace(num_layers=sz["moe_layers"][arch])
    if layers:
        cfg = cfg.replace(num_layers=layers)
    if room:
        E, k = cfg.moe.num_experts, cfg.moe.experts_per_token
        cfg = cfg.replace(moe=replace(cfg.moe, capacity_factor=E / k))
    return cfg


def moe_train_setup(arch: str):
    """The full config's optimizer (int8 first moments) and micro-batch
    count (8), at the case's lr: both key on the full config's parameter
    count, which the depth cut would change."""
    from repro_torch.configs import get_config
    from repro_torch.launch.steps import microbatches_for, optimizer_for

    full_cfg = get_config(arch)
    return (replace(optimizer_for(full_cfg), lr=TRAIN_LR, warmup_steps=2),
            microbatches_for(full_cfg))


def untrained_loss(cfg) -> float:
    """An untrained model's loss: ln V + sigma^2 / 2 for logits of std
    sigma = 0.02 sqrt(d) (phase 17's criterion, ``PERF.md`` section 2)."""
    return math.log(cfg.vocab_size) + 0.02 ** 2 * cfg.d_model / 2


def kernel_launches() -> int:
    """Launches of every kernel wrapper so far (K1-K5, the GEMM, the
    norms, the contractions): a training step must add none."""
    from repro_torch.kernels import contract, gemm, norm
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import kv_block_copy as kbc
    from repro_torch.kernels import paged_attention as pa

    return sum(w.launches for w in (pa.paged_decode_attention, pa.paged_prefill_attention,
                                    pa.paged_attention, kbc.kv_block_copy, fa.flash_attention,
                                    gemm.gemm, norm.norm, contract.contract))


def one_card_moe_grads(cfg, batch: dict, n_micro: int, device) -> dict:
    """The unsharded ``loss_and_grads`` of ``cfg`` (seed-0 weights drawn on
    ``device``) over ``batch`` (numpy) in ``n_micro`` micro-batches: the
    train_moe case's one-card reference (b) and smoke phase 17 (d).  The
    leaves are the bf16 casts of the f32 masters, drawn as bf16: the masters
    themselves are not held (grok-1-314b at one layer: 13 GB of leaves, 26
    GB of f32 grads and 13 GB of bf16 grads in flight; f32 masters would add
    26 GB).  Returns the loss, the grad norm (before clipping), seconds,
    the device's peak bytes, kernel launches and the leaves' bytes."""
    from repro_torch.models.registry import build_model
    from repro_torch.training.optimizer import global_norm
    from repro_torch.training.step import loss_and_grads
    from repro_torch.training.tree import leaves

    dev = torch.device(device)
    bundle = build_model(cfg, device=dev)
    params = bundle.init_params(torch.Generator().manual_seed(0))
    tensors = {k: torch.from_numpy(v).to(dev) for k, v in batch.items()}
    cuda = dev.type == "cuda"
    if cuda:
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
    k0, t0 = kernel_launches(), time.monotonic()
    loss, grads = loss_and_grads(bundle, params, tensors, n_micro)
    out = {"loss": float(loss), "grad_norm": float(global_norm(grads))}
    if cuda:
        torch.cuda.synchronize(dev)
    out.update(seconds=time.monotonic() - t0, kernel_launches=kernel_launches() - k0,
               peak_bytes=torch.cuda.max_memory_allocated(dev) if cuda else None,
               leaf_bytes=sum(t.numel() * t.element_size() for t in leaves(params)),
               n_micro=n_micro, layers=cfg.num_layers, tokens=list(batch["tokens"].shape))
    return out


def _master(t, spec, mesh):
    """This rank's shard of the f32 master of a bf16 leaf every rank drew:
    the shard is cut first, so no full f32 copy is made, and it owns its
    storage (a shard of a contiguous leaf may be a view of it)."""
    from torch.distributed.tensor import DTensor

    from repro_torch.sharding.rules import distribute

    d = distribute(t, spec, mesh)
    loc = d.to_local()
    loc = loc.float() if loc.is_floating_point() else loc.clone()
    return DTensor.from_local(loc, mesh, d.placements, run_check=False, shape=d.shape,
                              stride=d.stride())


def _zero_opt_state(cell, dev):
    """``init_opt_state`` of the cell's masters made shard by shard: the
    moments are zeros (an int8 moment of zeros has zero scales)."""
    from torch.distributed.tensor import DTensor

    from repro_torch.sharding.rules import local_shape, placements
    from repro_torch.training.tree import map_tree

    specs, meta = next((s, m) for name, s, m in cell.arg_layout if name == "opt_state")

    def zero(spec, like):
        loc = torch.zeros(local_shape(tuple(like.shape), spec, cell.mesh), dtype=like.dtype,
                          device=dev)
        return DTensor.from_local(loc, cell.mesh, placements(spec, cell.mesh), run_check=False,
                                  shape=like.shape, stride=like.stride())

    return map_tree(zero, specs, meta)


def _moments(params, opt) -> dict:
    """(e): every first moment int8 with one f32 scale per 256 elements of
    its (padded) last dim, every second moment bf16; m's bytes against
    f32's (global shapes)."""
    from repro_torch.training.tree import leaves_with_paths

    ok, m_bytes, f32_bytes = True, 0, 0
    for path, p in leaves_with_paths(params):
        m, v = opt["m"], opt["v"]
        for k in path:
            m, v = m[k], v[k]
        q, sc = m["q"], m["scale"]
        n = p.shape[-1]
        ok &= (q.dtype == torch.int8 and sc.dtype == torch.float32 and v.dtype == torch.bfloat16
               and q.shape[-1] == n + (-n) % 256 and sc.shape[-1] * 256 == q.shape[-1]
               and tuple(q.shape[:-1]) == tuple(p.shape[:-1]) == tuple(sc.shape[:-1]))
        m_bytes += q.numel() + 4 * sc.numel()
        f32_bytes += 4 * p.numel()
    return {"ok": bool(ok), "m_bytes": m_bytes, "m_f32_bytes": f32_bytes,
            "m_ratio": m_bytes / f32_bytes}


def moe_data(cfg, sz) -> list:
    from repro_torch.training.data import DataConfig, SyntheticLM

    B, S = sz["train_moe"]
    data = SyntheticLM(DataConfig(cfg.vocab_size, S, B))
    return [data.batch_at(i) for i in range(TRAIN_STEPS)]


def _moe_train_run(r: Rank, arch: str, cfg, mesh_key: str, strategy: str, data: list,
                   steps: int, measure: bool, save=None) -> dict:
    """``steps`` sharded train steps of ``cfg`` from the seed-0 masters:
    losses, grad norms, seconds, this rank's peak over the steps, the
    moments after the first step and the kernel launches; ``measure`` adds
    a counted and a profiled step."""
    from repro_torch.configs import ShapeSpec
    from repro_torch.launch import steps as st
    from repro_torch.sharding.rules import full
    from repro_torch.training.tree import map_tree

    opt_cfg, n_micro = moe_train_setup(arch)
    B, S = r.sz["train_moe"]
    mesh = r.meshes[mesh_key]
    cell = st.build_cell(arch, "train_4k", mesh, cfg=cfg, moe_strategy=strategy,
                         opt_cfg=opt_cfg, n_micro=n_micro,
                         shape=ShapeSpec("train_4k", S, B, "train"))
    init = cell.bundle.init_params(torch.Generator().manual_seed(0))
    if save:
        r.save_tree(save, init)
    params = map_tree(lambda s, t: _master(t, s, mesh), cell.arg_layout[0][1], init)
    del init
    opt = _zero_opt_state(cell, r.dev)
    r.free()
    if not r.cpu:  # the steps' own peak, past the full leaves the shards were cut from
        torch.cuda.reset_peak_memory_stats(r.dev)
    k0 = kernel_launches()
    got, secs, moments = [], [], None
    for i in range(steps):
        batch = st.distribute_argument(
            cell, "batch", {k: torch.from_numpy(v).to(r.dev) for k, v in data[i].items()})
        (params, opt, m), dt = r.timed(lambda: st.run_cell(cell, (params, opt, batch)), 1)
        got.append({"loss": float(full(m["loss"])), "grad_norm": float(full(m["grad_norm"]))})
        secs.append(dt[0])
        if i == 0:
            moments = _moments(params, opt)
    rec = {"arch": arch, "mesh": r.mesh_name(mesh_key), "strategy": strategy,
           "capacity_factor": cfg.moe.capacity_factor, "layers": cfg.num_layers,
           "tokens": [B, S], "n_micro": n_micro, "state_dtype": opt_cfg.state_dtype,
           "sharded": got, "sharded_step_s": secs,
           "sharded_step_s_median": _median_after_first(secs), "moments": moments,
           "step_peak_bytes": None if r.cpu else torch.cuda.max_memory_allocated(r.dev)}
    if measure:
        (params, opt, _), rec["collectives"] = r.counted(
            lambda: st.run_cell(cell, (params, opt, batch)))
        (params, opt, _), rec["profiled"] = r.profile(
            lambda: st.run_cell(cell, (params, opt, batch)))
    rec["kernel_launches"] = kernel_launches() - k0
    del params, opt, cell, batch
    r.free()
    return rec


def moe_run_label(arch: str, mesh: str, strategy: str, room: bool) -> str:
    return f"{arch} {strategy} {mesh}" + (" room" if room else "")


def _worst(a: list, b: list) -> float:
    return max(max(rel(x["loss"], y["loss"]), rel(x["grad_norm"], y["grad_norm"]))
               for x, y in zip(a, b))


def case_train_moe(r: Rank) -> dict:
    """grok-1-314b and arctic-480b through ``build_cell``'s train step at
    full width, cut in depth (2 of 64 and 1 of 35 layers), with the full
    configs' int8 first moments and 8 micro-batches, 3 steps of 16 x 4096
    ``SyntheticLM`` tokens (TRAIN_4K's length; its global batch of 256 cut
    to 16: two rows a micro-batch, since DTensor's matmul cannot flatten a
    one-row micro-batch sharded over 'data', and on 2 x 2 one local row).

    Reckoned per rank before the first run (15 bytes a parameter: f32
    master 4, int8 m ~1, bf16 v 2, bf16 compute leaf 2, f32 grad
    accumulator 4, bf16 grad in flight 2): grok on 1 x 4 (ep, 2 experts a
    rank) holds 2.87 B params (its 2.42 B of experts, attention,
    embedding and head quartered), ~43 GB, on 2 x 2 one layer's 4 experts
    all-gathered over 'data' besides (4.8 GB); arctic on 1 x 4 (ep, 32
    experts a rank) 3.52 B, ~53 GB.  The dry run's prediction for each
    run is made beside it (``main``) and each rank's step peak is held
    within 15% of it.

    Held: (a) every loss and grad norm finite, the first loss within 0.5 of
    an untrained model's; (b) grok at one layer: the sharded step on 1 x
    world against ``one_card_moe_grads`` on rank 0's card with every expert
    given room for every token (its micro-batches one row each: two rows of
    8192 tokens would not fit beside the grads), first loss 1e-3 and grad
    norm 5e-3 relative; at the model's capacity (the sharded run's
    micro-batches) recorded, not held; (c) ep, a2a and tp on 1 x world, (d)
    2 x (world / 2) against 1 x world, all with room, within 5e-3
    relative; (e) int8 m with per-256 f32 scales and bf16 v after the first
    step, m's bytes about a quarter of f32's; no kernel launch on any
    rank.  Recorded: (g) step seconds, collective bytes and NCCL device
    time."""
    opt_cfg, n_micro = moe_train_setup("grok-1-314b")
    B, S = r.sz["train_moe"]
    rec = {"optimizer": {a: moe_train_setup(a)[0].state_dtype for a in ("grok-1-314b",
                                                                        "arctic-480b")},
           "n_micro": n_micro, "tokens": [B, S], "runs": {}}
    if r.rank == 0:
        print(f"[rank 0] train_moe: optimizer_for(get_config(arch)) -> state_dtype "
              f"{rec['optimizer']}, microbatches_for(get_config(arch)) -> {n_micro}, "
              f"{B} x {S} tokens, lr {TRAIN_LR:g}", flush=True)
    # at --reduced the runs the CPU tests hold against the reference (every
    # expert with room); grok at its capacity factor and arctic run at full
    # width (``tests/test_torch_moe_train.py`` holds arctic's reduced step)
    runs = [run for run in MOE_RUNS if run[3] or not r.opts["reduced"]]
    data = {a: moe_data(moe_cfg(a, r.sz), r.sz) for a in {run[0] for run in runs}}
    for arch, batches in data.items():
        for i, b in enumerate(batches):
            for k, v in b.items():
                r.save(f"train_moe/{arch}/batch{i}/{k}", torch.from_numpy(v))
    saved = set()
    for arch, key, strategy, room in runs:
        cfg = moe_cfg(arch, r.sz, room=room)
        label = moe_run_label(arch, r.mesh_name(key), strategy, room)
        save = None if arch in saved else f"train_moe/{arch}/masters"
        saved.add(arch)
        run = _moe_train_run(r, arch, cfg, key, strategy, data[arch], TRAIN_STEPS, not r.cpu,
                             save)
        rec["runs"][label] = run
        got = run["sharded"]
        r.check(run["kernel_launches"] == 0,
                f"train_moe {label}: {run['kernel_launches']} kernel launches on this rank")
        if r.rank == 0:
            want = untrained_loss(cfg)
            finite = all(math.isfinite(g["loss"]) and math.isfinite(g["grad_norm"]) for g in got)
            r.check(finite and abs(got[0]["loss"] - want) <= 0.5,
                    f"train_moe {label} ({cfg.num_layers} layers, capacity factor "
                    f"{cfg.moe.capacity_factor:g}): losses {[round(g['loss'], 5) for g in got]}, "
                    f"grad norms {[round(g['grad_norm'], 4) for g in got]}, finite {finite}; first "
                    f"loss within 0.5 of an untrained model's {want:.4f}; step s "
                    f"{run['sharded_step_s_median']:.3f}")
            mo = run["moments"]
            r.check(mo["ok"] and (r.opts["reduced"] or mo["m_ratio"] <= 0.26),
                    f"train_moe {label}: after step 1 m int8 with per-256 f32 scales, v bf16: "
                    f"{mo['ok']}; m {mo['m_bytes']} bytes, {mo['m_ratio']:.4f} of f32's")
        torch.distributed.barrier()

    if r.rank == 0:  # (c), (d)
        runs = rec["runs"]
        mesh = r.mesh_name("tp")
        ep = runs[moe_run_label("grok-1-314b", mesh, "ep", True)]["sharded"]
        for other in (moe_run_label("grok-1-314b", mesh, "a2a", True),
                      moe_run_label("grok-1-314b", mesh, "tp", True),
                      moe_run_label("grok-1-314b", r.mesh_name("dp"), "auto", True)):
            w = _worst(runs[other]["sharded"], ep)
            r.check(w <= MOE_HOLD, f"train_moe {other} against grok ep {mesh} room: losses and "
                                   f"grad norms within {w:.3e} relative (limit {MOE_HOLD:g})")

    # (b): one layer, sharded on 1 x world against rank 0's card alone
    rec["one_layer"] = {}
    for room in (True,) if r.opts["reduced"] else (True, False):
        cfg1 = moe_cfg("grok-1-314b", r.sz, layers=1, room=room)
        one = _moe_train_run(r, "grok-1-314b", cfg1, "tp", "ep", data["grok-1-314b"], 1, False)
        r.check(one["kernel_launches"] == 0,
                f"train_moe one layer: {one['kernel_launches']} kernel launches on this rank")
        torch.distributed.barrier()
        if r.rank == 0:
            # with room, one row a micro-batch (memory); at the model's
            # capacity, the sharded run's micro-batches (the same groups)
            ref = one_card_moe_grads(cfg1, data["grok-1-314b"][0],
                                     B if room else n_micro, r.dev)
            r.free()
            got = one["sharded"][0]
            dl, dg = rel(got["loss"], ref["loss"]), rel(got["grad_norm"], ref["grad_norm"])
            one.update(one_card=ref, loss_rel=dl, grad_norm_rel=dg)
            msg = (f"train_moe grok one layer, capacity factor {cfg1.moe.capacity_factor:g}: "
                   f"sharded ep {r.mesh_name('tp')} loss {got['loss']:.6f}, grad norm "
                   f"{got['grad_norm']:.5f} vs one card ({ref['n_micro']} micro-batches, "
                   f"{ref['seconds']:.2f} s, peak {(ref['peak_bytes'] or 0) / 1e9:.2f} GB, "
                   f"{ref['kernel_launches']} launches) {ref['loss']:.6f}, "
                   f"{ref['grad_norm']:.5f}: relative {dl:.3e} / {dg:.3e}")
            if room:
                r.check(dl <= MOE_ONE_CARD_LOSS and dg <= MOE_HOLD
                        and ref["kernel_launches"] == 0,
                        msg + f" (limits {MOE_ONE_CARD_LOSS:g} / {MOE_HOLD:g})")
            else:
                print(f"[rank 0] recorded, not held: {msg}", flush=True)
        rec["one_layer"]["room" if room else "model_capacity"] = one
        torch.distributed.barrier()
    return rec


RANK_CASES = {"train": case_train, "prefill": case_prefill, "decode": case_decode,
              "attention": case_attention, "psum": case_psum, "moe": case_moe, "grok": case_grok,
              "train_moe": case_train_moe, "prefill_32k": case_prefill_32k,
              "decode_32k": case_decode_32k}


def rank_main(rank: int, world: int, port: int, opts: dict) -> None:
    import torch.distributed as dist

    from repro_torch.launch.mesh import init_group

    if opts["device"] == "cpu":  # gloo ranks share the host's cores
        torch.set_num_threads(1)
    init_group("gloo" if opts["device"] == "cpu" else "nccl", rank=rank, world_size=world,
               port=port)
    try:
        r = Rank(rank, world, opts)
        records = {"rank": rank, "device": str(r.dev), "cases": {}, "peak_bytes": {}}
        for case in opts["cases"]:
            if case not in RANK_CASES:
                continue
            dist.barrier()
            if not r.cpu:
                torch.cuda.reset_peak_memory_stats(r.dev)
            t0 = time.monotonic()
            records["cases"][case] = RANK_CASES[case](r)
            records["cases"][case]["wall_s"] = time.monotonic() - t0
            if not r.cpu:
                records["peak_bytes"][case] = torch.cuda.max_memory_allocated(r.dev)
            r.free()
        records["checks"] = r.checks
        out = Path(opts["out"])
        (out / f"rank{rank}.json").write_text(json.dumps(records, indent=1))
        if r.saved:
            np.savez(Path(opts["save"]) / "four_cards.npz", **r.saved)
    finally:
        dist.destroy_process_group()


def _rank_view(tree):
    """What differs by rank: model rank, K5 launches and query offsets."""
    keys = ("model_rank", "k5_launches", "q_offsets", "slice_start", "profiled",
            "step_peak_bytes", "kernel_launches", "cache_shard_bytes", "collectives")
    out = {}
    for k, v in tree.items():
        if k in keys:
            out[k] = v
        elif isinstance(v, dict):
            sub = _rank_view(v)
            if sub:
                out[k] = sub
    return out


def _start_dryrun(out: Path, arch: str, shape: str, mesh: str, batch: int, *extra):
    """``launch.dryrun`` of one cell in a subprocess started now; (process,
    the path of its JSON)."""
    out.mkdir(parents=True, exist_ok=True)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="2")
    log = open(out / "log.txt", "w")
    cmd = [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", arch, "--shape", shape,
           "--mesh", mesh, "--global-batch", str(batch), *extra, "--out", str(out), "--force"]
    return (subprocess.Popen(cmd, stdout=log, stderr=subprocess.STDOUT, env=env),
            out / mesh / f"{arch}__{shape}.json")


def start_moe_dryruns(opts: dict) -> list:
    """The dry run of each train_moe run's cell (``launch.dryrun``: the same
    config, mesh, strategy, batch, optimizer and micro-batches on a fake
    group of ``--world`` ranks, meta tensors, on the CPU), each in a
    subprocess started now, beside the ranks: [(label, process, its JSON)]."""
    B = sizes(False)["train_moe"][0]
    out = Path(opts["out"]) / "dryrun"
    procs = []
    for i, (arch, key, strategy, room) in enumerate(MOE_RUNS):
        data, model = (2, opts["world"] // 2) if key == "dp" else (1, opts["world"])
        cfg = moe_cfg(arch, sizes(False), room=room)
        label = moe_run_label(arch, f"{data} x {model}", strategy, room)
        procs.append((label, *_start_dryrun(
            out / str(i), arch, "train_4k", f"{data}x{model}", B, "--layers",
            str(cfg.num_layers), "--capacity-factor", repr(cfg.moe.capacity_factor),
            "--moe-strategy", strategy)))
    return procs


def start_long_dryruns(opts: dict) -> list:
    """The dry run of each 32k run's cell (both archs at full depth, the
    case's batch, each mesh) in a subprocess started now, beside the ranks:
    [((case, arch, mesh label), process, its JSON)]."""
    out = Path(opts["out"]) / "dryrun_32k"
    sz = sizes(False)
    procs = []
    for case in (c for c in LONG_CASES if c in opts["cases"]):
        for arch in LONG_ARCHS:
            for data, model in ((2, opts["world"] // 2), (1, opts["world"])):
                procs.append(((case, arch, f"{data} x {model}"), *_start_dryrun(
                    out / f"{case}__{arch}__{data}x{model}", arch, case, f"{data}x{model}",
                    sz[case][0])))
    return procs


def long_peaks(procs: list, ranks: list) -> tuple:
    """Each 32k run's per-rank step peak and collectives beside its dry
    run's: the bf16 decode's peaks held within PEAK_HOLD, the rest (the
    prefill, the f32-weight decode, which the bf16 dry run does not model)
    recorded.  (records, checks)."""
    recs, checks = {}, []
    for (case, arch, mesh), proc, path in procs:
        proc.wait(timeout=JOIN_TIMEOUT_S)
        dry = json.loads(path.read_text()) if path.exists() else {"status": "missing"}
        pred = dry.get("memory", {}).get("peak_bytes_per_device")
        for dt in ("bfloat16",) if case == "prefill_32k" else ("bfloat16", "float32"):
            if case == "prefill_32k":
                got = [rec["cases"][case][arch][mesh] for rec in ranks]
            else:
                got = [rec["cases"][case][arch][dt][mesh] for rec in ranks]
            peaks = [g["step_peak_bytes"] for g in got]
            gaps = [None if pred is None else (p - pred) / pred for p in peaks]
            label = f"{case} {arch} {mesh}" + (f" {dt} weights" if case == "decode_32k" else "")
            recs[label] = {"dryrun_status": dry["status"], "predicted_peak_bytes": pred,
                           "step_peak_bytes_by_rank": peaks, "gap": gaps,
                           "collectives_by_rank": [g["collectives"] for g in got],
                           "dryrun_collectives": dry.get("collectives"),
                           "dryrun_memory": dry.get("memory")}
            held = case == "decode_32k" and dt == "bfloat16"
            ok = pred is not None and (not held or all(abs(g) <= PEAK_HOLD for g in gaps))
            msg = (f"{label}: step peaks {[round(p / 1e9, 3) for p in peaks]} GB by rank against "
                   f"the dry run's {pred / 1e9 if pred else float('nan'):.3f} GB (status "
                   f"{dry['status']}): gaps {[None if x is None else round(x, 4) for x in gaps]} "
                   + (f"(limit {PEAK_HOLD:g})" if held else "(recorded)")
                   + f"; all-gather GB by rank "
                   f"{[round(g['collectives']['all-gather']['bytes'] / 1e9, 4) for g in got]} vs "
                   f"the dry run's "
                   f"{(dry.get('collectives') or {}).get('all-gather', {}).get('bytes', 0) / 1e9:.4f}")
            checks.append({"ok": ok, "msg": msg})
            print(f"[32k] {'ok  ' if ok else 'MISS'} {msg}", flush=True)
    return recs, checks


def moe_peaks(procs: list, ranks: list) -> tuple:
    """(f): each train_moe run's per-rank step peak against its dry run's
    ``peak_bytes_per_device``; (records, checks)."""
    recs, checks = {}, []
    for label, proc, path in procs:
        proc.wait(timeout=JOIN_TIMEOUT_S)
        dry = json.loads(path.read_text()) if path.exists() else {"status": "missing"}
        pred = dry.get("memory", {}).get("peak_bytes_per_device")
        got = [rec["cases"]["train_moe"]["runs"][label]["step_peak_bytes"] for rec in ranks]
        gaps = [None if pred is None else (g - pred) / pred for g in got]
        recs[label] = {"dryrun_status": dry["status"], "predicted_peak_bytes": pred,
                       "step_peak_bytes_by_rank": got, "gap": gaps}
        ok = pred is not None and all(abs(g) <= PEAK_HOLD for g in gaps)
        msg = (f"train_moe {label}: step peaks {[round(g / 1e9, 2) for g in got]} GB by rank "
               f"against the dry run's {pred / 1e9 if pred else float('nan'):.2f} GB "
               f"(status {dry['status']}): gaps "
               f"{[None if x is None else round(x, 4) for x in gaps]} "
               f"(limit {PEAK_HOLD:g})")
        checks.append({"ok": ok, "msg": msg})
        print(f"[train_moe] {'ok  ' if ok else 'MISS'} {msg}", flush=True)
    return recs, checks


def run_ranks(opts: dict) -> list:
    """Spawn the ranks, wait for all of them, return their records."""
    world = opts["world"]
    ctx = mp.get_context("spawn")
    port = free_port()
    procs = [ctx.Process(target=rank_main, args=(r, world, port, opts)) for r in range(world)]
    t0 = time.monotonic()
    for p in procs:
        p.start()
    try:
        for p in procs:
            p.join(max(0.0, JOIN_TIMEOUT_S - (time.monotonic() - t0)))
        alive = [i for i, p in enumerate(procs) if p.is_alive()]
        if alive:
            raise TimeoutError(f"ranks {alive} still running after {JOIN_TIMEOUT_S} s")
        codes = [p.exitcode for p in procs]
        if any(codes):
            raise RuntimeError(f"rank exit codes {codes}")
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
    return [json.loads((Path(opts["out"]) / f"rank{r}.json").read_text()) for r in range(world)]


# ---------------------------------------------------------------------------
# the router over one replica per card (this process, no process group)
# ---------------------------------------------------------------------------


def _launches():
    from repro_torch.kernels import kv_block_copy as kbc
    from repro_torch.kernels import paged_attention as pa

    return {"K1": pa.paged_decode_attention.launches, "K2": pa.paged_prefill_attention.launches,
            "K3": kbc.kv_block_copy.launches}


def _add(counts: dict, card: str, before: dict) -> None:
    now = _launches()
    per = counts.setdefault(card, {k: 0 for k in now})
    for k in now:
        per[k] += now[k] - before[k]


def _traffic(V: int):
    """The serving phase's eight requests: four fresh prompts of 64-512
    tokens (the first opens with a shared 256-token prefix), then three
    more on that prefix and a fresh 100-token prompt."""
    rng = np.random.default_rng(0)
    shared = tuple(int(t) for t in rng.integers(0, V, 256))
    fresh = lambda n: tuple(int(t) for t in rng.integers(0, V, n))
    reqs = [shared + fresh(64), fresh(64), fresh(150), fresh(512),
            shared + fresh(128), shared + fresh(200), shared + fresh(37), fresh(100)]
    return shared, reqs


def serve_router(devices, reduced: bool) -> dict:
    """The router phase over ``devices`` (one replica each; a device may
    repeat, which shares one copy of the weights).  Returns the gates,
    tokens, routing and per-card launch counts."""
    from repro_torch.configs import get_config
    from repro_torch.configs import reduced as cut
    from repro_torch.core.analyzer import check_observation_path, validate_event_sequence
    from repro_torch.core.claims import ClaimMode, ClaimState
    from repro_torch.core.native_descriptor import SCENARIO_DEFAULTS, scenario_routed_reuse
    from repro_torch.models.registry import build_model
    from repro_torch.serving.engine import ServingEngine
    from repro_torch.serving.router import KVAwareRouter

    cfg = get_config("qwen3-1.7b")
    cfg = cut(cfg) if reduced else cfg
    models = {}
    for d in devices:
        if str(d) not in models:
            b = build_model(cfg, device=d)
            models[str(d)] = (b, b.init_params(torch.Generator().manual_seed(0)))
    counts, out = {}, {"devices": [str(d) for d in devices]}

    made = []

    def make_engine(**kw):
        d = devices[(len(made) + ROUTER_SPREAD) % len(devices)]
        b, p = models[str(d)]
        made.append(str(d))
        return ServingEngine(b, p, device=d, **{**SCENARIO_DEFAULTS, **kw})

    before = _launches()
    res = scenario_routed_reuse(make_engine, workers=len(devices))
    routed = sorted({made[e["worker"]] for e in res["events"] if e["name"] == "route_decision"})
    for card in routed:  # the scenario's requests all went to the claim's worker
        _add(counts, card, before)
    out["routed_reuse"] = {"gates": res["gates"], "engines": made, "served_on": routed}

    V = cfg.vocab_size
    shared, reqs = _traffic(V)
    engines = [ServingEngine(*models[str(d)], block_size=16, device_blocks=128, device=d)
               for d in devices]
    try:
        router = KVAwareRouter(engines)
        last = len(engines) - 1
        claim = router.accept_claim(shared, worker=last)
        before = _launches()  # the claim's prefix, prefilled where the claim sits
        warm = engines[last].run(engines[last].submit(shared, max_new_tokens=1))
        _add(counts, str(devices[last]), before)
        tokens, workers = [], []
        for p in reqs:
            before = _launches()
            req, rec = router.submit_and_run(p, max_new_tokens=16)
            _add(counts, str(devices[rec.worker]), before)
            tokens.append(req.output_tokens)
            workers.append(rec.worker)
            if req.status != "finished":
                raise RuntimeError(f"router request {req.request_id}: {req.status} ({req.error})")
        out["traffic"] = {"tokens": tokens, "workers": workers, "warm": warm.status,
                          "claim": claim.claim_id,
                          "order_valid": all(validate_event_sequence(e.events).passed
                                             for e in engines)}
    finally:
        for e in engines:
            e.close()

    # witness path A on the third replica's card: offload, then restore through K3
    d = devices[2 % len(devices)]
    rng = np.random.default_rng(1)
    prefix = tuple(int(t) for t in rng.integers(0, V, 256))
    first = prefix + tuple(int(t) for t in rng.integers(0, V, 16))
    reuse = prefix + tuple(int(t) for t in rng.integers(0, V, 8))
    before = _launches()
    with ServingEngine(*models[str(d)], block_size=16, device_blocks=64, device=d) as eng:
        claim = eng.accept_claim(prefix, ClaimMode.OFFLOADABLE)
        r1 = eng.run(eng.submit(first, max_new_tokens=16))
        pages = [(b.k.clone(), b.v.clone()) for b in eng.pool.lookup_prefix(prefix, 16)]
        offloaded = eng.offload_claim(claim.claim_id, request_id=r1.request_id)
        r2 = eng.run(eng.submit(reuse, max_new_tokens=16))
        back = [(b.k, b.v) for b in eng.pool.lookup_prefix(prefix, 16)]
        bitwise = len(back) == len(pages) == 16 and all(
            torch.equal(a[0], b[0]) and torch.equal(a[1], b[1]) for a, b in zip(pages, back))
        verdict = check_observation_path(eng.events, claim.claim_id, r2.request_id)
        out["witness_a"] = {
            "card": str(d), "offloaded": bool(offloaded), "status": r2.status,
            "restored_tokens": r2.restored_tokens, "claim": claim.state.value,
            "restored_pages_bitwise": bool(bitwise), "observation_path": verdict.passed,
            "tokens": r2.output_tokens,
            "ok": bool(offloaded) and r2.status == "finished" and r2.restored_tokens == 256
            and claim.state == ClaimState.RESTORED and bool(bitwise) and verdict.passed}
    _add(counts, str(d), before)
    out["launches_by_card"] = counts
    return out


def router_case(opts: dict) -> dict:
    world = opts["world"]
    if opts["device"] == "cpu":
        devices = [torch.device("cpu")] * world
        one = devices
    else:
        devices = [torch.device("cuda", i) for i in range(world)]
        one = [torch.device("cuda", 0)] * world
        torch.cuda.set_device(0)
    t0 = time.monotonic()
    got = serve_router(devices, opts["reduced"])
    t_cards = time.monotonic() - t0
    gc.collect()
    if opts["device"] != "cpu":
        torch.cuda.empty_cache()
    t0 = time.monotonic()
    ref = serve_router(one, opts["reduced"])
    t_one = time.monotonic() - t0
    checks = []

    def check(ok, msg):
        checks.append({"ok": bool(ok), "msg": msg})
        print(f"[router] {'ok  ' if ok else 'MISS'} {msg}", flush=True)

    gates = got["routed_reuse"]["gates"]
    check(all(v for v in gates.values() if isinstance(v, bool)),
          f"routed_reuse over {got['routed_reuse']['engines']}: gates {gates}, served on "
          f"{got['routed_reuse']['served_on']}")
    tr, tr1 = got["traffic"], ref["traffic"]
    check(tr["tokens"] == tr1["tokens"] and tr["workers"] == tr1["workers"],
          f"router traffic: 8 requests routed to workers {tr['workers']} (the one-card run: "
          f"{tr1['workers']}), greedy tokens equal to the one-card run's: "
          f"{tr['tokens'] == tr1['tokens']}; event order valid {tr['order_valid']}")
    check(tr["order_valid"], "router traffic: every replica's event order valid")
    w = got["witness_a"]
    check(w["ok"] and w["tokens"] == ref["witness_a"]["tokens"],
          f"witness path A on {w['card']}: offloaded {w['offloaded']}, reuse {w['status']}, "
          f"restored {w['restored_tokens']} tokens, claim {w['claim']}, restored pages bitwise "
          f"{w['restored_pages_bitwise']}, observation path {w['observation_path']}, tokens equal "
          f"the one-card run's {w['tokens'] == ref['witness_a']['tokens']}")
    if opts["device"] != "cpu":  # the CPU runs the plain versions: nothing launches
        served = {str(devices[i]) for i in tr["workers"]} | set(got["routed_reuse"]["served_on"])
        lc = got["launches_by_card"]
        for card in sorted(served):
            check(lc[card]["K1"] > 0 and lc[card]["K2"] > 0,
                  f"launches on {card}, which served: {lc[card]}")
        check(lc[w["card"]]["K3"] > 0,
              f"K3 launched on the witness card {w['card']}: {lc[w['card']]}")
    return {"cards": got, "one_card": ref, "seconds": t_cards, "one_card_seconds": t_one,
            "checks": checks}


# ---------------------------------------------------------------------------


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--world", type=int, default=4)
    ap.add_argument("--device", default=None, help="cpu: gloo ranks on the host (default: cards)")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--cases", default=",".join(DEFAULT_CASES),
                    help=f"comma-separated, of {CASES} (default: all but {LONG_CASES})")
    ap.add_argument("--out", default=str(ROOT / "results" / "torch" / "four_cards"))
    ap.add_argument("--save", default=None, help="directory for rank 0's inputs and outputs")
    args = ap.parse_args(argv)
    cases = [c for c in args.cases.split(",") if c]
    unknown = set(cases) - set(CASES)
    if unknown:
        ap.error(f"unknown cases {sorted(unknown)}")
    if args.world < 2 or args.world % 2:
        ap.error("--world must be even and at least 2")
    if args.device not in (None, "cpu", "cuda"):
        ap.error("--device: cpu, or cuda (the default)")
    on_cards = args.device != "cpu"
    if on_cards:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device: pass --device cpu for gloo ranks on the host")
        n = torch.cuda.device_count()
        if n < args.world:
            raise RuntimeError(f"--world {args.world} needs {args.world} cards, the host has {n}")
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    if args.save:
        Path(args.save).mkdir(parents=True, exist_ok=True)
    opts = {"world": args.world, "device": "cpu" if not on_cards else None,
            "reduced": args.reduced, "cases": cases, "out": str(out), "save": args.save}
    card = card_line() if on_cards else "cpu"
    if on_cards:  # every rank loads the libraries this builds
        from repro_torch.kernels import build

        print(f"kernels built in {build.build_all()} s", flush=True)
    print(f"four cards: {card}; world {args.world}; torch {torch.__version__}; cases {cases}",
          flush=True)
    t0 = time.monotonic()
    summary = {"card": card, "world": args.world, "reduced": args.reduced,
               "torch": torch.__version__, "cases": {}, "peak_bytes_by_rank": {}}
    checks = []
    # (f)'s predictions, on the CPU beside the ranks (on the cards only: the
    # reduced configs have no dry run, and the CPU keeps no peak)
    dryruns = (start_moe_dryruns(opts) if on_cards and not args.reduced and "train_moe" in cases
               else [])
    long_dryruns = (start_long_dryruns(opts) if on_cards and not args.reduced
                    and any(c in LONG_CASES for c in cases) else [])
    try:
        if any(c in RANK_CASES for c in cases):
            ranks = run_ranks(opts)
            for rec in ranks:
                checks += rec["checks"]
                summary["peak_bytes_by_rank"][f"rank{rec['rank']}"] = rec["peak_bytes"]
            summary["cases"] = ranks[0]["cases"]
            summary["per_rank"] = {f"rank{rec['rank']}": {"device": rec["device"],
                                                          **_rank_view(rec["cases"])}
                                   for rec in ranks}
            if dryruns:
                summary["cases"]["train_moe"]["peaks"], more = moe_peaks(dryruns, ranks)
                checks += more
            if long_dryruns:
                summary["long_32k_peaks"], more = long_peaks(long_dryruns, ranks)
                checks += more
    finally:
        for _, p, _ in dryruns + long_dryruns:
            if p.poll() is None:
                p.kill()
                p.wait()
    if "router" in cases:
        router = router_case(opts)
        checks += router.pop("checks")
        summary["cases"]["router"] = router
    summary["checks"] = checks
    summary["ok"] = bool(checks) and all(c["ok"] for c in checks)
    summary["wall_s"] = time.monotonic() - t0
    (out / "summary.json").write_text(json.dumps(summary, indent=1))
    for rec in Path(out).glob("rank*.json"):
        rec.unlink()
    misses = [c["msg"] for c in checks if not c["ok"]]
    print(f"four cards: {len(checks) - len(misses)} of {len(checks)} checks held in "
          f"{summary['wall_s']:.1f} s; summary {out / 'summary.json'}", flush=True)
    for m in misses:
        print(f"MISS {m}", flush=True)
    return 0 if summary["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())

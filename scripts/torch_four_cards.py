#!/usr/bin/env python3
"""The port's sharded steps over NCCL with one rank per card, and the
KV-aware router over one serving replica per card.

    python3 scripts/torch_four_cards.py                      # every case, 4 ranks on 4 cards
    python3 scripts/torch_four_cards.py --cases router       # the router alone
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
tokens, prefill 4 x 64, decode 8 rows over 64 slots).  The MoE layer runs
in float32 on the CPU (held to 1e-6), bf16 on the cards; the attention
case in float32 everywhere.  Writes ``<out>/summary.json``; ``--save DIR``
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

MESH_CASES = ("train", "prefill", "decode", "attention", "psum", "moe", "grok")
CASES = MESH_CASES + ("router",)
JOIN_TIMEOUT_S = 1800
ROUTER_SPREAD = 1  # routed_reuse's worker i sits on card (i + 1) % world: w0 off the current card


def sizes(reduced: bool) -> dict:
    """The cases' shapes: full width, or the CPU tests' reduced sizes."""
    if reduced:
        return dict(train=(4, 32), prefill=(4, 64), decode=(8, 64, 16, 4), grok=(2, 64),
                    grok_layers=None)
    return dict(train=(4, 4096), prefill=(4, 2048), decode=(8, 4096, 64, 4), grok=(2, 512),
                grok_layers=4)


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
                     runs: int = 3, hold: bool = True) -> dict:
    """A sharded prefill cell against ``bundle.prefill_fn`` on rank 0's
    card: logits, K5 launches and query offsets per rank, times; for an
    MoE model the MoE dispatches of both runs compared layer by layer.
    ``hold=False`` records the logits' agreement without holding it."""
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
    (logits, _), secs = r.timed(step, runs - 1)
    _, prof = r.profile(step)
    logits = full(logits)
    tp_n = dict(zip(mesh.mesh_dim_names, mesh.shape))["model"]
    m_rank = mesh.get_local_rank("model")
    want_off = m_rank * (S // tp_n)
    rec = {"mesh": r.mesh_name(mesh_key), "tokens": [B, S], "layers": cfg.num_layers,
           "model_rank": m_rank, "k5_launches": k5, "q_offsets": sorted(set(spy.offsets)),
           "sharded_step_s_median": statistics.median(secs), "collectives": coll,
           "profiled": prof}
    if not r.cpu:  # on the CPU the body is the plain attention: no kernel, no spy
        r.check(k5 == cfg.num_layers and spy.offsets == [want_off] * cfg.num_layers,
                f"{name} on {rec['mesh']}: model rank {m_rank} launched K5 {k5} times "
                f"({cfg.num_layers} layers) with q_offset {sorted(set(spy.offsets))} (expected "
                f"{want_off})")
    r.save(f"{name}/{rec['mesh']}/logits", logits)
    del cell, pd, bd
    r.free()
    torch.distributed.barrier()
    if r.rank == 0:
        with DispatchSpy() as kept1:
            (want, _), usecs = r.timed(lambda: bundle.prefill_fn(params, {"tokens": tokens}, S), 1)
        _, more = r.timed(lambda: bundle.prefill_fn(params, {"tokens": tokens}, S), runs - 1)
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
    torch.distributed.barrier()
    return rec


def _qwen(r: Rank):
    from repro_torch.configs import get_config, reduced
    from repro_torch.models.registry import build_model

    cfg = get_config("qwen3-1.7b")
    cfg = reduced(cfg) if r.opts["reduced"] else cfg
    bundle = build_model(cfg, device=r.dev)
    return cfg, bundle, bundle.init_params(torch.Generator().manual_seed(0))


def case_prefill(r: Rank) -> dict:
    cfg, bundle, params = _qwen(r)
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

    cfg, bundle, params = _qwen(r)
    rec = {"bfloat16": _decode(r, cfg, bundle, params)}
    params = map_tree(_f32, params)
    r.free()
    rec["float32"] = _decode(r, cfg, bundle, params)
    return rec


def _f32(t):
    return t.float() if t.is_floating_point() else t


def _decode(r: Rank, cfg, bundle, params, limit: float = 0.25) -> dict:
    from repro_torch.configs import ShapeSpec
    from repro_torch.launch import steps as st
    from repro_torch.sharding.rules import full

    dtype = str(params["embed"].dtype).removeprefix("torch.")
    rows, slots, plen, steps = r.sz["decode"]
    rng = np.random.default_rng(19)
    prompt = torch.from_numpy(rng.integers(0, cfg.vocab_size, (rows, plen)).astype(np.int32))
    prompt = prompt.to(r.dev)
    r.save("decode/prompt", prompt)
    logits, cache = bundle.prefill_fn(params, {"tokens": prompt}, slots)
    mesh = r.meshes["dp"]
    cell = st.build_cell("qwen3-1.7b", "decode_32k", mesh, cfg=cfg,
                         shape=ShapeSpec("decode_32k", slots, rows, "decode"))
    pd = st.distribute_argument(cell, "params", params)
    cd = st.distribute_argument(cell, "cache", cache)
    worst, greedy, secs, usecs = 0.0, [], [], []
    for i in range(steps):
        tok = logits.argmax(-1).to(torch.int32)
        pos = torch.full((rows,), plen + i, dtype=torch.int32, device=r.dev)
        if dtype == "bfloat16":
            r.save(f"decode/tokens{i}", tok)
        args = (pd, cd, st.distribute_argument(cell, "tokens", tok),
                st.distribute_argument(cell, "cur_pos", pos))
        (ls, cd), dt = r.timed(lambda: st.run_cell(cell, args), 1)
        secs += dt
        ls = full(ls)
        if dtype == "bfloat16":
            r.save(f"decode/logits{i}", ls)
        (logits, cache), dt = r.timed(lambda: bundle.decode_fn(params, cache, tok, pos), 1)
        usecs += dt
        worst = max(worst, max_err(ls, logits))
        greedy.append(greedy_report(ls, logits))
    # the last step again: once counted, once profiled
    _, coll = r.counted(lambda: st.run_cell(cell, args))
    _, prof = r.profile(lambda: st.run_cell(cell, args))
    equal = sum(g["equal"] for g in greedy)
    flips = [dict(f, step=i) for i, g in enumerate(greedy) for f in g["flips"]]
    rec = {"mesh": r.mesh_name("dp"), "dtype": dtype, "rows": rows, "slots": slots,
           "steps": steps, "max_abs": worst, "limit": limit, "greedy_equal": equal,
           "greedy_flips": flips, "sharded_step_s_median": _median_after_first(secs),
           "one_card_step_s_median": _median_after_first(usecs), "collectives": coll,
           "profiled": prof}
    if r.rank == 0:
        held = worst <= limit and greedy_held({"flips": flips})
        r.check(held, f"decode {cfg.name} {dtype} weights {rows} rows over {slots} slots, {steps} "
                      f"steps on {rec['mesh']}: logits max|d| {worst:.3e} vs one card (limit "
                      f"{limit:g}); greedy tokens equal {equal}/{rows * steps}, differing only at "
                      f"near-ties of <= {NEAR_TIE:g} bf16 spacings ({flips}); step s "
                      f"{rec['sharded_step_s_median']:.4f} vs {rec['one_card_step_s_median']:.4f}")
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


RANK_CASES = {"train": case_train, "prefill": case_prefill, "decode": case_decode,
              "attention": case_attention, "psum": case_psum, "moe": case_moe, "grok": case_grok}


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
            "step_peak_bytes")
    out = {}
    for k, v in tree.items():
        if k in keys:
            out[k] = v
        elif isinstance(v, dict):
            sub = _rank_view(v)
            if sub:
                out[k] = sub
    return out


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
    ap.add_argument("--cases", default=",".join(CASES))
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
    if any(c in RANK_CASES for c in cases):
        ranks = run_ranks(opts)
        for rec in ranks:
            checks += rec["checks"]
            summary["peak_bytes_by_rank"][f"rank{rec['rank']}"] = rec["peak_bytes"]
        summary["cases"] = ranks[0]["cases"]
        summary["per_rank"] = {f"rank{rec['rank']}": {"device": rec["device"],
                                                      **_rank_view(rec["cases"])}
                               for rec in ranks}
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

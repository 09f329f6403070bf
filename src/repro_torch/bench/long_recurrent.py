"""The recurrent families' long cells on one card: xlstm-350m and
hymba-1.5b at ``prefill_32k``'s length, ``decode_32k``'s rows and
``long_500k``'s position, with a snapshot claim over the long prefix.

    PYTHONPATH=src python3 scripts/torch_long_recurrent.py --arch hymba-1.5b   # card, 32,768 tokens

``run_cells`` runs the four cells of one architecture at ``seq_len``
tokens, weights from seed 0, and returns their record (every check, cut
and number); ``chip_smoke.py`` phase 21 calls it at 4,096 tokens,
``scripts/torch_long_recurrent.py`` at 32,768, and the CPU tests at a
reduced config (``device="cpu"``).  Each failed check raises
``CellFailed`` after it is recorded.

(a) ``prefill_fn`` over ``rows`` x ``seq_len`` tokens (the catalogue's 32
    rows, cut to what the card holds: hymba's SSM coefficients ``dA`` and
    ``dBx`` are [B, S, d_inner, N] f32 each, the reference's layout); row 0
    is the claim's prefix.  Its logits and state are held bitwise against
    (b)'s B = 1 materialization of that prefix; where the rows differ, the
    first op whose row 0 differs by batch width is named
    (``first_row_variant_op``) before the check fails.
(b) A ResidentClaim over the prefix through ``SnapshotEngine``: the
    materialized snapshot serves 4 requests (the prefix + 2 fresh tokens,
    16 new tokens each) while it is on the device, is offloaded (K3), and
    serves the same 4 requests after its restore (K3): the tokens must be
    equal (path A, judged by the port's analyzer).  A second engine,
    handed path A's snapshot instead of prefilling the prefix again, fails
    the same claim's restore: refused fail-closed, E11 -> E12 -> E13 -> E14
    (path B).
(c) ``decode_fn`` over ``decode_rows`` rows (``decode_32k``'s 128) tiled
    from (a)'s row states, each with its own next token, at position
    ``seq_len``, 4 steps: the first step held against the CPU on a subset
    of rows (max |d| 0.25, the same greedy token up to a near-tie of 2 bf16
    spacings) and each row held bitwise against a B = 1 decode of it.
(d) One decode at ``long_500k``'s last position 524,287 at B = 1: hymba
    over a window-slot ring of seeded K/V holding the window's last
    positions beside (a)'s SSM state; xlstm from (a)'s state (its decode
    never reads the position, as in the reference).  Card against CPU as
    in (c), then ``build_cell(arch, "long_500k", mesh)`` on the caller's
    one-rank mesh against the unsharded step.
"""
from __future__ import annotations

import math
import time
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

from repro_torch.models.layers import tree_map
from repro_torch.serving.snapshot_engine import _flatten, _state_batch_axes

SEQ_LEN = 32_768  # prefill_32k / decode_32k's length
PREFILL_ROWS = 32  # prefill_32k's global batch
DECODE_ROWS = 128  # decode_32k's global batch
LONG_500K = 524_288  # long_500k's length: one decode at its last position
DECODE_STEPS = 4
CLAIM_REQUESTS, CLAIM_FRESH, CLAIM_NEW = 4, 2, 16
CPU_ROWS = 4  # (c): rows the CPU holds the card's first step to
PROFILE_TOKENS = 512  # (a): the profiled slice, the first tokens of the same rows
TRACE_TOKENS = 256  # the row-variance trace's prompt length
LOGITS_LIMIT = 0.25  # card against CPU, sharded against unsharded (the smoke's bf16 limit)
F32_LIMIT = 1e-2  # the same comparison with float32 copies of the weights and state
NEAR_TIE = 2.0  # bf16 spacings between two logits whose greedy order rounding may flip
SEED = 32


class CellFailed(RuntimeError):
    pass


def _sync(dev) -> None:
    if torch.device(dev).type == "cuda":
        torch.cuda.synchronize(dev)


def _reset_peak(dev) -> None:
    if torch.device(dev).type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)


def _peak_gib(dev) -> Optional[float]:
    if torch.device(dev).type == "cuda":
        return torch.cuda.max_memory_allocated(dev) / 2**30
    return None


def _spacings(logits, a: int, b: int) -> float:
    """The gap logits[a] - logits[b] in bf16 spacings at logits[a]."""
    top = float(logits[a])
    ulp = 2.0 ** (math.floor(math.log2(abs(top))) - 7) if top else 2.0 ** -133
    return (top - float(logits[b])) / ulp


def near_tie_flips(got, want) -> List[Dict[str, Any]]:
    """Rows [.., V] whose greedy token differs, each with ``want``'s gap
    between the two tokens in bf16 spacings."""
    g = got.detach().float().cpu().reshape(-1, got.shape[-1])
    w = want.detach().float().cpu().reshape(-1, want.shape[-1])
    ga, wa = g.argmax(-1), w.argmax(-1)
    return [{"row": r, "gap_bf16_spacings": _spacings(w[r], int(wa[r]), int(ga[r]))}
            for r in torch.nonzero(ga != wa).flatten().tolist()]


def _max_err(a, b) -> float:
    return float((a.float().cpu() - b.float().cpu()).abs().max())


class Run:
    """One architecture's cells: its model on the device, the record, the
    checks."""

    def __init__(self, bundle, params, cfg, seq_len: int, log: Callable[[str], None] = print,
                 record: Optional[Dict[str, Any]] = None):
        self.bundle, self.params, self.cfg, self.S = bundle, params, cfg, seq_len
        self.dev = bundle.device
        self.log = log
        self.record = {} if record is None else record
        self.record.update(arch=cfg.name, seq_len=seq_len, checks=[], cuts=[])
        self._cpu, self._f32 = None, None

    def check(self, name: str, ok: bool, detail: str) -> None:
        self.record["checks"].append({"name": name, "ok": bool(ok), "detail": detail})
        self.log(f"{'ok' if ok else 'FAIL'}: {self.cfg.name} {name}: {detail}")
        if not ok:
            raise CellFailed(f"{self.cfg.name} {name}: {detail}")

    def cut(self, what: str, catalogue, used, why: str) -> None:
        self.record["cuts"].append({"what": what, "catalogue": catalogue, "used": used,
                                    "why": why})
        self.log(f"cut: {self.cfg.name} {what} {catalogue} -> {used} ({why})")

    def cpu_model(self):
        """The same config and parameters on the CPU (plain versions of
        every kernel), built once: (bundle, params, float32 params)."""
        if self._cpu is None:
            from repro_torch.models.registry import build_model

            p = tree_map(lambda t: t.detach().to("cpu"), self.params)
            self._cpu = (build_model(self.cfg, device="cpu"), p, _f32(p))
        return self._cpu

    def params_f32(self):
        """Float32 copies of the device's parameters, made once."""
        if self._f32 is None:
            self._f32 = _f32(self.params)
        return self._f32

    def hold_cross(self, name: str, bf16: tuple, f32: tuple) -> Dict[str, Any]:
        """Two routes of one function (card and CPU, sharded and not) on the
        same inputs, each pair (got, want) [rows, V]: with the served bf16
        weights finite and within LOGITS_LIMIT, the greedy tokens recorded
        (a flip beyond a near-tie is bf16 rounding when the float32 pair
        agrees); with float32 copies of the weights and of the state (no
        bf16 rounding left: hymba's decode casts P to its ring's type)
        within F32_LIMIT and every greedy token equal up to a near-tie."""
        (got, want), (got32, want32) = bf16, f32
        e, e32 = _max_err(got, want), _max_err(got32, want32)
        flips, flips32 = near_tie_flips(got, want), near_tie_flips(got32, want32)
        ok = (bool(torch.isfinite(got.float()).all()) and e <= LOGITS_LIMIT and e32 <= F32_LIMIT
              and all(f["gap_bf16_spacings"] <= NEAR_TIE for f in flips32))
        self.check(name, ok, f"bf16 weights max|d| {e:.3e} (limit {LOGITS_LIMIT}), greedy flips "
                             f"(recorded) {flips}; float32 weights max|d| {e32:.3e} (limit "
                             f"{F32_LIMIT}), greedy flips {flips32} (limit {NEAR_TIE:g} bf16 "
                             "spacings)")
        return {"max_abs_err": e, "flips": flips, "f32_max_abs_err": e32, "f32_flips": flips32}


def _f32(tree):
    return tree_map(lambda t: t.float() if t.is_floating_point() else t, tree)


def take_rows(bundle, state, rows):
    """The state's rows ``rows`` (a list of ints) on every leaf's batch axis."""
    axes = _state_batch_axes(bundle)
    return tree_map(lambda ax, t: t.index_select(ax, torch.as_tensor(rows, device=t.device)),
                    axes, state)


def compare_states(bundle, a, b) -> Dict[str, Any]:
    """Leaf by leaf: bitwise equal, else the largest |d| and its leaf."""
    worst, where, equal = 0.0, None, True
    for (path, x), (_, y) in zip(_flatten(a), _flatten(b)):
        if not torch.equal(x, y.to(x.device)):
            equal = False
            e = _max_err(x, y)
            if where is None or e > worst:
                worst, where = e, "/".join(path)
    return {"bitwise": equal, "max_abs_err": worst, "leaf": where}


# ---------------------------------------------------------------- row variance
class _Fingerprints:
    """A ``TorchDispatchMode`` that records, for every floating op output,
    a fingerprint of its batch row 0 (the narrow of the dim that grew by the
    batch width against ``ref_shapes``), or, with ``at``, the model frames
    of op number ``at``."""

    def __init__(self, rows: int, ref_shapes=None, at: Optional[int] = None):
        from torch.utils._python_dispatch import TorchDispatchMode

        outer = self

        class Mode(TorchDispatchMode):
            def __torch_dispatch__(self, func, types, args=(), kwargs=None):
                out = func(*args, **(kwargs or {}))
                outer.see(func, out)
                return out

        self.mode, self.rows, self.ref_shapes, self.at = Mode(), rows, ref_shapes, at
        self.names, self.shapes, self.prints, self.frames = [], [], [], None

    def see(self, func, out) -> None:
        t = out[0] if isinstance(out, (tuple, list)) and out else out
        # layout ops (a reshape is a view at one width and a copy at
        # another) and empties (whose bytes a kernel launched outside the
        # dispatcher writes later) are not compared
        if (not isinstance(t, torch.Tensor) or not t.is_floating_point()
                or func.__name__.split(".")[0] in _LAYOUT_OPS):
            return
        i = len(self.names)
        self.names.append(str(func))
        self.shapes.append(tuple(t.shape))
        if self.at is not None:
            if i == self.at:
                import traceback

                self.frames = [f"{f.filename.split('src/')[-1]}:{f.lineno} {f.name}"
                               for f in traceback.extract_stack() if "repro_torch/models" in f.filename]
            return
        row = t.detach()
        if self.ref_shapes is not None and i < len(self.ref_shapes):
            want = self.ref_shapes[i]
            if len(want) == t.ndim and tuple(t.shape) != want:
                grown = [d for d in range(t.ndim) if t.shape[d] == self.rows * want[d] != want[d]
                         and all(t.shape[e] == want[e] for e in range(t.ndim) if e != d)]
                row = row.narrow(grown[0], 0, want[grown[0]]) if grown else None
        self.prints.append(None if row is None else _fingerprint(row))


_LAYOUT_OPS = {"empty", "empty_like", "empty_strided", "new_empty", "new_empty_strided", "view",
               "_unsafe_view", "reshape", "clone", "copy_", "contiguous", "expand", "transpose",
               "permute", "t", "slice", "select", "unsqueeze", "squeeze", "alias", "detach",
               "unbind", "split", "split_with_sizes", "as_strided", "lift_fresh"}


def _fingerprint(t):
    v = t.contiguous().reshape(-1)
    ints = {1: torch.uint8, 2: torch.int16, 4: torch.int32, 8: torch.int64}[v.element_size()]
    v = v.view(ints).to(torch.int64)
    w = torch.arange(v.numel(), device=v.device) % 1021 + 1
    return torch.stack([v.sum(), (v * w).sum()])


def first_row_variant_op(fn: Callable, one, many, rows: int) -> Dict[str, Any]:
    """Runs ``fn(one)`` (a B = 1 input) and ``fn(many)`` (``rows`` copies of
    that row) and names the first floating op whose row 0 differs between
    the two, with the model frames that issued it; ``None`` fields when
    every op's row 0 is bitwise equal."""
    a = _Fingerprints(1)
    with a.mode:
        fn(one)
    b = _Fingerprints(rows, ref_shapes=a.shapes)
    with b.mode:
        fn(many)
    for i, (na, nb, pa, pb) in enumerate(zip(a.names, b.names, a.prints, b.prints)):
        if na != nb:
            return {"op": f"the op sequences part at op {i}: {na} vs {nb}", "index": i,
                    "of": len(a.names), "frames": []}
        if pa is not None and pb is not None and not torch.equal(pa, pb):
            c = _Fingerprints(rows, at=i)
            with c.mode:
                fn(many)
            return {"op": na, "index": i, "of": len(a.names), "frames": c.frames[-3:]}
    return {"op": None, "index": None, "of": len(a.names), "frames": []}


def _report_rows(run: Run, name: str, bitwise: bool, err: float, trace: Callable[[], Dict],
                 into: Dict[str, Any]) -> None:
    """Holds rows bitwise equal across batch widths (the bits contract:
    since the recurrences' contractions run on the row-invariant kernel).
    Where they are not, the first op that makes them differ is recorded in
    ``into`` with the rows' numbers before the check fails."""
    into.update(bitwise=bitwise, max_abs_err=err)
    if not bitwise:
        into["first_row_variant_op"] = trace()
    run.check(f"{name} bitwise", bitwise,
              "every logit and state leaf equal" if bitwise else
              f"max|d| {err:.3e}; first op whose row 0 differs by batch width: "
              f"{into['first_row_variant_op']}")


# ---------------------------------------------------------------- (a) prefill
def rows_that_fit(cfg, S: int, dev) -> tuple:
    """(rows, why): prefill_32k's 32 rows, or fewer where the largest
    per-row activations of one layer would not fit the device's free
    memory (hymba: its SSM coefficients ``dA``, ``dBx`` [S, d_inner, N]
    f32 and the SSM's [S, 2 d_inner] input; xlstm: q, k, v, the stacked
    outputs and their list [S, d] f32)."""
    if cfg.family == "hybrid":
        di, N = cfg.ssm.expand * cfg.d_model, cfg.ssm.state_dim
        per_row = S * (2 * di * N * 4 + 2 * di * 2)
    else:
        per_row = S * 5 * cfg.d_model * 4
    if torch.device(dev).type != "cuda":
        return PREFILL_ROWS, f"{per_row / 1e9:.3f} GB of one layer's activations a row"
    free = torch.cuda.mem_get_info(dev)[0]
    rows = max(1, min(PREFILL_ROWS, int(0.85 * free / per_row)))
    return rows, (f"{per_row / 1e9:.3f} GB of one layer's live activations a row against "
                  f"{free / 1e9:.1f} GB free (85% of it used)")


def _busy_share(fn) -> Dict[str, float]:
    """Wall and device busy seconds of ``fn()`` under the profiler."""
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        t0 = time.monotonic()
        fn()
        torch.cuda.synchronize()
        wall = time.monotonic() - t0
    busy = sum(getattr(e, "self_device_time_total", 0.0) for e in prof.key_averages()) / 1e6
    return {"wall_s": wall, "busy_s": busy, "busy_share": busy / wall}


def prefill_rows(run: Run, rows: int) -> Dict[str, Any]:
    """(a): ``prefill_fn`` over ``rows`` x S seeded tokens."""
    cfg, dev, S = run.cfg, run.dev, run.S
    rng = np.random.default_rng(SEED)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (rows, S)).astype(np.int32)).to(dev)
    run.prefix = tuple(int(t) for t in toks[0].tolist())
    cache_len = cfg.sliding_window or 1  # as the snapshot engine prefills
    _sync(dev)
    _reset_peak(dev)
    t0 = time.monotonic()
    logits, state = run.bundle.prefill_fn(run.params, {"tokens": toks}, cache_len)
    _sync(dev)
    rec = {"rows": rows, "wall_s": time.monotonic() - t0, "peak_gib": _peak_gib(dev)}
    run.check("(a) prefill logits", bool(torch.isfinite(logits).all())
              and tuple(logits.shape) == (rows, cfg.vocab_size),
              f"{rows} x {S} tokens: logits {tuple(logits.shape)} finite")
    if torch.device(dev).type == "cuda":
        n = min(PROFILE_TOKENS, S)
        rec["profiled_slice"] = dict(_busy_share(lambda: run.bundle.prefill_fn(
            run.params, {"tokens": toks[:, :n]}, cache_len)), tokens=n)
    run.log(f"{cfg.name} (a) prefill {rows} x {S} tokens: wall {rec['wall_s']:.3f} s, peak "
            f"{rec['peak_gib']} GiB; profiled slice {rec.get('profiled_slice')}")
    run.a_logits, run.a_state = logits, state
    return rec


# ---------------------------------------------------------------- (b) claim
def _stage(eng) -> Dict[str, List[float]]:
    return {k: eng.stage_seconds.samples(stage=k) for k in ("prefill", "restore", "decode_step")}


def snapshot_claim(run: Run) -> Dict[str, Any]:
    """(b): the claim over (a)'s row 0 through two ``SnapshotEngine``s."""
    from repro_torch.core.analyzer import (
        check_failure_outcome_path,
        check_observation_path,
        validate_event_sequence,
    )
    from repro_torch.core.claims import ClaimMode, ClaimState
    from repro_torch.serving.snapshot_engine import SnapshotEngine, _unpack_state

    cfg, dev, prefix = run.cfg, run.dev, run.prefix
    V = cfg.vocab_size
    rng = np.random.default_rng(SEED + 1)
    prompts = [prefix + tuple(int(t) for t in rng.integers(0, V, CLAIM_FRESH))
               for _ in range(CLAIM_REQUESTS)]
    rec: Dict[str, Any] = {"prefix_tokens": len(prefix)}
    with SnapshotEngine(run.bundle, run.params, device=dev) as eng:
        _sync(dev)
        _reset_peak(dev)
        t0 = time.monotonic()
        claim = eng.accept_claim(prefix, ClaimMode.OFFLOADABLE)
        cid = claim.claim_id
        blk = eng.materialize_claim(cid)
        rec["materialize_s"] = time.monotonic() - t0
        rec["payload_bytes"] = int(blk.nbytes)
        run.check("(b) materialized", claim.state == ClaimState.MATERIALIZED,
                  f"claim {claim.state.value}, {blk.nbytes} B snapshot")
        # a copy: path B's engine is handed this snapshot after the slot is gone
        snap = _unpack_state(blk.k.clone(), eng._snapshot_meta[eng._chain_for(prefix)], dev)
        # (a)'s row 0 against this B = 1 materialization of the same tokens
        row0 = take_rows(run.bundle, run.a_state, [0])
        lg = run.a_logits[:1]
        st = compare_states(run.bundle, row0, snap["state"])
        bitwise = torch.equal(lg, snap["logits"]) and st["bitwise"]
        err = max(_max_err(lg, snap["logits"]), st["max_abs_err"])
        rec["row0_vs_b1"] = dict(state=st, logits_max_abs_err=_max_err(lg, snap["logits"]),
                                 logits_flips=near_tie_flips(lg, snap["logits"]))
        _report_rows(run, "(a) row 0 against the B = 1 materialization", bitwise, err,
                     lambda: trace_prefill(run), rec["row0_vs_b1"])
        del row0
        kept = eng.serve_batch(prompts, max_new_tokens=CLAIM_NEW)  # the snapshot on the device
        run.check("(b) served on the device", [r.status for r in kept] == ["finished"] * len(kept)
                  and [r.cached_tokens for r in kept] == [len(prefix)] * len(kept),
                  f"statuses {[r.status for r in kept]}, cached {[r.cached_tokens for r in kept]}")
        t1 = time.monotonic()
        run.check("(b) offloaded", eng.offload_claim(cid) and claim.state == ClaimState.OFFLOADED,
                  f"claim {claim.state.value}")
        _sync(dev)
        rec["offload_s"] = time.monotonic() - t1
        before = _stage(eng)
        t2 = time.monotonic()
        reqs = eng.serve_batch(prompts, max_new_tokens=CLAIM_NEW)
        _sync(dev)
        wall = time.monotonic() - t2
        stage = {k: v[len(before[k]):] for k, v in _stage(eng).items()}
        rec["peak_gib"] = _peak_gib(dev)
        run.check("(b) path A finished", all(r.status == "finished" and len(r.output_tokens)
                                             == CLAIM_NEW for r in reqs)
                  and reqs[0].restored_tokens == len(prefix)
                  and [r.cached_tokens for r in reqs] == [len(prefix)] * len(reqs),
                  f"statuses {[r.status for r in reqs]}, restored {reqs[0].restored_tokens}")
        run.check("(b) path A tokens", [r.output_tokens for r in reqs]
                  == [r.output_tokens for r in kept],
                  f"{len(reqs)} requests x {CLAIM_NEW} tokens after the restore against the "
                  "never-offloaded snapshot's")
        order = validate_event_sequence(eng.events)
        verdict = check_observation_path(eng.events, cid, reqs[0].request_id)
        run.check("(b) path A analyzer", claim.state == ClaimState.RESTORED and order.passed
                  and verdict.passed and not eng.fail_closed_total(),
                  f"claim {claim.state.value}; {order.reasons}; {verdict.reasons}")
        rec["path_a"] = {
            "wall_s": wall, "prefill_s": sum(stage["prefill"]), "restore_s": sum(stage["restore"]),
            "decode_steps_s": sum(stage["decode_step"]), "decode_steps": len(stage["decode_step"]),
            "other_host_s": wall - sum(sum(v) for v in stage.values()),
            "analyzer": verdict.reasons[0]}
    run.log(f"{cfg.name} (b) claim over {len(prefix)} tokens: {rec}")

    with SnapshotEngine(run.bundle, run.params, device=dev) as eng:
        # the claim's prefill is path A's B = 1 prefill of the same prefix:
        # this engine takes its result instead of running it a second time
        eng._prefill = lambda toks: (snap["logits"], snap["state"]) if tuple(toks) == prefix \
            else SnapshotEngine._prefill(eng, toks)
        claim = eng.accept_claim(prefix, ClaimMode.OFFLOADABLE)
        cid = claim.claim_id
        eng.materialize_claim(cid)
        del eng._prefill, snap
        run.check("(b) path B offloaded", eng.offload_claim(cid), f"claim {claim.state.value}")
        eng.connector.injection.resident_claim_load_failure = True
        eng.connector.injection.fail_claim_id = cid
        (r,) = eng.serve_batch([prompts[0]], max_new_tokens=CLAIM_NEW)
        order = validate_event_sequence(eng.events)
        up_to_load = check_observation_path(eng.events, cid, r.request_id)
        verdict = check_failure_outcome_path(eng.events, cid, r.request_id)
        served = any(e.request_id == r.request_id
                     for e in eng.events.named("offload_request_finished_no_pending_jobs"))
        run.check("(b) path B refused in order",
                  r.status == "refused" and r.output_tokens == []
                  and claim.state == ClaimState.RESTORATION_FAILED and order.passed
                  and up_to_load.reasons == ["no successful tier->device transfer for the claim"]
                  and not served and verdict.passed,
                  f"request {r.status}, claim {claim.state.value}, ordered E11 -> E12 -> E13 -> "
                  f"E14 -> FINISHED_ERROR ({verdict.reasons[0]})")
        rec["path_b"] = verdict.reasons[0]
    return rec


def trace_prefill(run: Run, rows: Optional[int] = None, tokens: int = TRACE_TOKENS
                  ) -> Dict[str, Any]:
    """The first op whose row 0 differs between a B = 1 prefill and one of
    ``rows`` copies of it (default (a)'s width), over the prefix's first
    ``tokens`` tokens."""
    n = min(tokens, run.S)
    rows = run.a_logits.shape[0] if rows is None else rows
    one = torch.tensor([run.prefix[:n]], dtype=torch.int32, device=run.dev)
    cache_len = run.cfg.sliding_window or 1
    out = first_row_variant_op(
        lambda t: run.bundle.prefill_fn(run.params, {"tokens": t}, cache_len), one,
        one.expand(rows, n).contiguous(), rows)
    return dict(out, tokens=n, rows=rows)


# ---------------------------------------------------------------- (c) decode
def decode_rows(run: Run, rows: int = DECODE_ROWS, steps: int = DECODE_STEPS,
                b1_rows: Optional[int] = None) -> Dict[str, Any]:
    """(c): ``rows`` rows tiled from (a)'s states at position S."""
    cfg, dev, S, b = run.cfg, run.dev, run.S, run.bundle
    n_a = run.a_logits.shape[0]
    state = take_rows(b, run.a_state, [r % n_a for r in range(rows)])
    rng = np.random.default_rng(SEED + 2)
    tok = torch.from_numpy(rng.integers(0, cfg.vocab_size, rows).astype(np.int32)).to(dev)
    pos = torch.full((rows,), S, dtype=torch.int32, device=dev)
    _sync(dev)
    _reset_peak(dev)
    first, cur, ts = None, state, []
    t_in, s_in = tok, state
    for _ in range(steps):
        t0 = time.monotonic()
        lg, cur = b.decode_fn(run.params, cur, tok, pos)
        _sync(dev)
        ts.append(1e3 * (time.monotonic() - t0))
        first = lg if first is None else first
        tok, pos = lg.argmax(-1).to(torch.int32), pos + 1
    rec = {"rows": rows, "steps": steps, "step_ms": ts, "peak_gib": _peak_gib(dev)}
    run.check("(c) decode logits", bool(torch.isfinite(lg).all())
              and tuple(lg.shape) == (rows, cfg.vocab_size), f"{rows} rows x {steps} steps finite")
    cpu_b, cpu_p, cpu_p32 = run.cpu_model()
    sub = list(range(min(CPU_ROWS, rows)))
    s_sub, t_sub = take_rows(b, s_in, sub), t_in[sub]
    at_sub = torch.full((len(sub),), S, dtype=torch.int32)
    cpu_in = (tree_map(lambda t: t.cpu(), s_sub), t_sub.cpu(), at_sub)
    want, _ = cpu_b.decode_fn(cpu_p, *cpu_in)
    got32, _ = b.decode_fn(run.params_f32(), _f32(s_sub), t_sub, at_sub.to(dev))
    want32, _ = cpu_b.decode_fn(cpu_p32, _f32(cpu_in[0]), *cpu_in[1:])
    rec["cpu"] = dict(run.hold_cross(f"(c) first step, rows {sub} of {rows}, card against CPU",
                                     (first[sub], want), (got32, want32)), rows=sub)
    worst, equal, n1 = 0.0, True, rows if b1_rows is None else min(rows, b1_rows)
    at_s = torch.full((1,), S, dtype=torch.int32, device=dev)
    for r in range(n1):
        one, _ = b.decode_fn(run.params, take_rows(b, s_in, [r]), t_in[r:r + 1], at_s)
        if not torch.equal(one, first[r:r + 1]):
            equal = False
            worst = max(worst, _max_err(one, first[r:r + 1]))
    if n1 < rows:
        run.cut("(c) rows held against a B = 1 decode", rows, n1, "the smoke's time")
    rec["b1"] = {"rows": n1}
    _report_rows(run, f"(c) {n1} rows against B = 1 decodes", equal, worst,
                 lambda: trace_decode(run, s_in, t_in), rec["b1"])
    run.log(f"{cfg.name} (c) decode {rows} rows at position {S}: step ms {[round(t, 3) for t in ts]}, "
            f"peak {rec['peak_gib']} GiB")
    del state, cur
    return rec


def trace_decode(run: Run, state, tok, rows: int = 8) -> Dict[str, Any]:
    """The first op whose row 0 differs between a B = 1 decode step and one
    of ``rows`` copies of that row."""
    b = run.bundle
    pos = torch.full((1,), run.S, dtype=torch.int32, device=run.dev)
    one = take_rows(b, state, [0])
    many = take_rows(b, state, [0] * rows)
    out = first_row_variant_op(
        lambda s: b.decode_fn(run.params, s[0], s[1], s[2]),
        (one, tok[:1], pos), (many, tok[:1].expand(rows).contiguous(), pos.expand(rows)), rows)
    return dict(out, rows=rows)


# ---------------------------------------------------------------- (d) long_500k
def long_500k_cache(run: Run):
    """B = 1 at long_500k's last position: hymba's ring (window slots of
    seeded K/V holding positions LONG_500K - window .. LONG_500K - 1,
    position p in slot p % window) with (a)'s row-0 SSM state; xlstm's
    state is (a)'s row 0."""
    cfg, b = run.cfg, run.bundle
    row0 = take_rows(b, run.a_state, [0])
    if not cfg.sliding_window:
        return row0
    W, L, KV, D = cfg.sliding_window, cfg.num_layers, cfg.num_kv_heads, cfg.resolved_head_dim
    g = torch.Generator().manual_seed(500)
    kv = lambda: torch.randn((L, 1, W, KV, D), generator=g).to(torch.bfloat16).to(run.dev)
    pos = torch.arange(LONG_500K - W, LONG_500K, dtype=torch.int32)
    ring = torch.empty(W, dtype=torch.int32)
    ring[(pos % W).long()] = pos
    return {"k": kv(), "v": kv(), "pos": ring[None].to(run.dev), "ssm": row0["ssm"]}


def long_500k(run: Run, mesh=None) -> Dict[str, Any]:
    """(d): the card against the CPU, then the ``long_500k`` cell on
    ``mesh`` (a one-rank mesh) against the unsharded step."""
    cfg, b, dev = run.cfg, run.bundle, run.dev
    cache = long_500k_cache(run)
    tok = torch.tensor([int(np.random.default_rng(SEED + 3).integers(0, cfg.vocab_size))],
                       dtype=torch.int32, device=dev)
    cur = torch.tensor([LONG_500K - 1], dtype=torch.int32, device=dev)
    t0 = time.monotonic()
    lg, new = b.decode_fn(run.params, cache, tok, cur)
    _sync(dev)
    rec: Dict[str, Any] = {"step_s": time.monotonic() - t0, "position": LONG_500K - 1}
    if not cfg.sliding_window:
        rec["position_read"] = ("xlstm's decode_step never reads cur_pos (as in the reference): "
                                "this is (a)'s 32k state's next step at any position")
        run.log(f"{cfg.name} (d): {rec['position_read']}")
    cpu_b, cpu_p, cpu_p32 = run.cpu_model()
    cpu_in = (tree_map(lambda t: t.cpu(), cache), tok.cpu(), cur.cpu())
    want, wnew = cpu_b.decode_fn(cpu_p, *cpu_in)
    lg32, _ = b.decode_fn(run.params_f32(), _f32(cache), tok, cur)
    want32, _ = cpu_b.decode_fn(cpu_p32, _f32(cpu_in[0]), *cpu_in[1:])
    rec["cpu"] = run.hold_cross(f"(d) decode at position {LONG_500K - 1}, card against CPU",
                                (lg, want), (lg32, want32))
    if cfg.sliding_window:
        run.check("(d) ring slots", torch.equal(new["pos"].cpu(), wnew["pos"]),
                  f"the {cfg.sliding_window}-slot ring's positions after the step equal the CPU's")
    if mesh is not None:
        rec["sharded"] = sharded_long_500k(run, mesh, cache, tok, cur, (lg, lg32))
    return rec


def sharded_long_500k(run: Run, mesh, cache, tok, cur, want) -> Dict[str, Any]:
    """``build_cell(arch, "long_500k", mesh)`` from the same parameters
    (bf16, then float32 copies), cache and token against the unsharded
    ``decode_fn``'s logits ``want`` (bf16, f32): the DTensor cell keeps
    ``x @ w`` where the unsharded bf16 step runs the row-invariant GEMM, so
    the two round differently (``Run.hold_cross``)."""
    from repro_torch.launch import steps as st
    from repro_torch.sharding.rules import full

    cell = st.build_cell(run.cfg.name, "long_500k", mesh, cfg=run.cfg)
    rest = (st.distribute_argument(cell, "tokens", tok), st.distribute_argument(cell, "cur_pos", cur))
    got, secs = [], []
    for params, state in ((run.params, cache), (run.params_f32(), _f32(cache))):
        args = (st.distribute_argument(cell, "params", params),
                st.distribute_argument(cell, "cache", state)) + rest
        _sync(run.dev)
        t0 = time.monotonic()
        ls, _ = st.run_cell(cell, args)
        got.append(full(ls))
        _sync(run.dev)
        secs.append(time.monotonic() - t0)
        del args
    rec = {"mesh": dict(zip(mesh.mesh_dim_names, mesh.shape)), "step_s": secs}
    rec.update(run.hold_cross("(d) build_cell long_500k on a one-rank mesh against the unsharded "
                              "step", (got[0], want[0]), (got[1], want[1])))
    return rec


# ---------------------------------------------------------------- the cells
def run_cells(bundle, params, cfg, seq_len: int = SEQ_LEN, *, rows: Optional[int] = None,
              decode_rows_: int = DECODE_ROWS, b1_rows: Optional[int] = None, mesh=None,
              log: Callable[[str], None] = print, why: str = "",
              record: Optional[Dict[str, Any]] = None) -> Dict[str, Any]:
    """(a)-(d) for one architecture; returns the record (``record``, filled
    as the cells run, so a failed check leaves what ran).  ``rows`` cuts
    (a)'s rows (default: what the card holds, ``rows_that_fit``),
    ``decode_rows_`` (c)'s, ``b1_rows`` the rows (c) holds against B = 1
    decodes; ``why`` says why the caller cut them."""
    run = Run(bundle, params, cfg, seq_len, log=log, record=record)
    rec = run.record
    if seq_len != SEQ_LEN:
        run.cut("prompt tokens", SEQ_LEN, seq_len, why or "the caller's length")
    if rows is None:
        rows, reason = rows_that_fit(cfg, seq_len, bundle.device)
    else:
        reason = why or "the caller's rows"
    if rows != PREFILL_ROWS:
        run.cut("(a) prefill rows", PREFILL_ROWS, rows, reason)
    if decode_rows_ != DECODE_ROWS:
        run.cut("(c) decode rows", DECODE_ROWS, decode_rows_, why or "the caller's rows")
    t0 = time.monotonic()
    rec["launches"] = {}
    for name, cell in (("prefill", lambda: prefill_rows(run, rows)),
                       ("claim", lambda: snapshot_claim(run)),
                       ("decode", lambda: decode_rows(run, decode_rows_, b1_rows=b1_rows)),
                       ("long_500k", lambda: long_500k(run, mesh))):
        before = launches()
        rec[name] = cell()
        rec["launches"][name] = {k: v - before[k] for k, v in launches().items()}
        log(f"{cfg.name} launches in ({name}): {rec['launches'][name]}")
    rec["wall_s"] = time.monotonic() - t0
    run.a_state = run.a_logits = run._cpu = run._f32 = None
    return rec


def launches() -> Dict[str, int]:
    """Every kernel wrapper's launch count (read, never reset: a caller's
    own counts stay whole)."""
    from repro_torch.kernels import contract
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import gemm
    from repro_torch.kernels import kv_block_copy as kbc
    from repro_torch.kernels import norm
    from repro_torch.kernels import paged_attention as pa

    return {"paged_decode_attention": pa.paged_decode_attention.launches,
            "paged_prefill_attention": pa.paged_prefill_attention.launches,
            "kv_block_copy": kbc.kv_block_copy.launches,
            "flash_attention": fa.flash_attention.launches,
            "paged_attention": pa.paged_attention.launches,
            "gemm": gemm.gemm.launches, "norm": norm.norm.launches,
            "contract": contract.contract.launches}


def snapshot_bytes(bundle) -> int:
    """A B = 1 snapshot payload's bytes (the state's leaves and the f32
    next-token logits), from the state's shapes alone."""
    cfg = bundle.cfg
    state = bundle.make_cache(1, cfg.sliding_window or 1, device="meta")
    return (sum(t.numel() * t.element_size() for _, t in _flatten(state))
            + 4 * cfg.vocab_size)

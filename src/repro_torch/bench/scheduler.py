"""Mixed-step scheduler bench on the port: decode inter-token latency
(ITL) under concurrent prefill admission.

The counterpart of ``benchmarks/bench_scheduler.py``, with its workload
and gates.  Ten decode streams (prompts of 96 tokens, 32 new tokens) run
first alone, then while a burst of longer prompts (40/56/72/88 tokens,
``prefill_chunk`` 8) is admitted and chunk-prefilled mid-stream.  ITL is
the host-clock gap between consecutive ``step_scheduled`` events of
full-width (exactly ten decode rows) steps; the step loop synchronises the
device before it emits the event, so the gap is a token's wall time.
Under the burst only the steps that carried a prefill chunk count (the
contended steps).

Gates (any failure exits 1):

  - ``itl_ratio_p99``: contended ITL p99 <= 1.5x the isolated ITL p99,
    each the best of ``reps`` repetitions;
  - ``decode_stall_steps_total`` == 0 on every engine;
  - ``check_step_interleave_order``, ``check_metrics_reconcile`` and
    ``validate_event_sequence`` green on every engine;
  - every request finishes with its full token budget.

Also reported (not gated): TTFT percentiles of the burst requests, step
occupancy, the prefill chunks' wall, the chunk steps by route
(``scheduler_chunk_steps_total``: fused into the decode rows' launch, or
why not), and ``step_trace``: one more burst repetition, after the
measured ones and outside every statistic above, recorded step by step
(``StepTrace``) with the contended steps' gaps split into stages, fused
and split steps apart.  The summary merges into
``<out-dir>/BENCH_serving.json`` under ``mixed_scheduler``.

    PYTHONPATH=src python -m repro_torch.bench.scheduler [--fast]        # card
    PYTHONPATH=src python -m repro_torch.bench.scheduler --device cpu --reduced --fast
"""
from __future__ import annotations

import json
import time
from pathlib import Path
from typing import Any, Dict, List, Optional

import torch

from repro_torch.bench.common import (
    RESULTS_DIR,
    SERVING_JSON,
    Model,
    gate_failed,
    merge_json,
    model_from,
    parse,
    parser,
    pct,
    pcts_ms,
)
from repro_torch.core.analyzer import (
    check_metrics_reconcile,
    check_step_interleave_order,
    validate_event_sequence,
)

ITL_RATIO_MAX = 1.5
N_STREAMS = 10
STREAM_PLEN = 96
ENGINE_KW = dict(device_blocks=320, cache_len=128, prefill_chunk=8)
LAUNCHES = ("_step_mixed", "_step_paged_decode", "_step_prefill_chunk")


def _launch_counts() -> Dict[str, int]:
    """The GEMM's, K1's and K2's launch counters (they move on the card only)."""
    from repro_torch.kernels import gemm, paged_attention as pa

    return {"gemm": gemm.gemm.launches, "k1": pa.paged_decode_attention.launches,
            "k2": pa.paged_prefill_attention.launches}


def _fail(msg: str) -> None:
    gate_failed("SCHEDULER", msg)


def decode_deltas(eng, *, overlap_only: bool) -> List[float]:
    """Gaps between consecutive steps that both carried exactly the
    N_STREAMS decode rows; with ``overlap_only`` the later step must also
    have carried a prefill chunk."""
    steps = eng.events.named("step_scheduled")
    out = []
    for prev, cur in zip(steps, steps[1:]):
        if cur.payload["step"] != prev.payload["step"] + 1:
            continue
        if prev.payload["n_decode"] != N_STREAMS or cur.payload["n_decode"] != N_STREAMS:
            continue
        if overlap_only and cur.payload["prefill_tokens"] < 1:
            continue
        out.append(cur.ts - prev.ts)
    return out


def join_deltas(eng) -> List[float]:
    """Step gaps where a burst row sat in the decode batch (batch growth)."""
    steps = eng.events.named("step_scheduled")
    return [cur.ts - prev.ts for prev, cur in zip(steps, steps[1:])
            if cur.payload["step"] == prev.payload["step"] + 1
            and cur.payload["n_decode"] > N_STREAMS]


_UNSET = object()


class StepTrace:
    """Per-step record of one burst repetition: what each scheduler step
    spent, by stage, and what it copied across the host/card boundary.

    Measurement code of the bench, not of the engine: while the context is
    open it wraps the engine's ``_device_pages`` (a page-store copy to the
    card when it returns tensors other than the pool's own), the offload
    connector's ``gather_payloads`` (restored payloads uploaded from the
    host), the pool's ``_page_in`` (a host payload landing in a store on the
    card), ``StepLoop._sync_state`` (whether the batched state was
    rebuilt), ``torch.Tensor.cpu``/``to`` (bytes copied between host and
    card) and the engine's three launches (``_step_mixed``,
    ``_step_paged_decode``, ``_step_prefill_chunk``: the GEMM, K1 and K2
    launches each made, from the wrappers' counters), and it restores all
    of them on exit.  Each record is stamped
    with ``time.monotonic()``, the event log's clock, and belongs to the
    first ``step_scheduled`` event at or after it."""

    def __init__(self, eng):
        self.eng = eng
        self.records: List[tuple] = []  # (ts, kind, nbytes, seconds, launches)
        self._quiet = 0  # inside a wrapped page copy: .to() is not counted twice

    def _note(self, kind: str, nbytes: int, seconds: float = 0.0, launches=None) -> None:
        self.records.append((time.monotonic(), kind, int(nbytes), seconds, launches))

    def _timed_page_copy(self, fn, *args):
        """Run ``fn`` with the device synchronised around it: the seconds
        of a page copy, not of whatever was queued before it."""
        dev = self.eng.device
        sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda *_: None)
        sync(dev)
        t0 = time.perf_counter()
        self._quiet += 1
        try:
            out = fn(*args)
        finally:
            self._quiet -= 1
        sync(dev)
        return out, time.perf_counter() - t0

    def __enter__(self) -> "StepTrace":
        from repro_torch.serving import offload, scheduler_loop

        eng, pool, tr = self.eng, self.eng.pool, self
        pages_fn, page_in, gather = eng._device_pages, pool._page_in, offload.gather_payloads
        sync_state, cpu, to = scheduler_loop.StepLoop._sync_state, torch.Tensor.cpu, torch.Tensor.to
        last = [None]

        def device_pages():
            out, secs = tr._timed_page_copy(pages_fn)
            own = out[0] is pool.k_pages
            if not own and pool.k_pages is not None and out[0] is not last[0]:
                tr._note("page_h2d", pool.k_pages.nbytes + pool.v_pages.nbytes, secs)
            last[0] = out[0]
            return out

        def page_in_wrapped(blk, k, v, *slot):
            store = pool.k_pages
            if store is None or k.device == store.device:
                return page_in(blk, k, v, *slot)
            _, secs = tr._timed_page_copy(page_in, blk, k, v, *slot)
            tr._note("page_h2d", k.nbytes + v.nbytes, secs)

        def gather_wrapped(arrays, device=None):
            out, secs = tr._timed_page_copy(gather, arrays, device)
            up = sum(a.nbytes for a, o in zip(arrays, out)
                     if a.device.type == "cpu" and o.device.type != "cpu")
            if up:
                tr._note("page_h2d", up, secs)
            return out

        def sync_wrapped(loop, pages):
            rebuilt = not (loop._state is not None and loop._members == loop.rows)
            tr._note("rebuilt" if rebuilt else "kept", 0)
            return sync_state(loop, pages)

        def cpu_wrapped(t, *a, **kw):
            if t.is_cuda and not tr._quiet:
                tr._note("d2h", t.nbytes)
            return cpu(t, *a, **kw)

        def to_wrapped(t, *a, **kw):
            out = to(t, *a, **kw)
            if not tr._quiet and out.device != t.device:
                tr._note("d2h" if t.is_cuda else "h2d_other", out.nbytes)
            return out

        def counted(fn):
            def launch(*args):
                n0 = _launch_counts()
                try:
                    return fn(*args)
                finally:
                    n1 = _launch_counts()
                    tr._note("launch", 0, launches={k: n1[k] - n0[k] for k in n0})
            return launch

        self._saved = []
        for obj, name, fn in (
            (eng, "_device_pages", device_pages), (pool, "_page_in", page_in_wrapped),
            (offload, "gather_payloads", gather_wrapped),
            (scheduler_loop.StepLoop, "_sync_state", sync_wrapped),
            (torch.Tensor, "cpu", cpu_wrapped), (torch.Tensor, "to", to_wrapped),
            *((eng, name, counted(getattr(eng, name))) for name in LAUNCHES
              if getattr(eng, name) is not None),
        ):
            self._saved.append((obj, name, vars(obj).get(name, _UNSET)))
            setattr(obj, name, fn)
        return self

    def __exit__(self, *exc) -> None:
        for obj, name, orig in reversed(self._saved):
            if orig is _UNSET:
                delattr(obj, name)  # the inherited attribute shows again
            else:
                setattr(obj, name, orig)

    def totals(self) -> Dict[str, Dict[str, float]]:
        """Bytes, seconds and count of each kind of copy over the whole
        trace (``page_h2d``, ``h2d_other``, ``d2h``)."""
        out: Dict[str, Dict[str, float]] = {}
        for _, kind, nbytes, secs, _ in self.records:
            if kind in ("rebuilt", "kept", "launch"):
                continue
            t = out.setdefault(kind, {"bytes": 0, "s": 0.0, "n": 0})
            t["bytes"] += nbytes
            t["s"] += secs
            t["n"] += 1
        return out

    def steps(self) -> List[Dict[str, Any]]:
        """One dict per ``step_scheduled`` event: its counts, the gap since
        the previous step (the ITL sample when both carried the ten decode
        rows), its route (``fused``: one ``mixed_step`` launch; else
        ``split``), the seconds of each stage, the GEMM, K1 and K2 launches
        and the bytes copied."""
        events = self.eng.events.named("step_scheduled")
        stages = self.eng.events.named("stage_latency")
        out, r, s, prev_ts = [], 0, 0, None
        for ev in events:
            p = ev.payload
            row = {
                "step": p["step"], "n_decode": p["n_decode"], "n_feed": p["n_feed"],
                "prefill_tokens": p["prefill_tokens"], "rebuilt": False,
                "gap_ms": None if prev_ts is None else round((ev.ts - prev_ts) * 1e3, 4),
                "decode_step_ms": 0.0, "prefill_chunk_ms": 0.0, "mixed_step_ms": 0.0,
                "launches": 0, "gemm_launches": 0, "k1_launches": 0, "k2_launches": 0,
                "page_h2d_bytes": 0, "page_h2d_ms": 0.0, "other_h2d_bytes": 0, "d2h_bytes": 0,
            }
            while s < len(stages) and stages[s].seq < ev.seq:
                key = f"{stages[s].payload['stage']}_ms"
                row[key] = row.get(key, 0.0) + stages[s].payload["seconds"] * 1e3
                s += 1
            while r < len(self.records) and self.records[r][0] <= ev.ts:
                _, kind, nbytes, secs, counts = self.records[r]
                if kind == "rebuilt":
                    row["rebuilt"] = True
                elif kind == "launch":
                    row["launches"] += 1
                    for k, n in counts.items():
                        row[f"{k}_launches"] += n
                elif kind == "page_h2d":
                    row["page_h2d_bytes"] += nbytes
                    row["page_h2d_ms"] += secs * 1e3
                elif kind == "h2d_other":
                    row["other_h2d_bytes"] += nbytes
                elif kind == "d2h":
                    row["d2h_bytes"] += nbytes
                r += 1
            for key in ("decode_step_ms", "prefill_chunk_ms", "mixed_step_ms", "page_h2d_ms"):
                row[key] = round(row[key], 4)
            row["route"] = "fused" if row["mixed_step_ms"] > 0 else "split"
            out.append(row)
            prev_ts = ev.ts
        return out


def contended(rows: List[Dict[str, Any]]) -> List[Dict[str, Any]]:
    """The steps whose gaps ``decode_deltas(overlap_only=True)`` takes."""
    return [cur for prev, cur in zip(rows, rows[1:])
            if cur["step"] == prev["step"] + 1
            and prev["n_decode"] == N_STREAMS and cur["n_decode"] == N_STREAMS
            and cur["prefill_tokens"] >= 1]


def _route_breakdown(steps: List[Dict[str, Any]]) -> Dict[str, Any]:
    keys = ("gap_ms", "mixed_step_ms", "decode_step_ms", "prefill_chunk_ms", "page_h2d_ms",
            "other_ms", "gemm_launches", "k1_launches", "k2_launches", "page_h2d_bytes",
            "other_h2d_bytes", "d2h_bytes")
    by_gap = sorted(steps, key=lambda row: row["gap_ms"])
    at = lambda q: by_gap[max(0, min(len(by_gap) - 1, -(-q * len(by_gap) // 100) - 1))]
    return {
        "steps": len(steps),
        "p50": {k: pct([row[k] for row in steps], 50) for k in keys},
        "launches_per_step": sorted({row["launches"] for row in steps}),
        "gemm_launches_per_step": sorted({row["gemm_launches"] for row in steps}),
        "step_at_gap_p50": at(50),
        "step_at_gap_p99": at(99),
        "rebuilt_steps": sum(row["rebuilt"] for row in steps),
        "join_steps": sum(row["n_feed"] > 0 for row in steps),
    }


def stage_breakdown(rows: List[Dict[str, Any]]) -> Dict[str, Any]:
    """The contended steps' gaps split into the fused launch
    (``mixed_step``), the decode launch, the prefill chunk's own launch,
    page-store copies to the card and the rest (host work: stores,
    admission, state assembly, copies back): for fused and split steps
    apart, the p50 of each stage and of the GEMM, K1 and K2 launches, and
    the step at the gap's p50 and p99 whole."""
    steps = contended(rows)
    if not steps:
        return {"contended_steps": 0}
    for row in steps:
        row["other_ms"] = round(row["gap_ms"] - row["mixed_step_ms"] - row["decode_step_ms"]
                                - row["prefill_chunk_ms"] - row["page_h2d_ms"], 4)
    return {
        "contended_steps": len(steps),
        **{route: _route_breakdown(group) for route in ("fused", "split")
           if (group := [row for row in steps if row["route"] == route])},
    }


def run_traced_rep(model: Model, *, dec_new: int, burst_lens: List[int]) -> Dict[str, Any]:
    """One more burst repetition under ``StepTrace``: every step's record
    and the contended steps' breakdown.  Not counted in the ITL gate."""
    with model.engine(**ENGINE_KW) as eng:
        with StepTrace(eng) as trace:
            eng.run_batch(submit_streams(eng, dec_new=dec_new) + submit_burst(eng, burst_lens))
        rows = trace.steps()
        _check_trace(eng, "traced burst")
    return {"breakdown": stage_breakdown(rows), "steps": rows}


def _check_trace(eng, label: str) -> None:
    for name, verdict in (
        ("sequence", validate_event_sequence(eng.events)),
        ("step_interleave_order", check_step_interleave_order(eng.events)),
        ("metrics_reconcile", check_metrics_reconcile(eng.events, eng.metrics)),
    ):
        if not verdict.passed:
            _fail(f"{label}: {name}: {verdict.reasons}")
    if eng.decode_stalls.value() != 0:
        _fail(f"{label}: decode_stall_steps_total = {eng.decode_stalls.value()} (want 0)")


def submit_streams(eng, *, dec_new: int):
    return [eng.submit(tuple(range(3000 + 200 * i, 3000 + 200 * i + STREAM_PLEN)),
                       max_new_tokens=dec_new)
            for i in range(N_STREAMS)]


def submit_burst(eng, burst_lens: List[int]):
    return [eng.submit(tuple(range(30000 + 500 * i, 30000 + 500 * i + n)), max_new_tokens=1)
            for i, n in enumerate(burst_lens)]


def run_iso_rep(model: Model, *, dec_new: int) -> List[float]:
    with model.engine(**ENGINE_KW) as eng:
        streams = submit_streams(eng, dec_new=dec_new)
        eng.run_batch(streams)
        for r in streams:
            if r.status != "finished" or len(r.output_tokens) != dec_new:
                _fail(f"isolated decode stream did not finish: {r.status} {r.error}")
        deltas = decode_deltas(eng, overlap_only=False)
        _check_trace(eng, "isolated")
    return deltas


def run_burst_rep(model: Model, *, dec_new: int, burst_lens: List[int]) -> Dict[str, Any]:
    with model.engine(**ENGINE_KW) as eng:
        t0 = time.monotonic()
        streams = submit_streams(eng, dec_new=dec_new)
        burst = submit_burst(eng, burst_lens)
        eng.run_batch(streams + burst)
        for r in streams:
            if r.status != "finished" or len(r.output_tokens) != dec_new:
                _fail(f"decode stream starved under admission: {r.status} {r.error}")
        for r, n in zip(burst, burst_lens):
            if r.status != "finished" or len(r.output_tokens) != 1:
                _fail(f"burst prompt (len {n}) did not finish: {r.status} {r.error}")
            if r.first_token_ts is None:
                _fail(f"burst prompt (len {n}) never stamped first_token_ts")
        overlap = decode_deltas(eng, overlap_only=True)
        if not overlap:
            _fail("no contended steps: prefill never overlapped the decode streams")
        steps = eng.events.named("step_scheduled")
        out = {
            "overlap_deltas": overlap,
            "all_deltas": decode_deltas(eng, overlap_only=False),
            "join_deltas": join_deltas(eng),
            "ttfts": [r.first_token_ts - t0 for r in burst],
            "phased_prefill_wall_s": sum(eng.stage_seconds.samples(stage="prefill_chunk")),
            "n_steps": len(steps),
            "mixed_steps": sum(1 for e in steps if e.payload["n_decode"] >= 1
                               and e.payload["prefill_tokens"] >= 1),
            "chunk_routes": eng.chunk_routes.as_dict(),
            "occupancy_max": max(e.payload["step_tokens"] / e.payload["budget"] for e in steps),
        }
        _check_trace(eng, "burst")
    return out


def measure(model: Model, out_dir: Path = RESULTS_DIR, *, fast: bool = False) -> Dict[str, Any]:
    """Warm-up, ``reps`` isolated and ``reps`` burst repetitions; merges
    the summary into ``<out_dir>/BENCH_serving.json`` and returns it.  A
    failed semantic gate (stalls, order, reconcile, a request that did
    not finish) exits 1; the ITL ratio is judged by ``check_itl``."""
    dec_new = 16 if fast else 32
    burst_lens = [40, 72] if fast else [40, 56, 72, 88]
    reps = 3 if fast else 4
    t_start = time.perf_counter()
    with model.engine(**ENGINE_KW) as warm:  # every launch shape both scenarios hit
        warm.run_batch(submit_streams(warm, dec_new=dec_new) + submit_burst(warm, burst_lens))
    iso_reps = [run_iso_rep(model, dec_new=dec_new) for _ in range(reps)]
    burst_reps = [run_burst_rep(model, dec_new=dec_new, burst_lens=burst_lens)
                  for _ in range(reps)]
    step_trace = run_traced_rep(model, dec_new=dec_new, burst_lens=burst_lens)
    # best-of-reps p99 on both sides: one OS hiccup must not fail the gate,
    # and the same treatment of numerator and denominator keeps it honest
    iso_p99 = min(pct(d, 99) for d in iso_reps)
    burst_p99 = min(pct(r["overlap_deltas"], 99) for r in burst_reps)
    ratio = burst_p99 / iso_p99 if iso_p99 > 0 else float("inf")
    join_pool = [x for r in burst_reps for x in r["join_deltas"]]
    summary = {
        "fast": fast,
        "model": model.describe(),
        "workload": {
            "decode_streams": {"n": N_STREAMS, "prompt_len": STREAM_PLEN,
                               "max_new_tokens": dec_new},
            "burst_prompt_lens": burst_lens,
            "engine": ENGINE_KW,
            "reps": reps,
        },
        "isolated_itl_ms": pcts_ms([x for d in iso_reps for x in d]),
        "burst_itl_contended_ms": pcts_ms([x for r in burst_reps for x in r["overlap_deltas"]]),
        "burst_itl_all_ms": pcts_ms([x for r in burst_reps for x in r["all_deltas"]]),
        "admission_transition_ms": pcts_ms(join_pool) if join_pool else None,
        "ttft_ms": pcts_ms([x for r in burst_reps for x in r["ttfts"]]),
        "itl_p99_best_ms": {"isolated": round(iso_p99 * 1e3, 4),
                            "contended": round(burst_p99 * 1e3, 4)},
        "itl_ratio_p99": round(ratio, 3),
        "mixed_steps_per_rep": [r["mixed_steps"] for r in burst_reps],
        "chunk_routes_per_rep": [r["chunk_routes"] for r in burst_reps],
        "step_occupancy_max": round(max(r["occupancy_max"] for r in burst_reps), 4),
        "phased_prefill_wall_ms": round(
            max(r["phased_prefill_wall_s"] for r in burst_reps) * 1e3, 2),
        "decode_stall_steps_total": 0,
        "step_trace": step_trace,
        "gates": {
            "itl_ratio_p99_max": ITL_RATIO_MAX,
            "zero_decode_stalls": True,
            "step_interleave_order": True,
            "metrics_reconcile": True,
            "all_requests_finished": True,
        },
        "wall_s": round(time.perf_counter() - t_start, 1),
    }
    merge_json(Path(out_dir) / SERVING_JSON, "mixed_scheduler", summary)
    return summary


def check_itl(summary: Dict[str, Any]) -> None:
    """Exit 1 unless the contended ITL p99 is within ITL_RATIO_MAX of the
    isolated one."""
    if summary["itl_ratio_p99"] > ITL_RATIO_MAX:
        best = summary["itl_p99_best_ms"]
        _fail(f"decode ITL p99 under admission {best['contended']:.3f}ms is "
              f"{summary['itl_ratio_p99']:.2f}x isolated {best['isolated']:.3f}ms "
              f"(> {ITL_RATIO_MAX}x)")


def main(argv: Optional[List[str]] = None) -> None:
    args = parse(parser(__doc__), argv)
    summary = measure(model_from(args), args.out_dir, fast=args.fast)
    print(json.dumps(summary, indent=1))
    check_itl(summary)
    print("SCHEDULER BENCH OK")


if __name__ == "__main__":
    main()

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
occupancy, the prefill chunks' wall.  The summary merges into
``<out-dir>/BENCH_serving.json`` under ``mixed_scheduler``.

    PYTHONPATH=src python -m repro_torch.bench.scheduler [--fast]        # card
    PYTHONPATH=src python -m repro_torch.bench.scheduler --device cpu --reduced --fast
"""
from __future__ import annotations

import json
import time
from pathlib import Path
from typing import Any, Dict, List, Optional

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
        "step_occupancy_max": round(max(r["occupancy_max"] for r in burst_reps), 4),
        "phased_prefill_wall_ms": round(
            max(r["phased_prefill_wall_s"] for r in burst_reps) * 1e3, 2),
        "decode_stall_steps_total": 0,
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

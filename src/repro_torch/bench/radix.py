"""Radix prefix-reuse bench on the port: effective capacity under a
prefix-heavy multi-turn trace.

The counterpart of ``benchmarks/bench_radix.py``, with its trace, engine
settings and gates.  S chat sessions share one 24-token system prompt;
each runs T turns, turn t's prompt being the SERVED turn t-1 sequence plus
8 new user tokens, 4 new tokens a turn.  With the pool-wide radix index
every turn reuses the system prompt, the session's earlier turns and the
readmitted decode tails; with ``prefix_sharing=False`` every request folds
a private copy of its whole sequence.  Effective capacity is the number of
requests served before the pool first evicts under pressure (its first
``pressure_eviction``).

Gates (any failure exits 1):

  - ``capacity_ratio``: requests served before the first eviction with
    sharing >= 1.5x the sharing-disabled baseline on the same trace;
  - byte identity: a warm turn-2 prefill over reused pages gives logits
    equal (``np.array_equal``) to a cold engine's prefill of the whole
    prompt;
  - zero analyzer violations on both engines (sequence, step interleave,
    metrics reconcile, shared-page immutability), the pool consistent;
  - every trace request finishes; the shared engine reuses, the baseline
    does not.

The summary merges into ``<out-dir>/BENCH_serving.json`` under
``radix_reuse``.

    PYTHONPATH=src python -m repro_torch.bench.radix [--fast]            # card
    PYTHONPATH=src python -m repro_torch.bench.radix --device cpu --reduced --fast
"""
from __future__ import annotations

import json
import time
from pathlib import Path
from typing import Any, Dict, List, Optional

import numpy as np

from repro_torch.bench.common import (
    RESULTS_DIR,
    SERVING_JSON,
    Model,
    gate_failed,
    merge_json,
    model_from,
    parse,
    parser,
)
from repro_torch.core.analyzer import (
    _counter_series,
    check_metrics_reconcile,
    check_shared_page_immutability,
    check_step_interleave_order,
    validate_event_sequence,
)

CAPACITY_RATIO_MIN = 1.5
ENGINE_KW = dict(device_blocks=48, cache_len=64)
SYSTEM_PROMPT = tuple(range(100, 124))  # 24 tokens = 6 blocks, shared by all
TURN_USER_TOKENS = 8  # block-aligned user turns
TURN_NEW_TOKENS = 4  # decode budget per turn (folds as one full block)


def _fail(msg: str) -> None:
    gate_failed("RADIX", msg)


def session_trace(n_sessions: int, n_turns: int) -> List[List[tuple]]:
    """Each session's user tokens per turn (the rest of a turn's prompt is
    the served turn before it, known only at run time)."""
    return [
        [tuple(range(1000 + 100 * (s * n_turns + t),
                     1000 + 100 * (s * n_turns + t) + TURN_USER_TOKENS))
         for t in range(n_turns)]
        for s in range(n_sessions)
    ]


def run_trace(eng, trace) -> Dict[str, Any]:
    """Serve every session's turns one request at a time; the trace's
    counts."""
    n_served = reuse_tokens = 0
    for session in trace:
        seq = SYSTEM_PROMPT
        for user_toks in session:
            req = eng.submit(seq + user_toks, max_new_tokens=TURN_NEW_TOKENS)
            eng.run(req)
            if req.status != "finished" or len(req.output_tokens) != TURN_NEW_TOKENS:
                _fail(f"trace request did not finish under pressure: {req.status} ({req.error})")
            n_served += 1
            reuse_tokens += req.cached_tokens
            seq = seq + user_toks + tuple(req.output_tokens)
    evictions = eng.events.named("pressure_eviction")
    cut = evictions[0].seq if evictions else float("inf")
    before = [e for e in eng.events.named("request_finished")
              if e.payload.get("status") == "FINISHED_OK" and e.seq < cut]
    return {
        "requests": n_served,
        "served_before_eviction": len(before),
        "evictions": len(evictions),
        "reused_tokens": reuse_tokens,
        "pool_used": eng.pool.used,
    }


def _check_trace(eng, label: str) -> None:
    for name, verdict in (
        ("sequence", validate_event_sequence(eng.events)),
        ("step_interleave_order", check_step_interleave_order(eng.events)),
        ("metrics_reconcile", check_metrics_reconcile(eng.events, eng.metrics)),
        ("shared_page_immutability", check_shared_page_immutability(eng.events)),
    ):
        if not verdict.passed:
            _fail(f"{label}: {name}: {verdict.reasons}")
    eng.pool.assert_consistent()


def _counter_total(eng, family: str) -> int:
    return int(sum(_counter_series(eng.metrics.snapshot(), family).values()))


def byte_identity_probe(model: Model) -> Dict[str, Any]:
    """A warm turn-2 prefill over reused pages against a cold engine's:
    whether the logits are equal (the gate ``check`` judges), their max
    |d| and whether their argmax agrees.  The analyzer checks of both
    engines and the reuse witness are held here."""
    with model.engine(**ENGINE_KW) as warm, model.engine(**ENGINE_KW) as cold:
        t1 = SYSTEM_PROMPT + tuple(range(5000, 5000 + TURN_USER_TOKENS))
        r1 = warm.submit(t1, max_new_tokens=TURN_NEW_TOKENS)
        warm.run(r1)
        t2 = t1 + tuple(r1.output_tokens) + tuple(range(5100, 5100 + TURN_USER_TOKENS))
        lg_warm = warm.prefill_logits(t2)
        if not warm.events.named("prefix_reuse"):
            _fail("byte-identity probe: warm turn-2 admission emitted no prefix_reuse")
        lg_cold = cold.prefill_logits(t2)
        # the probe requests stay un-decoded: no terminal events expected
        for eng, label in ((warm, "probe_warm"), (cold, "probe_cold")):
            for name, verdict in (
                ("sequence", validate_event_sequence(eng.events)),
                ("step_interleave_order",
                 check_step_interleave_order(eng.events, require_terminal=False)),
                ("shared_page_immutability", check_shared_page_immutability(eng.events)),
            ):
                if not verdict.passed:
                    _fail(f"{label}: {name}: {verdict.reasons}")
    return {"equal": bool(np.array_equal(lg_warm, lg_cold)),
            "max_abs_diff": float(np.abs(lg_warm - lg_cold).max()),
            "argmax_equal": bool(lg_warm.argmax() == lg_cold.argmax())}


def measure(model: Model, out_dir: Path = RESULTS_DIR, *, fast: bool = False) -> Dict[str, Any]:
    """The trace on both engines and the byte-identity probe; merges the
    summary into ``<out_dir>/BENCH_serving.json`` and returns it.  A
    failed analyzer or reuse check, or a request that did not finish, exits
    1; the byte identity and the capacity ratio are judged by ``check``."""
    n_sessions, n_turns = (6, 2) if fast else (10, 2)
    t_start = time.perf_counter()
    trace = session_trace(n_sessions, n_turns)
    with model.engine(**ENGINE_KW) as shared:
        shared_stats = run_trace(shared, trace)
        _check_trace(shared, "shared")
        reuse_hits = _counter_total(shared, "prefix_reuse_hits_total")
        cow_copies = _counter_total(shared, "cow_copies_total")
    if reuse_hits < 1:
        _fail("shared engine served the multi-turn trace with zero prefix reuse")
    with model.engine(prefix_sharing=False, **ENGINE_KW) as baseline:
        base_stats = run_trace(baseline, trace)
        _check_trace(baseline, "baseline")
        if _counter_total(baseline, "prefix_reuse_hits_total") != 0:
            _fail("sharing-disabled baseline reused a prefix (salting broken)")
    probe = byte_identity_probe(model)
    if base_stats["served_before_eviction"] < 1:
        _fail("baseline served no request before eviction; pool too small for the trace")
    ratio = shared_stats["served_before_eviction"] / base_stats["served_before_eviction"]
    summary = {
        "fast": fast,
        "model": model.describe(),
        "workload": {
            "sessions": n_sessions,
            "turns_per_session": n_turns,
            "system_prompt_tokens": len(SYSTEM_PROMPT),
            "user_tokens_per_turn": TURN_USER_TOKENS,
            "new_tokens_per_turn": TURN_NEW_TOKENS,
            "engine": ENGINE_KW,
        },
        "shared": shared_stats,
        "baseline": base_stats,
        "prefix_reuse_hits_total": reuse_hits,
        "cow_copies_total": cow_copies,
        "capacity_ratio": round(ratio, 3),
        "byte_identity_probe": probe,
        "gates": {
            "capacity_ratio_min": CAPACITY_RATIO_MIN,
            "byte_identical_warm_vs_cold": True,
            "analyzer_clean": True,
            "all_requests_finished": True,
        },
        "wall_s": round(time.perf_counter() - t_start, 1),
    }
    merge_json(Path(out_dir) / SERVING_JSON, "radix_reuse", summary)
    return summary


def check(summary: Dict[str, Any]) -> None:
    """Exit 1 unless the warm turn-2 logits equal the cold ones and sharing
    serves >= CAPACITY_RATIO_MIN x the baseline's requests before the first
    eviction."""
    probe = summary["byte_identity_probe"]
    if not probe["equal"]:
        _fail("warm turn-2 logits over reused pages differ from cold concat serve "
              f"(max |d| {probe['max_abs_diff']:.3e})")
    if summary["capacity_ratio"] < CAPACITY_RATIO_MIN:
        _fail(f"effective capacity with sharing {summary['shared']['served_before_eviction']} "
              f"is only {summary['capacity_ratio']:.2f}x baseline "
              f"{summary['baseline']['served_before_eviction']} (< {CAPACITY_RATIO_MIN}x)")


def main(argv: Optional[List[str]] = None) -> None:
    args = parse(parser(__doc__), argv)
    summary = measure(model_from(args), args.out_dir, fast=args.fast)
    print(json.dumps(summary, indent=1))
    check(summary)
    print("RADIX BENCH OK")


if __name__ == "__main__":
    main()

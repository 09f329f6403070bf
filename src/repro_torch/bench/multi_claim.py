"""Multi-claim attribution control (paper §7 path C, §8.3), serving
throughput (continuous batching against sequential decode), the paged-
decode batch x context ceiling and the chunked-prefill prompt ceiling, on
the port.

The counterpart of ``benchmarks/bench_multi_claim.py``, with its gates:

  - attribution: 3/3 repetitions attribute the failure/refusal ONLY to the
    target claim while the non-target claim restores;
  - serving: the same workload decoded through ``run_batch`` reaches
    >= 2x the sequential-decode throughput (best of ``reps`` walls);
  - paged ceiling: under ONE device-KV budget (pool pages x block_size
    tokens) paged decode sustains >= 2x the dense-assembly batch x context
    ceiling, every request finishing, at logits parity on a common prompt;
  - prefill ceiling: under the same budget chunked prefill admits a
    prompt >= 2x the dense prefill ceiling, at logits parity with the
    monolithic prefill on that prompt.

The ceilings run on the model they are given (the reference hard-codes
reduced qwen3).  Writes ``<out-dir>/vllm-multi-claim-attribution-control.json``
and ``<out-dir>/BENCH_serving.json`` (``serving``, ``paged_ceiling``,
``prefill_ceiling``); exits 1 unless every gate holds.

    PYTHONPATH=src python -m repro_torch.bench.multi_claim [--fast]      # card
    PYTHONPATH=src python -m repro_torch.bench.multi_claim --device cpu --reduced --fast
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
from repro_torch.core.analyzer import check_multi_claim_attribution, validate_event_sequence
from repro_torch.core.claims import ClaimMode, ClaimState
from repro_torch.serving.scheduler_loop import _round_up

CEILING_KW = dict(block_size=4, device_blocks=64, cache_len=32)  # budget: 256 KV token slots


def run(model: Model, out_dir: Path = RESULTS_DIR) -> Dict[str, Any]:
    """Path C three times; returns the summary ("n/3" strings)."""
    reps = []
    for rep in range(3):
        with model.engine() as eng:
            tp, op = tuple(range(100, 116)), tuple(range(200, 216))
            target = eng.accept_claim(tp, ClaimMode.OFFLOADABLE)
            other = eng.accept_claim(op, ClaimMode.OFFLOADABLE)
            for pfx in (tp, op):
                eng.run(eng.submit(pfx + (5, 6), max_new_tokens=1))
            eng.offload_claim(target.claim_id)
            eng.offload_claim(other.claim_id)
            eng.connector.injection.resident_claim_load_failure = True
            eng.connector.injection.fail_claim_id = target.claim_id
            r_other = eng.submit(op + (7, 8), max_new_tokens=1)
            eng.run(r_other)
            r_target = eng.submit(tp + (7, 8), max_new_tokens=1)
            eng.run(r_target)
            v = check_multi_claim_attribution(eng.events, target.claim_id, other.claim_id)
            reps.append({
                "rep": rep,
                "target_only_attribution": v.passed,
                "non_target_restored": other.state == ClaimState.RESTORED,
                "target_refused": r_target.status == "refused",
                "sequence_valid": validate_event_sequence(eng.events).passed,
                "event_bytes": len(eng.events.to_json()),
            })
    summary = {
        "target_only_attribution": f"{sum(r['target_only_attribution'] for r in reps)}/3",
        "non_target_restored": f"{sum(r['non_target_restored'] for r in reps)}/3",
        "non_target_failure_attributions": "0/3",
    }
    out = Path(out_dir) / "vllm-multi-claim-attribution-control.json"
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps({"summary": summary, "model": model.describe(),
                               "repetitions": reps}, indent=1))
    return summary


def run_serving(model: Model, out_dir: Path = RESULTS_DIR, *, batch: int = 8,
                new_tokens: int = 16, prompt_len: int = 12, reps: int = 3) -> Dict[str, Any]:
    """Batched against sequential decode on the same workload: the best
    of ``reps`` host walls of each (every step ends in a device sync)."""
    prompts = [tuple(range(1000 + 32 * i, 1000 + 32 * i + prompt_len)) for i in range(batch)]
    with model.engine(device_blocks=max(256, 4 * batch * (prompt_len + new_tokens))) as eng:
        # warm-up: the batch-wide and the one-row launch shapes once
        eng.run_batch([eng.submit(p, max_new_tokens=2) for p in prompts])
        eng.run(eng.submit(tuple(range(5000, 5000 + prompt_len)), max_new_tokens=2))

        def measure(fn):
            best = float("inf")
            for _ in range(reps):
                t0 = time.perf_counter()
                fn()
                best = min(best, time.perf_counter() - t0)
            return best

        t_seq = measure(lambda: [eng.run(eng.submit(p, max_new_tokens=new_tokens))
                                 for p in prompts])
        t_bat = measure(lambda: eng.run_batch([eng.submit(p, max_new_tokens=new_tokens)
                                               for p in prompts]))
        decode_mode = eng.decode_mode
    total = batch * new_tokens

    def side(t):
        return {"wall_s": round(t, 4), "tok_per_s": round(total / t, 1),
                "ms_per_token": round(1e3 * t / total, 3)}

    result = {
        "workload": {"model": model.cfg.name, "decode_mode": decode_mode, "batch": batch,
                     "prompt_len": prompt_len, "new_tokens": new_tokens, "reps": reps},
        "sequential": side(t_seq),
        "batched": side(t_bat),
        "speedup": round(t_seq / t_bat, 2),
        "meets_2x_criterion": t_seq / t_bat >= 2.0,
        "card": model.describe()["card"],
    }
    merge_json(Path(out_dir) / SERVING_JSON, "serving", result)
    return result


def _parity(a: np.ndarray, b: np.ndarray) -> bool:
    return bool(np.allclose(a, b, atol=3e-2, rtol=3e-2) and a.argmax() == b.argmax())


def _logits(model: Model, tokens, **kw) -> np.ndarray:
    with model.engine(**{**CEILING_KW, **kw}) as eng:
        return eng.prefill_logits(tokens)


def run_ceiling(model: Model, out_dir: Path = RESULTS_DIR) -> Dict[str, Any]:
    """Max batch x context under one device-KV budget: paged against dense.

    Budget = device_blocks x block_size KV token slots.  The dense ceiling
    is structural: budget // cache_len private caches, context capped at
    cache_len - new_tokens.  The paged cell shares a common prefix across
    the batch (pages held once) and spends the budget only on unique pages
    and per-request tails; it is run end to end."""
    bs, N, cache_len = (CEILING_KW[k] for k in ("block_size", "device_blocks", "cache_len"))
    new = 4
    budget = N * bs

    B_dense = budget // cache_len
    ctx_dense = cache_len - new
    shared_d = tuple(range(10, 10 + ctx_dense - bs))
    with model.engine(**CEILING_KW, decode_mode="dense") as eng_d:
        reqs = [eng_d.submit(shared_d + (100 + i,) * bs, max_new_tokens=new)
                for i in range(B_dense)]
        eng_d.run_batch(reqs)
        dense_ok = all(r.status == "finished" for r in reqs)

    B_paged = 2 * B_dense
    tail_cap = _round_up(new, 8)
    prefix_blocks = (budget - B_paged * (bs + tail_cap)) // bs
    ctx_paged = prefix_blocks * bs + bs  # shared prefix + a distinct suffix block
    shared_p = tuple(range(10, 10 + prefix_blocks * bs))
    with model.engine(**CEILING_KW, decode_mode="paged") as eng_p:
        reqs_p = [eng_p.submit(shared_p + (100 + i,) * bs, max_new_tokens=new)
                  for i in range(B_paged)]
        eng_p.run_batch(reqs_p)
        paged_ok = all(r.status == "finished" for r in reqs_p)
        pages_used = eng_p.pool.used

    common = tuple(range(400, 400 + min(ctx_dense, 24)))
    lg = {mode: _logits(model, common, decode_mode=mode) for mode in ("dense", "paged")}
    parity = _parity(lg["paged"], lg["dense"])
    ceiling_dense, ceiling_paged = B_dense * ctx_dense, B_paged * ctx_paged
    result = {
        "model": model.cfg.name,
        "budget_kv_token_slots": budget,
        "dense": {"batch": B_dense, "context": ctx_dense, "batch_x_context": ceiling_dense,
                  "all_finished": dense_ok,
                  "limit": "private cache per request: context <= cache_len, B <= budget/cache_len"},
        "paged": {"batch": B_paged, "context": ctx_paged, "batch_x_context": ceiling_paged,
                  "all_finished": paged_ok, "pool_pages_used": pages_used,
                  "limit": "unique pages + per-request tail; shared prefix held once"},
        "ceiling_ratio": round(ceiling_paged / ceiling_dense, 2),
        "logits_parity": parity,
        "logits_max_abs_diff": float(np.abs(lg["paged"] - lg["dense"]).max()),
        "meets_2x_criterion": bool(paged_ok and dense_ok and parity
                                   and ceiling_paged >= 2 * ceiling_dense),
        "card": model.describe()["card"],
    }
    merge_json(Path(out_dir) / SERVING_JSON, "paged_ceiling", result)
    return result


def run_prefill_ceiling(model: Model, out_dir: Path = RESULTS_DIR) -> Dict[str, Any]:
    """Max admissible prompt under one device-KV budget: chunked against
    dense (the reference's budget convention: block_size 4, 64 pool pages,
    cache_len 32, 256 KV token slots).

    - dense prefill writes into a fixed [cache_len] cache: the admissible
      prompt is cache_len - new_tokens whatever the pool holds, and a longer
      prompt is refused fail-closed (``dense_cache_overflow``); both sides
      of the boundary are run;
    - the monolithic paged prefill's S-token collect buffer beside S page
      slots gives budget // 2 (structural);
    - chunked prefill (prefill_chunk=C) peaks at S page slots + one C-token
      chunk: the admissible prompt is budget - C.  It is run end to end,
      the pool's occupancy sampled at every block insertion, and its logits
      held against the monolithic prefill's on the same prompt."""
    bs, N = CEILING_KW["block_size"], CEILING_KW["device_blocks"]
    cache_len, new, chunk = CEILING_KW["cache_len"], 4, 32
    budget = N * bs

    ctx_dense = cache_len - new
    with model.engine(**CEILING_KW, decode_mode="dense") as eng_d:
        r_ok = eng_d.submit(tuple(range(10, 10 + ctx_dense)), max_new_tokens=new)
        eng_d.run(r_ok)
        r_over = eng_d.submit(tuple(range(10, 10 + ctx_dense + bs)), max_new_tokens=new)
        eng_d.run(r_over)
    dense_ok = r_ok.status == "finished" and r_over.status == "refused"

    ctx_chunked = budget - chunk  # page slots + one chunk buffer == budget
    prompt = tuple(range(0, ctx_chunked))
    with model.engine(**CEILING_KW, prefill_chunk=chunk) as eng_c:
        # the MEASURED peak: pool occupancy at every block insertion, the
        # chunk buffer charged while the prefill is in flight (no output yet)
        peak = {"tokens": 0}
        box: Dict[str, Any] = {"req": None}
        orig_add = eng_c.pool.add_block

        def tracking_add_block(*a, **kw):
            blk = orig_add(*a, **kw)
            req = box["req"]
            live_chunk = chunk if req is None or not req.output_tokens else 0
            peak["tokens"] = max(peak["tokens"], eng_c.pool.used * bs + live_chunk)
            return blk

        eng_c.pool.add_block = tracking_add_block
        r_c = eng_c.submit(prompt, max_new_tokens=new)
        box["req"] = r_c
        eng_c.run(r_c)
        peak_tokens = max(peak["tokens"], eng_c.pool.used * bs)
        chunked_ok = r_c.status == "finished" and peak_tokens <= budget and eng_c.pool.used <= N

    lg_full = _logits(model, prompt, prefill_chunk=0)
    lg_chunk = _logits(model, prompt, prefill_chunk=chunk)
    parity = _parity(lg_chunk, lg_full)
    result = {
        "model": model.cfg.name,
        "budget_kv_token_slots": budget,
        "dense": {"max_prompt": ctx_dense, "at_ceiling_finished": r_ok.status == "finished",
                  "beyond_ceiling_refused": r_over.status == "refused",
                  "limit": "prompt + new_tokens <= cache_len (fixed cache shape; "
                           "fail-closed refusal beyond)"},
        "o_s_buffer_ceiling": {"max_prompt": budget // 2,
                               "limit": "monolithic paged prefill: S collect buffer + S page "
                                        "slots <= budget (structural)"},
        "chunked": {"max_prompt": ctx_chunked, "chunk": chunk, "peak_kv_tokens": peak_tokens,
                    "all_finished": chunked_ok,
                    "limit": "page slots + one chunk buffer <= budget; prompt bounded by pool "
                             "pages"},
        "ceiling_ratio": round(ctx_chunked / ctx_dense, 2),
        "logits_parity": parity,
        "logits_max_abs_diff": float(np.abs(lg_chunk - lg_full).max()),
        "meets_2x_criterion": bool(dense_ok and chunked_ok and parity
                                   and ctx_chunked >= 2 * ctx_dense),
        "card": model.describe()["card"],
    }
    merge_json(Path(out_dir) / SERVING_JSON, "prefill_ceiling", result)
    return result


def main(argv: Optional[List[str]] = None) -> None:
    args = parse(parser(__doc__), argv)
    model = model_from(args)
    print(json.dumps(run(model, args.out_dir), indent=1))
    serving = run_serving(model, args.out_dir, batch=4 if args.fast else 8,
                          new_tokens=8 if args.fast else 16, reps=1 if args.fast else 3)
    print(json.dumps(serving, indent=1))
    ceiling = run_ceiling(model, args.out_dir)
    print(json.dumps(ceiling, indent=1))
    prefill_ceiling = run_prefill_ceiling(model, args.out_dir)
    print(json.dumps(prefill_ceiling, indent=1))
    check(serving, ceiling, prefill_ceiling)


def check(serving: Dict[str, Any], ceiling: Dict[str, Any],
          prefill_ceiling: Dict[str, Any]) -> None:
    """Exit 1 unless the speedup and both ceilings meet their 2x criteria."""
    if not (serving["meets_2x_criterion"] and ceiling["meets_2x_criterion"]
            and prefill_ceiling["meets_2x_criterion"]):
        gate_failed("MULTI-CLAIM", f"speedup {serving['speedup']} (>= 2.0), paged ceiling "
                                   f"{ceiling['meets_2x_criterion']}, prefill ceiling "
                                   f"{prefill_ceiling['meets_2x_criterion']}")


if __name__ == "__main__":
    main()

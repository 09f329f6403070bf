"""Serving with the full ResidentClaim mode family on the PyTorch/CUDA
port: fail-closed restoration failure (witness path B), multi-claim
attribution (path C), hard protection, soft priority under pressure and
claim-attributed routing (the port's counterpart of
examples/serve_resident_claims.py).  Full-width qwen3-1.7b (weights from
seed 0) on the card by default.

  PYTHONPATH=src python examples/torch_serve_resident_claims.py          # card
  PYTHONPATH=src python examples/torch_serve_resident_claims.py --device cpu --reduced
"""
import argparse

from repro_torch.bench.common import Model
from repro_torch.core.analyzer import check_failure_outcome_path, check_multi_claim_attribution
from repro_torch.core.claims import ClaimMode, ClaimState
from repro_torch.serving.router import KVAwareRouter


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    ap.add_argument("--reduced", action="store_true", help="reduced qwen3-1.7b (CPU size)")
    args = ap.parse_args(argv)

    model = Model(args.device, reduced=args.reduced)
    print(f"model {model.cfg.name}: {model.cfg.num_layers} layers on {model.device}\n")
    prefix = tuple(range(10, 26))
    gates = []

    # --- path B: controlled same-claim restoration failure -> fail-closed ---
    print("== witness path B: fail-closed restoration failure ==")
    with model.engine() as eng:
        claim = eng.accept_claim(prefix, ClaimMode.OFFLOADABLE)
        eng.run(eng.submit(prefix + (30, 31), max_new_tokens=1))
        eng.offload_claim(claim.claim_id)
        eng.connector.injection.resident_claim_load_failure = True
        eng.connector.injection.fail_claim_id = claim.claim_id
        r = eng.submit(prefix + (40, 41), max_new_tokens=4)
        eng.run(r)
        v = check_failure_outcome_path(eng.events, claim.claim_id, r.request_id)
        gates.append(v.passed)
        print(f"request: {r.status} (no output served: {r.output_tokens == []})")
        print(f"claim:   {claim.state.value}")
        print(f"gate:    {v.passed} — {v.reasons[0]}")
        e13 = eng.events.named("scheduler_active_request_refused")[0]
        print(f"refusal: blocking_claim_ids={e13.payload['blocking_claim_ids']}\n")

    # --- path C: multi-claim attribution ---
    print("== witness path C: target-only attribution ==")
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
        eng.run(eng.submit(op + (7, 8), max_new_tokens=1))
        eng.run(eng.submit(tp + (7, 8), max_new_tokens=1))
        v = check_multi_claim_attribution(eng.events, target.claim_id, other.claim_id)
        gates.append(v.passed)
        print(f"target={target.state.value}, other={other.state.value}, gate={v.passed}\n")

    # --- hard protection: explicit active/resident conflict action ---
    print("== hard_protected: victim exclusion + refusal with blocking ids ==")
    with model.engine(device_blocks=8) as eng:
        hard = eng.accept_claim(prefix, ClaimMode.HARD_PROTECTED)
        eng.run(eng.submit(prefix, max_new_tokens=1))
        big = eng.submit(tuple(range(500, 532)), max_new_tokens=4)
        eng.run(big)
        refusal = eng.events.named("scheduler_admission_refused")[0]
        intact = hard.state == ClaimState.MATERIALIZED
        gates.append(big.status == "refused" and intact)
        print(f"big request: {big.status}; blocking={refusal.payload['blocking_claim_ids']}; "
              f"protected claim intact: {intact}\n")

    # --- soft priority under controlled pressure ---
    print("== soft_priority: eviction order follows priority ==")
    with model.engine() as eng:
        eng.accept_claim(tuple(range(600, 616)), ClaimMode.SOFT_PRIORITY, priority=5)
        lo = eng.accept_claim(tuple(range(700, 716)), ClaimMode.SOFT_PRIORITY, priority=1)
        for pfx in (tuple(range(600, 616)), tuple(range(700, 716))):
            eng.run(eng.submit(pfx, max_new_tokens=1))
        eng.scheduler.apply_pressure(2)
        first = [e.claim_id for e in eng.events.named("pressure_eviction")[:2]]
        print(f"first losses: {first} (low-priority claim: {lo.claim_id})\n")

    # --- routing with claim attribution ---
    print("== routed_reuse: claim-attributed KV-aware routing ==")
    engines = [model.engine(namespace=f"w{i}") for i in range(2)]
    try:
        router = KVAwareRouter(engines)
        rc = router.accept_claim(prefix)
        _, rec1 = router.submit_and_run(prefix + (30, 31))
        _, rec2 = router.submit_and_run(prefix + (40, 41))
        reuse = router.events.named("route_reuse_attributed")[-1]
        print(f"claim {rc.claim_id}: placed on worker {rec1.worker}; "
              f"reuse routed to worker {rec2.worker} with hit={reuse.payload['reuse_hit_tokens']} "
              "tokens")
    finally:
        for eng in engines:
            eng.close()
    if not all(gates):
        raise SystemExit(1)


if __name__ == "__main__":
    main()

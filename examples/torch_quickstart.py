"""Quickstart of the PyTorch/CUDA port: accept a ResidentClaim, serve,
offload, restore — witness path A end to end (the port's counterpart of
examples/quickstart.py).  Full-width qwen3-1.7b (weights from seed 0) on
the card by default.

  PYTHONPATH=src python examples/torch_quickstart.py                     # card
  PYTHONPATH=src python examples/torch_quickstart.py --device cpu --reduced
"""
import argparse

from repro_torch.bench.common import Model
from repro_torch.core.analyzer import check_observation_path, validate_event_sequence
from repro_torch.core.claims import ClaimMode


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    ap.add_argument("--reduced", action="store_true", help="reduced qwen3-1.7b (CPU size)")
    args = ap.parse_args(argv)

    model = Model(args.device, reduced=args.reduced)
    print(f"model {model.cfg.name}: {model.cfg.num_layers} layers on {model.device}")
    with model.engine() as engine:  # block_size 4, 64 device blocks, cache_len 64
        # 1. accept a future-reuse responsibility over a 16-token prefix
        prefix = tuple(range(10, 26))
        claim = engine.accept_claim(prefix, ClaimMode.OFFLOADABLE)
        print(f"accepted {claim.claim_id}: predicate={claim.predicate.name}")

        # 2. the first request materializes the claim
        r1 = engine.submit(prefix + (30, 31), max_new_tokens=4)
        engine.run(r1)
        print(f"{r1.request_id}: {r1.status}, output={r1.output_tokens}, claim={claim.state.value}")

        # 3. offload the claimed KV to the host
        engine.offload_claim(claim.claim_id, request_id=r1.request_id)
        print(f"offloaded: {claim.state.value}; host blocks={len(engine.host.blocks)}")

        # 4. reuse: restoration is required (and happens) before the prefix serves
        r2 = engine.submit(prefix + (40, 41), max_new_tokens=4)
        engine.run(r2)
        print(f"{r2.request_id}: {r2.status}, restored_tokens={r2.restored_tokens}, "
              f"claim={claim.state.value}")

        # 5. the analyzer verifies the ordered witness path from the event log
        assert validate_event_sequence(engine.events).passed
        verdict = check_observation_path(engine.events, claim.claim_id, r2.request_id)
        print(f"witness path A: passed={verdict.passed} ({verdict.reasons[0]})")

        print("\nevent log (claim-scoped):")
        for e in engine.events.for_claim(claim.claim_id):
            print(f"  [{e.seq:3d}] {e.name}")
    if not verdict.passed:
        raise SystemExit(1)


if __name__ == "__main__":
    main()

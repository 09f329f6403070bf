"""The norms end to end on one NVIDIA GPU, through whatever route a
checkout's ``repro_torch`` gives ``layers.rms_norm`` / ``layers.layer_norm``:
run it twice in one call, once with ``--src`` naming another checkout's
``src/``, to compare two routes.

    python3 scripts/torch_norm_ab.py [--src DIR] [--out F]

The shapes, weights, serving traffic and timers are this checkout's
``chip_smoke.py``'s whichever package is measured (``--src``: the
``repro_torch`` under DIR; by default this checkout's).  Prints, beside the
card's name and power limit:

* the norm at ``chip_smoke.NORM_SHAPES`` (bf16, the RMS norm, and the layer
  norm at qwen3-1.7b's chunk) under ``torch.no_grad``: device ms per call
  (``chip_smoke.time_ms``) and device kernels per call (the profiler's
  CUDA activity);
* full-width qwen3-1.7b from seed 0 serving the smoke's phase-3 traffic
  (``chip_smoke.serving_phase``: its wall and decode-launch seconds);
* the monolithic 32,768-token prefill (``bundle.prefill_fn`` at B = 1),
  seconds of each of two runs, the first one warm from the serving above.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402  (puts src/ on the path)

LONG_S = 32_768


def kernels_per_call(fn, args, iters=5):
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn(*args)
        torch.cuda.synchronize()
    return sum(e.count for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA) / iters


def norm_rows(g):
    from repro_torch.models import layers

    dev = torch.device("cuda")
    rows = {}
    for sname, (R, d) in cs.NORM_SHAPES.items():
        w, b = cs.norm_weights(d, g, dev)
        n = max(2, -(-120_000_000 // (2 * R * d)))
        copies = [(torch.randn((R, d), generator=g, device=dev).bfloat16(),) for _ in range(n)]
        for kind in (("rms", "layer") if sname == "chunk ln" else ("rms",)):
            fn = ((lambda t: layers.rms_norm(t, w)) if kind == "rms"
                  else (lambda t: layers.layer_norm(t, w, b)))
            with torch.no_grad():
                ms = cs.time_ms(fn, copies)
                k = kernels_per_call(fn, copies[0])
            label = f"{kind} {sname} {R} x {d}"
            rows[label] = {"ms": ms, "device_kernels_per_call": k}
            print(f"norm {label}: {ms:.4f} ms, {k:.0f} device kernels a call")
        del copies
    return rows


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--src", default=None,
                    help="measure the repro_torch under this directory (another checkout's src/)")
    ap.add_argument("--out", default=None, help="write the summary as JSON here too")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_norm_ab: no CUDA device", file=sys.stderr)
        raise SystemExit(2)
    src = Path(args.src).resolve() if args.src else ROOT / "src"
    sys.path.insert(0, str(src))
    import repro_torch

    if Path(repro_torch.__file__).resolve().parents[1] != src:
        raise SystemExit(f"torch_norm_ab: repro_torch came from {repro_torch.__file__}, not {src}")
    from repro_torch.configs import get_config
    from repro_torch.models.registry import build_model

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    out = {"card": smi.stdout.strip(), "src": str(src)}
    print(out["card"])
    out["norm"] = norm_rows(torch.Generator(device="cuda").manual_seed(0))
    cfg = get_config("qwen3-1.7b")
    bundle = build_model(cfg)
    params = bundle.init_params(torch.Generator().manual_seed(0))
    torch.cuda.synchronize()
    t = time.monotonic()
    cs.serving_phase(bundle, params, cfg, cs.qwen3_traffic, 192)
    torch.cuda.synchronize()
    out["serving_phase_s"] = time.monotonic() - t
    tokens = torch.randint(0, cfg.vocab_size, (1, LONG_S), generator=torch.Generator().manual_seed(1),
                           dtype=torch.int32).to(bundle.device)
    out["monolithic_prefill_s"] = []
    for _ in range(2):
        torch.cuda.synchronize()
        t = time.monotonic()
        logits, cache = bundle.prefill_fn(params, {"tokens": tokens}, LONG_S)
        torch.cuda.synchronize()
        out["monolithic_prefill_s"].append(time.monotonic() - t)
        cs.check(bool(torch.isfinite(logits.float()).all()), "non-finite prefill logits")
        del logits, cache
    print(f"monolithic prefill B = 1 x S = {LONG_S}: "
          + ", ".join(f"{s:.3f} s" for s in out["monolithic_prefill_s"]))
    print("norm a/b " + json.dumps(out))
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(out, indent=1))


if __name__ == "__main__":
    main()

"""The recurrent families' walls on one NVIDIA GPU, through whatever route a
checkout's ``repro_torch`` gives their f32 contractions: run it twice in
one call, once with ``--src`` naming another checkout's ``src/``, to
compare two routes (parent, change, change, parent).

    python3 scripts/torch_contract_ab.py [--src DIR] [--out F]

xlstm-350m and hymba-1.5b at full width and depth, weights from seed 0,
seeded tokens, each model freed before the next.  Prints, beside the
card's name and power limit: a B = 1 ``prefill_fn`` over ``B1_TOKENS``
tokens (the per-token loop a snapshot materialization runs), twice; a
``ROWS``-row prefill over ``ROWS_TOKENS`` tokens (prefill_32k's width);
and ``DECODE_STEPS`` decode steps at decode_32k's 128 rows tiled from a
2-row prefill, each step's wall.  Every wall ends in
``torch.cuda.synchronize()``.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
B1_TOKENS = {"xlstm-350m": 512, "hymba-1.5b": 1024}
ROWS, ROWS_TOKENS = {"xlstm-350m": 32, "hymba-1.5b": 4}, 256
DECODE_ROWS, DECODE_STEPS = 128, 4


def _wall(fn):
    torch.cuda.synchronize()
    t = time.monotonic()
    out = fn()
    torch.cuda.synchronize()
    return time.monotonic() - t, out


def one_arch(name):
    from repro_torch.configs import get_config
    from repro_torch.models.registry import build_model

    cfg = get_config(name)
    bundle = build_model(cfg)
    params = bundle.init_params(torch.Generator().manual_seed(0))
    rng = np.random.default_rng(7)
    toks = lambda r, s: torch.from_numpy(
        rng.integers(0, cfg.vocab_size, (r, s)).astype(np.int32)).cuda()
    cache_len = cfg.sliding_window or 1
    rec = {}
    with torch.no_grad():
        t1 = toks(1, B1_TOKENS[name])
        rec["b1_prefill_s"] = [_wall(lambda: bundle.prefill_fn(params, {"tokens": t1},
                                                               cache_len))[0] for _ in range(2)]
        tr = toks(ROWS[name], ROWS_TOKENS)
        rec["rows_prefill_s"], _ = _wall(lambda: bundle.prefill_fn(params, {"tokens": tr},
                                                                   cache_len))
        _, (_, st) = _wall(lambda: bundle.prefill_fn(params, {"tokens": toks(2, ROWS_TOKENS)},
                                                     cache_len))
        from repro_torch.bench import long_recurrent as lr

        state = lr.take_rows(bundle, st, [r % 2 for r in range(DECODE_ROWS)])
        tok = toks(1, DECODE_ROWS)[0]
        pos = torch.full((DECODE_ROWS,), ROWS_TOKENS, dtype=torch.int32, device=tok.device)
        rec["decode_step_ms"] = []
        for _ in range(DECODE_STEPS):
            s, (lg, state) = _wall(lambda: bundle.decode_fn(params, state, tok, pos))
            rec["decode_step_ms"].append(1e3 * s)
            tok, pos = lg.argmax(-1).to(torch.int32), pos + 1
    rec["b1_prefill_ms_a_token"] = [1e3 * s / B1_TOKENS[name] for s in rec["b1_prefill_s"]]
    print(f"{name}: B = 1 prefill of {B1_TOKENS[name]} tokens "
          f"{[round(s, 3) for s in rec['b1_prefill_s']]} s "
          f"({[round(m, 3) for m in rec['b1_prefill_ms_a_token']]} ms a token); "
          f"{ROWS[name]} x {ROWS_TOKENS} prefill {rec['rows_prefill_s']:.3f} s; decode at "
          f"{DECODE_ROWS} rows {[round(m, 2) for m in rec['decode_step_ms']]} ms", flush=True)
    del bundle, params, state, st
    torch.cuda.empty_cache()
    return rec


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--src", default=None,
                    help="measure the repro_torch under this directory (another checkout's src/)")
    ap.add_argument("--out", default=None, help="write the summary as JSON here too")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_contract_ab: no CUDA device", file=sys.stderr)
        raise SystemExit(2)
    src = Path(args.src).resolve() if args.src else ROOT / "src"
    sys.path.insert(0, str(src))
    import repro_torch

    if Path(repro_torch.__file__).resolve().parents[1] != src:
        raise SystemExit(f"torch_contract_ab: repro_torch came from {repro_torch.__file__}, "
                         f"not {src}")
    from repro_torch.kernels import build

    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    out = {"card": smi.stdout.strip(), "src": str(src), "build_s": build.build_all()}
    print(out["card"], flush=True)
    for name in ("xlstm-350m", "hymba-1.5b"):
        out[name] = one_arch(name)
    print("contract a/b " + json.dumps(out))
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(out, indent=1))


if __name__ == "__main__":
    main()

"""Whether recurrent rows keep their bits across batch widths on the card:
xlstm-350m and hymba-1.5b at full width and depth (weights from seed 0),
``bench.long_recurrent.first_row_variant_op`` between a B = 1 call and one
of R copies of that row, R = 1, 2, 8, 32 and 128, for a decode step (after
a 256-token prefill) and for a prefill (``--tokens`` tokens).

    python3 scripts/torch_row_variance.py                       # card, ~10 min
    PYTHONPATH=src python3 scripts/torch_row_variance.py --device cpu --reduced --tokens 8

Prints, for each (arch, call, R), the first floating op whose row 0
differs with the model frames that issued it, or none; writes
``<out>/row_variance.json`` with the card's name and power limit, and
exits 1 if any op was named.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro_torch.bench import long_recurrent as lr  # noqa: E402
from repro_torch.configs import get_config, reduced  # noqa: E402
from repro_torch.models.registry import build_model  # noqa: E402

ARCHS = ("xlstm-350m", "hymba-1.5b")
WIDTHS = (1, 2, 8, 32, 128)
PROMPT = 256  # the decode trace's prefill, and its position


def card() -> str:
    if not torch.cuda.is_available():
        return "cpu"
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    return smi.stdout.strip().splitlines()[0] if smi.stdout.strip() else "unknown"


def sweep(arch: str, args) -> list:
    cfg = get_config(arch)
    cfg = reduced(cfg) if args.reduced else cfg
    bundle = build_model(cfg, device=args.device)
    params = bundle.init_params(torch.Generator().manual_seed(0))
    run = lr.Run(bundle, params, cfg, PROMPT, log=lambda _: None)
    rng = np.random.default_rng(lr.SEED)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (1, PROMPT)).astype(np.int32))
    toks = toks.to(bundle.device)
    run.prefix = tuple(int(t) for t in toks[0].tolist())
    _, state = bundle.prefill_fn(params, {"tokens": toks}, cfg.sliding_window or 1)
    tok = toks[:, -1]
    out = []
    for rows in WIDTHS:
        for call, trace in (("decode", lambda: lr.trace_decode(run, state, tok, rows=rows)),
                            ("prefill", lambda: lr.trace_prefill(run, rows=rows,
                                                                 tokens=args.tokens))):
            t0 = time.monotonic()
            rec = dict(trace(), arch=arch, call=call, rows=rows, seconds=time.monotonic() - t0)
            print(f"{arch} {call} at {rows} rows: first row-variant op {rec['op']} "
                  f"(of {rec['of']} ops) {rec['frames']} ({rec['seconds']:.1f} s)", flush=True)
            out.append(rec)
    del bundle, params, state
    if torch.cuda.is_available():
        torch.cuda.empty_cache()
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", action="append", choices=ARCHS, help="default: both")
    ap.add_argument("--tokens", type=int, default=64, help="the prefill trace's tokens")
    ap.add_argument("--device", default=None, help="cpu rehearses (default: the card)")
    ap.add_argument("--reduced", action="store_true", help="the reduced configs (CPU rehearsal)")
    ap.add_argument("--out", default="chiprun_out/row_variance")
    args = ap.parse_args(argv)
    torch.backends.cuda.matmul.allow_tf32 = False
    rec = {"card": card(), "torch": torch.__version__, "traces": []}
    print(rec["card"], flush=True)
    with torch.no_grad():
        for arch in args.arch or ARCHS:
            rec["traces"] += sweep(arch, args)
    named = [r for r in rec["traces"] if r["op"] is not None]
    rec["ok"] = not named
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    (out / "row_variance.json").write_text(json.dumps(rec, indent=1, default=str))
    print(f"{len(rec['traces'])} traces, {len(named)} naming an op; wrote "
          f"{out / 'row_variance.json'}")
    return 0 if rec["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())

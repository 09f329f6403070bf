"""The recurrent families' long cells on one card: xlstm-350m or hymba-1.5b
at full width and depth (weights from seed 0), ``prefill_32k``'s 32,768
tokens, ``decode_32k``'s 128 rows and ``long_500k``'s position, with a
snapshot claim over the 32,768-token prefix offloaded, restored and
refused (``repro_torch.bench.long_recurrent``: cells (a)-(d)).

    python3 scripts/torch_long_recurrent.py --arch hymba-1.5b          # card, ~6 min
    python3 scripts/torch_long_recurrent.py --arch xlstm-350m          # card, ~16 min
    PYTHONPATH=src python3 scripts/torch_long_recurrent.py --arch hymba-1.5b --device cpu \\
        --reduced --len 64 --rows 2 --decode-rows 8 --out /tmp/lr    # CPU rehearsal

The ``long_500k`` cell runs through ``build_cell`` on a one-rank mesh
(NCCL on the card, gloo on the CPU).  The kernels of these cells are held
against their plain versions and timed at this length in ``chip_smoke.py``'s
phase 2 (K5 at hymba's 32,768-query windowed prefill, K3 on each snapshot
page).  Writes ``<out>/<arch>.json`` (every check, cut, number and launch
count, the card's name and power limit) and exits 1 at the first failed
check, after writing it.
"""
from __future__ import annotations

import argparse
import json
import os
import socket
import subprocess
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))
# hymba's (a) allocates its 25 GiB SSM coefficients one after another; a
# segment per block leaves the freed ones too fragmented to take the next
os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF", "expandable_segments:True")

import torch  # noqa: E402

from repro_torch.bench import long_recurrent as lr  # noqa: E402
from repro_torch.configs import get_config, reduced  # noqa: E402
from repro_torch.models.registry import build_model  # noqa: E402
from repro_torch.serving.snapshot_engine import _flatten  # noqa: E402


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def card() -> str:
    if not torch.cuda.is_available():
        return "cpu"
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    return smi.stdout.strip().splitlines()[0] if smi.stdout.strip() else "unknown"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", required=True, choices=["xlstm-350m", "hymba-1.5b"])
    ap.add_argument("--len", type=int, default=lr.SEQ_LEN, help="prompt tokens (default 32768)")
    ap.add_argument("--rows", type=int, default=None,
                    help="(a)'s rows (default: prefill_32k's 32, cut to what the card holds)")
    ap.add_argument("--decode-rows", type=int, default=lr.DECODE_ROWS)
    ap.add_argument("--device", default=None, help="cpu rehearses (default: the card)")
    ap.add_argument("--reduced", action="store_true", help="the reduced config (CPU rehearsal)")
    ap.add_argument("--out", default="chiprun_out/long_recurrent")
    args = ap.parse_args(argv)

    import torch.distributed as dist

    from repro_torch.launch.mesh import init_group, make_debug_mesh

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = get_config(args.arch)
    cfg = reduced(cfg) if args.reduced else cfg
    bundle = build_model(cfg, device=args.device)
    dev = bundle.device
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    rec = {"card": card(), "torch": torch.__version__, "device": str(dev)}
    print(rec["card"], flush=True)
    t0 = time.monotonic()
    if dev.type == "cuda":
        from repro_torch.kernels import build

        secs = build.build_all()
        rec["build_s"] = time.monotonic() - t0
        print(f"built kernels in {rec['build_s']:.1f} s: {secs}", flush=True)
    params = bundle.init_params(torch.Generator().manual_seed(0))
    n = sum(t.numel() for _, t in _flatten(params))
    print(f"{cfg.name}: {n / 1e9:.3f} B params, {cfg.num_layers} layers on {dev}", flush=True)
    init_group("nccl" if dev.type == "cuda" else "gloo", rank=0, world_size=1, port=_free_port())
    ok = False
    try:
        mesh = make_debug_mesh(1, 1, device=dev)
        rec["cells"] = {}
        lr.run_cells(bundle, params, cfg, args.len, rows=args.rows, decode_rows_=args.decode_rows,
                     mesh=mesh, why="the command line", record=rec["cells"])
        if rec["cells"]["claim"]["payload_bytes"] != lr.snapshot_bytes(bundle):
            raise lr.CellFailed("the claim's snapshot is not the size its state's shapes give")
        ok = True
    except lr.CellFailed as e:
        print(f"FAIL: {e}", flush=True)
        rec["failed"] = str(e)
    finally:
        dist.destroy_process_group()
        rec["wall_s"] = time.monotonic() - t0
        rec["ok"] = ok
        path = out / f"{args.arch}.json"
        path.write_text(json.dumps(rec, indent=1, default=str))
        print(f"wrote {path} (ok {ok}, {rec['wall_s']:.1f} s)", flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())

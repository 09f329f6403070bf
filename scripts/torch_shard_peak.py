#!/usr/bin/env python3
"""One sharded ``prefill_32k`` cell on a one-rank mesh: the step's peak on
the card against the dry run's prediction of the same cell, and what was
live at the card's peak.

    PYTHONPATH=src python3 scripts/torch_shard_peak.py [--arch h2o-danube-1.8b] [--batch 1]

The cell (``launch.steps.build_cell(arch, "prefill_32k")`` at ``--batch``
x 32,768 tokens, full width and depth, seed-0 weights) runs on a 1 x 1
(data, model) mesh over a one-rank NCCL group, as in smoke phase 18: once
to warm, once under ``torch.cuda.memory._record_memory_history``.  Its peak
is the dry run's quantity: the shards of the arguments plus the most the
step allocated at once beside what was allocated before it.  The
allocator's trace is replayed to that peak, and the largest blocks live
there are printed with the frames that allocated them.  The dry run of the
same cell (``launch.dryrun --mesh 1x1 --global-batch B``) runs in a
subprocess beside the card.  Writes ``<out>/shard_peak_<arch>.json``.
"""
from __future__ import annotations

import argparse
import json
import os
import shutil
import socket
import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _frames(ev) -> list:
    """The event's frames in the port and in DTensor, innermost first."""
    keep = ("repro_torch", "torch/distributed/tensor")
    return [f"{f['filename'].split('site-packages/')[-1].split('src/')[-1]}:{f['line']} "
            f"{f['name']}" for f in ev.get("frames", []) if any(k in f["filename"] for k in keep)]


def peak_blocks(trace, top: int = 8):
    """Replay the allocator's events: (the most bytes allocated at once
    beside what was live before the trace, the ``top`` largest blocks live
    then with their frames)."""
    live, total, best, at_best = {}, 0, 0, {}
    for ev in trace:
        if ev["action"] == "alloc":
            live[ev["addr"]] = ev
            total += ev["size"]
            if total > best:
                best, at_best = total, dict(live)
        elif ev["action"] == "free_completed" and ev["addr"] in live:
            total -= live.pop(ev["addr"])["size"]
    blocks = sorted(at_best.values(), key=lambda e: -e["size"])[:top]
    return best, [{"bytes": e["size"], "frames": _frames(e)[:6]} for e in blocks]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="h2o-danube-1.8b")
    ap.add_argument("--batch", type=int, default=1)
    ap.add_argument("--out", default=str(ROOT / "chiprun_out"))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: the peak is the card's")

    import torch.distributed as dist

    from repro_torch.configs import ShapeSpec
    from repro_torch.launch import steps as st
    from repro_torch.launch.mesh import init_group, make_debug_mesh

    B, S = args.batch, 32_768
    tmp = Path(tempfile.mkdtemp(prefix="shard_peak_"))
    dry = subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", args.arch, "--shape",
         "prefill_32k", "--mesh", "1x1", "--global-batch", str(B), "--out", str(tmp), "--force"],
        stdout=subprocess.DEVNULL, stderr=subprocess.STDOUT,
        env=dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="2"))
    init_group("nccl", rank=0, world_size=1, port=_free_port())
    try:
        mesh = make_debug_mesh(1, 1)
        cell = st.build_cell(args.arch, "prefill_32k", mesh,
                             shape=ShapeSpec("prefill_32k", S, B, "prefill"))
        params = cell.bundle.init_params(torch.Generator().manual_seed(0))
        V = cell.cfg.vocab_size
        tokens = np.random.default_rng(31).integers(0, V, (B, S)).astype(np.int32)
        pd = st.distribute_argument(cell, "params", params)
        bd = st.distribute_argument(cell, "batch", {"tokens": torch.from_numpy(tokens).cuda()})
        del params
        st.run_cell(cell, (pd, bd))  # warm
        torch.cuda.synchronize()
        before = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        torch.cuda.memory._record_memory_history(max_entries=1_000_000, stacks="python")
        out = st.run_cell(cell, (pd, bd))
        torch.cuda.synchronize()
        snap = torch.cuda.memory._snapshot()
        torch.cuda.memory._record_memory_history(enabled=None)
        del out
        args_bytes = st.argument_bytes_per_device((pd, bd))
        card = torch.cuda.max_memory_allocated() - before + args_bytes
        traced, blocks = peak_blocks(snap["device_traces"][torch.cuda.current_device()])
    finally:
        dist.destroy_process_group()
    dry.wait(timeout=1800)
    rec = json.loads((tmp / "1x1" / f"{args.arch}__prefill_32k.json").read_text())
    shutil.rmtree(tmp, ignore_errors=True)
    pred = rec["memory"]["peak_bytes_per_device"]
    res = {"arch": args.arch, "tokens": [B, S], "card": torch.cuda.get_device_name(0),
           "step_peak_bytes": card, "traced_peak_bytes": traced + args_bytes,
           "argument_bytes": args_bytes, "dryrun_peak_bytes": pred,
           "dryrun_live_peak_bytes": rec["memory"]["live_peak_bytes_per_device"],
           "gap": (card - pred) / pred, "largest_live_at_peak": blocks}
    print(f"{args.arch} prefill_32k {B} x {S} on a 1 x 1 mesh: step peak {card / 1e9:.3f} GB "
          f"(traced {res['traced_peak_bytes'] / 1e9:.3f}), dry run {pred / 1e9:.3f} GB, gap "
          f"{res['gap']:+.4f}; arguments {args_bytes / 1e9:.3f} GB")
    for b in blocks:
        print(f"  {b['bytes'] / 1e9:8.3f} GB  " + " < ".join(b["frames"][:4]))
    Path(args.out).mkdir(parents=True, exist_ok=True)
    (Path(args.out) / f"shard_peak_{args.arch}.json").write_text(json.dumps(res, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())

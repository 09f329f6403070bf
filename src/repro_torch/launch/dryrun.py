"""Multi-pod dry run of the port: build every (architecture x input shape)
cell against the production meshes, run its step once on meta tensors in a
256- or 512-rank fake process group, and record the collectives it issues
with the analytic roofline (the JAX package's ``launch/dryrun.py``).

  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen3-1.7b --shape decode_32k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh both [--subprocess]
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen3-1.7b --shape train_4k \
      --mesh 2x2 --global-batch 4    # a small (data x model) mesh, the batch cut

Each cell writes results/torch/dryrun/<mesh>/<arch>__<shape>.json with the
reference's keys where they mean something here: ``status``, ``chips``,
``timing``, ``analytic`` (FLOPs and HBM bytes), ``collectives`` (per kind:
count and result bytes per device, from ``roofline.analysis.
CollectiveCounter``), ``roofline`` (on the H100's data-sheet constants) and
``memory``.  Already-computed cells are skipped unless --force;
--subprocess runs each cell in a fresh interpreter.

What differs from the reference, and why:
  - nothing is compiled: the step runs eagerly once, on DTensors whose
    shards are meta tensors, in a process group of the ``fake`` backend
    (``torch.testing._internal.distributed.fake_pg``), which completes
    every collective without moving data.  Eager torch runs every layer
    and micro-batch, so the collective counts are what the reference's
    loop-aware HLO parser reconstructs;
  - ``memory`` holds the exact per-device bytes of the arguments (each
    DTensor's local shard) and of the outputs, and the reference's
    ``peak_bytes_per_device`` (arguments + outputs + temps): there is no
    compiled buffer assignment to read it from, so the arguments' bytes
    plus the most bytes the step's own tensors held at once
    (``roofline.analysis.LiveBytes``: each storage an op returns counted
    once, from the op until the storage dies).  Eager torch frees a
    temporary when its last reference goes, where XLA's assignment may
    reuse or keep it, so the two peaks need not agree.  The budget is the
    H100's 80 GiB (``fits_80GiB``); the reference's 16 GiB ``fits_16GiB``
    is its TPU's and is not carried over.

``FakeStore`` lives in a private module of torch: ``init_fake_group``
checks that it and ``local_map`` are there and raises, naming the version
this was written against (``requirements.txt``), on a torch without them.
"""
from __future__ import annotations

import argparse
import re
import json
import subprocess
import sys
import time
import traceback
from dataclasses import replace
from pathlib import Path
from typing import Optional

HBM_PER_GPU = 80 * 1024**3  # H100 80GB
WRITTEN_AGAINST = "torch 2.13.0"


def init_fake_group(world_size: int) -> None:
    """The default process group on the ``fake`` backend (rank 0 of
    ``world_size``)."""
    import torch.distributed as dist

    try:
        from torch.distributed.tensor.experimental import local_map  # noqa: F401
        from torch.testing._internal.distributed.fake_pg import FakeStore
    except ImportError as e:
        raise RuntimeError(
            f"the dry run needs torch's FakeStore and local_map (written against "
            f"{WRITTEN_AGAINST}; see requirements.txt): {e}") from e
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=world_size)


def run_cell(arch: str, shape_name: str, mesh_kind: str, out_path: Path,
             moe_strategy: str = "auto", attn_sharding: str = "gather_kv",
             kv_dtype: str = "bf16", global_batch: Optional[int] = None) -> dict:
    """One cell.  ``mesh_kind``: ``single`` (16 x 16), ``multi`` (2 x 16 x
    16) or ``DxM``, a (data, model) debug mesh of D * M fake ranks;
    ``global_batch`` cuts the shape's batch (the four-card runs' cells)."""
    import torch

    from repro_torch.configs import SHAPES_BY_NAME, get_config
    from repro_torch.launch import steps
    from repro_torch.launch.mesh import make_debug_mesh, make_production_mesh
    from repro_torch.models.layers import set_attn_sharding
    from repro_torch.roofline.analysis import (
        CollectiveCounter,
        LiveBytes,
        model_flops_for,
        roofline_report,
    )
    from repro_torch.training.tree import leaves
    from repro_torch.roofline.analytic import cell_flops, cell_hbm_bytes

    set_attn_sharding(attn_sharding)
    t0 = time.monotonic()
    if mesh_kind in ("single", "multi"):
        chips = 512 if mesh_kind == "multi" else 256
        init_fake_group(chips)
        mesh = make_production_mesh(multi_pod=(mesh_kind == "multi"), device="cpu")
    else:
        data, model = (int(n) for n in mesh_kind.split("x"))
        chips = data * model
        init_fake_group(chips)
        mesh = make_debug_mesh(data, model, device="cpu")
    shape = SHAPES_BY_NAME[shape_name]
    if global_batch:
        shape = replace(shape, global_batch=global_batch)
    record = {"arch": arch, "shape": shape_name, "mesh": mesh_kind, "chips": chips,
              "global_batch": shape.global_batch,
              "status": "ok"}
    try:
        cell = steps.build_cell(arch, shape_name, mesh, moe_strategy=moe_strategy,
                                kv_cache_dtype=kv_dtype, shape=shape)
    except steps.CellSkipped as e:
        record.update(status="skipped", reason=str(e))
        out_path.parent.mkdir(parents=True, exist_ok=True)
        out_path.write_text(json.dumps(record, indent=1))
        print(f"[dryrun] SKIP {arch} x {shape_name} x {mesh_kind}: {e}")
        return record
    args = steps.cell_arguments(cell)
    t_build = time.monotonic()
    arg_bytes = steps.argument_bytes_per_device(args)
    with CollectiveCounter() as counter, LiveBytes([t for a in args for t in leaves(a)]) as live:
        outs = steps.run_cell(cell, args)
    t_run = time.monotonic()
    out_bytes = steps.argument_bytes_per_device(
        [o for o in (outs if isinstance(outs, tuple) else (outs,))
         if isinstance(o, (dict, torch.Tensor))])

    cfg = get_config(arch)
    if kv_dtype != "bf16":
        cfg = cfg.replace(kv_cache_dtype=kv_dtype)
    aflops = cell_flops(cfg, shape)
    abytes = cell_hbm_bytes(cfg, shape, chips)
    coll = counter.summary()
    terms = roofline_report(
        flops_per_device=aflops["total"] / chips,
        bytes_per_device=abytes["per_device"],
        collective_bytes_per_device=float(coll["total_bytes"]),
        chips=chips,
        model_flops=model_flops_for(cfg, shape),
    )
    record.update(
        timing={"build_s": t_build - t0, "run_s": t_run - t_build},
        memory={
            "argument_bytes_per_device": arg_bytes,
            "output_bytes_per_device": out_bytes,
            "live_peak_bytes_per_device": live.peak,
            "peak_bytes_per_device": arg_bytes + live.peak,
            "peak": "arguments + the most bytes of the step's live tensors (LiveBytes)",
            "fits_80GiB": bool(arg_bytes + live.peak <= HBM_PER_GPU),
        },
        analytic={"flops": aflops, "hbm_bytes": abytes},
        collectives=coll,
        roofline=terms.to_dict(),
        roofline_hw="NVIDIA H100 SXM data-sheet constants (roofline.analysis.HW), not measured",
        moe_strategy=moe_strategy,
        attn_sharding=attn_sharding,
        micro_batches=cell.n_micro,
    )
    out_path.parent.mkdir(parents=True, exist_ok=True)
    out_path.write_text(json.dumps(record, indent=1))
    print(f"[dryrun] OK {arch} x {shape_name} x {mesh_kind}: run {t_run - t_build:.1f} s, "
          f"args {arg_bytes / 1e9:.2f} GB/dev, peak {(arg_bytes + live.peak) / 1e9:.2f} GB/dev, "
          f"collectives {coll['total_bytes'] / 1e9:.3f} "
          f"GB/dev, dominant={terms.dominant}", flush=True)
    return record


def cell_list():
    from repro_torch.configs import ALL_SHAPES, ARCHITECTURES

    return [(a, s.name) for a in sorted(ARCHITECTURES) for s in ALL_SHAPES]


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--mesh", default="single",
                    help="single, multi, both, or DxM: a (data, model) debug mesh")
    ap.add_argument("--global-batch", type=int, default=None,
                    help="cut the shape's global batch (a debug mesh's cell)")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--moe-strategy", default="auto")
    ap.add_argument("--attn-sharding", default="gather_kv",
                    choices=["chunked_seq", "gather_kv", "heads"])
    ap.add_argument("--kv-dtype", default="bf16", choices=["bf16", "int8"])
    ap.add_argument("--out", default="results/torch/dryrun")
    ap.add_argument("--subprocess", action="store_true",
                    help="run each cell in a fresh interpreter")
    args = ap.parse_args()

    meshes = ["single", "multi"] if args.mesh == "both" else [args.mesh]
    if not all(m in ("single", "multi") or re.fullmatch(r"\d+x\d+", m) for m in meshes):
        ap.error(f"--mesh {args.mesh}: single, multi, both or DxM")
    if args.all:
        cells = cell_list()
    else:
        if not (args.arch and args.shape):
            ap.error("--arch and --shape required unless --all")
        cells = [(args.arch, args.shape)]
    if len(cells) * len(meshes) > 1 and not args.subprocess:
        ap.error("one process holds one fake group: pass --subprocess for several cells")

    failures = 0
    for mesh_kind in meshes:
        for arch, shape_name in cells:
            out_path = Path(args.out) / mesh_kind / f"{arch}__{shape_name}.json"
            if out_path.exists() and not args.force:
                rec = json.loads(out_path.read_text())
                if rec.get("status") in ("ok", "skipped"):
                    print(f"[dryrun] cached {arch} x {shape_name} x {mesh_kind}")
                    continue
            out_path.parent.mkdir(parents=True, exist_ok=True)
            if args.subprocess:
                cmd = [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", arch,
                       "--shape", shape_name, "--mesh", mesh_kind, "--out", args.out,
                       "--moe-strategy", args.moe_strategy, "--attn-sharding",
                       args.attn_sharding, "--kv-dtype", args.kv_dtype, "--force"]
                if args.global_batch:
                    cmd += ["--global-batch", str(args.global_batch)]
                r = subprocess.run(cmd, timeout=3600)
                if r.returncode != 0:
                    failures += 1
                    out_path.write_text(json.dumps({
                        "arch": arch, "shape": shape_name, "mesh": mesh_kind,
                        "status": "error", "reason": f"subprocess rc={r.returncode}",
                    }, indent=1))
                continue
            try:
                run_cell(arch, shape_name, mesh_kind, out_path, args.moe_strategy,
                         args.attn_sharding, args.kv_dtype, args.global_batch)
            except Exception as e:  # recorded as an error: it is a bug to fix
                failures += 1
                out_path.write_text(json.dumps({
                    "arch": arch, "shape": shape_name, "mesh": mesh_kind,
                    "status": "error", "reason": f"{type(e).__name__}: {e}",
                    "traceback": traceback.format_exc(),
                }, indent=1))
                print(f"[dryrun] FAIL {arch} x {shape_name} x {mesh_kind}: {e}")
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())

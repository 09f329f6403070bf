"""Run reduced configs' sharded cells on a fake mesh and report, for each
failing cell, the first op DTensor could not place (its arguments'
layouts) and the model frames that issued it.

    PYTHONPATH=src python3 scripts/torch_dtensor_probe.py 2x2 qwen3-1.7b,grok-1-314b [train,prefill,decode]
    PYTHONPATH=src python3 scripts/torch_dtensor_probe.py 2x2x2 hymba-1.5b     # (pod, data, model)
    PYTHONPATH=src python3 scripts/torch_dtensor_probe.py 1x4 qwen3-1.7b decode --collectives

``--collectives`` also prints every collective a cell issues: its kind, its
result's shape and dtype, and the model frames that issued it (the op whose
arguments DTensor redistributed).  ``--batch N`` sets the cells' global
batch (default 16; 1 is a one-row batch), ``--micro N`` a train cell's
micro-batch count (default the config's; the batch's rows give one-row
micro-batches).

Meta tensors on a ``fake`` process group: no memory, no data, only
DTensor's sharding rules, which differ between torch versions, so run it
under every torch the port must run on (the card machine's too).  MoE
configs train with int8 moments, as their production cells do.  One
process holds one fake group: one mesh shape per call.
"""
from __future__ import annotations

import sys
import traceback
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

import torch  # noqa: E402
from torch.utils._python_dispatch import TorchDispatchMode  # noqa: E402

from repro_torch.configs import ShapeSpec, get_config, reduced  # noqa: E402
from repro_torch.launch import steps  # noqa: E402
from repro_torch.launch.dryrun import init_fake_group  # noqa: E402
from repro_torch.launch.mesh import make_mesh  # noqa: E402
from repro_torch.training.optimizer import AdamWConfig  # noqa: E402


def _layout(a):
    from torch.distributed.tensor import DTensor

    if isinstance(a, DTensor):
        return tuple(a.shape), tuple(str(p) for p in a.placements)
    if isinstance(a, (list, tuple)):
        return [_layout(x) for x in a][:4]
    return type(a).__name__


class FirstFailingOp(TorchDispatchMode):
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        try:
            return func(*args, **(kwargs or {}))
        except Exception:
            print(f"   op {func} {[_layout(a) for a in args][:4]}", flush=True)
            raise


class Collectives(TorchDispatchMode):
    """Prints each functional collective with the model frames under it."""

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if func.namespace in ("_c10d_functional", "_dtensor") and func.__name__.split(".")[0] in (
                "all_gather_into_tensor", "all_reduce", "reduce_scatter_tensor",
                "all_to_all_single", "shard_dim_alltoall"):
            frames = [f"{f.filename.split('src/')[-1]}:{f.lineno} {f.name}"
                      for f in traceback.extract_stack() if "repro_torch/models" in f.filename]
            print(f"   {func.__name__.split('.')[0]} {tuple(out.shape)} {out.dtype} "
                  f"<- {' < '.join(reversed(frames[-2:]))}", flush=True)
        return out


def main() -> int:
    trace = "--collectives" in sys.argv
    batch = 16
    if "--batch" in sys.argv:
        i = sys.argv.index("--batch")
        batch = int(sys.argv[i + 1])
        del sys.argv[i:i + 2]
    micro = None
    if "--micro" in sys.argv:
        i = sys.argv.index("--micro")
        micro = int(sys.argv[i + 1])
        del sys.argv[i:i + 2]
    sys.argv = [a for a in sys.argv if a != "--collectives"]
    dims = tuple(int(x) for x in sys.argv[1].split("x"))
    names = ("data", "model") if len(dims) == 2 else ("pod", "data", "model")
    init_fake_group(int(torch.tensor(dims).prod()))
    mesh = make_mesh(dims, names, device="cpu")
    kinds = sys.argv[3].split(",") if len(sys.argv) > 3 else ["train", "prefill", "decode"]
    failed = 0
    for arch in sys.argv[2].split(","):
        cfg = reduced(get_config(arch))
        for kind in kinds:
            shape = ShapeSpec(f"{kind}_probe", seq_len=32, global_batch=batch, kind=kind)
            opt = AdamWConfig(state_dtype="int8") if cfg.moe.num_experts else None
            try:
                cell = steps.build_cell(arch, shape.name, mesh, cfg=cfg, shape=shape, opt_cfg=opt,
                                        n_micro=micro)
                args = steps.cell_arguments(cell)
                with FirstFailingOp(), Collectives() if trace else FirstFailingOp():
                    steps.run_cell(cell, args)
                print(f"OK {sys.argv[1]} {arch} {kind}", flush=True)
            except Exception as e:  # reported, then the next cell
                failed += 1
                print(f"FAIL {sys.argv[1]} {arch} {kind} {type(e).__name__}: "
                      f"{str(e).splitlines()[0][:200]}", flush=True)
                for f in traceback.extract_tb(e.__traceback__):
                    if "repro_torch" in f.filename:
                        print(f"    at {f.filename.split('src/')[-1]}:{f.lineno} {f.line}")
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())

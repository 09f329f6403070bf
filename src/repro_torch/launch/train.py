"""Training launcher of the port.

  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-1.7b \\
      --reduced --steps 200 --batch 8 --seq 64 --ckpt-dir /tmp/ckpt --device cpu
  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-1.7b \\
      --steps 20 --batch 4 --seq 4096 --lr 3e-5      # full width, on the card

``--device`` defaults to the card (``repro_torch.device``); ``--reduced``
selects the CPU-sized config.  Resume is automatic when ``--ckpt-dir``
holds a checkpoint.  The families with a frontend (whisper's frames,
phi-3-vision's patch embeddings) need those inputs beside the tokens, which
the synthetic stream does not make, so they train through
``Trainer.train_step`` and not here.  At full width use lr 3e-5: 3e-4
diverged at full depth, and at 2 and 4 of its layers both packages take
the same unstable steps (ROADMAP Queue 3, ``scripts/torch_lr_parity.py``).

``--mesh debug`` (the default) trains on one device without a mesh, as the
reference's debug mesh does.  ``--mesh production`` trains on the 16 x 16
production mesh: every one of its 256 ranks runs this launcher with its
own ``--rank``, the same ``--world-size 256`` and ``--port`` (rank 0's
``tcp://localhost`` address; nccl on cards, gloo with ``--device cpu``).
A smaller group raises; the 256-rank step is proven by the dry run
(``python -m repro_torch.launch.dryrun``).
"""
from __future__ import annotations

import argparse
import json
from pathlib import Path

from repro_torch.configs import get_config, reduced as reduce_cfg
from repro_torch.models.registry import build_model
from repro_torch.training.data import DataConfig
from repro_torch.training.optimizer import AdamWConfig
from repro_torch.training.train_loop import Trainer


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-1.7b")
    ap.add_argument("--reduced", action="store_true", help="CPU-sized config")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--state-dtype", default="fp32", choices=["fp32", "bf16", "int8"])
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--out", default="")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    ap.add_argument("--mesh", default="debug", choices=["debug", "production"])
    ap.add_argument("--rank", type=int, default=0)
    ap.add_argument("--world-size", type=int, default=1)
    ap.add_argument("--port", type=int, default=29500)
    args = ap.parse_args()

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = reduce_cfg(cfg)
    if cfg.frontend != "none":
        raise SystemExit(f"{cfg.name} takes {cfg.frontend} beside its tokens: "
                         "drive it through Trainer.train_step")
    mesh = None
    if args.mesh == "production":
        if args.world_size != 256:
            raise SystemExit(
                f"--mesh production needs 256 ranks (16 x 16), not --world-size "
                f"{args.world_size}; the dry run proves its step on one machine: "
                "python -m repro_torch.launch.dryrun --all --mesh both --subprocess")
        from repro_torch.device import resolve_device
        from repro_torch.launch.mesh import init_group, make_production_mesh

        backend = "gloo" if resolve_device(args.device).type == "cpu" else "nccl"
        init_group(backend, rank=args.rank, world_size=args.world_size, port=args.port)
        mesh = make_production_mesh(device=args.device)
    trainer = Trainer(
        build_model(cfg, device=args.device, mesh=mesh),
        data_cfg=DataConfig(cfg.vocab_size, args.seq, args.batch),
        opt_cfg=AdamWConfig(lr=args.lr, state_dtype=args.state_dtype, warmup_steps=20),
        ckpt_dir=Path(args.ckpt_dir) if args.ckpt_dir else None,
        ckpt_every=args.ckpt_every,
        mesh=mesh,
    )
    if args.ckpt_dir:
        resumed = trainer.resume()
        if resumed:
            print(f"[train] resumed from step {trainer.step}")
    metrics = trainer.run(args.steps)
    first, last = metrics[0]["loss"], metrics[-1]["loss"]
    print(f"[train] loss {first:.4f} -> {last:.4f} over {len(metrics)} steps on {trainer.device}")
    if args.out:
        Path(args.out).write_text(json.dumps(metrics, indent=1))


if __name__ == "__main__":
    main()

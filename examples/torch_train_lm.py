"""End-to-end training driver of the PyTorch port: train a ~25M- or
~100M-parameter LM with the full substrate — synthetic pipeline, AdamW,
checkpoints, straggler monitor — and demonstrate restart-exactness
(the port's counterpart of examples/train_lm.py).

  PYTHONPATH=src python examples/torch_train_lm.py                  # ~25M, 60 steps, card
  PYTHONPATH=src python examples/torch_train_lm.py --hundred-m      # ~100M config
  PYTHONPATH=src python examples/torch_train_lm.py --device cpu --steps 20
"""
import argparse
import shutil
import tempfile
from pathlib import Path

import numpy as np

from repro_torch.configs import ModelConfig
from repro_torch.models.registry import build_model
from repro_torch.training.data import DataConfig
from repro_torch.training.optimizer import AdamWConfig
from repro_torch.training.train_loop import Trainer


def small_cfg(hundred_m: bool) -> ModelConfig:
    if hundred_m:  # ~100M params
        return ModelConfig(
            name="repro-100m", family="dense", num_layers=12, d_model=512,
            num_heads=8, num_kv_heads=4, d_ff=2048, vocab_size=32000, head_dim=64,
        )
    return ModelConfig(  # ~25M params
        name="repro-25m", family="dense", num_layers=6, d_model=320,
        num_heads=5, num_kv_heads=5, d_ff=1280, vocab_size=16000, head_dim=64,
    )


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=60)
    ap.add_argument("--hundred-m", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args()

    cfg = small_cfg(args.hundred_m)
    bundle = build_model(cfg, device=args.device)
    print(f"arch {cfg.name}: {cfg.param_count()/1e6:.1f}M params on {bundle.device}")

    ckpt_dir = Path(tempfile.mkdtemp(prefix="repro-torch-ckpt-"))
    try:
        def trainer(**kw):
            return Trainer(
                bundle,
                data_cfg=DataConfig(cfg.vocab_size, args.seq, args.batch),
                opt_cfg=AdamWConfig(lr=3e-3, warmup_steps=10),
                ckpt_dir=ckpt_dir,
                **kw,
            )

        tr = trainer(ckpt_every=max(10, args.steps // 4))
        metrics = tr.run(args.steps, log_every=10)
        first = np.mean([m["loss"] for m in metrics[:5]])
        last = np.mean([m["loss"] for m in metrics[-5:]])
        print(f"loss: {first:.4f} -> {last:.4f} over {args.steps} steps")
        print(f"stragglers flagged: {len(tr.monitor.events)}")

        # restart drill: a fresh trainer resumes from the latest checkpoint
        # and continues with the losses of the uninterrupted run
        tr.save()
        fresh = trainer()
        assert fresh.resume(), "restart failed to find checkpoint"
        print(f"restart drill: resumed at step {fresh.step} from {ckpt_dir}")
        fresh.run(fresh.step + 5, log_every=0)
        tr.run(tr.step + 5, log_every=0)
        a = [m["loss"] for m in tr.metrics[-5:]]
        b = [m["loss"] for m in fresh.metrics]
        print(f"restart drill: advanced to step {fresh.step}; losses equal the "
              f"uninterrupted run's: {a == b} (max |d| {max(abs(x - y) for x, y in zip(a, b)):.3g})")
    finally:
        shutil.rmtree(ckpt_dir, ignore_errors=True)


if __name__ == "__main__":
    main()

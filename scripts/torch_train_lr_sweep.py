"""Learning rates for the first steps of full-width qwen3-1.7b training on
one NVIDIA GPU.

    python3 scripts/torch_train_lr_sweep.py [--lrs 3e-4,1e-4,3e-5,1e-5] [--steps 6]

Trains qwen3-1.7b at full width and depth from seed 0 with ``Trainer``
(f32 masters and AdamW moments, warm-up 2) on the smoke's shape, 4 x 4096
``SyntheticLM`` tokens, for ``--steps`` steps at each learning rate in
turn, a fresh trainer each, and prints the losses, grad norms and step
seconds of each run beside the card's name and power limit.  It is how
``chip_smoke.py`` phase 17's learning rate was chosen: the highest of
these whose losses fall over six steps.
"""
from __future__ import annotations

import argparse
import gc
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

import torch  # noqa: E402

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models.registry import build_model  # noqa: E402
from repro_torch.training.data import DataConfig  # noqa: E402
from repro_torch.training.optimizer import AdamWConfig  # noqa: E402
from repro_torch.training.train_loop import Trainer  # noqa: E402


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--lrs", default="3e-4,1e-4,3e-5,1e-5")
    ap.add_argument("--steps", type=int, default=6)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs an NVIDIA GPU")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    print(smi.stdout.strip())
    cfg = get_config("qwen3-1.7b")
    for lr in (float(x) for x in args.lrs.split(",")):
        gc.collect()
        torch.cuda.empty_cache()
        tr = Trainer(build_model(cfg), data_cfg=DataConfig(cfg.vocab_size, 4096, 4),
                     opt_cfg=AdamWConfig(lr=lr, warmup_steps=2), seed=0)
        m = tr.run(args.steps, log_every=0)
        print(f"lr {lr:g} warm-up 2: losses {[round(r['loss'], 4) for r in m]}, grad norms "
              f"{[round(r['grad_norm'], 3) for r in m]}, step s {[round(r['dt_s'], 3) for r in m]}",
              flush=True)
        del tr


if __name__ == "__main__":
    main()

"""Both packages' first training steps at lr 3e-4 on full-width qwen3-1.7b,
side by side, on the CPU.

    PYTHONPATH=src JAX_PLATFORMS=cpu python3 scripts/torch_lr_parity.py \\
        [--layers 2] [--batch 1] [--seq 4096] [--steps 6] [--lr 3e-4]

Builds qwen3-1.7b at its full width (d_model 2048, 16 heads over 8 KV
heads, d_ff 6144, vocab 151936) with ``--layers`` of its 28 layers, and
trains it with the JAX package's ``Trainer`` from seed 0 on
``SyntheticLM`` batches of ``--batch`` x ``--seq`` tokens (f32 masters
and moments, AdamW at ``--lr`` with warm-up 2), saving the step-0 state.
The port's ``Trainer`` resumes that checkpoint, so both start from the
same masters and read the same batches, and runs the same steps.  Prints
each package's losses and grad norms, then each step's difference, and
the first step whose loss differs by more than 5e-3 (the bound the
reduced-size training tests hold the port to), or that none does.
"""
from __future__ import annotations

import argparse
import shutil
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

LOSS_TOL = 5e-3


def run_jax(cfg_name, layers, data, opt, steps, ckpt):
    from repro.configs import get_config
    from repro.launch.mesh import make_debug_mesh
    from repro.models.registry import build_model
    from repro.training.data import DataConfig
    from repro.training.optimizer import AdamWConfig
    from repro.training.train_loop import Trainer

    cfg = get_config(cfg_name).replace(num_layers=layers)
    tr = Trainer(build_model(cfg), make_debug_mesh(1, 1), data_cfg=DataConfig(cfg.vocab_size, *data),
                 opt_cfg=AdamWConfig(**opt), ckpt_dir=ckpt, ckpt_every=10**9, async_ckpt=False,
                 seed=0)
    tr.save()  # step 0: the masters the port resumes from
    t0 = time.perf_counter()
    tr.run(steps, log_every=0)
    return tr.metrics, time.perf_counter() - t0


def run_torch(cfg_name, layers, data, opt, steps, ckpt):
    from repro_torch.configs import get_config
    from repro_torch.models.registry import build_model
    from repro_torch.training.data import DataConfig
    from repro_torch.training.optimizer import AdamWConfig
    from repro_torch.training.train_loop import Trainer

    cfg = get_config(cfg_name).replace(num_layers=layers)
    tr = Trainer(build_model(cfg, device="cpu"), data_cfg=DataConfig(cfg.vocab_size, *data),
                 opt_cfg=AdamWConfig(**opt), ckpt_dir=ckpt, async_ckpt=False, seed=0)
    if not tr.resume() or tr.step != 0:
        raise RuntimeError("the port did not resume the JAX step-0 checkpoint")
    t0 = time.perf_counter()
    tr.run(steps, log_every=0)
    return tr.metrics, time.perf_counter() - t0


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-1.7b")
    ap.add_argument("--layers", type=int, default=2)
    ap.add_argument("--batch", type=int, default=1)
    ap.add_argument("--seq", type=int, default=4096)
    ap.add_argument("--steps", type=int, default=6)
    ap.add_argument("--lr", type=float, default=3e-4)
    args = ap.parse_args()
    data = (args.seq, args.batch)
    opt = dict(lr=args.lr, warmup_steps=2)
    print(f"{args.arch} full width, {args.layers} layers, {args.batch} x {args.seq} tokens, "
          f"lr {args.lr:g} warm-up 2, {args.steps} steps, seed 0, on the CPU", flush=True)
    ckpt = Path(tempfile.mkdtemp(prefix="lr_parity_"))
    try:
        jm, jt = run_jax(args.arch, args.layers, data, opt, args.steps, ckpt)
        print(f"jax   losses {[m['loss'] for m in jm]} grad norms {[m['grad_norm'] for m in jm]} "
              f"({jt:.1f} s)", flush=True)
        tm, tt = run_torch(args.arch, args.layers, data, opt, args.steps, ckpt)
        print(f"torch losses {[m['loss'] for m in tm]} grad norms {[m['grad_norm'] for m in tm]} "
              f"({tt:.1f} s)", flush=True)
    finally:
        shutil.rmtree(ckpt, ignore_errors=True)
    first = None
    for j, t in zip(jm, tm):
        dl, dg = abs(j["loss"] - t["loss"]), abs(j["grad_norm"] - t["grad_norm"])
        print(f"step {j['step']}: loss jax {j['loss']:.6f} torch {t['loss']:.6f} |d| {dl:.3e}; "
              f"grad norm jax {j['grad_norm']:.4f} torch {t['grad_norm']:.4f} |d| {dg:.3e}")
        if first is None and dl > LOSS_TOL:
            first = j["step"]
    print(f"first step whose losses differ by more than {LOSS_TOL:g}: "
          f"{first if first is not None else 'none'}")
    return 0


if __name__ == "__main__":
    sys.exit(main())

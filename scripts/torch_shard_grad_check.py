"""Per-leaf grads of one bf16 train step of qwen3-1.7b at full width: the
embedding's backward, and the sharded step on a one-rank mesh.

  PYTHONPATH=src python3 scripts/torch_shard_grad_check.py            # the card
  PYTHONPATH=src python3 scripts/torch_shard_grad_check.py --device cpu --layers 1 \\
      --batch 2 --seq 256                                             # a small CPU run

1. The unsharded ``loss_fn`` with the token embedding taken three ways:
   indexing (``embed[ids]``, whose backward is an ``index_put_`` with
   accumulate), ``F.embedding`` (the port's route), and ``F.embedding``
   over an f32 copy of the table (duplicate tokens summed in f32, one
   rounding to bf16 at the end: the accurate grad).  Prints each embed
   grad's distance to the f32 sums and each form's total grad norm.
2. The sharded step's model code on a 1 x 1 (data, model) mesh over a
   one-rank group (nccl on the card, gloo on the CPU), every parameter laid
   out by the training rules (``Shard`` on the one-rank axes), against the
   unsharded grads leaf by leaf.

Seed-0 weights, ``SyntheticLM`` batch 0.  No kernel runs (training
attention is the plain formulation).
"""
from __future__ import annotations

import argparse
import socket
import subprocess
import sys
from pathlib import Path

import torch
import torch.nn.functional as F

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--layers", type=int, default=28)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=4096)
    args = ap.parse_args()

    import torch.distributed as dist
    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch.configs import ShapeSpec, get_config
    from repro_torch.launch import steps as st
    from repro_torch.launch.mesh import init_group, make_debug_mesh
    from repro_torch.models import transformer as tf
    from repro_torch.models.registry import build_model
    from repro_torch.sharding.rules import full
    from repro_torch.training.data import DataConfig, SyntheticLM
    from repro_torch.training.step import loss_and_grads
    from repro_torch.training.tree import leaves_with_paths, map_tree

    dev = args.device
    if dev == "cuda":
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True)
        print(smi.stdout.strip().splitlines()[0])
    print(f"torch {torch.__version__}; qwen3-1.7b full width, {args.layers} layers, "
          f"{args.batch} x {args.seq} tokens")
    cfg = get_config("qwen3-1.7b").replace(num_layers=args.layers)
    plain = build_model(cfg, device=dev)
    masters = map_tree(lambda t: t.float(), plain.init_params(torch.Generator().manual_seed(0)))
    data = SyntheticLM(DataConfig(cfg.vocab_size, args.seq, args.batch))
    batch = {k: torch.from_numpy(v).to(dev) for k, v in data.batch_at(0).items()}
    ids = batch["tokens"]
    print(f"distinct tokens {int(ids.unique().numel())} of {ids.numel()}")

    def norm(tree):
        return sum(float(t.norm()) ** 2 for _, t in leaves_with_paths(tree)) ** 0.5

    route = tf.embed_tokens
    forms = {
        "indexing": lambda p, c, t, e=None: p["embed"][t.long().clamp(0, c.vocab_size - 1)],
        "F.embedding": route,
        "f32 sums": lambda p, c, t, e=None: F.embedding(
            t.long().clamp(0, c.vocab_size - 1), p["embed"].float()).to(torch.bfloat16),
    }
    embed = {}
    grads = None
    for name, fn in forms.items():
        tf.embed_tokens = fn
        try:
            loss, g = loss_and_grads(plain, masters, batch)
        finally:
            tf.embed_tokens = route
        embed[name] = g["embed"]
        print(f"embedding by {name}: loss {float(loss):.6f}, embed grad norm "
              f"{float(g['embed'].norm()):.6f}, grad norm {norm(g):.6f}")
        if name == "F.embedding":
            grads = g
        del g
    ref = embed["f32 sums"]
    for name in ("indexing", "F.embedding"):
        d = embed[name] - ref
        print(f"embed grad by {name} against the f32 sums: |d| / |f32| "
              f"{float(d.norm() / ref.norm()):.3e}, max|d| {float(d.abs().max()):.3e}, "
              f"bitwise {torch.equal(embed[name], ref)}")
    del embed, ref

    init_group("gloo" if dev == "cpu" else "nccl", rank=0, world_size=1, port=_free_port())
    try:
        mesh = make_debug_mesh(1, 1, device=dev)
        cell = st.build_cell("qwen3-1.7b", "train_4k", mesh, cfg=cfg,
                             shape=ShapeSpec("train_4k", args.seq, args.batch, "train"))
        params = st.distribute_argument(cell, "params", masters)
        bd = st.distribute_argument(cell, "batch", batch)
        with implicit_replication():
            loss, sg = loss_and_grads(cell.bundle, params, bd)
        placed = dict(leaves_with_paths(map_tree(lambda t: tuple(t.placements), params)))
        sg = map_tree(full, sg)
        print(f"sharded step on the 1 x 1 mesh: loss {float(full(loss)):.6f}, grad norm "
              f"{norm(sg):.6f} (unsharded {norm(grads):.6f})")
        for (path, a), (_, b) in zip(leaves_with_paths(grads), leaves_with_paths(sg)):
            print(f"  {'/'.join(path)} {placed[path]}: max|d| {float((a - b).abs().max()):.3e}, "
                  f"bitwise {torch.equal(a, b)}")
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main()

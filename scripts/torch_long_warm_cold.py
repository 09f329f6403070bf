"""Where a warm prefill leaves a cold one's bits, page by page.

Serves one seeded prompt of ``--tokens`` tokens (32,768: prefill_32k's
length) on ``--layers`` of full-width qwen3-1.7b's layers (weights from
seed 0; block_size 16, prefill_chunk 512) three ways: cold, cold again,
and warm (the prompt less its last 16 tokens served first, so the warm
request feeds those 16 through decode steps over the reused pages).  It
prints the entry logits' max |d| of cold vs cold again (determinism) and
of cold vs warm, and for each pair the first layer, k or v, whose page
bytes differ, with the block and the positions in it.

    PYTHONPATH=src python3 scripts/torch_long_warm_cold.py [--layers 28] [--tokens 32768]
"""
import argparse
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))
import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models.registry import build_model  # noqa: E402
from repro_torch.serving.engine import ServingEngine  # noqa: E402


def first_difference(a, b, layers):
    (la, ka, va), (lb, kb, vb) = a, b
    print(f"  logits max|d| {np.abs(la - lb).max():.4e}")
    for layer in range(layers):
        for name, x, y in (("k", ka, kb), ("v", va, vb)):
            blocks = (x[layer] != y[layer]).any(dim=(0, 2, 3)).nonzero().flatten()
            if len(blocks):
                blk = int(blocks[0])
                pos = (x[layer][:, blk] != y[layer][:, blk]).any(dim=(0, 2)).nonzero().flatten()
                d = float((x[layer].float() - y[layer].float()).abs().max())
                print(f"  first difference: layer {layer} {name}, {len(blocks)} blocks differ, the "
                      f"first block {blk} at positions {[blk * 16 + int(i) for i in pos]}, "
                      f"max|d| {d:.4e}")
                return
    print("  every page equal")


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--layers", type=int, default=28)
    ap.add_argument("--tokens", type=int, default=32_768)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    dev, S = torch.device(args.device), args.tokens
    cfg = get_config("qwen3-1.7b").replace(num_layers=args.layers)
    bundle = build_model(cfg, device=dev)
    params = bundle.init_params(torch.Generator().manual_seed(0))
    prompt = tuple(int(t) for t in np.random.default_rng(S).integers(0, cfg.vocab_size, S))
    kw = dict(block_size=16, device_blocks=S // 16 + 64, prefill_chunk=512,
              max_tokens_per_step=1024, device=dev)
    out = {}
    for name in ("cold", "cold again", "warm"):
        t0 = time.monotonic()
        with ServingEngine(bundle, params, **kw) as eng:
            if name == "warm":
                eng.prefill_logits(prompt[:S - 16])
            logits = eng.prefill_logits(prompt)
            slots = eng.pool.page_table(eng.pool.lookup_prefix(prompt, 16))
            idx = torch.tensor(slots, device=dev)
            out[name] = (logits, eng.pool.k_pages[:, :, idx].clone(),
                         eng.pool.v_pages[:, :, idx].clone())
        print(f"{name}: {time.monotonic() - t0:.1f} s", flush=True)
    for a, b in (("cold", "cold again"), ("cold", "warm")):
        print(f"{a} vs {b} ({args.layers} layers, {S} tokens):")
        first_difference(out[a], out[b], args.layers)


if __name__ == "__main__":
    main()

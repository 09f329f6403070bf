"""Digests of one reduced forward per family of the port, on the CPU in
bf16: the parameters from seed 0, inputs from numpy seed 1, one torch
thread.  ``tests/test_torch_distribution.py`` holds the digests of the
tree before the distribution slice against today's: every entry point that
gained a ``mesh=`` argument must stay bitwise what it was without one.

    PYTHONPATH=<a tree's src> python tests/torch_forward_digest.py

prints the digests of the tree on the path (how the held values were made).
"""
from __future__ import annotations

import hashlib

import numpy as np
import torch

FAMILIES = {
    "dense": "qwen3-1.7b",
    "moe": "grok-1-314b",
    "vlm": "phi-3-vision-4.2b",
    "hybrid": "hymba-1.5b",
    "ssm": "xlstm-350m",
    "audio": "whisper-small",
}


def _bytes(tree, out):
    if isinstance(tree, dict):
        for k in sorted(tree):
            _bytes(tree[k], out)
    elif isinstance(tree, (tuple, list)):
        for t in tree:
            _bytes(t, out)
    else:
        out.update(tree.detach().reshape(-1).contiguous().view(torch.uint8).numpy().tobytes())


def digest(arch: str) -> str:
    from repro_torch.configs import get_config, reduced
    from repro_torch.models.registry import build_model

    cfg = reduced(get_config(arch))
    b = build_model(cfg, device="cpu")
    params = b.init_params(torch.Generator().manual_seed(0))
    rng = np.random.default_rng(1)
    B, S = 2, 12
    batch = {"tokens": torch.from_numpy(rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32))}
    if cfg.family == "audio":
        batch["frames"] = torch.from_numpy(
            rng.standard_normal((B, 8, cfg.d_model)).astype(np.float32)).to(torch.bfloat16)
    if cfg.frontend == "image_patches":
        batch["patch_embeds"] = torch.from_numpy(
            rng.standard_normal((B, cfg.frontend_len, cfg.d_model)).astype(np.float32)
        ).to(torch.bfloat16)
    h = hashlib.sha256()
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        with torch.no_grad():
            _bytes(b.loss_fn(params, batch), h)
        logits, cache = b.prefill_fn(params, batch, 32)
        _bytes((logits, cache), h)
        P = cfg.frontend_len if cfg.frontend == "image_patches" else 0
        pos = torch.full((B,), S + P, dtype=torch.int32)
        tok = torch.from_numpy(rng.integers(0, cfg.vocab_size, (B,)).astype(np.int32))
        _bytes(b.decode_fn(params, cache, tok, pos), h)
    finally:
        torch.set_num_threads(threads)
    return h.hexdigest()


if __name__ == "__main__":
    for fam, arch in FAMILIES.items():
        print(f'    "{fam}": "{digest(arch)}",')

"""What the port's benches share: the model and its engine factory, the
card's name and power limit, the nearest-rank percentile and the output
directory.

The engines come from ``core.native_descriptor.engine_factory``: the
parameters are drawn once from ``torch.Generator`` seed 0 on the device
and every engine of a bench shares them, with the reference benches'
engine settings (``SCENARIO_DEFAULTS``: block_size 4, 64 device blocks,
cache_len 64) unless a bench's keywords override them.
"""
from __future__ import annotations

import argparse
import json
import math
import sys
from pathlib import Path
from typing import Any, Dict, Optional, Sequence

import torch

from repro_torch.core.native_descriptor import card_name, engine_factory
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.serving.engine import ServingEngine

RESULTS_DIR = Path("results/torch")
CPU_RESULTS_DIR = RESULTS_DIR / "cpu"  # runs off the card (not committed)
SERVING_JSON = "BENCH_serving.json"
ARCH = "qwen3-1.7b"


class Model:
    """One config's bundle and parameters on one device, built once."""

    def __init__(self, device: DeviceLike = None, *, reduced: bool = False, arch: str = ARCH,
                 seed: int = 0):
        from repro_torch.configs import get_config
        from repro_torch.configs import reduced as reduce_cfg
        from repro_torch.models.registry import build_model

        self.device = resolve_device(device)
        cfg = get_config(arch)
        self.cfg = reduce_cfg(cfg) if reduced else cfg
        self.reduced = reduced
        self.bundle = build_model(self.cfg, device=self.device)
        self.params = self.bundle.init_params(torch.Generator().manual_seed(seed))
        self.seed = seed

    def engine(self, **kw) -> ServingEngine:
        """A fresh engine over the shared parameters (the scenario settings
        unless ``kw`` overrides them)."""
        return engine_factory(self.bundle, self.params, self.device)(**kw)

    def describe(self) -> Dict[str, Any]:
        cfg = self.cfg
        return {
            "model": f"{cfg.name}{' (reduced)' if self.reduced else ''}",
            "layers": cfg.num_layers,
            "heads": f"{cfg.num_heads} over {cfg.num_kv_heads}",
            "params": sum(t.numel() for t in _leaves(self.params)),
            "seed": self.seed,
            "device": str(self.device),
            "card": card_name(self.device),
        }


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


def pct(xs: Sequence[float], q: float) -> float:
    """Nearest-rank percentile (the reference benches' convention)."""
    s = sorted(xs)
    rank = max(0, min(len(s) - 1, math.ceil(q / 100 * len(s)) - 1))
    return s[rank]


def pcts_ms(xs: Sequence[float]) -> Dict[str, Any]:
    """p50/p95/p99 of seconds ``xs`` in milliseconds, with the count."""
    return {**{f"p{q}": round(pct(xs, q) * 1e3, 4) for q in (50, 95, 99)}, "count": len(xs)}


def merge_json(path: Path, key: str, value: Any) -> None:
    """Set ``key`` in the JSON object at ``path`` (made if missing)."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    doc = json.loads(path.read_text()) if path.exists() else {}
    doc[key] = value
    path.write_text(json.dumps(doc, indent=1, default=str))


def gate_failed(bench: str, msg: str) -> None:
    """The reference benches' failure: print and exit 1 (nothing catches it)."""
    print(f"{bench} GATE FAILED: {msg}")
    sys.exit(1)


def parser(doc: Optional[str]) -> argparse.ArgumentParser:
    """The arguments every bench takes: ``--device`` (default: the card,
    which raises without one), ``--reduced`` (the CPU tests' size),
    ``--out-dir`` and ``--fast`` (the reference's fast settings)."""
    ap = argparse.ArgumentParser(description=(doc or "").split("\n\n")[0])
    ap.add_argument("--device", default=None, help="default: the CUDA card (raises without one)")
    ap.add_argument("--reduced", action="store_true", help="reduced qwen3-1.7b (CPU tests' size)")
    ap.add_argument("--out-dir", type=Path, default=None,
                    help=f"default: {RESULTS_DIR} on the card, {CPU_RESULTS_DIR} on the CPU")
    ap.add_argument("--fast", action="store_true", help="the reference bench's --fast settings")
    return ap


def parse(ap: argparse.ArgumentParser, argv: Optional[Sequence[str]]) -> argparse.Namespace:
    """Parse ``argv``; without ``--out-dir`` a run on the card writes under
    ``results/torch/`` and any other run under ``results/torch/cpu/`` (not
    committed), so a CPU run never overwrites the card's results."""
    args = ap.parse_args(argv)
    if args.out_dir is None:
        on_card = args.device is None or torch.device(args.device).type == "cuda"
        args.out_dir = RESULTS_DIR if on_card else CPU_RESULTS_DIR
    return args


def model_from(args: argparse.Namespace) -> Model:
    return Model(args.device, reduced=args.reduced)

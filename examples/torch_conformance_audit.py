"""Conformance audit of the PyTorch/CUDA port: regenerate the port's
native descriptor from live engine traces, run the port's fail-closed
checker over every descriptor, and print the lowering matrix (the paper's
central result, §8.1; the port's counterpart of
examples/conformance_audit.py).  Full-width qwen3-1.7b (weights from seed
0) on the card by default.

The regenerated descriptor goes to ``--descriptor`` (default
``<out-dir>/repro_torch_native.json``; ``<out-dir>`` defaults to
``results/torch/native`` on the card and ``results/torch/native-cpu``,
which git ignores, off it), beside the scenario results and the matrix.
The committed ``src/repro_torch/core/data/descriptors/repro_torch_native.json``
is written only when ``--descriptor`` names it.

  PYTHONPATH=src python examples/torch_conformance_audit.py              # card
  PYTHONPATH=src python examples/torch_conformance_audit.py --device cpu --reduced --out-dir /tmp/audit
"""
import argparse
from pathlib import Path

import torch

from repro_torch.bench.common import Model
from repro_torch.core.checker import generate_matrix, matrix_to_markdown
from repro_torch.core.descriptors import load_all_descriptors, load_descriptor
from repro_torch.core.lowering import LABEL_ADAPTER, LABEL_NATIVE
from repro_torch.core.native_descriptor import (
    BACKEND,
    RESULTS_DIR,
    generate_native_descriptor,
    run_scenarios,
)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    ap.add_argument("--reduced", action="store_true", help="reduced qwen3-1.7b (CPU size)")
    ap.add_argument("--out-dir", type=Path, default=None,
                    help=f"default: {RESULTS_DIR} on the card, {RESULTS_DIR}-cpu on the CPU")
    ap.add_argument("--descriptor", type=Path, default=None,
                    help="where the regenerated descriptor goes (default: in --out-dir)")
    args = ap.parse_args(argv)
    if args.out_dir is None:  # a run off the card never overwrites the card's evidence
        on_card = args.device is None or torch.device(args.device).type == "cuda"
        args.out_dir = RESULTS_DIR if on_card else Path(f"{RESULTS_DIR}-cpu")
    descriptor = args.descriptor or args.out_dir / "repro_torch_native.json"

    model = Model(args.device, reduced=args.reduced)
    results = run_scenarios(model.engine, args.out_dir)
    info = model.describe()
    path = generate_native_descriptor(results, descriptor, {
        "config": f"{info['model']}: {info['layers']} layers, bf16 weights from "
                  f"torch.Generator seed {info['seed']}",
        "device": info["device"],
        "card": info["card"],
    })
    print(f"regenerated native descriptor from live conformance traces: {path}\n")
    descriptors = [d for d in load_all_descriptors() if d.backend != BACKEND]
    rows = generate_matrix(descriptors + [load_descriptor(path)])
    width = max(len(r.backend) for r in rows)
    for r in rows:
        missing = f"  missing: {', '.join(r.missing)}" if r.missing else ""
        print(f"{r.backend:<{width}}  {r.mode:<14} {r.adapter_depth:<18} -> {r.label}{missing}")
    native = sum(r.label == LABEL_NATIVE for r in rows)
    print(f"\n{len(rows)} rows; native_sound={native} (this runtime), "
          f"sound_with_adapter={sum(r.label == LABEL_ADAPTER for r in rows)}")
    matrix = args.out_dir / "lowering-matrix.md"
    matrix.write_text(matrix_to_markdown(rows))
    print(f"artifacts: {matrix}, {path}")
    if {r.backend for r in rows if r.label == LABEL_NATIVE} != {BACKEND}:
        raise SystemExit(1)


if __name__ == "__main__":
    main()

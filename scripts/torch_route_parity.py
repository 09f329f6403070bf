"""Route parity of the port in bf16 and in f32: the radix bench's
byte-identity probe (a warm turn-2 prefill over reused pages against a
cold prefill) and the ceilings' logits parity (the dense mode's K5
prefill against the paged K2 prefill; chunked against monolithic), first
with the model's bf16 weights, then with the same weights cast to f32.

Where the bf16 differences exceed the reference benches' tolerances, the
f32 run tells rounding (differences near f32's precision) from a wrong
page or a wrong mask (differences that stay large).

    PYTHONPATH=src python3 scripts/torch_route_parity.py                      # the card, full width
    PYTHONPATH=src python3 scripts/torch_route_parity.py --device cpu --reduced
"""
import argparse
import json
import sys
import tempfile
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))
import torch  # noqa: E402
from torch.utils._pytree import tree_map  # noqa: E402

from repro_torch.bench import multi_claim, radix  # noqa: E402
from repro_torch.bench.common import Model  # noqa: E402


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None, help="default: the CUDA card")
    ap.add_argument("--reduced", action="store_true")
    args = ap.parse_args()
    torch.backends.cuda.matmul.allow_tf32 = False  # f32 stays f32
    model = Model(args.device, reduced=args.reduced)
    out = {"card": model.describe()["card"]}
    with tempfile.TemporaryDirectory() as tmp:
        for name in ("bf16", "f32"):
            if name == "f32":
                model.params = tree_map(lambda t: t.float() if t.is_floating_point() else t,
                                        model.params)
            ceiling = multi_claim.run_ceiling(model, tmp)
            prefill = multi_claim.run_prefill_ceiling(model, tmp)
            out[name] = {"warm_vs_cold": radix.byte_identity_probe(model),
                         "dense_vs_paged_max_abs_diff": ceiling["logits_max_abs_diff"],
                         "chunked_vs_monolithic_max_abs_diff": prefill["logits_max_abs_diff"]}
    print("route parity " + json.dumps(out))


if __name__ == "__main__":
    main()

"""Serving full-width qwen3-1.7b with the row-invariant GEMM against
``torch.matmul``, in turns, on one NVIDIA GPU.

    python3 scripts/torch_gemm_serving_ab.py

Runs ``chip_smoke.py``'s phase-3 traffic (8 requests of 64-512 tokens, 16
new tokens each, two ``run_batch`` calls) four times on one model: with
``layers.proj``'s no-grad bf16 products on the GEMM, then on
``torch.matmul``, then ``torch.matmul``, then the GEMM, and prints each
run's wall and its parts (the smoke's serving breakdown line).  Only the
GEMM route keeps a row's bits independent of its batch; this measures
what that costs end to end.
"""
from __future__ import annotations

import subprocess
import sys
import time
from pathlib import Path
from types import SimpleNamespace

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402  (puts src/ on the path)
from repro_torch.kernels import gemm  # noqa: E402
from repro_torch.models import layers  # noqa: E402


def main() -> None:
    if not torch.cuda.is_available():
        print("torch_gemm_serving_ab: no CUDA device", file=sys.stderr)
        raise SystemExit(2)
    from repro_torch.configs import get_config
    from repro_torch.models.registry import build_model

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True)
    print(smi.stdout.strip())
    cfg = get_config("qwen3-1.7b")
    bundle = build_model(cfg)
    params = bundle.init_params(torch.Generator().manual_seed(0))
    routes = {"gemm": gemm, "matmul": SimpleNamespace(gemm=lambda x, w: x @ w)}
    walls = {"gemm": [], "matmul": []}
    for name in ("gemm", "matmul", "matmul", "gemm"):
        layers.gemm_lib = routes[name]
        n0 = gemm.gemm.launches
        torch.cuda.synchronize()
        t = time.monotonic()
        cs.serving_phase(bundle, params, cfg, cs.qwen3_traffic, 192)
        torch.cuda.synchronize()
        walls[name].append(time.monotonic() - t)
        print(f"serving A/B: route {name}, phase wall {walls[name][-1]:.3f} s, "
              f"GEMM launches {gemm.gemm.launches - n0}")
    layers.gemm_lib = gemm
    print("serving A/B walls (s): " + ", ".join(f"{k} {[round(w, 3) for w in v]}"
                                                 for k, v in walls.items()))


if __name__ == "__main__":
    main()

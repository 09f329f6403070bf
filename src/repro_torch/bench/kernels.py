"""Kernel microbenchmarks of the port: each hand-written CUDA kernel
against its plain PyTorch version at the reference's three shapes.

The counterpart of ``benchmarks/bench_kernels.py`` (which times the
Pallas kernels in interpret mode against the jnp oracles): K5
``flash_attention`` (f32, B 1, 4 query heads over 2, S 256, D 64, causal),
K4 ``paged_attention`` (f32, 2 sequences, 2 kv heads x 2, D 64, pages of
16, 8 of 32 pages, lengths 128 and 64) and K3 ``kv_block_copy`` (16 of 64
bf16 pages [16, 4, 64]).  On the card each row records the kernel's and
the plain version's device time per call (``torch.profiler``, else CUDA
events; the row names which) and the max |d| between them.  On the CPU there is no kernel: the wrappers run their
plain versions, and the row says so and records no device time.  Writes
``<out-dir>/kernel-bench.json``.

    PYTHONPATH=src python -m repro_torch.bench.kernels                   # card
    PYTHONPATH=src python -m repro_torch.bench.kernels --device cpu
"""
from __future__ import annotations

import json
import time
from pathlib import Path
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.bench.common import RESULTS_DIR, parse, parser
from repro_torch.core.native_descriptor import card_name
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import kv_block_copy as kbc
from repro_torch.kernels import paged_attention as pa


def device_ms(fn: Callable, args: tuple, iters: int = 20) -> Tuple[float, str]:
    """The device time of one call, averaged over ``iters`` warm calls, and
    its source: the ``torch.profiler`` sum of every kernel and copy the
    calls ran on the card, or, where the profiler records no device time
    (a process that traced before may leave it so), CUDA events around the
    calls (which include any gaps where the card waits for the host)."""
    fn(*args)
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn(*args)
        torch.cuda.synchronize()
    us = sum(e.self_device_time_total for e in prof.key_averages()
             if getattr(e, "self_device_time_total", 0.0) > 0)
    if us > 0:
        return us / 1e3 / iters, "torch.profiler"
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn(*args)
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters, "cuda events"


def host_us(fn: Callable, args: tuple, iters: int = 3) -> float:
    fn(*args)
    t0 = time.perf_counter()
    for _ in range(iters):
        fn(*args)
    return (time.perf_counter() - t0) / iters * 1e6


def cases(dev: torch.device) -> List[Dict[str, Any]]:
    """The reference's three shapes, drawn with numpy from seed 0."""
    rng = np.random.default_rng(0)
    f32 = lambda shape: torch.from_numpy(rng.normal(size=shape).astype(np.float32)).to(dev)
    B, H, KV, S, D = 1, 4, 2, 256, 64
    q, k, v = f32((B, H, S, D)), f32((B, KV, S, D)), f32((B, KV, S, D))
    KV2, G, page, P, N = 2, 2, 16, 8, 32
    q2 = f32((2, KV2, G, D))
    kp, vp = f32((KV2, N, page, D)), f32((KV2, N, page, D))
    bt = torch.from_numpy(rng.integers(0, N, (2, P)).astype(np.int32)).to(dev)
    ln = torch.tensor([P * page, P * page // 2], dtype=torch.int32, device=dev)
    src = f32((64, 16, 4, 64)).to(torch.bfloat16)
    idx = torch.from_numpy(rng.permutation(64)[:16].astype(np.int64))
    return [
        dict(name="flash_attention_256", kernel="K5", fn=fa.flash_attention,
             plain=fa.flash_attention_ref, args=(q, k, v)),
        dict(name="paged_attention_8pages", kernel="K4", fn=pa.paged_attention,
             plain=pa.paged_attention_ref, args=(q2, kp, vp, bt, ln)),
        dict(name="kv_block_copy_16x", kernel="K3", fn=kbc.kv_block_copy,
             plain=kbc.kv_block_copy_ref, args=(src, idx)),
    ]


def run(device: DeviceLike = None, out_dir: Path = RESULTS_DIR) -> List[Dict[str, Any]]:
    """One row per kernel: on the card the kernel against its plain version
    (max |d|, device ms of each); on the CPU the plain version alone."""
    dev = resolve_device(device)
    rows = []
    for c in cases(dev):
        want = c["plain"](*c["args"])
        if dev.type == "cuda":
            got = c["fn"](*c["args"])
            torch.cuda.synchronize()
            kernel_ms, timer = device_ms(c["fn"], c["args"])
            plain_ms, plain_timer = device_ms(c["plain"], c["args"])
            row = {"name": c["name"], "kernel": c["kernel"], "route": "cuda",
                   "max_err": float((got.float() - want.float()).abs().max()),
                   "kernel_ms": kernel_ms, "plain_ms": plain_ms,
                   "timer": timer if timer == plain_timer else f"{timer} / {plain_timer}"}
        else:
            row = {"name": c["name"], "kernel": c["kernel"],
                   "route": "plain version only (no CUDA kernel on the CPU)",
                   "max_err": 0.0, "kernel_ms": None, "plain_ms": None,
                   "cpu_plain_us": host_us(c["plain"], c["args"])}
        rows.append(row)
    out = Path(out_dir) / "kernel-bench.json"
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps({"card": card_name(dev), "rows": rows}, indent=1))
    return rows


def main(argv: Optional[List[str]] = None) -> None:
    args = parse(parser(__doc__), argv)
    rows = run(args.device, args.out_dir)
    for r in rows:
        if r["kernel_ms"] is None:
            print(f"{r['name']},plain version only on the CPU (no CUDA kernel): "
                  f"{r['cpu_plain_us']:.1f} us host time")
        else:
            print(f"{r['name']},{r['kernel_ms']:.4f} ms (plain {r['plain_ms']:.4f} ms),"
                  f"max_err={r['max_err']:.2e}")


if __name__ == "__main__":
    main()

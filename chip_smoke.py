"""On-card smoke test of the PyTorch/CUDA port (one NVIDIA GPU).

    python3 chip_smoke.py

Phases, each stopping the run with a non-zero exit at its first failed check:
  1. the card's name and power limit (nvidia-smi), then the build of every
     CUDA kernel from ``src/repro_torch/kernels/csrc`` with nvcc (seconds,
     each kernel's registers, shared memory and spills), and whether the
     SASS of the flash-attention and chunked-prefill libraries holds
     tensor-core instructions;
  2. every kernel against its plain PyTorch version on the card, at the
     shapes the serving path gives it (seeded bf16 inputs; f32 and int32 for
     the page copy), with times of the kernel, the plain version, the
     library call where one computes the same function, and the least time
     the card could take; besides, the paged decode kernel at a long-context
     shape (8 x 2048 prefix keys), the chunked-prefill kernel at a
     long-prefix shape (prefixes of 2048, 2016, 1024 and 32 keys, with
     scaled_dot_product_attention over pre-gathered K/V as a yardstick) and
     the flash-attention kernel in float32 (its SIMT kernel, beside
     scaled_dot_product_attention in float32), each with its own bound;
     plus the reduced qwen3 model served on the card against the same model
     served on the CPU;
  3. full-width qwen3-1.7b (28 layers, random weights from seed 0) serving 8
     requests of 64-512 tokens in the paged mode, half of them sharing a
     256-token prefix;
  4. the claim witness paths at full width: A (offload, restore, reuse with
     the tokens of a never-offloaded engine) and B (same-claim restore
     failure refused fail-closed, in order), each judged by the port's
     analyzer (``check_observation_path``, ``check_failure_outcome_path``);
  5. the dense decode mode at full width: 6 requests in two batches (full-
     length prefills through the flash-attention kernel, then cached-prefix
     hits gathered into the dense cache), one more request under the
     profiler for the device busy share, and a prompt too long for the
     cache refused fail-closed;
  6. full-width cross-checks: dense (flash-attention) against paged
     (chunked-prefill kernel) prefill logits, monolithic against chunked,
     witness path A's restored logits dense against paged, and the paged-
     attention kernel over a served request's dense cache against the
     dense decode attention;
  7. conformance at full width: the seven ResidentClaim mode scenarios
     (about 30 small engines of block_size 4 sharing the model's parameters)
     with every gate checked, the native descriptor generated from their
     results and judged ``native_sound`` in all seven rows by the port's
     checker (no public runtime's row is), the port's analyzer over phase 3's
     event log and metrics, and that log exported as a Perfetto trace to
     ``chiprun_out/paged_serving_trace.json``.
Then two more models, at full width but cut depth (the cut keeps the
smoke's time with phases 10-11 added; both models also serve at full depth):
  8. stablelm-12b (head_dim 160, 32 query heads over 8 kv heads; 10 of its
     40 layers; random weights from seed 0, qwen3's freed first): six
     requests in two paged ``run_batch`` calls (fresh prompts of 512, 300,
     150 and 64 tokens, then two that share the first prompt's 256-token
     prefix), witness path A (a 256-token claim offloaded and restored
     through the page copy, tokens equal to a never-offloaded run), and the
     dense mode (flash-attention prefills of the 512- and 150-token prompts
     against the paged prefill logits, and the paged-attention kernel over
     layer 0 of a served dense cache against the dense decode attention);
  9. deepseek-7b (multi-head: 32 kv heads, G = 1; 8 of its 30 layers),
     stablelm's weights freed first: the same six-request paged traffic.
Then the recurrent families through ``SnapshotEngine``, at full width and
full depth, each model freed before the next:
 10. hymba-1.5b (32 layers of windowed attention beside a selective SSM):
     an OFFLOADABLE claim over an 1100-token prefix (past the 1024-token
     window) materialized (the flash-attention kernel, 32 launches) and
     offloaded through the page copy (a 49,243,140-byte snapshot: the byte
     loop), then 4 prompts of the prefix plus 2 fresh tokens served in one
     ``serve_batch`` (16 new tokens each): restored once, reused by all,
     tokens equal to an engine that never offloaded it, path A judged by
     the port's analyzer; one profiled request; then path B (an injected
     same-claim restore failure) refused in order;
 11. xlstm-350m (3 groups of 7 mLSTM + 1 sLSTM): the same with a 512-token
     prefix (a 22,356,816-byte snapshot: the page copy's vector path).
Then the MoE and VLM families, at full width, weights from seed 0, each
model freed before the next (the depth cuts are printed):
 12. grok-1-314b (8 experts top-2, 48 query heads over 8, soft-cap 30; 4 of
     its 64 layers, 42.6 GB): the six-request paged traffic of phases 8-9,
     witness paths A and B, and its dense mode: K5 (one call) against K2
     (32-query chunks) on layer 0 of the served 512-token prompt, and the
     dense engine's prefill logits beside the paged engine's (printed, not
     held to a tolerance: the experts' capacity depends on the tokens per
     call); K1, K2, K3 and K5 must each launch in the phase;
 13. arctic-480b (128 experts top-2 beside a dense residual MLP, 56 query
     heads over 8; 2 of its 35 layers, 55.4 GB): the same paged traffic;
 14. phi-3-vision-4.2b (32 layers, head_dim 96, 32 heads over 32): a dense
     prefill of 576 seeded patch embeddings plus 64 tokens (K5 at S = 640,
     once per layer), then the same paged traffic.
 15. int8 KV, run right after phase 6 on qwen3-1.7b's parameters
     (``kv_cache_dtype="int8"``, no weights drawn again): the int8 bundle
     has no paged entry points, so ``ServingEngine`` lands in the dense
     mode; phase 3's eight requests beside a bf16 dense engine (greedy
     tokens' agreement, first logits), witness paths A (int8 pages through
     K3, tokens equal a never-offloaded int8 engine's that reused the same
     prefix) and B, the reference's prefix-reuse finding at full width (a
     reused int8 prefix reads zero scales), and one request's cache bytes;
 16. whisper-small at full width and full depth (12 + 12 layers, 0.24 B
     params), after the other models: ``prefill_fn`` on 4 seeded segments
     of 1500 frame embeddings (the stub frontend) with 64-token prompts and
     ``cache_len`` 448 (K5 exactly 36 times: 12 non-causal encoder layers,
     12 causal decoder layers, 12 non-causal cross attentions over the 1500
     states), 32 greedy ``decode_fn`` steps, a 65-token prefill against the
     64-token prefill plus one teacher-forced decode step (3e-2), the stage
     split and one profiled prefill's device busy share.
 17. training, last: (a) qwen3-1.7b at full width and depth through
     ``Trainer`` (f32 masters and moments, lr 3e-5 with warm-up 2) on 4 x
     4096-token ``SyntheticLM`` batches for 6 steps (the first loss within
     0.5 of an untrained model's, ln V + 0.02^2 d / 2, every loss and grad
     norm finite, the last three below the first), the step time,
     tokens/s, model-FLOPs utilisation, peak memory
     and a profiled step split into loss-and-grads and the AdamW update;
     (c) its trained masters cast to bf16 and served by a paged engine (2
     requests x 16 tokens, K1 and K2 must launch); (b) the restart drill at
     full width and 2 of 28 layers (async checkpoints every 2 steps, a
     fresh trainer resumed at step 4, its losses against the uninterrupted
     run's; the checkpoint's bytes and save seconds, sync and async); (d)
     one training step each of whisper-small (full depth, 2 x 1500 frames +
     448 tokens), hymba-1.5b (4 layers, 2 x 512), xlstm-350m (8 layers,
     2 x 256) and phi-3-vision-4.2b (4 layers, 576 patches + 64 tokens).
     The training forward is the reference's (plain chunked attention
     under rematerialization): no kernel may launch in (a), (b) or (d).
 18. distribution, on a one-rank NCCL group (a 1 x 1 ``data, model``
     mesh, rank, world size and a localhost port passed explicitly): (a)
     ``launch.steps.build_cell("qwen3-1.7b", "train_4k")`` at full width
     and depth, 4 x 4096 tokens, lr 3e-5, three sharded steps on DTensors
     against ``Trainer.train_step`` from the same seed-0 masters and
     batches (losses and grad norms within 1e-3 relative), step seconds
     beside the unsharded ones; (b) a sharded prefill cell at 4 x 2048
     against ``prefill_fn`` (max |d| 0.25, the same argmax) whose sharded
     attention body launches K5 once per layer (28); (c) a sharded decode
     cell, 8 rows over 4096 slots, 4 steps, against ``decode_fn``; (d)
     ``compressed_psum`` on a 2048 x 151936 f32 leaf, bitwise
     ``compress_roundtrip``, its bytes against bf16's; (e)
     ``moe_apply_sharded`` ep, tp and a2a on one full-width grok-1-314b
     layer against ``moe_apply_local``; (f) three dry-run cells (qwen3
     train_4k and decode_32k on 256 fake ranks, grok-1-314b train_4k on
     512), each in a subprocess on the CPU started when the smoke starts
     (the fake backend cannot share this process's default group with
     NCCL): status ok, all-gather bytes in the train cells.
After phase 2, the card tests that make K1's and K2's launch fail (their
library entry points return a CUDA error) run in a child pytest: both
must become fail-closed refusals with every pin unwound.
Phase 2 also holds K1, K2, K4 and K5 at stablelm-12b's head_dim 160, K1 and
K2 at 16 query heads per kv head, K2 and K5 at head_dim 256, K5 at a bf16
head_dim of 24, K1, K2, K4 and K5 at a bf16 head_dim of 100 (zero-padded
to 104 by the wrappers), K5 at hymba-1.5b's prefill shape and K3 on one
hymba snapshot page against their plain versions, and K1, K2 and K5 at the
served shapes of phases 12-14 (G = 6 with soft-cap 30, G = 7, head_dim 96),
and K5 at whisper-small's shapes of phase 16 (the non-causal encoder over
4 x 1500 frames, the decoder's causal self-attention over 4 x 64 tokens,
cross attention from 64 and from 448 tokens over 1500 states), beside
scaled_dot_product_attention.
Every launch count is zeroed
just before each path of phases 3-18 and read just after it, so the counts
show each path itself went through its kernels.  The line before the
kernels' JSON record gives the smoke's wall and each path's.
The last two lines are the kernels' JSON record and the device JSON line.
"""
from __future__ import annotations

import gc
import json
import math
import os
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

H100_BYTES_PER_S = 3.35e12  # HBM3, H100 SXM data sheet
H100_BF16_FLOPS = 989e12  # dense bf16 tensor-core peak, H100 SXM data sheet
H100_F32_FLOPS = 67e12  # float32 outside the tensor cores, H100 SXM data sheet
DENSE_CACHE_LEN = 640  # the dense mode's per-request cache at full width
TOLS = {torch.float32: dict(rtol=1e-5, atol=1e-5), torch.bfloat16: dict(rtol=2e-2, atol=2e-2)}


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", flush=True)
    raise SystemExit(1)


def check(cond, msg: str) -> None:
    if not cond:
        fail(msg)


def time_ms(fn, calls, iters: int = 30, breakdown: bool = False) -> float:
    """Device time of one call: the profiler's sum of every kernel and copy
    the calls ran on the card, over ``iters`` warm calls cycling over
    ``calls`` argument sets (sized to exceed the L2 cache).  Host overhead
    between launches is not counted.  If the profiler records no device
    time, CUDA events around the calls are used instead (they include any
    gaps where the card waits for the host)."""
    for args in calls[:3]:
        fn(*args)
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for i in range(iters):
            fn(*calls[i % len(calls)])
        torch.cuda.synchronize()
    avg = [e for e in prof.key_averages() if getattr(e, "self_device_time_total", 0.0) > 0]
    us = sum(e.self_device_time_total for e in avg)
    if breakdown:  # each device kernel of the call, by name
        for e in sorted(avg, key=lambda e: -e.self_device_time_total):
            print(f"    {e.self_device_time_total / 1e3 / iters:.4f} ms  {e.key[:90]}")
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for i in range(iters):
        fn(*calls[i % len(calls)])
    end.record()
    torch.cuda.synchronize()
    events_ms = start.elapsed_time(end) / iters
    if us > 0:
        print(f"  device {us / 1e3 / iters:.4f} ms per call; CUDA events with host gaps "
              f"{events_ms:.4f} ms")
        return us / 1e3 / iters
    print("  (profiler saw no device time: CUDA events used)")
    return events_ms


def bound(nbytes: float, flops: float, peak: float = H100_BF16_FLOPS):
    t_bytes, t_ops = nbytes / H100_BYTES_PER_S, flops / peak
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def max_err(got, want) -> float:
    return float((got.float() - want.float()).abs().max())


def within(got, want, dtype) -> bool:
    return bool(torch.allclose(got.float(), want.float(), **TOLS[dtype]))


def tensor_core_sass(label: str, lib):
    """Start dumping a library's SASS (cuobjdump runs beside the kernel
    phase); the returned function waits for it, counts the tensor-core
    instructions (HGMMA for wgmma, HMMA for mma.sync) and fails if there is
    none."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not Path(tool).exists():
        return lambda: print(f"{label} SASS: cuobjdump not found, tensor-core instructions "
                             "could not be checked")
    proc = subprocess.Popen([tool, "-sass", str(lib)], stdout=subprocess.PIPE,
                            stderr=subprocess.DEVNULL, text=True)

    def finish():
        sass = proc.communicate(timeout=300)[0]
        hgmma, hmma = sass.count("HGMMA"), sass.count("HMMA")
        print(f"{label} SASS ({lib.name}): {hgmma} HGMMA, {hmma} HMMA instructions")
        check(hgmma + hmma > 0, f"the {label} library has no tensor-core instruction")

    return finish


# --------------------------------------------------------------------- phase 2
def kernel_phase(gen_seed: int = 0):
    from repro_torch.kernels import kv_block_copy as kbc

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(gen_seed)
    bf = torch.bfloat16
    rnd = lambda *s, dtype=bf: torch.randn(s, generator=g, device=dev).to(dtype)
    results = {}

    # ---- K1: paged decode, W=8 rows, KV=8, G=2, D=128, page=16, T=24 (6
    # pools of 17 MB: timed launches do not run from L2)
    copies, P = _decode_copies(rnd, dev, gen_seed, 8, 2, 128, PLEN, T_USED, n=6)
    results["paged_decode_attention"] = dict(
        route="cuda", source="src/repro_torch/kernels/csrc/paged_decode.cu",
        replaces="src/repro/kernels/paged_attention.py:405",
        **decode_row("K1 paged_decode", copies, P, PLEN, T_USED),
    )
    # K1 at a long-context shape: 8 sequences of 2048 prefix keys (a
    # 1024-page pool of 67 MB of K/V per copy, 3 copies), the same tails
    copies, P = _decode_copies(rnd, dev, gen_seed + 2, 8, 2, 128, [2048] * 8, T_USED, n=3)
    decode_row("K1 long context (8 x 2048 keys + tail)", copies, P, [2048] * 8, T_USED,
               variants=[dict(window=0, softcap=0.0), dict(window=1000, softcap=30.0)])

    # ---- K2: chunked prefill, B=4 chunks of C=32, same heads
    copies, P = _prefill_copies(rnd, dev, gen_seed, 8, 2, 32, 128, PLEN2, n=6)
    results["paged_prefill_attention"] = dict(
        route="cuda", source="src/repro_torch/kernels/csrc/paged_attention.cu",
        replaces="src/repro/kernels/paged_attention.py:317",
        **prefill_row("K2 paged_prefill", copies, P, PLEN2),
    )
    long_prefix_prefill_check(dev, rnd, gen_seed)

    # ---- K3: page gather of block payloads [448, 8, 128], M=16 of N=32
    M, NP = 16, 32
    idx = torch.randperm(NP, generator=torch.Generator().manual_seed(gen_seed + 1))[:M]
    errs = []
    for dtype in (torch.bfloat16, torch.float32, torch.int32):
        if dtype == torch.int32:
            src = torch.randint(0, 1 << 30, (NP, 448, 8, 128), generator=g, device=dev, dtype=dtype)
        else:
            src = rnd(NP, 448, 8, 128, dtype=dtype)
        got = kbc.kv_block_copy(src, idx)
        want = kbc.kv_block_copy_ref(src, idx)
        torch.cuda.synchronize()
        e = max_err(got, want)
        errs.append(e)
        print(f"K3 kv_block_copy {str(dtype).removeprefix('torch.')}: max|d|={e:.3e}")
        check(torch.equal(got, want), f"K3 is not an exact copy for {dtype}")
    copies3 = [(rnd(NP, 448, 8, 128), idx) for _ in range(4)]
    d_idx = idx.to(dev)
    ms = time_ms(lambda s, i: kbc.kv_block_copy(s, i), copies3)
    plain_ms = time_ms(lambda s, i: kbc.kv_block_copy_ref(s, i), copies3)
    library_ms = time_ms(lambda s, i: torch.index_select(s, 0, d_idx), copies3)
    page_bytes = 448 * 8 * 128 * 2
    b_ms, b_by = bound(2.0 * M * page_bytes + M * 4, 0.0)
    results["kv_block_copy"] = dict(
        route="cuda", source="src/repro_torch/kernels/csrc/kv_block_copy.cu",
        replaces="src/repro/kernels/kv_block_copy.py:25", max_abs_err=max(errs),
        ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by, library_ms=library_ms,
    )
    results["flash_attention"] = flash_kernel_check(dev, g, rnd)
    # ---- K4: decode over pages only, lengths ragged from 1 to 512
    copies, P = _paged_copies(rnd, dev, gen_seed, 8, 2, 128, K4_LENGTHS, n=6)
    results["paged_attention"] = dict(
        route="cuda", source="src/repro_torch/kernels/csrc/paged_decode.cu",
        replaces="src/repro/kernels/paged_attention.py:87",
        **paged_row("K4 paged_attention", copies, P, K4_LENGTHS),
    )
    wide_kernel_rows(dev, rnd, gen_seed)
    snapshot_kernel_rows(dev, rnd)
    moe_vlm_kernel_rows(dev, rnd, gen_seed)
    whisper_kernel_rows(rnd)
    sharded_prefill_kernel_row(rnd)
    for name, r in results.items():
        print(f"{name}: {r['ms']:.4f} ms (plain {r['plain_ms']:.4f} ms, bound {r['bound_ms']:.4f} ms "
              f"by {r['bound_by']}, library {r['library_ms']})")
    return results


def long_prefix_prefill_check(dev, rnd, gen_seed):
    """K2 at a long-prefix shape: B=4 chunks of C=32 queries (KV=8, G=2,
    D=128, page=16) after prefixes of 2048, 2016, 1024 and 32 keys, a
    132-column block table over a 528-page pool (35 MB of bf16 K/V per
    copy), timed over 3 copies so no launch runs from L2; window 0, and a
    1000-key window with softcap 30.  Beside it, as a yardstick only (not
    the same function: no paging), scaled_dot_product_attention over the
    same keys gathered into contiguous K/V beforehand (the gather untimed)
    with the same mask."""
    from repro_torch.kernels import paged_attention as pa

    B, C, KV, G, D, page = 4, 32, 8, 2, 128, 16
    plen = [2048, 2016, 1024, 32]
    copies, P = _prefill_copies(rnd, dev, gen_seed + 3, KV, G, C, D, plen, n=3)
    ms = prefill_row("K2 long prefix (prefixes 2048/2016/1024/32 + a 32-token chunk)", copies, P,
                     plen, variants=[dict(window=0, softcap=0.0), dict(window=1000, softcap=30.0)])["ms"]
    plen = torch.tensor(plen)

    # yardstick: the same keys in contiguous [B, KV, P*page + C, D] buffers
    sdpa = torch.nn.functional.scaled_dot_product_attention
    kpos = torch.arange(P * page + C, device=dev)
    plen_d = plen.to(dev).long()[:, None, None]
    qpos = plen_d + torch.arange(C, device=dev)[None, :, None]
    kabs = torch.where(kpos < P * page, kpos, plen_d + kpos - P * page)
    mask = ((kpos < P * page) & (kpos < plen_d)) | ((kpos >= P * page) & (kabs <= qpos))
    mask = mask[:, None]  # [B, 1, C, P*page + C]

    def gathered(q, kp, vp, bt_, _, kc, vc):
        k = torch.cat([kp[:, bt_.long()].permute(1, 0, 2, 3, 4).reshape(B, KV, P * page, D), kc], 2)
        v = torch.cat([vp[:, bt_.long()].permute(1, 0, 2, 3, 4).reshape(B, KV, P * page, D), vc], 2)
        return q.reshape(B, KV * G, C, D), k.contiguous(), v.contiguous()

    lib_calls = [gathered(*c) for c in copies]
    lib = lambda q, k, v: sdpa(q, k, v, attn_mask=mask, enable_gqa=True)
    e = max_err(lib(*lib_calls[0]).reshape(B, KV, G, C, D), pa.paged_prefill_attention(*copies[0]))
    check(e <= 2e-2, f"the long-prefix yardstick computes another function ({e})")
    sdpa_ms = time_ms(lib, lib_calls)
    print(f"K2 long prefix yardstick (not library_ms): scaled_dot_product_attention with "
          f"enable_gqa over pre-gathered contiguous K/V and the same mask {sdpa_ms:.4f} ms "
          f"(max|d| to K2 {e:.3e}); K2 {ms / sdpa_ms:.2f}x of it")


def flash_kernel_check(dev, g, rnd):
    """K5 at the serving shape of qwen3-1.7b's full-length prefill (B=1,
    16 query heads over 8 kv heads, S=512, D=128, bf16, causal) with every
    window/softcap combination, plus a ragged non-causal Sq != Sk case and
    h2o-danube's head_dim 80.  Operands are [B, H, S, D] views of
    [B, S, H, D] activations, as the model hands them over."""
    from repro_torch.kernels import flash_attention as fa

    bf = torch.bfloat16
    act = lambda B, S, H, D: rnd(B, S, H, D).transpose(1, 2)
    B, H, KV, S, D = 1, 16, 8, 512, 128
    errs = []
    cases = [(S, S, D, H, True, w, c) for w in (0, 128) for c in (0.0, 30.0)]
    cases += [(300, S, D, H, False, 0, 0.0), (S, S, 80, 32, True, 0, 0.0)]
    for Sq, Sk, d, h, causal, window, softcap in cases:
        q, k, v = act(B, Sq, h, d), act(B, Sk, KV, d), act(B, Sk, KV, d)
        kw = dict(causal=causal, window=window, softcap=softcap)
        got = fa.flash_attention(q, k, v, **kw)
        want = fa.flash_attention_ref(q, k, v, **kw)
        torch.cuda.synchronize()
        e = max_err(got, want)
        errs.append(e)
        print(f"K5 flash_attention Sq={Sq} Sk={Sk} H={h} D={d} causal={causal} window={window} "
              f"softcap={softcap}: max|d|={e:.3e}")
        check(within(got, want, bf), f"K5 disagrees with its plain version ({e})")
    copies = [(act(B, S, H, D), act(B, S, KV, D), act(B, S, KV, D)) for _ in range(16)]
    ms = time_ms(lambda q, k, v: fa.flash_attention(q, k, v), copies, breakdown=True)
    plain_ms = time_ms(lambda q, k, v: fa.flash_attention_ref(q, k, v), copies, iters=10)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    if tuple(int(x) for x in torch.__version__.split(".")[:2]) >= (2, 5):
        lib = lambda q, k, v: sdpa(q, k, v, is_causal=True, enable_gqa=True)
        lib_calls = copies
    else:  # K/V repeated per query head outside the timed call
        lib = lambda q, k, v: sdpa(q, k, v, is_causal=True)
        lib_calls = [(q, k.repeat_interleave(H // KV, 1), v.repeat_interleave(H // KV, 1))
                     for q, k, v in copies]
    e = max_err(lib(*lib_calls[0]), fa.flash_attention(*copies[0]))
    print(f"K5 against scaled_dot_product_attention: max|d|={e:.3e}")
    check(e <= 2e-2, f"K5 and scaled_dot_product_attention disagree ({e})")
    library_ms = time_ms(lib, lib_calls)
    nbytes = 2.0 * (2 * B * H * S * D + 2 * B * KV * S * D)  # q, out, k, v in bf16
    flops = 4.0 * B * H * D * S * (S + 1) / 2  # the causal pairs this input attends
    b_ms, b_by = bound(nbytes, flops)
    print(f"K5 bf16 (tensor cores) {ms:.4f} ms vs scaled_dot_product_attention {library_ms:.4f} ms "
          f"({ms / library_ms:.2f}x), plain {plain_ms:.4f} ms")

    # float32 runs the SIMT instantiation (1e-5 against the plain version)
    f32 = [tuple(t.float() for t in c) for c in copies[:8]]
    errs32 = []
    for causal, window, softcap in ((True, 0, 0.0), (True, 128, 30.0), (False, 0, 0.0)):
        kw = dict(causal=causal, window=window, softcap=softcap)
        got = fa.flash_attention(*f32[0], **kw)
        want = fa.flash_attention_ref(*f32[0], **kw)
        torch.cuda.synchronize()
        errs32.append(max_err(got, want))
        check(within(got, want, torch.float32), f"K5 float32 disagrees ({errs32[-1]})")
    ms32 = time_ms(lambda q, k, v: fa.flash_attention(q, k, v), f32)
    plain32 = time_ms(lambda q, k, v: fa.flash_attention_ref(q, k, v), f32, iters=10)
    b32, by32 = bound(2 * nbytes, flops, H100_F32_FLOPS)  # f32 FMAs on the CUDA cores
    lib32 = lambda q, k, v: sdpa(q, k, v, is_causal=True, enable_gqa=True)
    e32 = max_err(lib32(*f32[0]), fa.flash_attention(*f32[0]))
    check(e32 <= 2e-2, f"float32 scaled_dot_product_attention computes another function ({e32})")
    lib32_ms = time_ms(lib32, f32)
    print(f"K5 float32 (SIMT) at the serving shape: {ms32:.4f} ms (plain {plain32:.4f} ms, bound "
          f"{b32:.4f} ms by {by32}, library {lib32_ms:.4f} ms: scaled_dot_product_attention in "
          f"float32, max|d| to K5 {e32:.3e}), max|d|={max(errs32):.3e} over "
          "causal/window+softcap/non-causal")
    return dict(
        route="cuda", source="src/repro_torch/kernels/csrc/flash_attention.cu",
        replaces="src/repro/kernels/flash_attention.py:98", max_abs_err=max(errs),
        ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by, library_ms=library_ms,
    )


def kernel_row(label, fn, plain, copies, variants, nbytes, flops, library=None, timed=None):
    """One kernel at one shape: checked against its plain version on
    ``copies[0]`` under each keyword set of ``variants`` (the bf16
    tolerance), then timed (profiler device time, under the keywords
    ``timed``: the served model's soft-cap, for one) beside the plain version,
    the bound of this input (bytes / 3.35 TB/s or FLOPs / 989 TFLOP/s) and,
    where one PyTorch call computes the same function, that call as the
    yardstick (``library``: (fn, its argument sets))."""
    errs = []
    for kw in variants:
        got = fn(*copies[0], **kw)
        want = plain(*copies[0], **kw)
        torch.cuda.synchronize()
        errs.append(max_err(got, want))
        check(within(got, want, torch.bfloat16), f"{label} {kw} disagrees with its plain version "
                                                 f"({errs[-1]})")
    timed = timed or {}
    ms = time_ms(lambda *a: fn(*a, **timed), copies, breakdown=True)
    plain_ms = time_ms(lambda *a: plain(*a, **timed), copies, iters=6)
    lib_ms = None
    if library is not None:
        lib_fn, lib_calls = library
        e = max_err(lib_fn(*lib_calls[0]), fn(*copies[0], **timed))
        check(e <= 2e-2, f"{label}: the library yardstick computes another function ({e})")
        lib_ms = time_ms(lib_fn, lib_calls)
    b_ms, b_by = bound(nbytes, flops)
    print(f"{label}: {ms:.4f} ms (plain {plain_ms:.4f} ms, bound {b_ms:.4f} ms by {b_by}, "
          f"{100 * b_ms / ms:.1f}% of the bound, {nbytes / ms / 1e6:.0f} GB/s, library "
          f"{'none' if lib_ms is None else f'{lib_ms:.4f} ms'}), max|d|={max(errs):.3e} over "
          f"{len(variants)} variants")
    return dict(ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by, library_ms=lib_ms,
                max_abs_err=max(errs))


# The paged shapes of phase 2: prefixes of 8 decode rows (K1) with the tail
# slots each uses of T = 24, lengths of 8 rows (K4), prefixes of 4 chunks (K2)
PLEN = [0, 37, 64, 100, 256, 300, 411, 512]
T_USED = [1, 24, 5, 17, 9, 24, 2, 13]
K4_LENGTHS = [1, 37, 64, 100, 256, 300, 411, 512]
PLEN2 = [0, 32, 96, 224]
BOTH = [dict(window=w, softcap=c) for w in (0, 128) for c in (0.0, 30.0)]


def _decode_copies(rnd, dev, seed, KV, G, D, plen, t_used, T=24, n=4, page=16):
    """Paged-decode operands (block tables of distinct pages over a pool of
    exactly those pages, tails of ``t_used`` slots after each prefix) in
    ``n`` copies; also the block table's width."""
    W, P = len(plen), max(1, math.ceil(max(plen) / page))
    bt = torch.randperm(W * P, generator=torch.Generator().manual_seed(seed)).reshape(W, P)
    tail_pos = torch.full((W, T), -1, dtype=torch.int32)
    for b in range(W):
        tail_pos[b, : t_used[b]] = plen[b] + torch.arange(t_used[b], dtype=torch.int32)
    pl = torch.tensor(plen, dtype=torch.int32)
    cur = pl + torch.tensor(t_used, dtype=torch.int32) - 1
    return [(rnd(W, KV, G, D), rnd(KV, W * P, page, D), rnd(KV, W * P, page, D),
             bt.to(torch.int32).to(dev), pl.to(dev), rnd(W, KV, T, D), rnd(W, KV, T, D),
             tail_pos.to(dev), cur.to(dev)) for _ in range(n)], P


def _paged_copies(rnd, dev, seed, KV, G, D, lengths, n=4, page=16):
    """K4's operands: the decode operands without a tail, block-table
    entries past each length set to -7 (never read)."""
    copies, P = _decode_copies(rnd, dev, seed, KV, G, D, lengths, [0] * len(lengths), T=1, n=n)
    out = []
    for q, kp, vp, bt, ln, *_ in copies:
        bt = bt.clone()
        for b, L in enumerate(lengths):
            bt[b, -(-L // page):] = -7
        out.append((q, kp, vp, bt, ln))
    return out, P


def _prefill_copies(rnd, dev, seed, KV, G, C, D, plen, n=4, page=16):
    """Chunked-prefill operands: chunks of C queries after ``plen``, block
    tables 4-column aligned over a pool of exactly their pages."""
    B, P = len(plen), 4 * math.ceil(math.ceil((max(plen) + C) / page) / 4)
    bt = torch.randperm(B * P, generator=torch.Generator().manual_seed(seed)).reshape(B, P)
    return [(rnd(B, KV, G, C, D), rnd(KV, B * P, page, D), rnd(KV, B * P, page, D),
             bt.to(torch.int32).to(dev), torch.tensor(plen, dtype=torch.int32, device=dev),
             rnd(B, KV, C, D), rnd(B, KV, C, D)) for _ in range(n)], P


def decode_row(label, copies, P, plen, t_used, variants=BOTH, timed=None):
    """K1 at one shape.  Its bound counts q and the output once, the K/V
    rows of the keys the timed call (window 0) attends (every prefix key
    and each used tail slot: the kernel never loads an empty slot), the
    block table, the lengths, the positions and the tail slots."""
    from repro_torch.kernels import paged_attention as pa

    W, KV, G, D = copies[0][0].shape
    T, es = copies[0][5].shape[2], copies[0][0].element_size()
    keys = sum(plen) + sum(t_used)
    nbytes = (2 * W * KV * G * D + 2 * keys * KV * D) * es + (W * P + 2 * W + W * T) * 4
    return kernel_row(label, pa.paged_decode_attention, pa.paged_decode_attention_ref, copies,
                      variants, nbytes, 4.0 * keys * KV * G * D, timed=timed)


def paged_row(label, copies, P, lengths):
    """K4 at one shape, its bound counted as K1's over ``lengths`` keys."""
    from repro_torch.kernels import paged_attention as pa

    W, KV, G, D = copies[0][0].shape
    keys, es = sum(lengths), copies[0][0].element_size()
    nbytes = (2 * W * KV * G * D + 2 * keys * KV * D) * es + (W * P + W) * 4
    return kernel_row(label, pa.paged_attention, pa.paged_attention_ref, copies,
                      [dict(softcap=0.0), dict(softcap=30.0)], nbytes, 4.0 * keys * KV * G * D)


def prefill_row(label, copies, P, plen, variants=BOTH, timed=None):
    """K2 at one shape: the bound counts q, the output and the chunk's own
    K/V once, each prefix key's K/V row once, the block table and lengths;
    the operations are the causal (query, key) pairs of the chunk."""
    from repro_torch.kernels import paged_attention as pa

    B, KV, G, C, D = copies[0][0].shape
    es = copies[0][0].element_size()
    keys = sum(p * C + C * (C + 1) / 2 for p in plen)  # per (kv head, query head)
    nbytes = (2 * B * KV * G * C * D + 2 * sum(plen) * KV * D + 2 * B * KV * C * D) * es
    nbytes += (B * P + B) * 4
    return kernel_row(label, pa.paged_prefill_attention, pa.paged_prefill_attention_ref, copies,
                      variants, nbytes, 4.0 * keys * KV * G * D, timed=timed)


def wide_kernel_rows(dev, rnd, gen_seed):
    """K1, K4, K2 and K5 at stablelm-12b's serving shapes (head_dim 160, 4
    query heads per kv head), K1 and K2 at 16 query heads per kv head
    (head_dim 128 over 2 kv heads), K2 and K5 at head_dim 256 (the widest
    tiles, one K/V stage per warpgroup), K5 at a bf16 head_dim of 24
    (tiles zero-padded to 32 columns), and K1, K4, K2 and K5 at a bf16
    head_dim of 100 (operands zero-padded to 104 by the wrappers; the time
    includes the padding copies), each against its plain version."""
    from repro_torch.kernels import flash_attention as fa

    rows = {}
    for label, KV, G, D in (("K1 D=160 G=4 (stablelm-12b decode)", 8, 4, 160),
                            ("K1 D=128 G=16", 2, 16, 128)):
        copies, P = _decode_copies(rnd, dev, gen_seed + 5, KV, G, D, PLEN, T_USED)
        rows[label] = decode_row(label, copies, P, PLEN, T_USED)
    label = "K4 D=160 G=4 (stablelm-12b widths)"
    copies, P = _paged_copies(rnd, dev, gen_seed + 6, 8, 4, 160, K4_LENGTHS)
    rows[label] = paged_row(label, copies, P, K4_LENGTHS)
    for label, KV, G, D in (("K2 D=160 G=4 (stablelm-12b prefill chunk)", 8, 4, 160),
                            ("K2 D=128 G=16", 2, 16, 128), ("K2 D=256 G=2", 8, 2, 256)):
        copies, P = _prefill_copies(rnd, dev, gen_seed + 7, KV, G, 32, D, PLEN2)
        rows[label] = prefill_row(label, copies, P, PLEN2)

    # bf16 D = 100 is not a multiple of the 8-element vector: the wrappers
    # zero-pad q, k, v (K1, K2 and K4: the whole page pool) to 104 per call
    label = "K1 bf16 D=100 G=2 (padded to 104)"
    copies, P = _decode_copies(rnd, dev, gen_seed + 8, 8, 2, 100, PLEN, T_USED)
    rows[label] = decode_row(label, copies, P, PLEN, T_USED)
    label = "K4 bf16 D=100 G=2 (padded to 104)"
    copies, P = _paged_copies(rnd, dev, gen_seed + 8, 8, 2, 100, K4_LENGTHS)
    rows[label] = paged_row(label, copies, P, K4_LENGTHS)
    label = "K2 bf16 D=100 G=2 (padded to 104)"
    copies, P = _prefill_copies(rnd, dev, gen_seed + 8, 8, 2, 32, 100, PLEN2)
    rows[label] = prefill_row(label, copies, P, PLEN2)

    sdpa = torch.nn.functional.scaled_dot_product_attention
    act = lambda B, S, H, D: rnd(B, S, H, D).transpose(1, 2)
    for label, H, KV, S, D in (("K5 D=160 32/8 heads (stablelm-12b prefill)", 32, 8, 512, 160),
                               ("K5 D=256 16/8 heads", 16, 8, 512, 256),
                               ("K5 bf16 D=24 16/8 heads", 16, 8, 512, 24),
                               ("K5 bf16 D=100 16/8 heads (padded to 104)", 16, 8, 512, 100)):
        copies = [(act(1, S, H, D), act(1, S, KV, D), act(1, S, KV, D)) for _ in range(8)]
        variants = [dict(causal=True, window=w, softcap=c) for w in (0, 128) for c in (0.0, 30.0)]
        nbytes = 2.0 * (2 * H * S * D + 2 * KV * S * D)
        lib = (lambda q, k, v: sdpa(q, k, v, is_causal=True, enable_gqa=True), copies)
        rows[label] = kernel_row(label, fa.flash_attention, fa.flash_attention_ref, copies, variants,
                                 nbytes, 4.0 * H * D * S * (S + 1) / 2, library=lib)
    print("wide kernel rows: " + json.dumps(rows))
    return rows


def moe_vlm_kernel_rows(dev, rnd, gen_seed):
    """K1, K2 and K5 at the served shapes of phases 12-14, each against its
    plain version under every window/soft-cap variant and timed as the
    model runs it: grok-1-314b (48 query heads over 8, G = 6, soft-cap 30:
    timed with it), arctic-480b (56 over 8, G = 7), and phi-3-vision-4.2b
    (32 over 32, G = 1, head_dim 96).  D = 96 needs no wrapper padding
    (96 % 8 == 0): K1 runs it in its 128-column layout (lanes past 96 idle),
    K2 and K5 on their 128-column tensor-core tiles (``launch_tc<128>``, the
    columns past 96 zero in shared memory).  K5 with soft-cap 30 has no
    library yardstick (scaled_dot_product_attention has no soft-cap); the
    rows of grok's heads without it split the soft-cap's cost from the
    grouping's, and give K5 at G = 6 its yardstick."""
    from repro_torch.kernels import flash_attention as fa

    rows = {}
    cap = dict(softcap=30.0)
    for label, G, D, timed in (("K1 grok-1-314b decode (G = 6, D 128, soft-cap 30)", 6, 128, cap),
                               ("K1 grok-1-314b heads without soft-cap (G = 6, D 128)", 6, 128, None),
                               ("K1 arctic-480b decode (G = 7, D 128)", 7, 128, None),
                               ("K1 phi-3-vision-4.2b decode (G = 1, D 96, 128 layout)", 1, 96, None)):
        KV = 32 if G == 1 else 8
        copies, P = _decode_copies(rnd, dev, gen_seed + 9, KV, G, D, PLEN, T_USED)
        rows[label] = decode_row(label, copies, P, PLEN, T_USED, timed=timed)
    for label, G, D, timed in (("K2 grok-1-314b prefill chunk (G = 6, D 128, soft-cap 30)", 6, 128, cap),
                               ("K2 arctic-480b prefill chunk (G = 7, D 128)", 7, 128, None),
                               ("K2 phi-3-vision-4.2b prefill chunk (G = 1, D 96, 128-column tiles)",
                                1, 96, None)):
        KV = 32 if G == 1 else 8
        copies, P = _prefill_copies(rnd, dev, gen_seed + 10, KV, G, 32, D, PLEN2)
        rows[label] = prefill_row(label, copies, P, PLEN2, timed=timed)

    sdpa = torch.nn.functional.scaled_dot_product_attention
    act = lambda S, H, D: rnd(1, S, H, D).transpose(1, 2)
    variants = [dict(causal=True, window=w, softcap=c) for w in (0, 128) for c in (0.0, 30.0)]
    for label, H, KV, S, D, softcap in (
            ("K5 grok-1-314b prefill (48/8 heads, S 512, soft-cap 30)", 48, 8, 512, 128, 30.0),
            ("K5 grok-1-314b heads without soft-cap (48/8 heads, S 512)", 48, 8, 512, 128, 0.0),
            ("K5 phi-3-vision-4.2b prefix prefill (32/32 heads, S 576 + 64, D 96, 128-column tiles)",
             32, 32, 640, 96, 0.0)):
        copies = [(act(S, H, D), act(S, KV, D), act(S, KV, D)) for _ in range(8)]
        lib = None
        if not softcap:
            lib = (lambda q, k, v: sdpa(q, k, v, is_causal=True, enable_gqa=True), copies)
        rows[label] = kernel_row(label, fa.flash_attention, fa.flash_attention_ref, copies, variants,
                                 2.0 * (2 * H * S * D + 2 * KV * S * D), 4.0 * H * D * S * (S + 1) / 2,
                                 library=lib, timed=dict(causal=True, softcap=softcap))
    print("moe/vlm kernel rows: " + json.dumps(rows))
    return rows


def whisper_kernel_rows(rnd):
    """K5 at whisper-small's served shapes (phase 16: 12 heads over 12,
    G = 1, D 64), each against its plain version with and without a
    soft-cap and timed as the model runs it, beside
    scaled_dot_product_attention: the encoder over 4 segments of 1500
    frames (non-causal; 1500 = 23 full key tiles of 64 and a ragged one of
    28), the decoder's causal self-attention over its 64 prompt tokens,
    cross attention from those 64 tokens over the 1500 encoder states
    (non-causal, Sq != Sk), and from whisper's longest decoder prefix (448
    tokens).  q arrives as a view of [B, Sq, H, D] activations, k and v as
    views of the [B, T, H * D] projections, as the model hands them over.
    A causal row's operations count the S (S + 1) / 2 pairs it attends."""
    from repro_torch.kernels import flash_attention as fa

    sdpa = torch.nn.functional.scaled_dot_product_attention
    H, D, T = 12, 64, 1500
    rows = {}
    for label, B, Sq, Sk, causal, n in (
            ("K5 whisper-small encoder (4 x 1500 frames, 12/12 heads, D 64, non-causal)",
             4, T, T, False, 4),
            ("K5 whisper-small decoder self-attention (4 x 64 tokens, 12/12 heads, D 64, causal)",
             4, 64, 64, True, 8),
            ("K5 whisper-small cross attention (4 x 64 tokens over 1500 states)", 4, 64, T, False, 6),
            ("K5 whisper-small cross attention (4 x 448 tokens over 1500 states)",
             4, 448, T, False, 6)):
        act = lambda S: rnd(B, S, H * D).reshape(B, S, H, D).transpose(1, 2)
        copies = [(act(Sq), act(Sk), act(Sk)) for _ in range(n)]
        variants = [dict(causal=causal, softcap=c) for c in (0.0, 30.0)]
        lib = (lambda q, k, v, c=causal: sdpa(q, k, v, is_causal=c), copies)
        pairs = Sq * (Sq + 1) / 2 if causal else Sq * Sk
        nbytes = 2.0 * (2 * B * H * Sq * D + 2 * B * H * Sk * D)  # q, out, k, v in bf16
        rows[label] = kernel_row(label, fa.flash_attention, fa.flash_attention_ref, copies, variants,
                                 nbytes, 4.0 * B * H * pairs * D, library=lib,
                                 timed=dict(causal=causal))
    print("whisper kernel rows: " + json.dumps(rows))
    return rows


def sharded_prefill_kernel_row(rnd):
    """K5 at the shape phase 18's sharded prefill hands it on the 1 x 1
    mesh: qwen3-1.7b's 4 x 2048 tokens, 16 query heads over 8 kv heads,
    D 128, causal, q as a view of the [B, S, H, D] activations and k, v of
    [B, S, KV, D], against its plain version and beside
    scaled_dot_product_attention (``enable_gqa``).  The sharded prefill's
    logits are held only against the unsharded prefill, which runs the
    same kernel; this row holds the kernel itself at that shape."""
    from repro_torch.kernels import flash_attention as fa

    sdpa = torch.nn.functional.scaled_dot_product_attention
    B, S, H, KV, D = *DIST_PREFILL, 16, 8, 128
    act = lambda n: rnd(B, S, n, D).transpose(1, 2)
    copies = [(act(H), act(KV), act(KV)) for _ in range(4)]
    lib = (lambda q, k, v: sdpa(q, k, v, is_causal=True, enable_gqa=True), copies)
    label = "K5 qwen3-1.7b sharded prefill (4 x 2048 tokens, 16/8 heads, D 128, causal)"
    row = kernel_row(label, fa.flash_attention, fa.flash_attention_ref, copies,
                     [dict(causal=True)], 2.0 * (2 * B * H * S * D + 2 * B * KV * S * D),
                     4.0 * B * H * D * S * (S + 1) / 2, library=lib, timed=dict(causal=True))
    print("sharded prefill kernel row: " + json.dumps({label: row}))
    return row


# hymba-1.5b's full-width snapshot after an 1100-token prefix: ring k and v
# (2 x 32 x 1024 x 5 x 64 bf16), SSM h (32 x 3200 x 16 f32), conv (32 x 3 x
# 3200 bf16), pos (1024 int32) and the logits (32001 f32): 4 mod 16 bytes
HYMBA_SNAPSHOT_BYTES = 49_243_140


def snapshot_kernel_rows(dev, rnd):
    """The two kernels of the snapshot path at their served shapes: K5 at
    hymba-1.5b's prefill (B 1, 25 query heads over 5 kv heads, S 1100,
    D 64, causal, window 1024: keys past the window masked), beside
    scaled_dot_product_attention with the same causal+window mask given
    explicitly (a boolean mask, which SDPA serves with a non-flash
    kernel); and K3 on one hymba snapshot page of 49,243,140 uint8 bytes
    (not a multiple of 16: the byte loop), beside ``index_select``."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import kv_block_copy as kbc

    sdpa = torch.nn.functional.scaled_dot_product_attention
    H, KV, S, D, W = 25, 5, 1100, 64, 1024
    act = lambda n: rnd(1, S, n, D).transpose(1, 2)
    copies = [(act(H), act(KV), act(KV)) for _ in range(8)]
    pos = torch.arange(S, device=dev)
    mask = (pos[:, None] >= pos[None, :]) & (pos[:, None] - pos[None, :] < W)
    pairs = int(mask.sum())  # the (query, key) pairs this input attends
    lib = (lambda q, k, v: sdpa(q, k, v, attn_mask=mask, enable_gqa=True), copies)
    label = "K5 hymba-1.5b prefill (25/5 heads, S 1100, D 64, window 1024)"
    kw = dict(causal=True, window=W)
    row = kernel_row(label, lambda *a: fa.flash_attention(*a, **kw),
                     lambda *a: fa.flash_attention_ref(*a, **kw), copies, [{}],
                     2.0 * (2 * H * S * D + 2 * KV * S * D), 4.0 * H * D * pairs, library=lib)
    print(f"{label}: library_ms is scaled_dot_product_attention with an explicit boolean "
          f"causal+window mask (a non-flash SDPA kernel); {pairs} attended pairs")

    g = torch.Generator(device=dev).manual_seed(9)
    pages = [torch.randint(0, 256, (1, HYMBA_SNAPSHOT_BYTES, 1, 1), generator=g, device=dev,
                           dtype=torch.uint8) for _ in range(3)]
    idx = torch.zeros(1, dtype=torch.int32)
    d_idx = idx.to(dev)
    got = kbc.kv_block_copy(pages[0], idx)
    torch.cuda.synchronize()
    check(torch.equal(got, pages[0]), "K3 is not an exact copy of a snapshot page")
    calls = [(pg, idx) for pg in pages]
    ms = time_ms(lambda s, i: kbc.kv_block_copy(s, i), calls)
    plain_ms = time_ms(lambda s, i: kbc.kv_block_copy_ref(s, i), calls)
    lib_ms = time_ms(lambda s, i: torch.index_select(s, 0, d_idx), calls)
    b_ms, b_by = bound(2.0 * HYMBA_SNAPSHOT_BYTES + 4, 0.0)
    rows = {label: row, "K3 hymba-1.5b snapshot page (49,243,140 B, byte loop)": dict(
        ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by, library_ms=lib_ms, max_abs_err=0.0)}
    print(f"K3 one hymba-1.5b snapshot page ({HYMBA_SNAPSHOT_BYTES} B, 4 mod 16: byte loop): "
          f"{ms:.4f} ms (plain {plain_ms:.4f} ms, bound {b_ms:.4f} ms by {b_by}, "
          f"{100 * b_ms / ms:.1f}% of the bound, {2 * HYMBA_SNAPSHOT_BYTES / ms / 1e6:.0f} GB/s, "
          f"library index_select {lib_ms:.4f} ms), exact")
    print("snapshot kernel rows: " + json.dumps(rows))
    return rows


def reduced_parity_phase():
    """The reduced qwen3 engine on the card (kernels) against the same
    weights on the CPU (plain versions)."""
    from repro_torch.configs import get_config, reduced
    from repro_torch.models.registry import build_model
    from repro_torch.serving.engine import ServingEngine

    cfg = reduced(get_config("qwen3-1.7b"))
    params_cpu = build_model(cfg, device="cpu").init_params(torch.Generator().manual_seed(0))
    params_gpu = {k: v for k, v in _to(params_cpu, "cuda").items()}
    prompt = tuple(range(300, 341))
    from repro_torch.kernels import paged_attention as pa

    lg = {}
    toks = {}
    before = (pa.paged_decode_attention.launches, pa.paged_prefill_attention.launches)
    for dev, p in (("cpu", params_cpu), ("cuda", params_gpu)):
        with ServingEngine(build_model(cfg, device=dev), p, block_size=4, device_blocks=64,
                           device=dev) as eng:
            lg[dev] = torch.from_numpy(eng.prefill_logits(prompt))
            r = eng.run(eng.submit(prompt, max_new_tokens=4))
            check(r.status == "finished", f"reduced engine on {dev}: {r.status} {r.error}")
            toks[dev] = r.output_tokens
    after = (pa.paged_decode_attention.launches, pa.paged_prefill_attention.launches)
    check(after[0] > before[0] and after[1] > before[1], "reduced card run skipped the kernels")
    e = max_err(lg["cuda"], lg["cpu"])
    print(f"reduced qwen3 card vs CPU: prefill logits max|d|={e:.3e}, "
          f"tokens {toks['cuda']} vs {toks['cpu']}")
    check(bool(torch.isfinite(lg["cuda"]).all()), "reduced card logits not finite")
    check(e <= 5e-2, f"reduced card logits disagree with the CPU run ({e})")
    check(int(lg["cuda"].argmax()) == int(lg["cpu"].argmax()), "reduced argmax differs")


def _to(tree, dev):
    if isinstance(tree, dict):
        return {k: _to(v, dev) for k, v in tree.items()}
    return tree.to(dev)


# ----------------------------------------------------------------- phases 3-4
def qwen3_traffic(V):
    """Phase 3's 8 requests: 4 fresh prompts of 64-512 tokens, one of them
    opening with a shared 256-token prefix, then 3 more on that prefix and
    a fresh 100-token prompt."""
    rng = np.random.default_rng(0)
    shared = tuple(int(t) for t in rng.integers(0, V, 256))
    fresh = lambda n: tuple(int(t) for t in rng.integers(0, V, n))
    first = [shared + fresh(64), fresh(64), fresh(150), fresh(512)]
    return first, [shared + fresh(128), shared + fresh(200), shared + fresh(37), fresh(100)]


def wide_traffic(V):
    """Phases 8-9's 6 requests: fresh prompts of 512, 300, 150 and 64
    tokens, then two that share the first prompt's 256-token prefix plus 8
    fresh tokens."""
    rng = np.random.default_rng(6)
    fresh = lambda n: tuple(int(t) for t in rng.integers(0, V, n))
    first = [fresh(512), fresh(300), fresh(150), fresh(64)]
    return first, [first[0][:256] + fresh(8), first[0][:256] + fresh(8)]


def serving_phase(bundle, params, cfg, traffic, device_blocks):
    """The paged mode at full width: the two batches of ``traffic`` in two
    ``run_batch`` calls, 16 new tokens per request, block_size 16; every
    request finished, the second call reused a cached prefix, nothing
    failed closed.  Then one more request under the profiler for the
    device busy share.  Returns the event log, the metrics and the first
    batch's prompts."""
    from repro_torch.serving.engine import ServingEngine

    V = cfg.vocab_size
    batches = traffic(V)
    eng = ServingEngine(bundle, params, block_size=16, device_blocks=device_blocks,
                        device=bundle.device)
    # time the page-store mirror uploads (the engine re-uploads the whole
    # host page store to the card after any page write)
    uploads = {"s": 0.0, "n": 0}
    mirror = eng._device_pages

    def timed_mirror():
        before = eng._pages_mirror
        torch.cuda.synchronize()
        t = time.monotonic()
        out = mirror()
        torch.cuda.synchronize()
        if before is None or before[1] is not out[0]:
            uploads["n"] += 1
            uploads["s"] += time.monotonic() - t
        return out

    eng._device_pages = timed_mirror
    torch.cuda.reset_peak_memory_stats()
    t0 = time.monotonic()
    reqs, ttft, hits = [], [], [eng.prefix_reuse_hits.value()]
    for batch in batches:
        rs = [eng.submit(p, max_new_tokens=16) for p in batch]
        tb = time.monotonic()
        eng.run_batch(rs)
        torch.cuda.synchronize()
        ttft += [r.first_token_ts - tb for r in rs if r.first_token_ts is not None]
        reqs += rs
        hits.append(eng.prefix_reuse_hits.value())
    wall = time.monotonic() - t0
    name = cfg.name
    for r in reqs:
        check(r.status == "finished", f"{name} {r.request_id}: {r.status} ({r.error})")
        check(len(r.output_tokens) == 16, f"{name} {r.request_id}: {len(r.output_tokens)} tokens")
        check(all(0 <= t < V for t in r.output_tokens), f"{name} {r.request_id}: token out of range")
    check(hits[2] > hits[1], f"{name}: the second call had no prefix reuse hit ({hits})")
    check(not eng.fail_closed_total(), f"{name} fail-closed outcomes: {eng.fail_closed_total()}")
    n_out = sum(len(r.output_tokens) for r in reqs)
    ttft = sorted(ttft)
    print(f"serving {name} full width: {len(reqs)} requests finished, {n_out} tokens in "
          f"{wall:.3f} s ({n_out / wall:.1f} tok/s incl. prefill), TTFT median "
          f"{ttft[len(ttft) // 2] * 1e3:.1f} ms max {ttft[-1] * 1e3:.1f} ms, prefix reuse hits "
          f"{hits[2] - hits[0]:.0f} ({hits[2] - hits[1]:.0f} in the second call), peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB on {torch.cuda.get_device_name(0)}")
    stage = {k: sum(eng.stage_seconds.samples(stage=k)) for k in ("prefill_chunk", "decode_step")}
    n_steps = len(eng.events.named("step_scheduled"))
    print(f"{name} serving time: wall {wall:.3f} s over {n_steps} steps = decode/feed launches "
          f"{stage['decode_step']:.3f} s + prefill chunks {stage['prefill_chunk']:.3f} s + "
          f"page-store uploads {uploads['s']:.3f} s ({uploads['n']} x "
          f"{eng.pool.k_pages.numel() * 2 * eng.pool.k_pages.element_size() / 2**20:.0f} MiB) + "
          f"other host work {wall - sum(stage.values()) - uploads['s']:.3f} s")
    # one more request under the profiler: how busy the card is on this path
    extra = eng.submit(tuple(int(t) for t in np.random.default_rng(5).integers(0, V, 64)),
                       max_new_tokens=8)
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        t = time.monotonic()
        eng.run_batch([extra])
        torch.cuda.synchronize()
        w = time.monotonic() - t
    check(extra.status == "finished", f"profiled request {extra.status}")
    avg = prof.key_averages()
    busy = sum(getattr(e, "self_device_time_total", 0.0) for e in avg) / 1e6
    print(f"{name} profiled request (64-token prompt, 8 new tokens): wall {w:.3f} s, device busy "
          f"{busy:.3f} s ({100 * busy / w:.1f}%), {sum(e.count for e in avg)} device ops")
    top = sorted(avg, key=lambda e: -getattr(e, "self_device_time_total", 0.0))[:6]
    for e in top:  # where the device time of the request went, by kernel
        us = getattr(e, "self_device_time_total", 0.0)
        print(f"    {us / 1e3:.3f} ms ({100 * us / 1e6 / max(busy, 1e-12):.1f}% of busy) x{e.count} "
              f"{e.key[:80]}")
    eng.close()
    return eng.events, eng.metrics, batches[0]


def dense_phase(bundle, params, cfg):
    """The dense decode mode at full width: a first batch of four fresh
    prompts (full-length K5 prefills), a second batch of two prompts that
    hit the first prompt's 256-token prefix (gather-to-dense, 8 replayed
    tokens each), 16 new tokens per request; then a prompt too long for the
    cache, refused fail-closed."""
    from repro_torch.serving.engine import ServingEngine

    rng = np.random.default_rng(2)
    V = cfg.vocab_size
    fresh = lambda n: tuple(int(t) for t in rng.integers(0, V, n))
    first = [fresh(512), fresh(300), fresh(150), fresh(64)]
    second = [first[0][:256] + fresh(8), first[0][:256] + fresh(8)]
    eng = ServingEngine(bundle, params, block_size=16, device_blocks=192, cache_len=DENSE_CACHE_LEN,
                        decode_mode="dense", device=bundle.device)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.monotonic()
    reqs, ttft = [], []
    for batch in (first, second):
        rs = [eng.submit(p, max_new_tokens=16) for p in batch]
        tb = time.monotonic()
        eng.run_batch(rs)
        torch.cuda.synchronize()
        ttft += [r.first_token_ts - tb for r in rs if r.first_token_ts is not None]
        reqs += rs
    wall = time.monotonic() - t0
    for r in reqs:
        check(r.status == "finished", f"dense {r.request_id}: {r.status} ({r.error})")
        check(len(r.output_tokens) == 16, f"dense {r.request_id}: {len(r.output_tokens)} tokens")
        check(all(0 <= t < V for t in r.output_tokens), f"dense {r.request_id}: token out of range")
    check([r.cached_tokens for r in reqs[4:]] == [256, 256], "dense second batch missed the prefix")
    check(not eng.fail_closed_total(), f"dense fail-closed outcomes: {eng.fail_closed_total()}")
    n_out = sum(len(r.output_tokens) for r in reqs)
    ttft = sorted(ttft)
    peak = torch.cuda.max_memory_allocated() / 2**30
    stage = {k: sum(eng.stage_seconds.samples(stage=k)) for k in ("prefill", "decode_step")}
    print(f"dense serving qwen3-1.7b full width: {len(reqs)} requests finished, {n_out} tokens in "
          f"{wall:.3f} s ({n_out / wall:.1f} tok/s incl. prefill), TTFT median "
          f"{ttft[len(ttft) // 2] * 1e3:.1f} ms max {ttft[-1] * 1e3:.1f} ms, peak device memory "
          f"{peak:.2f} GiB")
    print(f"dense serving time: wall {wall:.3f} s = prefill (K5) {stage['prefill']:.3f} s "
          f"({len(eng.stage_seconds.samples(stage='prefill'))} launches) + decode steps "
          f"{stage['decode_step']:.3f} s ({len(eng.stage_seconds.samples(stage='decode_step'))} "
          f"steps) + other host work (cache gather, replayed tokens, page stores) "
          f"{wall - sum(stage.values()):.3f} s")
    # one more request under the profiler: how busy the card is on this path
    extra = eng.submit(fresh(150), max_new_tokens=8)
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        t = time.monotonic()
        eng.run_batch([extra])
        torch.cuda.synchronize()
        w = time.monotonic() - t
    check(extra.status == "finished", f"dense profiled request {extra.status}")
    avg = prof.key_averages()
    busy = sum(getattr(e, "self_device_time_total", 0.0) for e in avg) / 1e6
    print(f"dense profiled request (150-token prompt, 8 new tokens): wall {w:.3f} s, device busy "
          f"{busy:.3f} s ({100 * busy / w:.1f}%), {sum(e.count for e in avg)} device ops")
    over = eng.submit(fresh(600), max_new_tokens=64)
    eng.run_batch([over])
    check(over.status == "refused" and over.error.startswith("dense_cache_overflow"),
          f"600 + 64 tokens were not refused: {over.status} ({over.error})")
    check(eng.fail_closed_total() == {"dense_cache_overflow": 1},
          f"overflow refusal not counted: {eng.fail_closed_total()}")
    check(any(e.request_id == over.request_id and e.payload.get("trigger") == "dense_cache_overflow"
              for e in eng.events.named("scheduler_admission_refused")),
          "no dense_cache_overflow event")
    print(f"dense overflow: 600 + 64 tokens > cache_len {DENSE_CACHE_LEN} refused fail-closed "
          f"({over.error})")
    eng.close()
    return first[0]


def dense_checks(bundle, params, cfg, served_prompt):
    """Full-width cross-checks of the K5 prefills against the K2 chunked
    path, witness path A in dense mode against the paged engine, and K4
    over a served request's dense cache against ``attention_decode``."""
    from repro_torch.core.claims import ClaimMode, ClaimState
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.serving.engine import ServingEngine

    rng = np.random.default_rng(3)
    V = cfg.vocab_size
    fresh = lambda n: tuple(int(t) for t in rng.integers(0, V, n))
    dev = bundle.device
    engine = lambda **kw: ServingEngine(bundle, params, block_size=16, device_blocks=64,
                                        cache_len=DENSE_CACHE_LEN, device=dev, **kw)

    prompt = fresh(150)
    n0 = fa.flash_attention.launches
    with engine(decode_mode="dense") as d, engine() as pg:
        compare_logits("dense (K5) vs paged (K2) prefill logits, 150 tokens",
                       d.prefill_logits(prompt), pg.prefill_logits(prompt), V)
    n1 = fa.flash_attention.launches
    with engine() as a, engine(prefill_chunk=0) as b:
        compare_logits("chunked (K2) vs monolithic (K5) prefill logits, 150 tokens",
                       a.prefill_logits(prompt), b.prefill_logits(prompt), V)
    check(n1 > n0, "the dense prefill never launched K5")
    check(fa.flash_attention.launches > n1, "the monolithic prefill never launched K5")

    prefix = fresh(256)
    first, reuse = prefix + fresh(16), prefix + fresh(8)
    restored = {}
    for mode in ("dense", "paged"):
        with engine(decode_mode=mode) as eng:
            claim = eng.accept_claim(prefix, ClaimMode.OFFLOADABLE)
            r1 = eng.run(eng.submit(first, max_new_tokens=1))
            check(r1.status == "finished" and claim.state == ClaimState.MATERIALIZED,
                  f"{mode} path A: claim not materialized ({r1.status}, {claim.state})")
            check(eng.offload_claim(claim.claim_id, request_id=r1.request_id),
                  f"{mode} path A: offload failed")
            restored[mode] = eng.prefill_logits(reuse)
            check(claim.state == ClaimState.RESTORED, f"{mode} path A: claim {claim.state}")
            check(not eng.fail_closed_total(), f"{mode} path A: {eng.fail_closed_total()}")
    compare_logits("witness path A restored prefill logits, dense vs paged",
                   restored["dense"], restored["paged"], V)

    k4_over_dense_cache(bundle, params, cfg, served_prompt)


def k4_over_dense_cache(bundle, params, cfg, served_prompt):
    """K4 over layer 0 of the dense cache of a served prompt, paged out in
    shuffled page order, against the dense mode's ``attention_decode``."""
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.models.layers import attention_decode

    dev = bundle.device
    _, cache = bundle.prefill_fn(
        params, {"tokens": torch.tensor([served_prompt], dtype=torch.int32, device=dev)},
        DENSE_CACHE_LEN)
    k, v, pos = cache["k"][0], cache["v"][0], cache["pos"]  # [1, Sc, KV, D], [1, Sc]
    Sc, KV, D = k.shape[1:]
    H, page = cfg.num_heads, 16
    P = Sc // page
    order = torch.randperm(P, generator=torch.Generator().manual_seed(4))
    pool = lambda t: t[0].reshape(P, page, KV, D).permute(2, 0, 1, 3)[:, torch.argsort(order)].contiguous()
    lengths = torch.tensor([512, 300, 150, 64], dtype=torch.int32, device=dev)
    W = lengths.shape[0]
    bt = order[None].expand(W, P).to(torch.int32).to(dev).contiguous()
    q = torch.randn((W, 1, H, D), generator=torch.Generator(device=dev).manual_seed(5),
                    device=dev).to(k.dtype)
    got = pa.paged_attention(q[:, 0].reshape(W, KV, H // KV, D), pool(k), pool(v), bt, lengths)
    want = attention_decode(q, k.expand(W, -1, -1, -1), v.expand(W, -1, -1, -1),
                            kv_positions=pos.expand(W, -1), cur_pos=lengths - 1)
    torch.cuda.synchronize()
    e = max_err(got.reshape(W, 1, H, D), want)
    print(f"K4 over a served request's dense cache ({cfg.name}, layer 0, lengths 512/300/150/64, "
          f"head_dim {D}) vs attention_decode: max|d|={e:.3e}")
    check(within(got.reshape(W, 1, H, D), want, torch.bfloat16),
          f"K4 disagrees with attention_decode ({e})")


def witness_phase(bundle, params, cfg, paths=("A", "B"), engine_kw=None, warm_reference=False):
    """The claim witness paths at full width: a 256-token claim prefix is
    materialized and offloaded; A restores it through the page copy (the
    reuse request's 16 tokens equal a never-offloaded engine's), B fails
    the same claim's restore and must be refused fail-closed, in order.
    ``engine_kw`` goes to every engine; ``warm_reference`` has the
    never-offloaded engine serve the first request too, so that it reuses
    the prefix as the restored run does (the int8 dense mode, whose reused
    prefix differs from a cold prefill).  Returns path A's page-store
    dtype."""
    from repro_torch.core.analyzer import (
        check_failure_outcome_path,
        check_observation_path,
        validate_event_sequence,
    )
    from repro_torch.core.claims import ClaimMode, ClaimState
    from repro_torch.serving.engine import ServingEngine

    rng = np.random.default_rng(1)
    V = cfg.vocab_size
    prefix = tuple(int(t) for t in rng.integers(0, V, 256))
    first = prefix + tuple(int(t) for t in rng.integers(0, V, 16))
    reuse = prefix + tuple(int(t) for t in rng.integers(0, V, 8))

    kw = dict(block_size=16, device_blocks=64, device=bundle.device, **(engine_kw or {}))
    with ServingEngine(bundle, params, **kw) as plain:
        if warm_reference:
            check(plain.run(plain.submit(first, max_new_tokens=16)).status == "finished",
                  "never-offloaded first request did not finish")
        r_plain = plain.run(plain.submit(reuse, max_new_tokens=16))
        check(r_plain.status == "finished", "never-offloaded run did not finish")

    t0 = time.monotonic()
    outcomes = {}
    page_dtype = None
    for path in paths:
        with ServingEngine(bundle, params, **kw) as eng:
            claim = eng.accept_claim(prefix, ClaimMode.OFFLOADABLE)
            cid = claim.claim_id
            r1 = eng.run(eng.submit(first, max_new_tokens=16))
            check(r1.status == "finished" and claim.state == ClaimState.MATERIALIZED,
                  f"path {path}: claim not materialized ({r1.status}, {claim.state})")
            check(eng.offload_claim(cid, request_id=r1.request_id), f"path {path}: offload failed")
            check(claim.state == ClaimState.OFFLOADED, f"path {path}: claim not offloaded")
            if path == "B":
                eng.connector.injection.resident_claim_load_failure = True
                eng.connector.injection.fail_claim_id = cid
            r2 = eng.run(eng.submit(reuse, max_new_tokens=16))
            order = validate_event_sequence(eng.events)
            check(order.passed, f"path {path}: {order.reasons}")
            if path == "A":
                check(r2.status == "finished", f"path A: reuse request {r2.status} ({r2.error})")
                check(r2.restored_tokens == 256, f"path A: restored {r2.restored_tokens} tokens")
                check(claim.state == ClaimState.RESTORED, f"path A: claim {claim.state}")
                check(r2.output_tokens == r_plain.output_tokens,
                      f"path A: restored tokens {r2.output_tokens} != never-offloaded "
                      f"{r_plain.output_tokens}")
                check(not eng.fail_closed_total(), f"path A fail-closed: {eng.fail_closed_total()}")
                verdict = check_observation_path(eng.events, cid, r2.request_id)
                page_dtype = eng.pool.k_pages.dtype
            else:
                check(r2.status == "refused" and r2.output_tokens == [],
                      f"path B: reuse request {r2.status} with {len(r2.output_tokens)} tokens")
                check(claim.state == ClaimState.RESTORATION_FAILED, f"path B: claim {claim.state}")
                # path A's order holds up to the load job (accept, materialize, store
                # job, store ok, offload, reuse, lookup hit, E6, load job) and stops
                # exactly at the restore transfer, which failed after that load job
                up_to_load = check_observation_path(eng.events, cid, r2.request_id)
                check(up_to_load.reasons == ["no successful tier->device transfer for the claim"],
                      f"path B: observation order before the restore: {up_to_load.reasons}")
                load = min(e.seq for e in eng.events.named("offload_load_job_created")
                           if e.claim_id == cid)
                check(any(e.claim_id == cid and e.payload.get("ok") is False and e.seq > load
                          for e in eng.events.named("offload_worker_transfer_finished")),
                      "path B: no failed restore transfer after the claim's load job")
                check(not any(e.request_id == r2.request_id for e in
                              eng.events.named("offload_request_finished_no_pending_jobs")),
                      "path B served output")
                verdict = check_failure_outcome_path(eng.events, cid, r2.request_id)
            check(verdict.passed, f"path {path}: {verdict.reasons}")
            print(f"witness path {path} analyzer: {verdict.reasons[0]}")
            outcomes[path] = (r2.status, claim.state.value)
    print(f"{cfg.name} witness path A: restored 256 tokens, output equals the never-offloaded run "
          f"({len(r_plain.output_tokens)} tokens), claim {outcomes['A'][1]}, pages {page_dtype}")
    if "B" in paths:
        print(f"{cfg.name} witness path B: request {outcomes['B'][0]}, claim {outcomes['B'][1]}, "
              f"ordered E11 -> E12 -> E13 -> E14 -> FINISHED_ERROR")
    print(f"{cfg.name} witness paths {'/'.join(paths)}: {time.monotonic() - t0:.3f} s")
    return page_dtype


# ---------------------------------------------------------------- phase 15
def int8_phase(params, cfg):
    """int8 KV at full width on qwen3-1.7b's parameters
    (``cfg.replace(kv_cache_dtype="int8")``: no weights drawn again).  The
    int8 bundle has no paged entry points, so ``ServingEngine`` lands in the
    dense mode: phase 3's eight requests beside a bf16 dense engine on the
    same traffic (greedy tokens' agreement, the first prefill and decode
    logits' max |d|), witness paths A (restored tokens equal a
    never-offloaded int8 engine's that reused the same prefix; int8 pages
    through K3) and B; the reference's int8 prefix-reuse finding at full
    width (a reused prefix comes back with zero scales: reuse-versus-cold
    max |d| for int8 and for bf16); and one request's dense cache bytes."""
    from repro_torch.models.registry import build_model
    from repro_torch.serving.engine import ServingEngine

    cfg8 = cfg.replace(kv_cache_dtype="int8")
    bundles = {"int8": build_model(cfg8), "bf16": build_model(cfg)}
    check(bundles["int8"].paged_decode_fn is None, "the int8 bundle has paged entry points")
    V = cfg.vocab_size
    kw = dict(block_size=16, device_blocks=192, cache_len=DENSE_CACHE_LEN,
              device=bundles["int8"].device)
    batches = qwen3_traffic(V)
    served = {}
    for label, b in bundles.items():
        mode = {} if label == "int8" else dict(decode_mode="dense")  # int8: the default, paged
        with ServingEngine(b, params, **mode, **kw) as eng:
            check(eng.decode_mode == "dense", f"{label} engine in {eng.decode_mode} mode")
            t0 = time.monotonic()
            reqs = []
            for batch in batches:
                rs = [eng.submit(p, max_new_tokens=16) for p in batch]
                eng.run_batch(rs)
                reqs += rs
            torch.cuda.synchronize()
            wall = time.monotonic() - t0
            for r in reqs:
                check(r.status == "finished", f"{label} dense {r.request_id}: {r.status} ({r.error})")
                check(len(r.output_tokens) == 16, f"{label} dense {r.request_id}: "
                                                  f"{len(r.output_tokens)} tokens")
                check(all(0 <= t < V for t in r.output_tokens), f"{label} dense: token out of range")
            check(not eng.fail_closed_total(), f"{label} dense fail-closed: {eng.fail_closed_total()}")
            n_out = sum(len(r.output_tokens) for r in reqs)
            print(f"{label} dense serving qwen3-1.7b full width: {len(reqs)} requests finished, "
                  f"{n_out} tokens in {wall:.3f} s ({n_out / wall:.1f} tok/s incl. prefill), cached "
                  f"tokens {[r.cached_tokens for r in reqs]}, page store {eng.pool.k_pages.dtype}")
            served[label] = reqs
    pairs = [(a, b) for ra, rb in zip(served["int8"], served["bf16"])
             for a, b in zip(ra.output_tokens, rb.output_tokens)]
    same = sum(a == b for a, b in pairs)
    first_equal = sum(ra.output_tokens[0] == rb.output_tokens[0]
                      for ra, rb in zip(served["int8"], served["bf16"]))
    print(f"int8 vs bf16 dense greedy tokens: {same}/{len(pairs)} equal position by position, first "
          f"token equal in {first_equal}/{len(served['int8'])} requests")

    prompt = torch.tensor([batches[0][1]], dtype=torch.int32, device=kw["device"])
    first = {}
    for label, b in bundles.items():
        lg, cache = b.prefill_fn(params, {"tokens": prompt}, DENSE_CACHE_LEN)
        tok = torch.tensor([int(batches[0][1][-1])], dtype=torch.int32, device=kw["device"])
        lg2, _ = b.decode_fn(params, cache, tok, torch.tensor([prompt.shape[1]], dtype=torch.int32,
                                                              device=kw["device"]))
        first[label] = (lg.float().cpu(), lg2.float().cpu())
        check(bool(torch.isfinite(lg2).all()), f"{label} decode logits not finite")
    e_pre = max_err(first["int8"][0], first["bf16"][0])
    e_dec = max_err(first["int8"][1], first["bf16"][1])
    print(f"int8 vs bf16 first logits ({prompt.shape[1]}-token prompt): prefill max|d|={e_pre:.3e} "
          f"(the cache is not read yet), first decode step max|d|={e_dec:.3e}, argmax "
          f"{int(first['int8'][1].argmax())} vs {int(first['bf16'][1].argmax())}")
    check(bool(torch.allclose(first["int8"][1], first["bf16"][1], atol=0.35, rtol=0.1)),
          f"int8 decode logits stray from bf16's past tests/test_int8_kv.py's bounds ({e_dec})")

    page_dtype = witness_phase(bundles["int8"], params, cfg8,
                               engine_kw=dict(cache_len=DENSE_CACHE_LEN), warm_reference=True)
    check(page_dtype == torch.int8, f"int8 witness path A stored {page_dtype} pages")

    rng = np.random.default_rng(8)
    prefix = tuple(int(t) for t in rng.integers(0, V, 256))
    first_req = prefix + tuple(int(t) for t in rng.integers(0, V, 16))
    reuse = prefix + tuple(int(t) for t in rng.integers(0, V, 8))
    for label, b in bundles.items():
        with ServingEngine(b, params, decode_mode="dense", **kw) as eng:
            eng.run(eng.submit(first_req, max_new_tokens=1))
            reused = eng.prefill_logits(reuse)
        with ServingEngine(b, params, decode_mode="dense", **kw) as eng:
            cold = eng.prefill_logits(reuse)
        check(np.isfinite(reused).all() and np.isfinite(cold).all(), f"{label} logits not finite")
        print(f"prefix reuse vs cold prefill ({label} dense, 256-token prefix + 8): max|d|="
              f"{float(np.abs(reused - cold).max()):.3e}, argmax {reused.argmax()} vs {cold.argmax()}"
              + (" (the reused int8 prefix reads zero scales, as in the reference)"
                 if label == "int8" else ""))
    nbytes = {label: sum(t.nbytes for t in b.make_cache(1, DENSE_CACHE_LEN).values())
              for label, b in bundles.items()}
    print(f"dense cache of one request ({DENSE_CACHE_LEN} slots, {cfg.num_layers} layers): int8 {nbytes['int8']:,} "
          f"bytes (values and scales) vs bf16 {nbytes['bf16']:,} bytes "
          f"({nbytes['int8'] / nbytes['bf16']:.3f}x)")


# ---------------------------------------------------------------- phase 16
def whisper_phase(bundle, params, cfg):
    """whisper-small at full width and depth through its bundle's entry
    points: ``prefill_fn`` on 4 segments of 1500 seeded frame embeddings
    (the stub frontend) with 64-token seeded prompts and ``cache_len`` 448
    (K5 exactly encoder_layers + 2 * num_layers = 36 times: encoder,
    decoder self-attention, cross attention), then 32 greedy ``decode_fn``
    steps; a 65-token prefill against the 64-token prefill plus one
    teacher-forced decode step; the stage split (encode, decoder prefill,
    decode) and one profiled prefill's device busy share."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models import whisper as wl

    dev = bundle.device
    # as many frames as cross-cache rows (1500): decode attends every row
    B, T, S, steps = 4, cfg.cross_attend_len, 64, 32
    g = torch.Generator(device=dev).manual_seed(7)
    frames = torch.randn((B, T, cfg.d_model), generator=g, device=dev).to(torch.bfloat16)
    tokens = torch.randint(0, cfg.vocab_size, (B, S + 1), generator=g, device=dev, dtype=torch.int32)
    batch = {"frames": frames, "tokens": tokens[:, :S]}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    n0 = fa.flash_attention.launches
    t0 = time.monotonic()
    logits, cache0 = bundle.prefill_fn(params, batch, wl.DEC_LEN)
    torch.cuda.synchronize()
    t_prefill = time.monotonic() - t0
    n_k5 = fa.flash_attention.launches - n0
    want = cfg.encoder_layers + 2 * cfg.num_layers
    check(n_k5 == want, f"whisper prefill launched K5 {n_k5} times, not {want}")
    check(tuple(logits.shape) == (B, cfg.vocab_size) and bool(torch.isfinite(logits).all()),
          f"whisper prefill logits {tuple(logits.shape)} not finite")
    t0 = time.monotonic()
    cache, tok, out = cache0, logits.argmax(-1).int(), []
    for i in range(steps):
        out.append(tok)
        pos = torch.full((B,), S + i, dtype=torch.int32, device=dev)
        logits, cache = bundle.decode_fn(params, cache, tok, pos)
        tok = logits.argmax(-1).int()
    torch.cuda.synchronize()
    t_decode = time.monotonic() - t0
    check(bool(torch.isfinite(logits).all()), "whisper decode logits not finite")
    gen = torch.stack(out, 1).cpu()
    check(bool(((gen >= 0) & (gen < cfg.vocab_size)).all()), "whisper token out of range")
    peak = torch.cuda.max_memory_allocated() / 2**30
    print(f"whisper-small full width and depth: {B} segments x {T} frames + {S} tokens, prefill "
          f"{t_prefill:.3f} s (K5 {n_k5} launches), {steps} greedy decode steps {t_decode:.3f} s "
          f"({B * steps / t_decode:.1f} tok/s), peak device memory {peak:.2f} GiB; first tokens "
          f"{gen[:, :6].tolist()}")

    l65, _ = bundle.prefill_fn(params, {"frames": frames, "tokens": tokens}, wl.DEC_LEN)
    l_tf, _ = bundle.decode_fn(params, cache0, tokens[:, S].contiguous(),
                               torch.full((B,), S, dtype=torch.int32, device=dev))
    e = max_err(l_tf, l65)
    agree = int((l_tf.argmax(-1) == l65.argmax(-1)).sum())
    print(f"whisper teacher-forced check: 65-token prefill vs 64-token prefill + one decode step, "
          f"max|d|={e:.3e} (limit 3e-2 + 3e-2 relative, the CPU tests' cross-graph tolerance), "
          f"argmax equal in {agree}/{B} rows")
    check(bool(torch.allclose(l_tf.float(), l65.float(), rtol=3e-2, atol=3e-2)),
          f"whisper decode disagrees with its prefill ({e})")

    with torch.no_grad():
        torch.cuda.synchronize()
        t0 = time.monotonic()
        enc = wl.encode(params, cfg, frames)
        torch.cuda.synchronize()
        t_enc = time.monotonic() - t0
        t0 = time.monotonic()
        wl.decode_prefill(params, cfg, tokens[:, :S], enc, collect_cache=True)
        torch.cuda.synchronize()
        t_dec = time.monotonic() - t0
    print(f"whisper stage seconds: encode {t_enc:.4f} s, decoder prefill {t_dec:.4f} s, "
          f"{steps} decode steps {t_decode:.4f} s ({1e3 * t_decode / steps:.2f} ms per step)")
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        t0 = time.monotonic()
        bundle.prefill_fn(params, batch, wl.DEC_LEN)
        torch.cuda.synchronize()
        w = time.monotonic() - t0
    avg = prof.key_averages()
    busy = sum(getattr(e, "self_device_time_total", 0.0) for e in avg) / 1e6
    print(f"whisper profiled prefill: wall {w:.3f} s, device busy {busy:.3f} s "
          f"({100 * busy / w:.1f}%), {sum(e.count for e in avg)} device ops")
    for e in sorted(avg, key=lambda e: -getattr(e, "self_device_time_total", 0.0))[:5]:
        us = getattr(e, "self_device_time_total", 0.0)
        print(f"    {us / 1e3:.3f} ms ({100 * us / 1e6 / max(busy, 1e-12):.1f}% of busy) x{e.count} "
              f"{e.key[:80]}")


# ---------------------------------------------------------------- phase 17
# Training: the reference's training forward runs no Pallas kernel (plain
# chunked attention under jax.checkpoint), so none of K1-K5 may launch in a
# training step; the trained weights are then served through K1 and K2.
TRAIN_STEPS = 6
# lr 3e-4 with warm-up 2 diverged at full width and depth on the card
# (losses 12.50, 11.99, 15.45, 9.64, 18.25, 15.71; PERF.md), as the first
# steps of a deep model from random weights may without a long warm-up;
# 3e-5 falls in these 6 steps
TRAIN_LR = 3e-5
TRAIN_BATCH = 4  # TRAIN_4K's global batch of 256, cut to what one card takes without accumulation
TRAIN_SEQ = 4096  # TRAIN_4K's length
OTHER_FAMILIES = {  # (d): name -> (layers or None for full depth, batch, tokens, frontend rows)
    "whisper-small": (None, 2, 448, 1500),
    "hymba-1.5b": (4, 2, 512, 0),
    "xlstm-350m": (8, 2, 256, 0),
    "phi-3-vision-4.2b": (4, 2, 64, 576),
}


def _finite(t) -> bool:
    return bool(torch.isfinite(t).all())


def _device_time(prof):
    """(busy seconds, the top device ops by time) of a CUDA-only profile."""
    avg = prof.key_averages()
    busy = sum(getattr(e, "self_device_time_total", 0.0) for e in avg) / 1e6
    top = sorted(avg, key=lambda e: -getattr(e, "self_device_time_total", 0.0))
    return busy, top, sum(e.count for e in avg)


def train_full_width():
    """(a) qwen3-1.7b at full width and depth: ``Trainer`` (f32 masters and
    moments, lr 3e-5, warm-up 2) on ``SyntheticLM`` batches of 4 x 4096
    tokens for 6 steps; the first loss within 0.5 of an untrained model's,
    every loss and grad norm finite, the mean of the last 3 losses below
    the first; then
    one more step under the profiler, its two halves timed apart.  Returns
    the trainer (its masters are served in (c))."""
    from repro_torch.configs import get_config
    from repro_torch.models.registry import build_model
    from repro_torch.training.data import DataConfig
    from repro_torch.training.optimizer import AdamWConfig
    from repro_torch.training.train_loop import Trainer

    cfg = get_config("qwen3-1.7b")
    print(f"training qwen3-1.7b full width and depth ({cfg.num_layers} layers, "
          f"{cfg.param_count() / 1e9:.3f} B params): batch {TRAIN_BATCH} x {TRAIN_SEQ} tokens "
          f"(TRAIN_4K's global batch 256 cut to {TRAIN_BATCH}: one card, no accumulation)")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.monotonic()
    tr = Trainer(build_model(cfg), data_cfg=DataConfig(cfg.vocab_size, TRAIN_SEQ, TRAIN_BATCH),
                 opt_cfg=AdamWConfig(lr=TRAIN_LR, warmup_steps=2), seed=0)
    torch.cuda.synchronize()
    print(f"trainer state on the card in {time.monotonic() - t0:.1f} s: "
          f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB (f32 masters, m, v)")
    metrics = tr.run(TRAIN_STEPS, log_every=1)
    losses = [m["loss"] for m in metrics]
    norms = [m["grad_norm"] for m in metrics]
    ln_v = math.log(cfg.vocab_size)
    # an untrained model's loss: ln V + sigma^2 / 2 for logits of std sigma,
    # here 0.02 * sqrt(d) (the tied embedding's N(0, 0.02^2) init against the
    # RMS-normed final state), 0.41 above ln V at qwen3-1.7b's width
    untrained = ln_v + 0.02 ** 2 * cfg.d_model / 2
    check(all(math.isfinite(x) for x in losses + norms), f"non-finite loss or grad norm: {metrics}")
    check(abs(losses[0] - untrained) <= 0.5,
          f"first loss {losses[0]:.4f} not within 0.5 of ln V + sigma^2/2 = {untrained:.4f}")
    check(np.mean(losses[-3:]) < losses[0], f"loss did not fall: {losses}")
    dts = sorted(m["dt_s"] for m in metrics[1:])
    step_s = dts[len(dts) // 2]
    tokens = TRAIN_BATCH * TRAIN_SEQ
    mfu = 6 * cfg.param_count() * tokens / step_s / H100_BF16_FLOPS
    peak = torch.cuda.max_memory_allocated() / 2**30
    print(f"training losses {[round(x, 4) for x in losses]} (ln V = {ln_v:.4f}, untrained "
          f"{untrained:.4f}), grad norms "
          f"{[round(x, 3) for x in norms]}")
    print(f"training qwen3-1.7b: median step {step_s:.3f} s over steps 2-{TRAIN_STEPS} "
          f"(first {metrics[0]['dt_s']:.3f} s), {tokens / step_s:.0f} tokens/s, MFU "
          f"{100 * mfu:.2f}% (6 x {cfg.param_count() / 1e9:.3f} B x {tokens} tokens per step over "
          f"989 TFLOP/s), peak device memory {peak:.2f} GiB on {torch.cuda.get_device_name(0)}")

    batch = tr.batch_at(tr.step)
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        t0 = time.monotonic()
        loss, grads = tr.loss_and_grads(batch)
        torch.cuda.synchronize()
        t1 = time.monotonic()
        m = tr.apply_grads(grads)
        torch.cuda.synchronize()
        t2 = time.monotonic()
    del grads
    check(_finite(loss) and _finite(m["grad_norm"]), "the profiled step is not finite")
    busy, top, n_ops = _device_time(prof)
    print(f"training profiled step: wall {t2 - t0:.3f} s = loss and grads {t1 - t0:.3f} s + "
          f"AdamW update {t2 - t1:.3f} s; device busy {busy:.3f} s ({100 * busy / (t2 - t0):.1f}%), "
          f"{n_ops} device ops")
    gemm = sum(getattr(e, "self_device_time_total", 0.0) for e in top
               if any(w in e.key.lower() for w in ("nvjet", "gemm", "cutlass", "xmma"))) / 1e6
    print(f"training profiled step by kind: matrix products (cuBLAS kernels) {gemm:.3f} s "
          f"({100 * gemm / max(busy, 1e-12):.1f}% of busy), everything else (elementwise, casts, "
          f"reductions, copies) {busy - gemm:.3f} s")
    for e in top[:8]:  # where the step's device time went, by kernel
        us = getattr(e, "self_device_time_total", 0.0)
        print(f"    {us / 1e3:.1f} ms ({100 * us / 1e6 / max(busy, 1e-12):.1f}% of busy) x{e.count} "
              f"{e.key[:80]}")
    return tr


def serve_trained(tr):
    """(c) The trained masters cast to bf16 and served by a paged engine:
    2 requests (64-token prompts from the training stream) of 16 tokens,
    every one finished, nothing failed closed (K1 and K2 must launch)."""
    from repro_torch.serving.engine import ServingEngine
    from repro_torch.training.tree import map_tree

    params = map_tree(lambda p: p.to(torch.bfloat16), tr.params)
    bundle, V = tr.bundle, tr.cfg.vocab_size
    prompts = [tuple(int(t) for t in row[:64]) for row in tr.data.batch_at(100)["tokens"][:2]]
    with ServingEngine(bundle, params, block_size=16, device_blocks=64, device=bundle.device) as eng:
        reqs = [eng.submit(p, max_new_tokens=16) for p in prompts]
        t0 = time.monotonic()
        eng.run_batch(reqs)
        torch.cuda.synchronize()
        wall = time.monotonic() - t0
        for r in reqs:
            check(r.status == "finished" and len(r.output_tokens) == 16,
                  f"trained-weights request {r.request_id}: {r.status} ({r.error})")
            check(all(0 <= t < V for t in r.output_tokens), "trained-weights token out of range")
        check(not eng.fail_closed_total(), f"fail-closed outcomes: {eng.fail_closed_total()}")
    print(f"train-then-serve: the trained masters as bf16, 2 requests x 16 tokens finished in "
          f"{wall:.3f} s, no fail-closed outcome; first tokens {[r.output_tokens[:6] for r in reqs]}")


def restart_drill():
    """(b) Full width, 2 of 28 layers (a full-depth checkpoint would write
    about 20 GB): train 4 steps with async checkpoints every 2, resume a
    fresh trainer at step 4 and run it to step 7, and hold its losses
    against an uninterrupted 7-step run's (bitwise, else within 1e-3).
    Then the checkpoint's bytes and the save seconds, sync and async.
    Everything is written into a temporary directory that is removed."""
    from repro_torch.configs import get_config
    from repro_torch.models.registry import build_model
    from repro_torch.training.checkpoint import latest_checkpoint, save_checkpoint
    from repro_torch.training.data import DataConfig
    from repro_torch.training.optimizer import AdamWConfig
    from repro_torch.training.train_loop import Trainer

    cfg = get_config("qwen3-1.7b")
    cfg = cfg.replace(num_layers=2)
    print(f"restart drill: qwen3-1.7b full width, depth cut to 2 of 28 layers "
          f"({cfg.param_count() / 1e9:.3f} B params), batch 2 x 1024 tokens")
    bundle = build_model(cfg)
    tmp = Path(tempfile.mkdtemp(prefix="train-drill-"))
    try:
        def trainer(**kw):
            return Trainer(bundle, data_cfg=DataConfig(cfg.vocab_size, 1024, 2),
                           opt_cfg=AdamWConfig(lr=TRAIN_LR, warmup_steps=2), seed=0, **kw)

        a = trainer(ckpt_dir=tmp / "run", ckpt_every=2, async_ckpt=True)
        a.run(4, log_every=0)
        check(latest_checkpoint(tmp / "run").name == "step-00000004", "no step-4 checkpoint")
        b = trainer(ckpt_dir=tmp / "run")
        check(b.resume() and b.step == 4, "the fresh trainer did not resume at step 4")
        b.run(7, log_every=0)
        c = trainer()
        c.run(7, log_every=0)
        lb = [m["loss"] for m in b.metrics]
        lc = [m["loss"] for m in c.metrics[4:]]
        d = max(abs(x - y) for x, y in zip(lb, lc))
        check([m["loss"] for m in a.metrics] == [m["loss"] for m in c.metrics[:4]],
              "two trainers of one seed disagree before the restart")
        print(f"restart drill: resumed losses {lb} vs uninterrupted {lc}: "
              f"{'bitwise equal' if lb == lc else f'max |d| {d:.3e} (limit 1e-3)'}")
        check(d <= 1e-3, f"resumed run diverged from the uninterrupted run ({d})")
        state = {"params": a.params, "opt": a.opt_state}
        torch.cuda.synchronize()
        t0 = time.monotonic()
        path = save_checkpoint(tmp / "sync", a.step, state)
        t_sync = time.monotonic() - t0
        nbytes = (path / "state.npz").stat().st_size
        shutil.rmtree(tmp / "sync")
        t0 = time.monotonic()
        a.ckpt.save(tmp / "async", a.step, state)
        t_snap = time.monotonic() - t0
        a.ckpt.wait()
        t_async = time.monotonic() - t0
        print(f"restart drill checkpoint: {nbytes} bytes (f32 masters, m and v); save sync "
              f"{t_sync:.3f} s; async {t_snap:.3f} s blocking (the host snapshot) + "
              f"{t_async - t_snap:.3f} s on the writer thread")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def train_other_families():
    """(d) One ``Trainer`` step of every other family the card holds, at
    full width (depth cuts printed), seeded frontend embeddings beside the
    tokens where the family takes them: losses and grad norms finite.  The
    MoE configs train on the CPU only: the training state of one
    full-width layer exceeds the card (printed)."""
    from repro_torch.configs import get_config
    from repro_torch.models.registry import build_model
    from repro_torch.training.data import DataConfig
    from repro_torch.training.optimizer import AdamWConfig
    from repro_torch.training.train_loop import Trainer

    card_gb = torch.cuda.get_device_properties(0).total_memory / 1e9
    for name in ("grok-1-314b", "arctic-480b"):
        cfg = get_config(name)
        per_layer = cfg.replace(num_layers=1).param_count() - cfg.replace(num_layers=0).param_count()
        print(f"{name} trains on the CPU only: one full-width layer holds {per_layer / 1e9:.3f} B "
              f"params, {20 * per_layer / 1e9:.1f} GB of training state at 20 bytes each (f32 "
              f"masters, m and v, bf16 casts and grads, f32 grads), over the card's {card_gb:.1f} GB")
    for name, (layers, B, S, n_front) in OTHER_FAMILIES.items():
        gc.collect()
        torch.cuda.empty_cache()
        cfg = get_config(name)
        cut = "full depth" if layers is None else f"{layers} of {cfg.num_layers} layers"
        if layers is not None:
            cfg = cfg.replace(num_layers=layers)
        torch.cuda.reset_peak_memory_stats()
        tr = Trainer(build_model(cfg), data_cfg=DataConfig(cfg.vocab_size, S, B),
                     opt_cfg=AdamWConfig(lr=TRAIN_LR, warmup_steps=2), seed=0)
        batch = tr.batch_at(0)
        if n_front:
            key = "frames" if cfg.frontend == "audio_frames" else "patch_embeds"
            g = torch.Generator(device=tr.device).manual_seed(11)
            batch[key] = torch.randn((B, n_front, cfg.d_model), generator=g,
                                     device=tr.device).to(torch.bfloat16)
        torch.cuda.synchronize()
        t0 = time.monotonic()
        m = tr.train_step(batch)
        loss, gn = float(m["loss"]), float(m["grad_norm"])
        dt = time.monotonic() - t0
        check(math.isfinite(loss) and math.isfinite(gn), f"{name}: loss {loss} grad norm {gn}")
        front = f" + {n_front} frontend rows" if n_front else ""
        print(f"training {name} full width, {cut}: one step of {B} x {S} tokens{front} in "
              f"{dt:.3f} s, loss {loss:.4f} (ln V {math.log(cfg.vocab_size):.4f}), grad norm "
              f"{gn:.3f}, peak {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
        del tr, batch, m


# ----------------------------------------------------------------- phases 8-9
WIDE_DEVICE_BLOCKS = 128  # per layer: 10 MiB of stablelm-12b pages, 32 MiB of deepseek-7b's
# Phases 8-9 run at full width but cut depth, so the snapshot phases 10-11
# fit in the smoke's time (the models serve at full depth too; the cut saves time only).
WIDE_DEPTH = {"stablelm-12b": 10, "deepseek-7b": 8}


# ---------------------------------------------------------------- phase 18
# Distribution on a one-rank NCCL group over a 1 x 1 (data, model) mesh:
# the sharded steps of launch/steps.py on DTensors, at qwen3-1.7b's full
# width and depth, held against the unsharded paths; the sharded prefill's
# attention body launches K5; then the dry run's fake-backend cells, which
# run in subprocesses started at the smoke's beginning (CPU only: the fake
# backend cannot share this process's default group with NCCL).
DIST_STEPS = 3
DIST_PREFILL = (4, 2048)  # PREFILL_32K's 32 x 32768 cut: its cache alone is ~120 GB at 28 layers
DIST_DECODE = (8, 4096, 4)  # rows, cache slots, steps (DECODE_32K's 128 x 32768 cut)
DRYRUN_CELLS = (("qwen3-1.7b", "train_4k", "single"), ("qwen3-1.7b", "decode_32k", "single"),
                ("grok-1-314b", "train_4k", "multi"))
_CHILDREN = []


def _stop_children():
    for p in _CHILDREN:
        if p.poll() is None:
            p.kill()
            p.wait()


def start_dryruns():
    """(f) The three dry-run cells, each in a subprocess of its own, started
    now and collected in phase 18.  Returns (out dir, [(cell, process,
    start time)])."""
    import atexit

    atexit.register(_stop_children)
    out = Path(tempfile.mkdtemp(prefix="dryrun_"))
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="2")
    procs = []
    for arch, shape, mesh in DRYRUN_CELLS:
        log = open(out / f"{arch}__{shape}__{mesh}.log", "w")
        p = subprocess.Popen([sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", arch,
                              "--shape", shape, "--mesh", mesh, "--out", str(out), "--force"],
                             stdout=log, stderr=subprocess.STDOUT, env=env, cwd=str(ROOT))
        _CHILDREN.append(p)
        procs.append(((arch, shape, mesh), p, time.monotonic()))
    return out, procs


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _rel(a, b) -> float:
    return abs(a - b) / max(abs(b), 1e-12)


def sharded_training(mesh):
    """(a) ``build_cell("qwen3-1.7b", "train_4k")`` at full width and
    depth, the batch cut to 4 x 4096, seed-0 masters, lr 3e-5 (warm-up 2):
    three sharded steps against ``Trainer.train_step`` from the same
    masters and batches; losses and grad norms within 1e-3 relative.  A
    spec's one-rank axes place ``Shard`` (``sharding.rules.placements``),
    so DTensor picks each op's sharded strategy here as on a larger mesh:
    the check fails where a strategy changes the arithmetic."""
    from repro_torch.configs import ShapeSpec, get_config
    from repro_torch.launch import steps as st
    from repro_torch.models.registry import build_model
    from repro_torch.sharding.rules import full
    from repro_torch.training.data import DataConfig, SyntheticLM
    from repro_torch.training.optimizer import AdamWConfig, init_opt_state
    from repro_torch.training.train_loop import Trainer

    cfg = get_config("qwen3-1.7b")
    opt_cfg = AdamWConfig(lr=TRAIN_LR, warmup_steps=2)
    cell = st.build_cell("qwen3-1.7b", "train_4k", mesh, opt_cfg=opt_cfg,
                         shape=ShapeSpec("train_4k", TRAIN_SEQ, TRAIN_BATCH, "train"))
    masters = {k: v for k, v in cell.bundle.init_params(torch.Generator().manual_seed(0)).items()}
    masters = _f32_tree(masters)
    params = st.distribute_argument(cell, "params", masters)
    opt = st.distribute_argument(cell, "opt_state", init_opt_state(masters, opt_cfg))
    del masters
    shards = {k: tuple(params["layers"]["attn"][k].placements) for k in ("wq", "wo")}
    check(all(p.is_shard() for pl in shards.values() for p in pl),
          f"the 1 x 1 mesh does not shard the attention weights: {shards}")
    data = SyntheticLM(DataConfig(cfg.vocab_size, TRAIN_SEQ, TRAIN_BATCH))
    got = []
    for i in range(DIST_STEPS):
        batch = st.distribute_argument(
            cell, "batch", {k: torch.from_numpy(v).cuda() for k, v in data.batch_at(i).items()})
        torch.cuda.synchronize()
        t0 = time.monotonic()
        params, opt, m = st.run_cell(cell, (params, opt, batch))
        loss = float(full(m["loss"]))
        got.append({"loss": loss, "grad_norm": float(full(m["grad_norm"])),
                    "dt_s": time.monotonic() - t0})
    del params, opt, cell
    gc.collect()
    torch.cuda.empty_cache()
    tr = Trainer(build_model(cfg), data_cfg=DataConfig(cfg.vocab_size, TRAIN_SEQ, TRAIN_BATCH),
                 opt_cfg=opt_cfg, seed=0)
    want = tr.run(DIST_STEPS, log_every=0)
    del tr
    gc.collect()
    torch.cuda.empty_cache()
    rel = max(max(_rel(g["loss"], w["loss"]), _rel(g["grad_norm"], w["grad_norm"]))
              for g, w in zip(got, want))
    print(f"sharded training qwen3-1.7b full width and depth on the 1 x 1 mesh (wq, wo placed "
          f"{shards['wq']}, {shards['wo']}): losses "
          f"{[round(g['loss'], 5) for g in got]} vs Trainer {[round(w['loss'], 5) for w in want]}, "
          f"grad norms {[round(g['grad_norm'], 4) for g in got]} vs "
          f"{[round(w['grad_norm'], 4) for w in want]}: max relative difference {rel:.3e} "
          f"(limit 1e-3)")
    print(f"sharded training step s {[round(g['dt_s'], 3) for g in got]} vs unsharded Trainer "
          f"{[round(w['dt_s'], 3) for w in want]} (phase 17's shape: 4 x 4096 tokens)")
    check(all(math.isfinite(g["loss"]) and math.isfinite(g["grad_norm"]) for g in got),
          f"sharded training not finite: {got}")
    check(rel <= 1e-3, f"sharded training differs from the Trainer by {rel:.3e}")


def _f32_tree(tree):
    if isinstance(tree, dict):
        return {k: _f32_tree(v) for k, v in tree.items()}
    return tree.float() if tree.is_floating_point() else tree


def sharded_serving(mesh):
    """(b) A sharded prefill cell at 4 x 2048 tokens against the unsharded
    ``prefill_fn`` (phase 5's tolerance: max |d| 0.25, the same argmax per
    row); its attention body must launch K5 once per layer.  (c) A sharded
    decode cell of 8 rows over a 4096-slot cache, 4 steps, against the
    unsharded ``decode_fn`` from the same cache, same tolerance."""
    from repro_torch.configs import ShapeSpec, get_config
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.launch import steps as st
    from repro_torch.models.registry import build_model
    from repro_torch.sharding.rules import full

    cfg = get_config("qwen3-1.7b")
    V = cfg.vocab_size
    bundle = build_model(cfg)
    params = bundle.init_params(torch.Generator().manual_seed(0))
    rng = np.random.default_rng(18)
    B, S = DIST_PREFILL
    tokens = torch.from_numpy(rng.integers(0, V, (B, S)).astype(np.int32)).cuda()
    cell = st.build_cell("qwen3-1.7b", "prefill_32k", mesh,
                         shape=ShapeSpec("prefill_32k", S, B, "prefill"))
    pd = st.distribute_argument(cell, "params", params)
    bd = st.distribute_argument(cell, "batch", {"tokens": tokens})
    n0 = fa.flash_attention.launches
    torch.cuda.synchronize()
    t0 = time.monotonic()
    logits_s, cache_s = st.run_cell(cell, (pd, bd))
    logits_s = full(logits_s)
    torch.cuda.synchronize()
    t_sharded = time.monotonic() - t0
    k5 = fa.flash_attention.launches - n0
    t0 = time.monotonic()
    logits_u, cache_u = bundle.prefill_fn(params, {"tokens": tokens}, S)
    torch.cuda.synchronize()
    t_plain = time.monotonic() - t0
    e = max_err(logits_s, logits_u)
    same = bool((logits_s.argmax(-1) == logits_u.argmax(-1)).all())
    ek = max_err(full(cache_s["k"]), cache_u["k"])
    print(f"sharded prefill {B} x {S} tokens: logits max|d| {e:.3e} vs the unsharded prefill_fn "
          f"(limit 0.25), argmax equal {same}, cache k max|d| {ek:.3e}; K5 launches {k5} "
          f"({cfg.num_layers} per call); {t_sharded:.3f} s sharded, {t_plain:.3f} s unsharded")
    check(bool(torch.isfinite(logits_s).all()) and tuple(logits_s.shape) == (B, V),
          "sharded prefill logits")
    check(e <= 0.25 and same, f"sharded prefill disagrees ({e})")
    check(k5 == cfg.num_layers, f"the sharded prefill launched K5 {k5} times, not {cfg.num_layers}")
    del cell, pd, bd, cache_s, cache_u, logits_s, logits_u

    rows, slots, steps = DIST_DECODE
    prompt = torch.from_numpy(rng.integers(0, V, (rows, 64)).astype(np.int32)).cuda()
    logits, cache = bundle.prefill_fn(params, {"tokens": prompt}, slots)
    cell = st.build_cell("qwen3-1.7b", "decode_32k", mesh,
                         shape=ShapeSpec("decode_32k", slots, rows, "decode"))
    pd = st.distribute_argument(cell, "params", params)
    cd = st.distribute_argument(cell, "cache", cache)
    worst, ts, tu = 0.0, [], []
    for i in range(steps):
        tok = logits.argmax(-1).to(torch.int32)
        pos = torch.full((rows,), 64 + i, dtype=torch.int32, device=tok.device)
        args = (pd, cd, st.distribute_argument(cell, "tokens", tok),
                st.distribute_argument(cell, "cur_pos", pos))
        torch.cuda.synchronize()
        t0 = time.monotonic()
        ls, cd = st.run_cell(cell, args)
        ls = full(ls)
        torch.cuda.synchronize()
        ts.append(time.monotonic() - t0)
        t0 = time.monotonic()
        logits, cache = bundle.decode_fn(params, cache, tok, pos)
        torch.cuda.synchronize()
        tu.append(time.monotonic() - t0)
        worst = max(worst, max_err(ls, logits))
        check(bool((ls.argmax(-1) == logits.argmax(-1)).all()), f"sharded decode step {i}: argmax")
    print(f"sharded decode {rows} rows over {slots} slots, {steps} steps: logits max|d| "
          f"{worst:.3e} vs decode_fn (limit 0.25); step s sharded "
          f"{[round(t, 4) for t in ts]}, unsharded {[round(t, 4) for t in tu]}")
    check(worst <= 0.25, f"sharded decode disagrees ({worst})")


def compressed_psum_check(mesh):
    """(d) ``compressed_psum`` over the one-rank group on a full-width f32
    gradient leaf (lm_head's 2048 x 151936): bitwise ``compress_roundtrip``;
    the bytes its two all-gathers move against a bf16 all-reduce's."""
    from repro_torch.roofline.analysis import CollectiveCounter
    from repro_torch.training.compression import compress_roundtrip, compressed_psum

    g = torch.Generator(device="cuda").manual_seed(18)
    x = torch.randn((2048, 151936), generator=g, device="cuda")
    group = mesh.get_group("data")
    compressed_psum(x, group)  # warm
    torch.cuda.synchronize()
    with CollectiveCounter() as c:
        t0 = time.monotonic()
        y = compressed_psum(x, group)
        torch.cuda.synchronize()
        dt = time.monotonic() - t0
    want = compress_roundtrip(x)
    bf16 = x.numel() * 2
    sent = c.bytes["all-gather"]
    print(f"compressed psum of a 2048 x 151936 f32 leaf over the one-rank group: bitwise equal to "
          f"compress_roundtrip {torch.equal(y, want)}; {c.counts['all-gather']} all-gathers, "
          f"{sent} bytes against bf16's {bf16} ({sent / bf16:.3f}x); {dt:.4f} s")
    check(torch.equal(y, want), "compressed_psum differs from compress_roundtrip")


def sharded_moe(mesh):
    """(e) ``moe_apply_sharded`` with ep, tp and a2a on one grok-1-314b
    layer at full width (8 experts of 6144 x 32768) against
    ``moe_apply_local``, 512 bf16 tokens."""
    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch.configs import get_config
    from repro_torch.sharding.rules import distribute
    from repro_torch.models.moe import moe_apply_local, moe_apply_sharded, moe_init

    cfg = get_config("grok-1-314b")
    gen = torch.Generator(device="cuda").manual_seed(0)
    p = moe_init(gen, cfg)
    x = (torch.randn((512, cfg.d_model), generator=gen, device="cuda")).to(torch.bfloat16)
    with torch.no_grad():
        want, aux = moe_apply_local(p, x, cfg)
        rep = lambda t: distribute(t, (None,) * t.ndim, mesh)
        pd = {k: rep(v) for k, v in p.items()}
        for strategy in ("ep", "tp", "a2a"):
            torch.cuda.synchronize()
            t0 = time.monotonic()
            with implicit_replication():
                out, a = moe_apply_sharded(pd, rep(x), cfg, mesh, strategy=strategy)
                out, a = out.full_tensor(), a.full_tensor()
            torch.cuda.synchronize()
            e, ea = max_err(out, want), abs(float(a) - float(aux))
            print(f"sharded MoE grok-1-314b layer, {strategy}: max|d| {e:.3e} vs moe_apply_local "
                  f"(aux |d| {ea:.3e}), {time.monotonic() - t0:.3f} s")
            check(within(out, want, torch.bfloat16) and ea <= 1e-5,
                  f"sharded MoE {strategy} disagrees ({e}, {ea})")
    del p, pd


def collect_dryruns(dryruns):
    """(f) Wait for the dry-run subprocesses; each cell ``ok``, a train
    cell with all-gather bytes."""
    out, procs = dryruns
    for (arch, shape, mesh), p, t0 in procs:
        t_wait = time.monotonic()
        try:
            rc = p.wait(timeout=max(1.0, 1050 - (time.monotonic() - T_START)))
        except subprocess.TimeoutExpired:
            fail(f"dry run {arch} {shape} {mesh} did not finish in time")
        waited = time.monotonic() - t_wait
        if rc != 0:
            print((out / f"{arch}__{shape}__{mesh}.log").read_text()[-3000:])
            fail(f"dry run {arch} {shape} {mesh} exited {rc}")
        rec = json.loads((out / mesh / f"{arch}__{shape}.json").read_text())
        coll = rec["collectives"]
        kinds = {k: (v["count"], v["bytes"]) for k, v in coll.items() if isinstance(v, dict)}
        print(f"dry run {arch} x {shape} x {mesh} ({rec['chips']} fake ranks): {rec['status']}, "
              f"build {rec['timing']['build_s']:.1f} s + run {rec['timing']['run_s']:.1f} s (started "
              f"with the smoke; phase 18 waited {waited:.1f} s for it); per device "
              f"(count, bytes) {kinds}; args {rec['memory']['argument_bytes_per_device']} B")
        check(rec["status"] == "ok", f"dry run {arch} {shape} {mesh}: {rec['status']}")
        if shape == "train_4k":
            check(coll["all-gather"]["bytes"] > 0, f"dry run {arch} {shape}: no all-gather bytes")
    shutil.rmtree(out, ignore_errors=True)


def distribution_phase(dryruns):
    import torch.distributed as dist

    from repro_torch.launch.mesh import init_group, make_debug_mesh

    init_group("nccl", rank=0, world_size=1, port=_free_port())
    try:
        mesh = make_debug_mesh(1, 1)
        print(f"distribution: one-rank NCCL group, mesh "
              f"{dict(zip(mesh.mesh_dim_names, mesh.shape))} on {mesh.device_type}; torch "
              f"{torch.__version__} (the dry run's FakeStore and local_map were written against "
              f"torch 2.13.0, requirements.txt)")
        sharded_training(mesh)
        sharded_serving(mesh)
        compressed_psum_check(mesh)
        sharded_moe(mesh)
    finally:
        dist.destroy_process_group()
    collect_dryruns(dryruns)


def compare_logits(label, la, lb, V):
    """Two prefill logit vectors of one prompt: finite, within 0.25 (bf16
    activations through other kernels and graphs), and the same argmax."""
    e = float(np.abs(la - lb).max())
    print(f"{label}: max|d|={e:.3e} (limit 0.25), argmax {la.argmax()} vs {lb.argmax()}")
    check(np.isfinite(la).all() and la.shape == (V,), f"{label}: bad logits")
    check(e <= 0.25, f"{label}: disagree ({e})")
    check(la.argmax() == lb.argmax(), f"{label}: different tokens")


def load_model(name, layers=None):
    """Full-width ``name`` on the card, weights from seed 0; full depth
    unless ``layers`` cuts it (the cut is printed)."""
    from repro_torch.configs import get_config
    from repro_torch.models.registry import build_model

    cfg = get_config(name)
    if layers is not None:
        print(f"{name}: depth cut to {layers} of {cfg.num_layers} layers (full width) to keep "
              "the smoke's time")
        cfg = cfg.replace(num_layers=layers)
    bundle = build_model(cfg)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.monotonic()
    params = bundle.init_params(torch.Generator().manual_seed(0))
    torch.cuda.synchronize()
    n = sum(t.numel() for t in _leaves(params))
    print(f"{name} params: {n / 1e9:.3f} B ({cfg.num_layers} layers, head_dim "
          f"{cfg.resolved_head_dim}, {cfg.num_heads} heads over {cfg.num_kv_heads}) on the card in "
          f"{time.monotonic() - t0:.1f} s, init peak {torch.cuda.max_memory_allocated() / 2**30:.2f} "
          f"GiB, resident {torch.cuda.memory_allocated() / 2**30:.2f} GiB")
    return cfg, bundle, params


def wide_dense_checks(bundle, params, cfg, prompts):
    """The dense mode at full width: flash-attention prefills of the 512-
    and 150-token prompts against the paged (chunked-prefill) logits of the
    same prompts, then K4 over layer 0 of the 512-token prompt's dense
    cache."""
    from repro_torch.serving.engine import ServingEngine

    engine = lambda **kw: ServingEngine(bundle, params, block_size=16, device_blocks=64,
                                        cache_len=DENSE_CACHE_LEN, device=bundle.device, **kw)
    t0 = time.monotonic()
    with engine(decode_mode="dense") as d, engine() as pg:
        for prompt in prompts:
            compare_logits(f"{cfg.name} dense (K5) vs paged (K2) prefill logits, {len(prompt)} tokens",
                           d.prefill_logits(prompt), pg.prefill_logits(prompt), cfg.vocab_size)
    k4_over_dense_cache(bundle, params, cfg, prompts[0])
    print(f"{cfg.name} dense checks: {time.monotonic() - t0:.3f} s")


# --------------------------------------------------------------- phases 10-11
def snapshot_phase(bundle, params, cfg, prefix_len):
    """A recurrent model at full width through ``SnapshotEngine``: an
    OFFLOADABLE claim over a ``prefix_len``-token prefix is materialized
    (one prefill; hymba's attention half on K5) and offloaded (the page
    copy K3 moves the packed snapshot), then ``serve_batch`` runs 4
    prompts of the prefix plus 2 fresh tokens, 16 new tokens each: the
    first restores the snapshot (K3 again), every request reuses it, and
    the tokens equal those of an engine that kept the snapshot on the card
    (path A, judged by the port's analyzer).  One more request runs under
    the profiler for the device busy share.  Then a second engine fails
    the same claim's restore: refused fail-closed, in order (path B)."""
    from repro_torch.core.analyzer import (
        check_failure_outcome_path,
        check_observation_path,
        validate_event_sequence,
    )
    from repro_torch.core.claims import ClaimMode, ClaimState
    from repro_torch.serving.snapshot_engine import SnapshotEngine

    rng = np.random.default_rng(8)
    V, name, dev = cfg.vocab_size, cfg.name, bundle.device
    fresh = lambda n: tuple(int(t) for t in rng.integers(0, V, n))
    prefix = fresh(prefix_len)
    prompts = [prefix + fresh(2) for _ in range(4)]

    with SnapshotEngine(bundle, params, device=dev) as keep:  # never offloaded
        c = keep.accept_claim(prefix, ClaimMode.OFFLOADABLE)
        keep.materialize_claim(c.claim_id)
        kept = keep.serve_batch(prompts, max_new_tokens=16)
    check([r.status for r in kept] == ["finished"] * 4, f"{name} never-offloaded run did not finish")

    with SnapshotEngine(bundle, params, device=dev) as eng:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.monotonic()
        claim = eng.accept_claim(prefix, ClaimMode.OFFLOADABLE)
        cid = claim.claim_id
        payload = eng.materialize_claim(cid).nbytes
        check(claim.state == ClaimState.MATERIALIZED, f"{name}: claim {claim.state}")
        check(eng.offload_claim(cid), f"{name}: offload failed")
        check(claim.state == ClaimState.OFFLOADED, f"{name}: claim {claim.state}")
        reqs = eng.serve_batch(prompts, max_new_tokens=16)
        torch.cuda.synchronize()
        wall = time.monotonic() - t0
        peak = torch.cuda.max_memory_allocated() / 2**30
        for r in reqs:
            check(r.status == "finished", f"{name} {r.request_id}: {r.status} ({r.error})")
            check(len(r.output_tokens) == 16 and all(0 <= t < V for t in r.output_tokens),
                  f"{name} {r.request_id}: tokens {r.output_tokens}")
        check(reqs[0].restored_tokens == prefix_len,
              f"{name}: restored {reqs[0].restored_tokens} tokens")
        check([r.cached_tokens for r in reqs] == [prefix_len] * 4, f"{name}: a request missed the snapshot")
        check([r.output_tokens for r in reqs] == [r.output_tokens for r in kept],
              f"{name} path A: restored tokens differ from the never-offloaded run")
        check(claim.state == ClaimState.RESTORED, f"{name} path A: claim {claim.state}")
        check(not eng.fail_closed_total(), f"{name} path A fail-closed: {eng.fail_closed_total()}")
        order = validate_event_sequence(eng.events)
        check(order.passed, f"{name} path A: {order.reasons}")
        verdict = check_observation_path(eng.events, cid, reqs[0].request_id)
        check(verdict.passed, f"{name} path A: {verdict.reasons}")
        print(f"{name} snapshot path A analyzer: {verdict.reasons[0]}")
        stage = {k: eng.stage_seconds.samples(stage=k) for k in ("prefill", "restore", "decode_step")}
        print(f"{name} snapshot serving full width: claim over {prefix_len} tokens materialized, "
              f"offloaded and restored ({payload} B = {payload / 2**20:.2f} MiB per snapshot, "
              f"{'a multiple of 16' if payload % 16 == 0 else f'{payload % 16} mod 16'}), 4 requests "
              f"x 16 tokens equal to the never-offloaded run; wall {wall:.3f} s = prefill "
              f"{sum(stage['prefill']):.3f} s ({len(stage['prefill'])}) + restore "
              f"{sum(stage['restore']):.3f} s ({len(stage['restore'])}) + decode steps "
              f"{sum(stage['decode_step']):.3f} s ({len(stage['decode_step'])}) + other host work "
              f"(offload, unpacking, 2 replayed tokens per request) "
              f"{wall - sum(sum(v) for v in stage.values()):.3f} s; peak device memory {peak:.2f} GiB")
        extra = prefix + fresh(2)
        torch.cuda.synchronize()
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            t = time.monotonic()
            (r,) = eng.serve_batch([extra], max_new_tokens=8)
            torch.cuda.synchronize()
            w = time.monotonic() - t
        check(r.status == "finished" and r.cached_tokens == prefix_len, f"{name} profiled request {r.status}")
        avg = prof.key_averages()
        busy = sum(getattr(e, "self_device_time_total", 0.0) for e in avg) / 1e6
        print(f"{name} profiled request (snapshot hit + 2 fresh tokens, 8 new tokens): wall {w:.3f} s, "
              f"device busy {busy:.3f} s ({100 * busy / w:.1f}%), {sum(e.count for e in avg)} device ops")

    with SnapshotEngine(bundle, params, device=dev) as eng:
        claim = eng.accept_claim(prefix, ClaimMode.OFFLOADABLE)
        cid = claim.claim_id
        eng.materialize_claim(cid)
        check(eng.offload_claim(cid), f"{name} path B: offload failed")
        eng.connector.injection.resident_claim_load_failure = True
        eng.connector.injection.fail_claim_id = cid
        (r,) = eng.serve_batch([prompts[0]], max_new_tokens=16)
        check(r.status == "refused" and r.output_tokens == [],
              f"{name} path B: {r.status} with {len(r.output_tokens)} tokens")
        check(claim.state == ClaimState.RESTORATION_FAILED, f"{name} path B: claim {claim.state}")
        order = validate_event_sequence(eng.events)
        check(order.passed, f"{name} path B: {order.reasons}")
        up_to_load = check_observation_path(eng.events, cid, r.request_id)
        check(up_to_load.reasons == ["no successful tier->device transfer for the claim"],
              f"{name} path B: observation order before the restore: {up_to_load.reasons}")
        check(not any(e.request_id == r.request_id for e in
                      eng.events.named("offload_request_finished_no_pending_jobs")),
              f"{name} path B served output")
        verdict = check_failure_outcome_path(eng.events, cid, r.request_id)
        check(verdict.passed, f"{name} path B: {verdict.reasons}")
        print(f"{name} snapshot path B: request {r.status}, claim {claim.state.value}, "
              f"ordered E11 -> E12 -> E13 -> E14 -> FINISHED_ERROR ({verdict.reasons[0]})")


# --------------------------------------------------------------- phases 12-14
# Full width, depth cut to what one card holds beside the serving state
# (grok-1-314b: 42.6 GB of bf16 weights at 4 layers; arctic-480b: 55.4 GB
# at 2); phi-3-vision-4.2b runs at full depth.
MOE_DEPTH = {"grok-1-314b": 4, "arctic-480b": 2}


def moe_dense_checks(bundle, params, cfg, prompt):
    """grok-1-314b's dense mode beside its paged mode.  (a) The two prefill
    kernels on the served activations: layer 0's q, k and v of the
    ``prompt`` through K5 (one causal call, soft-cap 30) and through K2 (the
    same keys in 16-key pages, 32-query chunks after growing prefixes, as
    the engine's chunked prefill runs them), within the bf16 tolerance.
    (b) The dense engine's prefill logits (K5, the whole prompt in one MoE
    call: expert capacity 160 at 512 tokens) beside the paged engine's (K2,
    chunks of 32: capacity 10), finite; their difference is printed, not held to phase
    6's 0.25, since the experts drop other tokens at the other capacity, in
    the JAX package too."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models.layers import apply_norm, attn_qkv, paged_attention_prefill
    from repro_torch.models.moe import capacity_for
    from repro_torch.models.transformer import embed_tokens, layer_params
    from repro_torch.serving.engine import ServingEngine

    dev, S, page, C = bundle.device, len(prompt), 16, 32
    t0 = time.monotonic()
    lp0 = layer_params(params["layers"], 1)[0]  # layer 0's views
    tokens = torch.tensor([prompt], dtype=torch.int32, device=dev)
    pos = torch.arange(S, device=dev)[None]
    with torch.no_grad():
        h = apply_norm(cfg.norm, lp0["ln1"], embed_tokens(params, cfg, tokens))
        q, k, v = attn_qkv(lp0["attn"], cfg, h, pos)  # [1, S, H | KV, D]
        cap = cfg.attn_logit_softcap
        dense = fa.flash_attention(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                                   causal=True, softcap=cap).transpose(1, 2)
        KV, D = k.shape[2:]
        pages = lambda t: t[0].reshape(S // page, page, KV, D).permute(2, 0, 1, 3).contiguous()
        kp, vp = pages(k), pages(v)
        bt = torch.arange(S // page, dtype=torch.int32, device=dev)[None]
        chunks = [paged_attention_prefill(
            q[:, c0:c0 + C], kp, vp, bt, torch.tensor([c0], dtype=torch.int32, device=dev),
            k[:, c0:c0 + C], v[:, c0:c0 + C], pos[:, c0:c0 + C], softcap=cap)
            for c0 in range(0, S, C)]
        paged = torch.cat(chunks, 1)
        torch.cuda.synchronize()
    e = max_err(paged, dense)
    print(f"{cfg.name} layer 0 on the served {S}-token prompt ({cfg.num_heads} heads over {KV}, "
          f"soft-cap {cap}): K5 in one call vs K2 in {S // C} chunks of {C}: max|d|={e:.3e}")
    check(within(paged, dense, torch.bfloat16), f"{cfg.name}: K5 and K2 disagree on the served "
                                                 f"activations ({e})")
    engine = lambda **kw: ServingEngine(bundle, params, block_size=page, device_blocks=64,
                                        cache_len=DENSE_CACHE_LEN, device=dev, **kw)
    with engine(decode_mode="dense") as d, engine() as pg:
        ld, lp = d.prefill_logits(prompt), pg.prefill_logits(prompt)
        check(not d.fail_closed_total() and not pg.fail_closed_total(), f"{cfg.name} dense checks "
                                                                        "failed closed")
    V = cfg.vocab_size
    check(ld.shape == lp.shape == (V,) and np.isfinite(ld).all() and np.isfinite(lp).all(),
          f"{cfg.name}: bad prefill logits")
    cap_dense, cap_chunk = capacity_for(cfg, S), capacity_for(cfg, C)
    print(f"{cfg.name} dense (K5, one MoE call over {S} tokens: capacity {cap_dense}) vs paged (K2, "
          f"chunks of {C}: capacity {cap_chunk}) prefill logits: max|d|="
          f"{float(np.abs(ld - lp).max()):.3e}, argmax {ld.argmax()} vs {lp.argmax()} (not held to "
          "a tolerance: the capacity differs)")
    print(f"{cfg.name} dense checks: {time.monotonic() - t0:.3f} s")


def vlm_prefix_prefill(bundle, params, cfg):
    """phi-3-vision-4.2b's dense prefill with its stub frontend: 576 seeded
    normal patch embeddings in front of 64 tokens (K5 at S = 640, D = 96,
    G = 1, once per layer); finite logits, the cache's last position 639."""
    from repro_torch.kernels import flash_attention as fa

    dev, P = bundle.device, cfg.frontend_len
    g = torch.Generator(device=dev).manual_seed(7)
    patches = torch.randn((1, P, cfg.d_model), generator=g, device=dev).to(torch.bfloat16)
    tokens = torch.from_numpy(np.random.default_rng(8).integers(0, cfg.vocab_size, (1, 64))
                              .astype(np.int32)).to(dev)
    n0 = fa.flash_attention.launches
    torch.cuda.synchronize()
    t0 = time.monotonic()
    logits, cache = bundle.prefill_fn(params, {"tokens": tokens, "patch_embeds": patches},
                                      DENSE_CACHE_LEN)
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    n = fa.flash_attention.launches - n0
    check(tuple(logits.shape) == (1, cfg.vocab_size) and bool(torch.isfinite(logits).all()),
          f"{cfg.name}: patch-prefix prefill logits not finite")
    check(n == cfg.num_layers, f"{cfg.name}: K5 launched {n} times, not once per layer")
    check(int(cache["pos"].max()) == P + 63, f"{cfg.name}: cache positions end at "
                                             f"{int(cache['pos'].max())}")
    print(f"{cfg.name} patch-prefix prefill ({P} patches + 64 tokens, S {P + 64}, head_dim "
          f"{cfg.resolved_head_dim}): {n} K5 launches, finite logits, argmax {int(logits.argmax())}, "
          f"{wall:.3f} s")


def launch_failure_phase():
    """The card tests that make K1's and K2's launch fail (their library
    entry points stubbed to return a CUDA error): each must become a
    fail-closed refusal with every pin unwound, after which the engine
    serves again.  Runs pytest in a child process and waits for it."""
    t0 = time.monotonic()
    proc = subprocess.run(
        [sys.executable, "-m", "pytest", "-q", "-m", "gpu", "-p", "no:cacheprovider",
         "tests/test_torch_gpu.py", "-k", "launch_failure_fails_closed_on_card"],
        cwd=ROOT, env={**os.environ, "PYTHONPATH": str(ROOT / "src")}, capture_output=True,
        text=True, timeout=600,
    )
    last = proc.stdout.strip().splitlines()[-1] if proc.stdout.strip() else ""
    print(f"launch failures on the card (K1 -> decode_launch_failure, K2 -> "
          f"prefill_launch_failure): {last} ({time.monotonic() - t0:.1f} s)")
    check(proc.returncode == 0 and "2 passed" in last,
          f"launch-failure card tests failed:\n{proc.stdout[-3000:]}{proc.stderr[-2000:]}")


# --------------------------------------------------------------------- phase 7
SOFT_PRIORITY_COUNTS = {  # the JAX package's results/native/soft_priority.json
    "original_lower_priority_lost_first": "5/5",
    "swapped_lower_priority_lost_first": "5/5",
    "equal_priority_no_priority_separation": "3/3",
    "claims_joinable_before_pressure": "13/13",
    "no_pre_pressure_claim_loss": "13/13",
}


def conformance_phase(bundle, params, serving_log, serving_metrics, card):
    """(a) the seven mode scenarios on the full-width model, every gate
    checked; (b) the native descriptor generated from their results and
    judged by the port's checker, beside the public descriptors' matrix;
    (c) the port's analyzer over the paged serving phase's event log and
    metrics; (d) that log exported as a Perfetto trace."""
    from repro_torch.core import analyzer
    from repro_torch.core.checker import generate_matrix
    from repro_torch.core.descriptors import load_all_descriptors, load_descriptor
    from repro_torch.core.lowering import LABEL_NATIVE, judge_descriptor
    from repro_torch.core.native_descriptor import (
        BACKEND,
        engine_factory,
        generate_native_descriptor,
        run_scenarios,
    )
    from repro_torch.serving.tracing import build_spans, write_perfetto, validate_perfetto

    t0 = time.monotonic()
    with tempfile.TemporaryDirectory(prefix="conformance-") as tmp:
        results = run_scenarios(engine_factory(bundle, params, device=bundle.device),
                                Path(tmp) / "native")
        t_scen = time.monotonic() - t0
        for mode, res in results.items():
            gates = res["result"]["gates"]
            print(f"conformance {mode}: " + ", ".join(f"{k}={v}" for k, v in gates.items()))
            for gate, v in gates.items():
                if isinstance(v, bool):
                    check(v, f"conformance {mode}: gate {gate} is False")
        soft = results["soft_priority"]["result"]["gates"]
        check({k: soft[k] for k in SOFT_PRIORITY_COUNTS} == SOFT_PRIORITY_COUNTS,
              f"soft priority counts {soft} differ from the reference's {SOFT_PRIORITY_COUNTS}")
        path = generate_native_descriptor(results, Path(tmp) / "repro_torch_native.json",
                                          {"device": str(bundle.device),
                                           "card": card})
        rows = judge_descriptor(load_descriptor(path))
    for r in rows:
        check(r.label == LABEL_NATIVE, f"{BACKEND} {r.mode}: {r.label} ({r.reasons})")
    print(f"conformance descriptor: {BACKEND} " + ", ".join(f"{r.mode}={r.label}" for r in rows))
    public = generate_matrix([d for d in load_all_descriptors() if d.backend != BACKEND])
    check(public and all(r.label != LABEL_NATIVE for r in public), "a public row reads native_sound")
    labels = {}
    for r in public:
        labels.setdefault(r.backend, {}).setdefault(r.label, 0)
        labels[r.backend][r.label] += 1
    for backend, counts in labels.items():
        print(f"conformance public matrix: {backend} {json.dumps(counts)}")

    checks = {
        "validate_event_sequence": analyzer.validate_event_sequence(serving_log),
        "check_step_interleave_order": analyzer.check_step_interleave_order(serving_log),
        "check_fail_closed_attribution": analyzer.check_fail_closed_attribution(serving_log),
        "check_metrics_reconcile": analyzer.check_metrics_reconcile(serving_log, serving_metrics),
        "check_shared_page_immutability": analyzer.check_shared_page_immutability(serving_log),
    }
    for name, v in checks.items():
        check(v.passed, f"analyzer {name} on the paged serving log: {v.reasons}")
        print(f"analyzer {name} on the paged serving log: {'; '.join(v.reasons)}")

    out = ROOT / "chiprun_out" / "paged_serving_trace.json"
    out.parent.mkdir(parents=True, exist_ok=True)
    trace = write_perfetto(serving_log, out)
    problems = validate_perfetto(trace)
    check(problems == [], f"Perfetto trace problems: {problems[:5]}")
    cats = {}
    for sp in build_spans(serving_log):
        cats[sp.cat] = cats.get(sp.cat, 0) + 1
    print(f"Perfetto trace of the paged serving log: {len(trace['traceEvents'])} trace events, "
          f"spans per category {json.dumps(cats)}, written to {out.relative_to(ROOT)}")
    print(f"conformance phase wall {time.monotonic() - t0:.3f} s (scenarios {t_scen:.3f} s)")


T_START = time.monotonic()


def main() -> None:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        raise SystemExit(2)
    from repro_torch.configs import get_config
    from repro_torch.kernels import build
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import kv_block_copy as kbc
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.models.registry import build_model

    # float32 references stay full float32 (no TF32 in matmuls or cuDNN)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    card = smi.stdout.strip().splitlines()[0] if smi.stdout.strip() else "unknown"
    print(card)
    print(f"torch {torch.__version__} cuda {torch.version.cuda}")
    t_start = time.monotonic()
    dryruns = start_dryruns()  # phase 18 (f), on the CPU beside the card's phases

    t0 = time.monotonic()
    secs = build.build_all()
    print(f"built kernels in {time.monotonic() - t0:.1f} s: "
          + ", ".join(f"{k} {v:.1f} s" for k, v in secs.items()))
    for name in build.SOURCES:
        log = (build.BUILD_DIR / f"{name}.log").read_text()
        for line in log.splitlines():
            if "Compiling entry" in line:
                print(f"  {name}: {line.split(chr(39))[1] if chr(39) in line else line.strip()}")
            elif "registers" in line or "spill" in line:
                print(f"  {name}: {line.strip()}")
    sass_checks = [tensor_core_sass("K5", build.library_path("flash_attention")),
                   tensor_core_sass("K2", build.library_path("paged_attention"))]

    walls = {"build": time.monotonic() - t0}
    t0 = time.monotonic()
    kernels = kernel_phase()
    for finish in sass_checks:
        finish()
    walls["kernel rows"] = time.monotonic() - t0
    t0 = time.monotonic()
    reduced_parity_phase()
    walls["reduced parity"] = time.monotonic() - t0
    t0 = time.monotonic()
    launch_failure_phase()
    walls["launch failures"] = time.monotonic() - t0

    cfg = get_config("qwen3-1.7b")
    bundle = build_model(cfg)
    t0 = time.monotonic()
    params = bundle.init_params(torch.Generator().manual_seed(0))
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in _leaves(params))
    print(f"qwen3-1.7b params: {n_params / 1e9:.3f} B bf16 on the card in {time.monotonic() - t0:.1f} s")

    wrappers = {
        "paged_decode_attention": pa.paged_decode_attention,
        "paged_prefill_attention": pa.paged_prefill_attention,
        "kv_block_copy": kbc.kv_block_copy,
        "flash_attention": fa.flash_attention,
        "paged_attention": pa.paged_attention,
    }

    def drive(name, fn, *args):
        """One path of the main run, with every launch count zeroed just
        before it and read just after."""
        for w in wrappers.values():
            w.launches = 0
        t = time.monotonic()
        out = fn(*args)
        walls[name] = time.monotonic() - t
        counts[name] = {k: w.launches for k, w in wrappers.items()}
        print(f"launches in {name}: {counts[name]} ({walls[name]:.1f} s)")
        return out

    counts = {}
    plain_before = kbc.gather_payloads.plain_copies
    serving_log, serving_metrics, _ = drive("paged serving", serving_phase, bundle, params, cfg,
                                            qwen3_traffic, 192)
    drive("witness paths", witness_phase, bundle, params, cfg)
    served_prompt = drive("dense serving", dense_phase, bundle, params, cfg)
    drive("dense checks", dense_checks, bundle, params, cfg, served_prompt)
    drive("int8 dense serving", int8_phase, params, cfg)
    drive("conformance", conformance_phase, bundle, params, serving_log, serving_metrics, card)
    del bundle, params, serving_log, serving_metrics
    for name in ("stablelm-12b", "deepseek-7b"):
        gc.collect()
        torch.cuda.empty_cache()  # the previous model's weights go before the next is drawn
        cfg, bundle, params = load_model(name, WIDE_DEPTH[name])
        *_, prompts = drive(f"{name} paged serving", serving_phase, bundle, params, cfg,
                            wide_traffic, WIDE_DEVICE_BLOCKS)
        if name == "stablelm-12b":
            drive(f"{name} witness paths", witness_phase, bundle, params, cfg, ("A",))
            drive(f"{name} dense checks", wide_dense_checks, bundle, params, cfg,
                  [prompts[0], prompts[2]])
            check(counts[f"{name} dense checks"]["flash_attention"] > 0,
                  f"{name} dense prefills never launched K5")
            check(counts[f"{name} dense checks"]["paged_attention"] > 0,
                  f"{name} dense checks never launched K4")
        del bundle, params
    for name, prefix_len in (("hymba-1.5b", 1100), ("xlstm-350m", 512)):
        gc.collect()
        torch.cuda.empty_cache()
        cfg, bundle, params = load_model(name)
        drive(f"{name} snapshot serving", snapshot_phase, bundle, params, cfg, prefix_len)
        check(counts[f"{name} snapshot serving"]["kv_block_copy"] > 0,
              f"{name} offload/restore never launched K3")
        del bundle, params
    for name in ("grok-1-314b", "arctic-480b", "phi-3-vision-4.2b"):
        gc.collect()
        torch.cuda.empty_cache()
        cfg, bundle, params = load_model(name, MOE_DEPTH.get(name))
        paths = [f"{name} paged serving"]
        *_, prompts = drive(paths[0], serving_phase, bundle, params, cfg, wide_traffic,
                            WIDE_DEVICE_BLOCKS)
        if name == "grok-1-314b":
            paths += [f"{name} witness paths", f"{name} dense checks"]
            drive(paths[1], witness_phase, bundle, params, cfg)
            drive(paths[2], moe_dense_checks, bundle, params, cfg, prompts[0])
        if name == "phi-3-vision-4.2b":
            paths.append(f"{name} patch-prefix prefill")
            drive(paths[1], vlm_prefix_prefill, bundle, params, cfg)
        phase = {k: sum(counts[p][k] for p in paths) for k in wrappers}
        print(f"launches in the {name} phase: {phase}")
        need = ["paged_decode_attention", "paged_prefill_attention"]
        if name == "grok-1-314b":
            need += ["kv_block_copy", "flash_attention"]
        for k in need:
            check(phase[k] > 0, f"the {name} phase never launched {k}")
        del bundle, params
    gc.collect()
    torch.cuda.empty_cache()
    cfg, bundle, params = load_model("whisper-small")
    drive("whisper-small prefill and decode", whisper_phase, bundle, params, cfg)
    del bundle, params
    check(counts["whisper-small prefill and decode"]["flash_attention"] > 0,
          "the whisper-small phase never launched K5")
    gc.collect()
    torch.cuda.empty_cache()
    trainer = drive("training qwen3-1.7b", train_full_width)
    drive("train-then-serve", serve_trained, trainer)
    del trainer
    gc.collect()
    torch.cuda.empty_cache()
    drive("restart drill", restart_drill)
    drive("training other families", train_other_families)
    gc.collect()
    torch.cuda.empty_cache()
    drive("distribution", distribution_phase, dryruns)
    check(counts["distribution"]["flash_attention"] > 0, "the distribution phase never launched K5")
    for name in ("training qwen3-1.7b", "restart drill", "training other families"):
        check(not any(counts[name].values()), f"{name} launched a kernel: {counts[name]}")
    for k in ("paged_decode_attention", "paged_prefill_attention"):
        check(counts["train-then-serve"][k] > 0, f"train-then-serve never launched {k}")
    for k in ("flash_attention", "kv_block_copy"):
        check(counts["int8 dense serving"][k] > 0, f"the int8 phase never launched {k}")
    check(counts["phi-3-vision-4.2b patch-prefix prefill"]["flash_attention"] == 32,
          "the phi-3-vision-4.2b prefix prefill did not launch K5 once per layer")
    check(counts["hymba-1.5b snapshot serving"]["flash_attention"] > 0,
          "hymba-1.5b prefills never launched K5")
    for name in ("", "stablelm-12b ", "deepseek-7b "):
        check(counts[f"{name}paged serving"]["paged_decode_attention"] > 0,
              f"{name}serving never launched the paged decode kernel")
        check(counts[f"{name}paged serving"]["paged_prefill_attention"] > 0,
              f"{name}serving never launched the prefill kernel")
    for name in ("", "stablelm-12b "):
        check(counts[f"{name}witness paths"]["kv_block_copy"] > 0,
              f"{name}offload/restore never launched K3")
    check(counts["dense serving"]["flash_attention"] > 0, "dense serving never launched K5")
    check(counts["dense checks"]["flash_attention"] > 0, "the dense checks never launched K5")
    check(counts["dense checks"]["paged_attention"] > 0, "the dense checks never launched K4")
    for k in ("paged_decode_attention", "paged_prefill_attention", "kv_block_copy"):
        check(counts["conformance"][k] > 0, f"the conformance phase never launched {k}")
    check(kbc.gather_payloads.plain_copies == plain_before, "a payload gather took the plain copy")
    launches = {k: sum(c[k] for c in counts.values()) for k in wrappers}

    print(f"smoke wall {time.monotonic() - t_start:.1f} s (kernel build included): "
          + ", ".join(f"{k} {v:.1f} s" for k, v in walls.items()))
    print("kernels: " + json.dumps([{"name": k, "launches": v} for k, v in launches.items()]))
    record = []
    for name in wrappers:
        r = dict(name=name, **kernels[name], launches=launches[name])
        record.append({k: r[k] for k in ("name", "route", "source", "replaces", "launches",
                                         "max_abs_err", "ms", "plain_ms", "bound_ms",
                                         "bound_by", "library_ms")})
    print(json.dumps({"kernels": record}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


if __name__ == "__main__":
    main()

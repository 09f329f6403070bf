"""Host cost of one contended step: the decode rows' own launch
(``paged_decode_step``), the chunk's own launch (``prefill_chunk``) and the
fused launch (``paged_mixed_step``) on a join step (the chunk's pages
written layer by layer) and on any other (written once after the layer
loop), at the scheduler bench's contended shapes: ten decode rows padded to 12, one 8-token chunk completing two
blocks of 4, full-width qwen3-1.7b from seed 0 in bf16.

For each launch: the median wall of ``--reps`` launches (each ends in a
synchronise, as the step loop's), and, from ``torch.profiler``'s CPU
activity over three launches, the host ops per launch and the ops with
the most host self time; on the card also its device kernels per launch
(the CUDA activity of the same three launches) and those of the norm
kernel among them.  The wall here is what a step's stage seconds
read; it is host dispatch wherever the card sits idle (``PERF.md`` §5).

Then the host ops the fused launch adds to the decode rows' own launch,
by op, and the bits: the fused launch against the two launches (the
chunk, its blocks' page writes, the decode rows), max |d| of the logits,
tails, ``(ck, cv)`` and pages.

    PYTHONPATH=src python3 scripts/torch_mixed_step_host.py [--reps 30] [--out F]   # the card
    PYTHONPATH=src python3 scripts/torch_mixed_step_host.py --device cpu --reduced  # a rehearsal
"""
import argparse
import json
import statistics
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))
import torch  # noqa: E402

from repro_torch.bench.common import Model  # noqa: E402

W, B, C, PAGE, T, P = 12, 1, 8, 4, 40, 24


def scene(cfg, dev):
    """Decode rows over random pages and tails, the last one joining with
    the chunk's row (its table names the two pages the chunk writes), and
    the chunk at prefix 32."""
    g = torch.Generator().manual_seed(0)
    L, KV, Dh, V = cfg.num_layers, cfg.num_kv_heads, cfg.resolved_head_dim, cfg.vocab_size
    dt = torch.bfloat16
    rnd = lambda *s: torch.randn(s, generator=g).to(dt).to(dev)
    plen = torch.randint(60, 100, (W,), generator=g, dtype=torch.int32)
    used = torch.randint(0, 16, (W,), generator=g, dtype=torch.int32)
    bt = torch.zeros((W, P), dtype=torch.int32)
    for w in range(W):
        bt[w] = torch.randperm(128, generator=g)[:P].to(torch.int32)
    bt[W - 1, :10] = torch.tensor([128 + i for i in range(8)] + [192, 193], dtype=torch.int32)
    plen[W - 1], used[W - 1] = 32 + C - 1, 0
    tpos = torch.full((W, T), -1, dtype=torch.int32)
    for w in range(W):
        tpos[w, : int(used[w])] = plen[w] + torch.arange(int(used[w]), dtype=torch.int32)
    state = {"k_pages": rnd(L, KV, 256, PAGE, Dh), "v_pages": rnd(L, KV, 256, PAGE, Dh),
             "block_tables": bt.to(dev), "prefix_len": plen.to(dev),
             "k_tail": rnd(L, W, T, KV, Dh), "v_tail": rnd(L, W, T, KV, Dh),
             "tail_pos": tpos.to(dev)}
    cbt = torch.zeros((B, P), dtype=torch.int32)
    cbt[0, :8] = torch.arange(128, 136, dtype=torch.int32)
    chunk = {"tokens": torch.randint(0, V, (B, C), generator=g, dtype=torch.int32).to(dev),
             "positions": (32 + torch.arange(C, dtype=torch.int32))[None].to(dev),
             "block_tables": cbt.to(dev), "prefix_len": torch.full((B,), 32, dtype=torch.int32,
                                                                    device=dev),
             "write_blocks": None,  # both of the chunk's blocks, in order
             "write_pages": torch.tensor([192, 193], device=dev), "rows_join": True}
    toks = torch.randint(0, V, (W,), generator=g, dtype=torch.int32).to(dev)
    return state, toks, (plen + used).to(dev), chunk


def bits(b, params, state, toks, cur, chunk):
    """The fused launch against the two launches (the chunk, its blocks'
    page writes, the decode rows): max |d| of the logits, tails, ``(ck,
    cv)`` and the pages (0 is bitwise)."""
    split = dict(state, k_pages=state["k_pages"].clone(), v_pages=state["v_pages"].clone())
    ck, cv = b.prefill_chunk_fn(params, dict(split, block_tables=chunk["block_tables"],
                                             prefix_len=chunk["prefix_len"]),
                                chunk["tokens"], chunk["positions"])
    for j, p in enumerate(chunk["write_pages"].tolist()):
        split["k_pages"][:, :, p] = ck[:, 0, PAGE * j:PAGE * j + PAGE].permute(0, 2, 1, 3)
        split["v_pages"][:, :, p] = cv[:, 0, PAGE * j:PAGE * j + PAGE].permute(0, 2, 1, 3)
    lg, st = b.paged_decode_fn(params, split, toks, cur)
    fused = dict(state, k_pages=state["k_pages"].clone(), v_pages=state["v_pages"].clone())
    flg, fst, fck, fcv = b.mixed_step_fn(params, fused, toks, cur, chunk)
    pairs = {"logits": (flg, lg), "k_tail": (fst["k_tail"], st["k_tail"]),
             "v_tail": (fst["v_tail"], st["v_tail"]), "ck": (fck, ck), "cv": (fcv, cv),
             "k_pages": (fused["k_pages"], split["k_pages"]),
             "v_pages": (fused["v_pages"], split["v_pages"])}
    return {k: float((x.float() - y.float()).abs().max()) for k, (x, y) in pairs.items()}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None, help="default: the CUDA card")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--reps", type=int, default=30)
    ap.add_argument("--top", type=int, default=12)
    ap.add_argument("--out", default=None, help="write the summary as JSON here too")
    args = ap.parse_args()
    model = Model(args.device, reduced=args.reduced)
    b, params, dev = model.bundle, model.params, model.device
    state, toks, cur, chunk = scene(model.cfg, dev)
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    launches = {
        "decode": lambda: b.paged_decode_fn(params, state, toks, cur),
        "chunk": lambda: b.prefill_chunk_fn(
            params, dict(state, block_tables=chunk["block_tables"],
                         prefix_len=chunk["prefix_len"]), chunk["tokens"], chunk["positions"]),
        "fused": lambda: b.mixed_step_fn(params, state, toks, cur, chunk),
        "fused_no_join": lambda: b.mixed_step_fn(params, state, toks, cur,
                                                 dict(chunk, rows_join=False)),
    }
    out = {"card": model.describe()["card"], "shapes": dict(W=W, B=B, C=C, page=PAGE),
           "layers": model.cfg.num_layers}
    counts = {}
    for name, fn in launches.items():
        for _ in range(3):
            fn()
        sync()
        walls = []
        for _ in range(args.reps):
            t0 = time.perf_counter()
            fn()
            sync()
            walls.append(time.perf_counter() - t0)
        acts = [torch.profiler.ProfilerActivity.CPU]
        if dev.type == "cuda":
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        with torch.profiler.profile(activities=acts) as prof:
            for _ in range(3):
                fn()
            sync()
        avg = prof.key_averages()
        ops = [e for e in avg if e.key.startswith("aten::")]
        kernels = [e for e in avg if e.device_type == torch.autograd.DeviceType.CUDA]
        top = sorted(ops, key=lambda e: e.self_cpu_time_total, reverse=True)[: args.top]
        counts[name] = {e.key: e.count / 3 for e in ops}
        out[name] = {
            "wall_ms_median": statistics.median(walls) * 1e3,
            "wall_ms_min": min(walls) * 1e3,
            "aten_ops_per_launch": sum(e.count for e in ops) / 3,
            "device_kernels_per_launch": sum(e.count for e in kernels) / 3,
            "norm_kernels_per_launch": sum(e.count for e in kernels if "norm" in e.key) / 3,
            "top_self_cpu": [{"op": e.key, "per_launch": e.count / 3,
                              "self_cpu_us_per_launch": e.self_cpu_time_total / 3}
                             for e in top],
        }
        print(f"{name}: wall median {out[name]['wall_ms_median']:.3f} ms (min "
              f"{out[name]['wall_ms_min']:.3f}), aten ops a launch "
              f"{out[name]['aten_ops_per_launch']:.0f}, device kernels a launch "
              f"{out[name]['device_kernels_per_launch']:.0f} (norm kernels "
              f"{out[name]['norm_kernels_per_launch']:.0f})")
        for t in out[name]["top_self_cpu"]:
            print(f"    {t['op']:<40} x{t['per_launch']:<6.0f} {t['self_cpu_us_per_launch']:9.1f} us")
    print("mixed step host " + json.dumps({k: out[k]["wall_ms_median"] for k in launches}))
    ops = set(counts["fused"]) | set(counts["decode"])
    extra = {op: counts["fused"].get(op, 0) - counts["decode"].get(op, 0) for op in ops}
    out["fused_minus_decode_ops"] = {op: n for op, n in sorted(extra.items(), key=lambda x: -x[1])
                                     if n}
    print("fused launch's ops beyond the decode launch's: " + json.dumps(out["fused_minus_decode_ops"]))
    out["bits"] = bits(b, params, state, toks, cur, chunk)
    print("mixed step bits " + json.dumps(out["bits"]))
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(out, indent=1))


if __name__ == "__main__":
    main()

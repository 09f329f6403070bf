"""Route parity of the port in bf16 and in f32: the radix bench's
byte-identity probe (a warm turn-2 prefill over reused pages against a
cold prefill), the ceilings' logits parity (the dense mode's K5 prefill
against the paged K2 prefill; chunked against monolithic) and the step
loop's fused route against its split one (the scheduler bench's burst
beside ten decode streams: every decode launch's logits, the greedy tokens
and the page store, with each contended step as one ``paged_mixed_step``
launch or as the chunk's launch and then the decode rows'), first with
the model's bf16 weights, then with the same weights cast to f32.  The
fused-vs-split pair is held at 0 in bf16 (the script exits 1 otherwise).

Where the bf16 differences exceed the reference benches' tolerances, the
f32 run tells rounding (differences near f32's precision) from a wrong
page or a wrong mask (differences that stay large).

``--long`` runs the three route pairs at length instead, in bf16 only,
each held at 0 (the script exits 1 otherwise): full-width qwen3-1.7b on
a 32,768-token prompt (prefill_32k's length) and h2o-danube-1.8b on a
12,388-token prompt past its 4096-key window (warm: a prefix 16-20 tokens
short of the prompt served first, its continuation fed token by token;
dense: the K5 prefill, over a ring of the window for h2o-danube;
monolithic: ``prefill_chunk=0``; the paged side chunks of 512).

``--trace`` runs the three route pairs once more in bf16 with every
norm, projection, rotary embedding and attention output recorded, row by
row with its absolute position, and prints for each pair the first op
(layer and name, in execution order) whose row bytes differ at each
position both routes computed, with the max |d| there, and for each op
name the first layer where it differs.  ``norm_in`` is a norm's input (the
residual stream), so a residual that differs is not blamed on the norm;
``rope`` rows are the q and k rows after the rotary embedding, so the
decoded tail's K/V rows are held against the cold chunk's.

    PYTHONPATH=src python3 scripts/torch_route_parity.py [--trace | --long]   # the card, full width
    PYTHONPATH=src python3 scripts/torch_route_parity.py --device cpu --reduced [--trace | --long]
"""
import argparse
import contextlib
import dataclasses
import json
import sys
import tempfile
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))
import torch  # noqa: E402
from torch.utils._pytree import tree_map  # noqa: E402

from repro_torch.bench import multi_claim, radix, scheduler  # noqa: E402
from repro_torch.bench.common import Model  # noqa: E402
from repro_torch.models import layers  # noqa: E402

# op name -> the functions of models/layers.py whose outputs it records
TRACED = {
    "rms_norm": ("rms_norm",),
    "proj": ("proj",),
    "rope": ("apply_rope",),
    "attention": ("paged_attention_decode", "paged_attention_prefill", "attention_prefill",
                  "attention_contiguous"),
}
# the bundle's entry points and where each finds its rows' positions
ENTRIES = {
    "paged_decode_fn": lambda a: a[3][:, None],
    "decode_fn": lambda a: a[3][:, None],
    "prefill_chunk_fn": lambda a: a[3],
    "prefill_collect_fn": lambda a: torch.arange(a[1]["tokens"].shape[1])[None],
    "prefill_fn": lambda a: torch.arange(a[1]["tokens"].shape[1])[None],
}


class Recorder:
    """Rows of batch row 0 of every traced op, keyed (layer, op index in
    the layer, op, position); the layer advances at each attention."""

    def __init__(self):
        self.rows = {}
        self.positions = None
        self.depth = 0

    def begin(self, positions):
        self.positions = [int(p) for p in positions[0].tolist()]
        self.layer, self.index = 0, 0

    def record(self, op, out):
        S = len(self.positions)
        if out.ndim >= 3 and out.shape[1] == S:
            rows = out[0].reshape(S, -1).detach().float().cpu()
            for s, pos in enumerate(self.positions):
                self.rows[(self.layer, self.index, op, pos)] = rows[s]
        self.index += 1
        if op == "attention":
            self.layer, self.index = self.layer + 1, 0


@contextlib.contextmanager
def tracing(model: Model, rec: Recorder):
    """Patch the traced functions (in every module of the models package
    that holds them) and the bundle's entry points for the duration."""
    patched = []

    def wrap(op, fn):
        def traced(*args, **kw):
            if rec.depth or rec.positions is None:
                return fn(*args, **kw)
            if op == "rms_norm":
                rec.record("norm_in", args[0])
            rec.depth += 1
            try:
                out = fn(*args, **kw)
            finally:
                rec.depth -= 1
            rec.record(op, out)
            return out
        return traced

    for op, names in TRACED.items():
        for name in names:
            fn = getattr(layers, name)
            new = wrap(op, fn)
            for mod in [m for k, m in sys.modules.items() if k.startswith("repro_torch.models")]:
                if getattr(mod, name, None) is fn:
                    patched.append((mod, name, fn))
                    setattr(mod, name, new)
    bundle = model.bundle

    def entry(fn, where):
        def traced(*args, **kw):
            rec.begin(where(args))
            return fn(*args, **kw)
        return traced

    model.bundle = dataclasses.replace(bundle, **{
        name: entry(getattr(bundle, name), where) for name, where in ENTRIES.items()
        if getattr(bundle, name, None) is not None})
    try:
        yield
    finally:
        model.bundle = bundle
        for mod, name, fn in patched:
            setattr(mod, name, fn)


def first_differences(a: dict, b: dict, n_tokens: int) -> dict:
    """For each position both recordings hold (below ``n_tokens``), the
    first op in execution order whose row bytes differ; for each op name,
    the first layer where any of its rows differs."""
    per_pos, per_op = [], {}
    for pos in sorted({k[3] for k in a} & {k[3] for k in b}):
        if pos >= n_tokens:
            continue
        for key in sorted(k for k in a if k[3] == pos and k in b):
            x, y = a[key], b[key]
            if x.shape != y.shape or torch.equal(x, y):
                continue
            d = float((x - y).abs().max())
            layer, _, op, _ = key
            if op not in per_op or per_op[op]["layer"] > layer:
                per_op[op] = {"layer": layer, "pos": pos, "max_abs_diff": d}
            if len(per_pos) == 0 or per_pos[-1]["pos"] != pos:
                per_pos.append({"pos": pos, "layer": layer, "op": op, "max_abs_diff": d})
    equal = [p for p in sorted({k[3] for k in a} & {k[3] for k in b}) if p < n_tokens
             and p not in {r["pos"] for r in per_pos}]
    return {"first_diff_per_position": per_pos, "first_layer_per_op": per_op,
            "positions_bitwise_equal": equal}


def trace_pairs(model: Model) -> dict:
    """The three route pairs of the probes, recorded op by op."""
    out = {}
    t1 = radix.SYSTEM_PROMPT + tuple(range(5000, 5000 + radix.TURN_USER_TOKENS))

    def rec_run(fn):
        rec = Recorder()
        with tracing(model, rec):
            result = fn()
        return rec.rows, result

    def warm():
        with model.engine(**radix.ENGINE_KW) as eng:
            r1 = eng.submit(t1, max_new_tokens=radix.TURN_NEW_TOKENS)
            eng.run(r1)
            t2 = t1 + tuple(r1.output_tokens) + tuple(range(5100, 5100 + radix.TURN_USER_TOKENS))
            return t2, eng.prefill_logits(t2)

    warm_rows, (t2, _) = rec_run(warm)

    def logits(tokens, **kw):
        def run():
            with model.engine(**kw) as eng:
                return eng.prefill_logits(tokens)
        return run

    cold_rows, _ = rec_run(logits(t2, **radix.ENGINE_KW))
    out["warm_vs_cold"] = first_differences(warm_rows, cold_rows, len(t2))
    ckw = multi_claim.CEILING_KW
    common = tuple(range(400, 400 + min(ckw["cache_len"] - 4, 24)))
    dense, _ = rec_run(logits(common, **ckw, decode_mode="dense"))
    paged, _ = rec_run(logits(common, **ckw, decode_mode="paged"))
    out["dense_vs_paged"] = first_differences(dense, paged, len(common))
    prompt = tuple(range(0, ckw["device_blocks"] * ckw["block_size"] - 32))
    chunked, _ = rec_run(logits(prompt, **ckw, prefill_chunk=32))
    mono, _ = rec_run(logits(prompt, **ckw, prefill_chunk=0))
    out["chunked_vs_monolithic"] = first_differences(chunked, mono, len(prompt))
    return out


def fused_vs_split(model: Model) -> dict:
    """The scheduler bench's burst (``--fast`` lengths) on an engine with
    the fused route and on one without it (``_step_mixed = None``): the
    max |d| over every decode-side launch's logits, step by step, whether
    the tokens and the page store are equal, and the fused steps taken."""
    runs = []
    for fused in (True, False):
        with model.engine(**scheduler.ENGINE_KW) as eng:
            logits = []

            def keep(fn):
                def launch(*args):
                    out = fn(*args)
                    logits.append(out[0].float().cpu())
                    return out
                return launch

            eng._step_paged_decode = keep(eng._step_paged_decode)
            eng._step_mixed = keep(eng._step_mixed) if fused else None
            reqs = (scheduler.submit_streams(eng, dec_new=16)
                    + scheduler.submit_burst(eng, [40, 72]))
            eng.run_batch(reqs)
            runs.append({"logits": logits, "tokens": [r.output_tokens for r in reqs],
                         "pages": (eng.pool.k_pages.clone(), eng.pool.v_pages.clone()),
                         "fused_steps": eng.chunk_routes.value(route="fused")})
    a, b = runs
    same_steps = len(a["logits"]) == len(b["logits"])
    return {
        "max_abs_diff": max(float((x - y).abs().max()) for x, y in zip(a["logits"], b["logits"]))
        if same_steps else float("inf"),
        "decode_launches": len(a["logits"]),
        "fused_steps": a["fused_steps"],
        "tokens_equal": a["tokens"] == b["tokens"],
        "pages_equal": all(torch.equal(x, y) for x, y in zip(a["pages"], b["pages"])),
    }


# (arch, prompt tokens) of the pairs at length; --reduced cuts the lengths
LONG_PAIRS = (("qwen3-1.7b", 32_768), ("h2o-danube-1.8b", 12_388))


def long_pairs(device, reduced: bool) -> dict:
    """The three route pairs at LONG_PAIRS' lengths in bf16: max |d| of the
    prefill logits, warm vs cold, dense vs paged, chunked vs monolithic."""
    import numpy as np

    out = {}
    for arch, S in LONG_PAIRS:
        S = S // 16 if reduced else S
        model = Model(device, reduced=reduced, arch=arch)
        window = model.cfg.sliding_window
        prompt = tuple(int(t) for t in np.random.default_rng(S).integers(0, model.cfg.vocab_size, S))
        kw = dict(block_size=16, device_blocks=S // 16 + 64, prefill_chunk=512,
                  max_tokens_per_step=1024)

        def logits(tokens=prompt, **extra):
            with model.engine(**{**kw, **extra}) as eng:
                return eng.prefill_logits(tokens)

        cold = logits()
        with model.engine(**kw) as eng:
            eng.prefill_logits(prompt[:S - 16 - S % 16])
            warm = eng.prefill_logits(prompt)
        dense = logits(decode_mode="dense", cache_len=window or S + 1)
        mono = logits(prefill_chunk=0)
        d = lambda a, b: float(np.abs(a - b).max())
        out[arch] = {"tokens": S, "window": window, "warm_vs_cold": d(warm, cold),
                     "dense_vs_paged": d(dense, cold), "chunked_vs_monolithic": d(cold, mono)}
        print(f"route parity at length {arch} " + json.dumps(out[arch]), flush=True)
        del model
    return out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None, help="default: the CUDA card")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--trace", action="store_true", help="also trace the three pairs op by op (bf16)")
    ap.add_argument("--long", action="store_true",
                    help="the pairs at 32,768 tokens and past a window instead (bf16, held at 0)")
    args = ap.parse_args()
    torch.backends.cuda.matmul.allow_tf32 = False  # f32 stays f32
    if args.long:
        out = long_pairs(args.device, args.reduced)
        bad = {a: r for a, r in out.items()
               if any(r[k] for k in ("warm_vs_cold", "dense_vs_paged", "chunked_vs_monolithic"))}
        if bad and args.device != "cpu":  # the CPU's plain routes are not bitwise across routes
            sys.exit(f"a route pair at length differs in bf16: {bad}")
        return
    model = Model(args.device, reduced=args.reduced)
    out = {"card": model.describe()["card"]}
    with tempfile.TemporaryDirectory() as tmp:
        if args.trace:
            for pair, res in trace_pairs(model).items():
                print(f"route trace {pair} " + json.dumps(res))
        for name in ("bf16", "f32"):
            if name == "f32":
                model.params = tree_map(lambda t: t.float() if t.is_floating_point() else t,
                                        model.params)
            ceiling = multi_claim.run_ceiling(model, tmp)
            prefill = multi_claim.run_prefill_ceiling(model, tmp)
            out[name] = {"warm_vs_cold": radix.byte_identity_probe(model),
                         "dense_vs_paged_max_abs_diff": ceiling["logits_max_abs_diff"],
                         "chunked_vs_monolithic_max_abs_diff": prefill["logits_max_abs_diff"],
                         "fused_vs_split": fused_vs_split(model)}
    print("route parity " + json.dumps(out))
    fused = out["bf16"]["fused_vs_split"]
    if fused["max_abs_diff"] != 0 or not (fused["tokens_equal"] and fused["pages_equal"]):
        sys.exit(f"fused vs split differs in bf16: {fused}")


if __name__ == "__main__":
    main()

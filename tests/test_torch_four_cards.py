"""Four ranks, four cards: the port's rank-to-card binding, kernels launched
on their operand's card, and ``scripts/torch_four_cards.py``'s cases on four
gloo ranks held against the JAX package.

* ``launch.mesh.card_for_rank`` / ``init_group``: an NCCL rank r is bound
  to ``cuda:r`` before its group starts; more ranks than cards raise.
* Every kernel wrapper (K1-K5) calls its CUDA entry point through
  ``build.launch`` with its operand's card current: a stub library records
  the current card at the call, with the operands on ``cuda:1`` while the
  process's card is 0 (tensors that report ``cuda:1``; the CPU has no card).
* The program at ``--device cpu --reduced`` (one spawn of four gloo ranks
  for both meshes, 2 x 2 and 1 x 4, then the router in the test's
  subprocess) holds every case against the same step unsharded, and its
  saved inputs and outputs go through the JAX package in one subprocess
  with four host devices (``--xla_force_host_platform_device_count=4``):
  the reference's ``build_cell`` train step on 2 x 2 (3 steps, bf16: losses
  within 5e-3, measured 6.7e-5; grad norms 5e-3 relative, measured
  1.6e-3), its prefill cells on 2 x 2 and 1 x 4 (bf16 logits within 2e-2,
  measured 6.6e-3, the same argmax), its decode cell on 2 x 2 from its own
  prefill of the same prompt fed the program's tokens (2e-2, measured
  8.8e-3), ``attention_prefill_sharded`` on 1 x 4 whose bodies start at 0,
  16, 32 and 48 of 64 (f32, 1e-5, measured 4.8e-7), ``moe_apply_sharded``
  on 2 x 2 (f32 1e-6, measured 4.8e-7; aux relative 1e-5, measured 0) and
  grok's prefill cell on 1 x 4 (2e-2, measured 8.4e-3), and
  ``compressed_psum`` against the reference's ``quantize``/``dequantize``
  of each member's shard summed in group order (relative 1e-6, measured 0).
  The train_moe case runs in a spawn of its own, with its reference in a
  JAX subprocess of its own: reduced grok at one layer with room for
  every token (int8 first moments, 8 micro-batches, 16 x 128 tokens; ep,
  a2a and tp on 1 x 4, auto on 2 x 2) against the reference's ``build_cell`` step on the
  same mesh and strategy (losses 5e-3, measured 2.3e-4; grad norms 5e-3
  relative, measured 2.2e-3).
* The 32k cells' cases (``prefill_32k``, ``decode_32k``) at their reduced
  sizes in a spawn of their own, qwen3-1.7b and h2o-danube-1.8b (its
  16-key window reaching into the previous rank's query slice, its decode
  passing the 16-slot ring) on 2 x 2 and 1 x 4, against the reference's
  ``build_cell`` cells on the same meshes: prefill logits within 2e-2
  (measured max 6.6e-3); each of 4 decode steps from the reference's own
  prefill of the program's 60-token prompt, fed the program's tokens,
  within 2e-2 (measured max 8.6e-3); the same argmax but where the
  reference's two logits lie within that 2e-2 (measured gaps 0 to 4.9e-3).
* The sharded decode's cache update keeps the cache's layout: a step's
  all-gather bytes do not grow with the cache's slots, on a fake group.
"""
import ast
import contextlib
import json
import os
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.training import compression as j_comp
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import kv_block_copy as kbc
from repro_torch.kernels import paged_attention as pa
from repro_torch.launch import mesh as mesh_mod

ROOT = Path(__file__).resolve().parents[1]
PROGRAM = ROOT / "scripts" / "torch_four_cards.py"
FOUR_CASES = ("train", "prefill", "decode", "attention", "psum", "moe", "grok", "router")
LONG_CASES = ("prefill_32k", "decode_32k")
LONG_RUNS = [(a, m) for a in ("qwen3-1.7b", "h2o-danube-1.8b") for m in ("2 x 2", "1 x 4")]


def _env(**kw):
    return dict(os.environ, PYTHONPATH=str(ROOT / "src"), **kw)


# ---------------------------------------------------------------------------
# one rank, one card
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("rank,world,cards,want", [(0, 4, 4, 0), (3, 4, 4, 3), (1, 2, 4, 1),
                                                   (0, 1, 1, 0), (5, 8, 8, 5)])
def test_card_for_rank(rank, world, cards, want):
    assert mesh_mod.card_for_rank(rank, world, cards) == want


def test_card_for_rank_refuses_more_ranks_than_cards():
    with pytest.raises(RuntimeError, match="needs 4 cards, the host has 2"):
        mesh_mod.card_for_rank(0, 4, 2)
    with pytest.raises(ValueError, match="rank 4 outside"):
        mesh_mod.card_for_rank(4, 4, 4)


def test_init_group_binds_nccl_rank_before_the_group(monkeypatch):
    """``init_group("nccl")`` sets the rank's card current before the
    group starts (so ``resolve_device(None)`` names it); gloo binds
    nothing; four NCCL ranks on a two-card host raise before any group."""
    calls = []
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    monkeypatch.setattr(torch.cuda, "set_device", lambda d: calls.append(("set_device", d)))
    monkeypatch.setattr(mesh_mod.dist, "init_process_group",
                        lambda backend, **kw: calls.append(("group", backend, kw["rank"])))
    mesh_mod.init_group("nccl", rank=2, world_size=4, port=1)
    assert calls == [("set_device", 2), ("group", "nccl", 2)]
    calls.clear()
    mesh_mod.init_group("gloo", rank=2, world_size=4, port=1)
    assert calls == [("group", "gloo", 2)]
    calls.clear()
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    with pytest.raises(RuntimeError, match="a card never holds two ranks"):
        mesh_mod.init_group("nccl", rank=0, world_size=4, port=1)
    assert calls == []


# ---------------------------------------------------------------------------
# every kernel launches on its operand's card
# ---------------------------------------------------------------------------


class OnCardOne(torch.Tensor):
    """A host tensor that reports ``cuda:1``: the CPU has no card, and the
    wrappers read only the device, shapes, strides and pointers before the
    entry point, which a stub library takes here."""

    @property
    def device(self):
        return torch.device("cuda", 1)


@pytest.fixture
def stub_card(monkeypatch):
    """A fake current card (0), ``torch.cuda.device``/``current_stream``
    that move it, host allocations for ``device=cuda:1`` and a stub library
    whose entry points record the current card and the stream they got."""
    state = {"current": 0, "calls": []}

    @contextlib.contextmanager
    def device(d):
        prev, state["current"] = state["current"], torch.device(d).index
        try:
            yield
        finally:
            state["current"] = prev

    class Stream:
        def __init__(self, d):
            self.cuda_stream = 1000 + torch.device(d).index

    class Lib:
        def __getattr__(self, name):
            def entry(*args):
                state["calls"].append((name, state["current"], args[-1]))
                return 0
            return entry

    empty, to = torch.empty, torch.Tensor.to

    def host_to(self, *a, **kw):  # the page copy's index upload: dtype only
        a = [x for x in a if not isinstance(x, (torch.device, str))]
        kw.pop("device", None)
        kw.pop("non_blocking", None)
        return to(self, *a, **kw) if a or kw else self

    monkeypatch.setattr(torch.cuda, "device", device)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda d=None: Stream(d))
    monkeypatch.setattr(torch, "empty", lambda *a, device=None, **kw: empty(*a, **kw))
    monkeypatch.setattr(torch.Tensor, "to", host_to)
    for mod, name in ((fa, "_lib"), (pa, "_lib"), (pa, "_decode_lib"), (kbc, "_lib")):
        monkeypatch.setattr(mod, name, lambda: Lib())
    return state


def _card1(a, dtype=torch.bfloat16):
    t = torch.as_tensor(np.asarray(a))
    t = t.to(torch.int32) if t.dtype in (torch.int64, torch.int32) else t.to(dtype)
    return t.as_subclass(OnCardOne)


def _operands(kernel):
    rng = np.random.default_rng(0)
    f = lambda *s: _card1(rng.standard_normal(s).astype(np.float32))
    B, KV, G, D, N, page, P, T, C = 2, 2, 2, 16, 8, 4, 3, 2, 4
    bt = _card1([[0, 1, 2], [3, 4, 5]])
    if kernel == "K1":
        return pa.paged_decode_attention, (f(B, KV, G, D), f(KV, N, page, D), f(KV, N, page, D),
                                           bt, _card1([5, 9]), f(B, KV, T, D), f(B, KV, T, D),
                                           _card1([[5, 6], [9, 10]]), _card1([6, 10]))
    if kernel == "K2":
        return pa.paged_prefill_attention, (f(B, KV, G, C, D), f(KV, N, page, D),
                                            f(KV, N, page, D), bt, _card1([4, 8]),
                                            f(B, KV, C, D), f(B, KV, C, D))
    if kernel == "K3":
        return kbc.kv_block_copy, (f(N, page, KV, D), [3, 1])
    if kernel == "K4":
        return pa.paged_attention, (f(B, KV, G, D), f(KV, N, page, D), f(KV, N, page, D), bt,
                                    _card1([5, 9]))
    return fa.flash_attention, (f(1, 4, 8, D), f(1, 2, 8, D), f(1, 2, 8, D))


ENTRIES = {"K1": "paged_decode_forward", "K2": "paged_attention_forward",
           "K3": "kv_block_copy", "K4": "paged_decode_forward", "K5": "flash_attention_forward"}


@pytest.mark.parametrize("kernel", sorted(ENTRIES))
def test_wrapper_enters_its_operands_card(stub_card, kernel):
    """K1-K5 with every operand on ``cuda:1`` while card 0 is current:
    the entry point runs with card 1 current and card 1's stream, once,
    and card 0 is current again afterwards; the launch is counted."""
    fn, args = _operands(kernel)
    n0 = fn.launches
    fn(*args)
    assert stub_card["calls"] == [(ENTRIES[kernel], 1, 1001)]
    assert stub_card["current"] == 0 and fn.launches == n0 + 1


def test_wrapper_refuses_operands_on_two_cards(stub_card):
    q, k, v = _operands("K5")[1]
    with pytest.raises(ValueError, match="every operand"):
        fa.flash_attention(q, torch.zeros(k.shape, dtype=k.dtype), v)
    assert stub_card["calls"] == []


def test_entry_points_are_called_only_through_launch():
    """No module of ``kernels/`` calls a library's entry point itself:
    every ``_lib().<entry>`` / ``_decode_lib().<entry>`` is an argument of
    ``build.launch``, which makes the operand's card current."""
    for path in sorted((ROOT / "src" / "repro_torch" / "kernels").glob("*.py")):
        tree = ast.parse(path.read_text())
        for node in ast.walk(tree):
            if (isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute)
                    and isinstance(node.func.value, ast.Call)
                    and getattr(node.func.value.func, "id", "") in ("_lib", "_decode_lib")):
                raise AssertionError(f"{path.name}:{node.lineno} calls an entry point directly")
        launches = [n for n in ast.walk(tree) if isinstance(n, ast.Call)
                    and isinstance(n.func, ast.Attribute) and n.func.attr == "launch"]
        for n in launches:
            assert isinstance(n.args[1], ast.Attribute) and n.args[1].attr == "device", path.name


# ---------------------------------------------------------------------------
# the program on four gloo ranks, against the JAX package
# ---------------------------------------------------------------------------

_JAX_REF = """
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import jax, jax.numpy as jnp, numpy as np
from repro.configs import get_config, reduced
from repro.configs.base import ShapeSpec
from repro.launch import steps
from repro.launch.mesh import make_debug_mesh
from repro.models.layers import attention_prefill_sharded
from repro.models.moe import moe_apply_sharded
from repro.models.registry import build_model
from repro.training.optimizer import AdamWConfig, init_opt_state

z = dict(np.load(sys.argv[1]))
out = {}


def tree(prefix, like):
    def walk(path, node):
        if isinstance(node, dict):
            return {k: walk(f"{path}/{k}", v) for k, v in node.items()}
        return jnp.asarray(z[path], node.dtype)
    return walk(prefix, like)


opt_cfg = AdamWConfig(lr=3e-5, warmup_steps=2)
steps.get_config = lambda a: reduced(get_config(a))
steps.optimizer_for = lambda cfg: opt_cfg
for name, S, B, kind in (("train_t", 32, 4, "train"), ("prefill_t", 64, 4, "prefill"),
                         ("decode_t", 64, 8, "decode"), ("prefill_g", 64, 2, "prefill")):
    steps.SHAPES_BY_NAME[name] = ShapeSpec(name, S, B, kind)


def jitted(cell):
    return jax.jit(cell.step_fn, in_shardings=cell.in_shardings, out_shardings=cell.out_shardings)


m22, m14 = make_debug_mesh(2, 2), make_debug_mesh(1, 4)
qb = build_model(reduced(get_config("qwen3-1.7b")))
pshape = jax.eval_shape(qb.init_params, jax.random.PRNGKey(0))

f = jitted(steps.build_cell("qwen3-1.7b", "train_t", m22))
params = tree("train/masters",
              jax.tree.map(lambda s: jax.ShapeDtypeStruct(s.shape, jnp.float32), pshape))
opt = init_opt_state(params, opt_cfg)
losses, norms = [], []
with m22:
    for i in range(3):
        pre = f"train/batch{i}/"
        params, opt, m = f(params, opt, {k[len(pre):]: z[k] for k in z if k.startswith(pre)})
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
out["train/loss"], out["train/grad_norm"] = np.array(losses), np.array(norms)

qp = tree("qwen/params", pshape)
for label, mesh in (("2 x 2", m22), ("1 x 4", m14)):
    with mesh:
        logits, _ = jitted(steps.build_cell("qwen3-1.7b", "prefill_t", mesh))(
            qp, {"tokens": z["prefill/tokens"]})
    out["prefill/" + label] = np.asarray(logits, np.float32)

q, k, v = (jnp.asarray(z["attention/" + n]) for n in "qkv")
B, S = q.shape[:2]
pos = jnp.broadcast_to(jnp.arange(S)[None], (B, S))
with m14:
    out["attention"] = np.asarray(jax.jit(lambda q, k, v: attention_prefill_sharded(
        q, k, v, q_positions=pos, kv_positions=pos, mesh=m14, causal=True, window=16,
        softcap=30.0))(q, k, v))

_, cache = qb.prefill_fn(qp, {"tokens": jnp.asarray(z["decode/prompt"])}, 64)
f = jitted(steps.build_cell("qwen3-1.7b", "decode_t", m22))
plen = z["decode/prompt"].shape[1]
with m22:
    for i in range(4):
        tok = jnp.asarray(z[f"decode/tokens{i}"])
        logits, cache = f(qp, cache, tok, jnp.full(tok.shape, plen + i, jnp.int32))
        out[f"decode/{i}"] = np.asarray(logits, np.float32)

for arch, strategies in (("grok-1-314b", ("tp",)), ("arctic-480b", ("ep", "a2a"))):
    cfg = reduced(get_config(arch))
    p = {k: jnp.asarray(z[f"moe/{arch}/params/{k}"])
         for k in ("router", "w_gate", "w_up", "w_down")}
    for strategy in strategies:
        g = jax.jit(lambda p, x: moe_apply_sharded(p, x, cfg, m22, strategy=strategy))
        with m22:
            o, a = g(p, jnp.asarray(z[f"moe/{arch}/x"]))
        out[f"moe/{arch}/{strategy}/out"] = np.asarray(o)
        out[f"moe/{arch}/{strategy}/aux"] = np.asarray(a)

gb = build_model(reduced(get_config("grok-1-314b")))
gp = tree("grok/params", jax.eval_shape(gb.init_params, jax.random.PRNGKey(0)))
with m14:
    logits, _ = jitted(steps.build_cell("grok-1-314b", "prefill_g", m14))(
        gp, {"tokens": z["grok/tokens"]})
out["grok"] = np.asarray(logits, np.float32)
np.savez(sys.argv[2], **out)
"""


_JAX_MOE_REF = """
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
from dataclasses import replace
import jax, jax.numpy as jnp, numpy as np
from repro.configs import get_config, reduced
from repro.configs.base import ShapeSpec
from repro.launch import steps
from repro.launch.mesh import make_debug_mesh
from repro.models.registry import build_model
from repro.training.optimizer import AdamWConfig, init_opt_state

z = dict(np.load(sys.argv[1]))
out = {}


def tree(prefix, like):
    def walk(path, node):
        if isinstance(node, dict):
            return {k: walk(f"{path}/{k}", v) for k, v in node.items()}
        return jnp.asarray(z[path], node.dtype)
    return walk(prefix, like)


def jitted(cell):
    return jax.jit(cell.step_fn, in_shardings=cell.in_shardings, out_shardings=cell.out_shardings)


m22, m14 = make_debug_mesh(2, 2), make_debug_mesh(1, 4)
L = z["train_moe/grok-1-314b/masters/layers/ln1/w"].shape[0]  # the program's depth
gb = build_model(reduced(get_config("grok-1-314b")).replace(num_layers=L))

# the reduced grok's build_cell train step with the full config's int8 first
# moments and 8 micro-batches, every expert with room for every token, on
# the program's meshes and strategies
moe_opt = AdamWConfig(lr=3e-5, warmup_steps=2, state_dtype="int8")


def room(cfg):
    E, k = cfg.moe.num_experts, cfg.moe.experts_per_token
    return cfg.replace(moe=replace(cfg.moe, capacity_factor=E / k))


steps.get_config = lambda a: room(reduced(get_config(a)).replace(num_layers=L))
steps.optimizer_for = lambda cfg: moe_opt
steps.microbatches_for = lambda cfg: 8
B, S = z["train_moe/grok-1-314b/batch0/tokens"].shape
steps.SHAPES_BY_NAME["train_m"] = ShapeSpec("train_m", S, B, "train")
gm = tree("train_moe/grok-1-314b/masters",
          jax.tree.map(lambda s: jax.ShapeDtypeStruct(s.shape, jnp.float32),
                       jax.eval_shape(gb.init_params, jax.random.PRNGKey(0))))
for label, mesh, strategy in (("ep 1 x 4", m14, "ep"), ("a2a 1 x 4", m14, "a2a"),
                              ("tp 1 x 4", m14, "tp"), ("auto 2 x 2", m22, "auto")):
    f = jitted(steps.build_cell("grok-1-314b", "train_m", mesh, moe_strategy=strategy))
    params, opt = gm, init_opt_state(gm, moe_opt)
    losses, norms = [], []
    with mesh:
        for i in range(3):
            pre = f"train_moe/grok-1-314b/batch{i}/"
            params, opt, m = f(params, opt, {k[len(pre):]: z[k] for k in z if k.startswith(pre)})
            losses.append(float(m["loss"]))
            norms.append(float(m["grad_norm"]))
    out[f"train_moe/{label}/loss"], out[f"train_moe/{label}/grad_norm"] = (np.array(losses),
                                                                         np.array(norms))
np.savez(sys.argv[2], **out)
"""


_JAX_LONG_REF = """
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import jax, jax.numpy as jnp, numpy as np
from repro.configs import get_config, reduced
from repro.configs.base import ShapeSpec
from repro.launch import steps
from repro.launch.mesh import make_debug_mesh
from repro.models.registry import build_model

z = dict(np.load(sys.argv[1]))
out = {}


def tree(prefix, like):
    def walk(path, node):
        if isinstance(node, dict):
            return {k: walk(f"{path}/{k}", v) for k, v in node.items()}
        return jnp.asarray(z[path], node.dtype)
    return walk(prefix, like)


def jitted(cell):
    return jax.jit(cell.step_fn, in_shardings=cell.in_shardings, out_shardings=cell.out_shardings)


steps.get_config = lambda a: reduced(get_config(a))
B, S = z["prefill_32k/qwen3-1.7b/tokens"].shape
rows, plen = z["decode_32k/qwen3-1.7b/prompt"].shape
slots = plen + 4  # the prompt fills the cache to slots - steps
steps.SHAPES_BY_NAME["prefill_r"] = ShapeSpec("prefill_r", S, B, "prefill")
steps.SHAPES_BY_NAME["decode_r"] = ShapeSpec("decode_r", slots, rows, "decode")
meshes = (("2 x 2", make_debug_mesh(2, 2)), ("1 x 4", make_debug_mesh(1, 4)))
for arch in ("qwen3-1.7b", "h2o-danube-1.8b"):
    b = build_model(reduced(get_config(arch)))
    p = tree(f"{arch}/params", jax.eval_shape(b.init_params, jax.random.PRNGKey(0)))
    for label, mesh in meshes:
        with mesh:
            logits, _ = jitted(steps.build_cell(arch, "prefill_r", mesh))(
                p, {"tokens": z[f"prefill_32k/{arch}/tokens"]})
        out[f"prefill_32k/{arch}/{label}"] = np.asarray(logits, np.float32)
    _, cache0 = b.prefill_fn(p, {"tokens": jnp.asarray(z[f"decode_32k/{arch}/prompt"])}, slots)
    for label, mesh in meshes:
        f = jitted(steps.build_cell(arch, "decode_r", mesh))
        cache = cache0
        with mesh:
            for i in range(4):
                tok = jnp.asarray(z[f"decode_32k/{arch}/{label}/tokens{i}"])
                logits, cache = f(p, cache, tok, jnp.full(tok.shape, plen + i, jnp.int32))
                out[f"decode_32k/{arch}/{label}/{i}"] = np.asarray(logits, np.float32)
np.savez(sys.argv[2], **out)
"""


@pytest.fixture(scope="module")
def four(tmp_path_factory):
    """The program's every case but train_moe at ``--device cpu
    --reduced`` (one spawn of four gloo ranks), then the reference in one
    JAX subprocess on the saved inputs: (exit code, summary, the program's
    saved arrays, the reference's arrays, the program's output)."""
    return _program_and_reference(tmp_path_factory.mktemp("four_cards"), FOUR_CASES, _JAX_REF)


@pytest.fixture(scope="module")
def four_moe(tmp_path_factory):
    """The train_moe case at ``--device cpu --reduced`` in a spawn of its
    own (its 8 micro-batches of gloo collectives would crowd the other
    cases out of ``four``'s timeout on a loaded host), then its reference
    in a JAX subprocess of its own: as ``four``."""
    return _program_and_reference(tmp_path_factory.mktemp("four_cards_moe"), ("train_moe",),
                                  _JAX_MOE_REF)


@pytest.fixture(scope="module")
def four_long(tmp_path_factory):
    """The 32k cells' cases at their reduced sizes (one spawn of four gloo
    ranks), then their reference in a JAX subprocess of its own: as
    ``four``."""
    return _program_and_reference(tmp_path_factory.mktemp("four_cards_32k"), LONG_CASES,
                                  _JAX_LONG_REF)


def _program_and_reference(out, cases, reference):
    proc = subprocess.run([sys.executable, str(PROGRAM), "--device", "cpu", "--reduced",
                           "--cases", ",".join(cases), "--out", str(out), "--save", str(out)],
                          capture_output=True, text=True, timeout=300,
                          env=_env(OMP_NUM_THREADS="1"))
    summary = json.loads((out / "summary.json").read_text())
    subprocess.run([sys.executable, "-c", reference, str(out / "four_cards.npz"),
                    str(out / "jax.npz")], check=True, timeout=300, env=_env(JAX_PLATFORMS="cpu"))
    return (proc.returncode, summary, dict(np.load(out / "four_cards.npz")),
            dict(np.load(out / "jax.npz")), proc.stdout[-4000:] + proc.stderr[-4000:])


def test_program_holds_every_case_on_four_gloo_ranks(four, four_moe):
    cases = set()
    for rc, summary, *_, log in (four, four_moe):
        assert rc == 0 and summary["ok"], log
        cases |= set(summary["cases"])
    assert cases == {"train", "prefill", "decode", "attention", "psum", "moe", "grok",
                     "train_moe", "router"}
    assert four[1]["cases"]["prefill"]["1 x 4"]["argmax_equal"]


def test_32k_cases_hold_on_four_gloo_ranks(four_long):
    """Every check of both 32k cases holds at reduced size: logits and
    greedy tokens against one card, each rank's cache against the one-card
    cache (h2o-danube's the ring of its window)."""
    rc, summary, *_, log = four_long
    assert rc == 0 and summary["ok"], log
    assert set(summary["cases"]) == set(LONG_CASES)
    pre = summary["cases"]["prefill_32k"]
    assert pre["h2o-danube-1.8b"]["1 x 4"]["cache_slots"] == 16
    assert all(pre[a][m]["cache_pos_equal"] for a, m in LONG_RUNS)
    dec = summary["cases"]["decode_32k"]
    assert {dec[a][dt][m]["steps"] for a, m in LONG_RUNS for dt in ("bfloat16", "float32")} == {4}
    assert dec["h2o-danube-1.8b"]["bfloat16"]["2 x 2"]["cache_slots"] == 16


def _greedy_held(got, want, tol=2e-2):
    """Every row's argmax equal, or the two tokens' reference logits within
    ``tol`` of each other: a tie at the logits' own tolerance, which either
    package's bf16 rounding may break its own way (the program's
    ``greedy_held`` in absolute terms).  Returns (held, the differing rows'
    gaps)."""
    ga, wa = got.argmax(-1), want.argmax(-1)
    gaps = [float(want[r, wa[r]] - want[r, ga[r]]) for r in np.nonzero(ga != wa)[0]]
    return all(g <= tol for g in gaps), gaps


@pytest.mark.parametrize("arch,mesh", LONG_RUNS)
def test_prefill_32k_matches_reference(four_long, arch, mesh):
    """The reduced prefill_32k cell's logits against the reference's
    ``build_cell`` cell on the same mesh: 2e-2 (measured max 6.6e-3)."""
    _, _, saved, ref, _ = four_long
    got, want = saved[f"prefill_32k/{arch}/{mesh}/logits"], ref[f"prefill_32k/{arch}/{mesh}"]
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-2)
    held, gaps = _greedy_held(got, want)
    assert held, gaps


@pytest.mark.parametrize("arch,mesh", LONG_RUNS)
def test_decode_32k_matches_reference(four_long, arch, mesh):
    """Four reduced decode_32k steps (the prompt fills the cache to slots -
    steps; h2o-danube's positions pass its ring) against the reference's
    cell on the same mesh from its own prefill, fed the program's tokens:
    2e-2 (measured max 8.6e-3)."""
    _, _, saved, ref, _ = four_long
    for i in range(4):
        got, want = saved[f"decode_32k/{arch}/{mesh}/logits{i}"], ref[f"decode_32k/{arch}/{mesh}/{i}"]
        np.testing.assert_allclose(got, want, rtol=0, atol=2e-2)
        held, gaps = _greedy_held(got, want)
        assert held, (i, gaps)


_GATHERS = """
import json, sys
import torch
import torch.distributed._functional_collectives as funcol
from torch.distributed.tensor.experimental import implicit_replication
from repro_torch.configs import ShapeSpec, get_config, reduced
from repro_torch.launch import steps
from repro_torch.launch.dryrun import init_fake_group
from repro_torch.launch.mesh import make_mesh
from repro_torch.models import layers
from repro_torch.roofline.analysis import CollectiveCounter
from repro_torch.sharding.rules import distribute

init_fake_group(4)
out = {}
# every all-gather, DTensor's own inside an op too (CollectiveCounter sees
# only those issued at the Python level)
gathered, real = [], funcol.all_gather_single


def spy(t, *a, **kw):
    gathered.append(real(t, *a, **kw))
    return gathered[-1]


funcol.all_gather_single = spy
for dims in ((2, 2), (1, 4)):
    mesh = make_mesh(dims, ("data", "model"), device="cpu")
    # slot_update with the new row's heads sharded over 'model', as the
    # projection leaves them: the cache keeps its sequence sharding
    k = distribute(torch.randn(4, 32, 4, 16), (("data",), "model", None, None), mesh)
    row = distribute(torch.randn(4, 1, 4, 16), (("data",), None, "model", None), mesh)
    with implicit_replication():
        new = layers.slot_update(k, row, torch.full((4,), 5))
    out[f"{dims} slot_update"] = [str(p) for p in new.placements] == [str(p) for p in k.placements]
    for arch in ("qwen3-1.7b", "h2o-danube-1.8b"):
        cfg = reduced(get_config(arch)).replace(sliding_window=0)
        for slots in (64, 256):
            cell = steps.build_cell(arch, "d", mesh, cfg=cfg,
                                    shape=ShapeSpec("d", slots, 4, "decode"))
            args = steps.cell_arguments(cell)
            with CollectiveCounter() as c:
                _, cache = steps.run_cell(cell, args)
            out[f"{dims} {arch} {slots}"] = [c.bytes["all-gather"],
                                             str(cache["k"].placements)]
        cfg = reduced(get_config(arch))
        cell = steps.build_cell(arch, "p", mesh, cfg=cfg, shape=ShapeSpec("p", 64, 4, "prefill"))
        gathered.clear()
        steps.run_cell(cell, steps.cell_arguments(cell))
        out[f"{dims} {arch} prefill"] = [list(t.shape) for t in gathered if t.ndim == 5]
print(json.dumps(out))
"""


def test_sharded_steps_gather_no_cache():
    """On a fake group of four ranks (meta tensors), the decode cell's
    all-gather bytes per device are the same over 64 and 256 cache slots
    (nothing of the sequence-sharded cache is gathered) and the new cache
    keeps the input's layout; ``slot_update`` keeps the cache's placements
    when the new row comes with its heads sharded over 'model' (torch 2.11
    laid such a select out as the row and gathered the cache, every step).
    The prefill cell gathers no stacked [L, B, S, KV, Dh] K/V: h2o-danube's
    ring once cut its trailing 16 positions out of the sequence-sharded
    stack, which DTensor did by gathering all of it inside the slice."""
    proc = subprocess.run([sys.executable, "-c", _GATHERS], capture_output=True, text=True,
                          timeout=300, env=_env(OMP_NUM_THREADS="1"))
    assert proc.returncode == 0, proc.stderr[-3000:]
    got = json.loads(proc.stdout.strip().splitlines()[-1])
    for dims in ("(2, 2)", "(1, 4)"):
        assert got[f"{dims} slot_update"]
        for arch in ("qwen3-1.7b", "h2o-danube-1.8b"):
            (small, lay), (large, lay2) = got[f"{dims} {arch} 64"], got[f"{dims} {arch} 256"]
            assert small == large and lay == lay2 and "Shard(dim=2)" in lay, got
            assert got[f"{dims} {arch} prefill"] == [], got


_ONE_ROW = """
import socket, sys
import numpy as np, torch
from repro_torch.configs import ShapeSpec, get_config, reduced
from repro_torch.launch import steps
from repro_torch.launch.mesh import init_group, make_debug_mesh
from repro_torch.models.registry import build_model
from repro_torch.sharding.rules import full

with socket.socket() as s:
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
init_group("gloo", rank=0, world_size=1, port=port)
mesh = make_debug_mesh(1, 1, device="cpu")
for arch in ("qwen3-1.7b", "h2o-danube-1.8b"):
    cfg = reduced(get_config(arch))
    cell = steps.build_cell(arch, "p", mesh, cfg=cfg, shape=ShapeSpec("p", 64, 1, "prefill"))
    params = cell.bundle.init_params(torch.Generator().manual_seed(0))
    tokens = torch.from_numpy(np.random.default_rng(3).integers(0, cfg.vocab_size, (1, 64)))
    tokens = tokens.to(torch.int32)
    args = (steps.distribute_argument(cell, "params", params),
            steps.distribute_argument(cell, "batch", {"tokens": tokens}))
    logits, cache = steps.run_cell(cell, args)
    want, want_cache = build_model(cfg, device="cpu").prefill_fn(params, {"tokens": tokens}, 64)
    print(arch, float((full(logits) - want).abs().max()),
          float((full(cache["k"]).float() - want_cache["k"].float()).abs().max()))
"""


def test_one_row_sharded_prefill():
    """A one-row prefill cell (smoke phase 18's 1 x 32,768 on its 1 x 1
    mesh) on a one-rank gloo group, reduced: the batch dim is sharded over
    the one-rank 'data' axis, which DTensor refused to flatten in the
    projections; the logits and the cache's k against the unsharded
    prefill within the bf16 tolerance 2e-2 (measured 0 on the CPU)."""
    proc = subprocess.run([sys.executable, "-c", _ONE_ROW], capture_output=True, text=True,
                          timeout=300, env=_env(OMP_NUM_THREADS="1"))
    assert proc.returncode == 0, proc.stderr[-3000:]
    rows = [line.split() for line in proc.stdout.strip().splitlines()]
    assert [r[0] for r in rows] == ["qwen3-1.7b", "h2o-danube-1.8b"]
    assert all(float(r[1]) <= 2e-2 and float(r[2]) <= 2e-2 for r in rows), rows


def test_train_matches_reference(four):
    _, summary, _, ref, _ = four
    got = summary["cases"]["train"]["sharded"]
    for g, loss, norm in zip(got, ref["train/loss"], ref["train/grad_norm"]):
        assert abs(g["loss"] - loss) < 5e-3, (g, loss)
        assert abs(g["grad_norm"] - norm) / norm < 5e-3, (g, norm)


@pytest.mark.parametrize("mesh", ["2 x 2", "1 x 4"])
def test_prefill_matches_reference(four, mesh):
    _, _, saved, ref, _ = four
    got, want = saved[f"prefill/{mesh}/logits"], ref[f"prefill/{mesh}"]
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-2)
    assert (got.argmax(-1) == want.argmax(-1)).all()


def test_attention_body_slices_match_reference(four):
    """The 1 x 4 mesh's four bodies start at 0, 16, 32 and 48 of 64."""
    _, summary, saved, ref, _ = four
    starts = [summary["per_rank"][f"rank{r}"]["attention"]["slice_start"] for r in range(4)]
    assert starts == [0, 16, 32, 48]
    np.testing.assert_allclose(saved["attention/out"], ref["attention"], rtol=0, atol=1e-5)


def test_decode_matches_reference(four):
    _, _, saved, ref, _ = four
    for i in range(4):
        got, want = saved[f"decode/logits{i}"], ref[f"decode/{i}"]
        np.testing.assert_allclose(got, want, rtol=0, atol=2e-2)
        assert (got.argmax(-1) == want.argmax(-1)).all()


@pytest.mark.parametrize("group,members", [("world", [0, 1, 2, 3]), ("data", [0, 2])])
def test_compressed_psum_matches_reference(four, group, members):
    _, summary, saved, _, _ = four
    assert summary["cases"]["psum"][group]["members"] == members
    want = None
    for m in members:
        shard = saved[f"psum/shard{m}"]
        q, s = j_comp.quantize(jnp.asarray(shard))
        d = np.asarray(j_comp.dequantize(q, s, shard.shape))
        want = d if want is None else want + d
    np.testing.assert_allclose(saved[f"psum/{group}"], want, rtol=1e-6, atol=0)


@pytest.mark.parametrize("case", ["grok-1-314b/tp", "arctic-480b/ep", "arctic-480b/a2a"])
def test_moe_matches_reference(four, case):
    _, _, saved, ref, _ = four
    np.testing.assert_allclose(saved[f"moe/{case}/out"], ref[f"moe/{case}/out"], rtol=0, atol=1e-6)
    np.testing.assert_allclose(saved[f"moe/{case}/aux"], ref[f"moe/{case}/aux"], rtol=1e-5, atol=0)


def test_grok_prefill_matches_reference(four):
    _, _, saved, ref, _ = four
    got = saved["grok/1 x 4/logits"]
    np.testing.assert_allclose(got, ref["grok"], rtol=0, atol=2e-2)
    assert (got.argmax(-1) == ref["grok"].argmax(-1)).all()


@pytest.mark.parametrize("run", ["ep 1 x 4", "a2a 1 x 4", "tp 1 x 4", "auto 2 x 2"])
def test_train_moe_matches_reference(four_moe, run):
    """The program's reduced grok train_moe runs (one layer) with room for
    every token (int8 first moments, 8 micro-batches, 16 x 128 tokens) against the
    reference's ``build_cell`` step on the same mesh and strategy: three
    losses within 5e-3 and grad norms within 5e-3 relative."""
    _, summary, _, ref, _ = four_moe
    strategy, mesh = run.split(" ", 1)
    label = f"grok-1-314b {strategy} {mesh} room"
    run_rec = summary["cases"]["train_moe"]["runs"][label]
    assert run_rec["state_dtype"] == "int8" and run_rec["n_micro"] == 8
    got = run_rec["sharded"]
    for g, loss, norm in zip(got, ref[f"train_moe/{run}/loss"], ref[f"train_moe/{run}/grad_norm"],
                             strict=True):
        assert abs(g["loss"] - loss) < 5e-3, (g, loss)
        assert abs(g["grad_norm"] - norm) / norm < 5e-3, (g, norm)


def test_router_over_four_replicas(four):
    """The router case on four CPU replicas: every gate, tokens and routes
    equal to the one-replica-set run, witness path A restored bitwise."""
    _, summary, *_ = four
    r = summary["cases"]["router"]
    assert all(r["cards"]["routed_reuse"]["gates"].values())
    assert r["cards"]["traffic"]["tokens"] == r["one_card"]["traffic"]["tokens"]
    assert r["cards"]["traffic"]["workers"] == [3, 0, 0, 0, 3, 3, 3, 0]
    assert r["cards"]["witness_a"]["ok"] and r["cards"]["witness_a"]["restored_pages_bitwise"]


def test_program_needs_a_card_per_rank(tmp_path):
    """Without ``--device cpu`` the program runs on cards only: here, with
    none, it raises and writes no summary."""
    proc = subprocess.run([sys.executable, str(PROGRAM), "--cases", "psum", "--out", str(tmp_path)],
                          capture_output=True, text=True, timeout=120, env=_env())
    assert proc.returncode != 0 and "no CUDA device" in proc.stderr
    assert not (tmp_path / "summary.json").exists()

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


@pytest.fixture(scope="module")
def four(tmp_path_factory):
    """The program's every case at ``--device cpu --reduced`` (one spawn of
    four gloo ranks), then the reference in one JAX subprocess on the
    saved inputs: (exit code, summary, the program's saved arrays, the
    reference's arrays, the program's output)."""
    out = tmp_path_factory.mktemp("four_cards")
    proc = subprocess.run([sys.executable, str(PROGRAM), "--device", "cpu", "--reduced",
                           "--out", str(out), "--save", str(out)],
                          capture_output=True, text=True, timeout=300,
                          env=_env(OMP_NUM_THREADS="1"))
    summary = json.loads((out / "summary.json").read_text())
    subprocess.run([sys.executable, "-c", _JAX_REF, str(out / "four_cards.npz"),
                    str(out / "jax.npz")], check=True, timeout=300, env=_env(JAX_PLATFORMS="cpu"))
    return (proc.returncode, summary, dict(np.load(out / "four_cards.npz")),
            dict(np.load(out / "jax.npz")), proc.stdout[-4000:] + proc.stderr[-4000:])


def test_program_holds_every_case_on_four_gloo_ranks(four):
    rc, summary, *_, log = four
    assert rc == 0 and summary["ok"], log
    assert set(summary["cases"]) == {"train", "prefill", "decode", "attention", "psum", "moe",
                                     "grok", "router"}
    assert summary["cases"]["prefill"]["1 x 4"]["argmax_equal"]


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

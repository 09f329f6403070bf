"""The port's distribution slice against the JAX package's, on the CPU.

* ``shape_applicable``, the analytic FLOP/byte model and the roofline
  report equal the reference's exactly (all ten configs x four shapes; the
  roofline with the reference's TPU constants passed as ``hw=``).
* The production meshes on the ``fake`` backend, the debug mesh on gloo.
* The sharding rules: every parameter, batch, cache and optimizer-state
  leaf's (dim -> mesh axes) map equals the reference's PartitionSpec, on
  the single- and multi-pod meshes, training and serving rules.  The
  reference's rules read only ``mesh.shape`` and ``mesh.axis_names``, so a
  ``SimpleNamespace`` stands in for its 256- and 512-device meshes.
* Multi-rank cases on four gloo ranks (``torch_dist_workers.run_ranks``:
  spawned processes, a free localhost port, a join timeout of 120 s; no
  process group in the pytest process), each with its measured max |d|:
  ``compressed_psum`` against the reference's arithmetic on the same four
  shards (relative 1e-6; measured 0: the rank-order sum is the
  reference's); ``moe_apply_sharded`` ``ep``/``a2a`` (reduced arctic) and
  ``tp`` (reduced grok) on a 2 x 2 mesh against the reference's
  ``moe_apply_sharded`` on a 2 x 2 host mesh in a JAX subprocess (f32
  outputs 1e-6, aux relative 1e-5; measured 4.2e-7 / 3.6e-7 and 0);
  ``attention_prefill_sharded`` on 2 x 2 against the reference's
  unsharded ``attention_prefill`` (f32 1e-5; measured 4.8e-7 causal with
  window and soft-cap, 2.4e-7 non-causal); reduced qwen3's loss and grads
  on 2 x 2 under each attention sharding mode against the unsharded
  ``loss_fn`` (f32 1e-5; measured 5.1e-7); three sharded train steps of
  reduced qwen3 on 2 x 2 against the reference's ``build_cell`` train step
  on ``make_debug_mesh(1, 1)`` and the port's unsharded step in f32
  compute (losses and grad norms relative 1e-5; measured 2.5e-7 and
  1.1e-7), and against both in bf16 (losses 5e-3,
  ``test_torch_train_archs.py``'s bound, measured 2.9e-4 and 2.6e-4; grad
  norms 5e-3 relative, measured 1.0e-3 and 1.2e-3); one reduced-grok ``a2a`` step (5e-3;
  measured 1.2e-3: each rank dispatches its own tokens with its own
  capacity); ``Trainer(mesh=)`` resuming its checkpoint onto placements
  and re-meshing.
* The dry run: one cell in a subprocess, and the committed sweep
  (``results/torch/dryrun/``: 33 ok and 7 skipped per mesh, no error).
* Without a mesh every touched entry point is bitwise what it was:
  ``torch_forward_digest`` digests against the tree before this slice.
"""
import json
import os
import subprocess
import sys
import types
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ALL_SHAPES as J_SHAPES
from repro.configs import ARCHITECTURES as J_ARCHS
from repro.configs import SHAPES_BY_NAME as J_SHAPES_BY_NAME
from repro.configs import get_config as j_get_config
from repro.configs import reduced as j_reduced
from repro.configs import shape_applicable as j_shape_applicable
from repro.configs.base import ShapeSpec as JShapeSpec
from repro.models.registry import build_model as j_build_model
from repro.roofline import analysis as j_analysis
from repro.roofline import analytic as j_analytic
from repro.sharding import rules as j_rules
from repro.training import compression as j_comp
from repro.training import optimizer as j_opt
from repro_torch.configs import ALL_SHAPES, ARCHITECTURES, SHAPES_BY_NAME, get_config, reduced
from repro_torch.configs import shape_applicable
from repro_torch.launch.steps import microbatches_for, optimizer_for
from repro_torch.models.registry import build_model
from repro_torch.params import params_from_jax
from repro_torch.roofline import analysis, analytic
from repro_torch.sharding import rules
from repro_torch.training.optimizer import opt_state_pspecs
from repro_torch.training.tree import leaves_with_paths, map_tree

import torch_dist_workers as W
from torch_forward_digest import FAMILIES, digest

ROOT = Path(__file__).resolve().parents[1]
ARCH_NAMES = sorted(ARCHITECTURES)
MESHES = {
    "single": {"data": 16, "model": 16},
    "multi": {"pod": 2, "data": 16, "model": 16},
}


def _env(**kw):
    return dict(os.environ, PYTHONPATH=str(ROOT / "src"), **kw)


def _jmesh(kind):
    shape = MESHES[kind]
    return types.SimpleNamespace(shape=dict(shape), axis_names=tuple(shape))


def _runnable():
    return [(a, s.name) for a in ARCH_NAMES for s in ALL_SHAPES
            if shape_applicable(get_config(a), s)[0]]


# ---------------------------------------------------------------------------
# 1-3: applicability, the analytic model, the roofline
# ---------------------------------------------------------------------------


def test_shape_applicability_matches_reference():
    """33 runnable and 7 skipped cells, cell by cell the reference's, with
    the reference's reasons."""
    assert sorted(ARCHITECTURES) == sorted(J_ARCHS)
    runnable = skipped = 0
    for arch in ARCH_NAMES:
        for s, js in zip(ALL_SHAPES, J_SHAPES):
            assert s.name == js.name
            got = shape_applicable(get_config(arch), s)
            assert got == tuple(j_shape_applicable(j_get_config(arch), js)), (arch, s.name)
            runnable += got[0]
            skipped += not got[0]
    assert (runnable, skipped) == (33, 7)


@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_analytic_model_equals_reference(arch):
    """forward_flops, cell_flops, param_bytes, cache_bytes and
    cell_hbm_bytes at 256 and 512 chips: ``==`` for every shape."""
    cfg, jcfg = get_config(arch), j_get_config(arch)
    assert analytic.param_bytes(cfg) == j_analytic.param_bytes(jcfg)
    for s in ALL_SHAPES:
        js = J_SHAPES_BY_NAME[s.name]
        assert analytic.forward_flops(cfg, s) == j_analytic.forward_flops(jcfg, js)
        assert analytic.cell_flops(cfg, s) == j_analytic.cell_flops(jcfg, js)
        assert analytic.cache_bytes(cfg, s) == j_analytic.cache_bytes(jcfg, js)
        for chips in (256, 512):
            assert analytic.cell_hbm_bytes(cfg, s, chips) == j_analytic.cell_hbm_bytes(jcfg, js, chips)


def test_roofline_report_equals_reference():
    """With the reference's TPU constants passed as ``hw=``, every field of
    the report equals the reference's on tests/test_distribution.py's
    inputs; ``model_flops_for`` equals it on every runnable cell."""
    kw = dict(flops_per_device=197e12, bytes_per_device=819e9 / 2,
              collective_bytes_per_device=50e9 / 4, chips=256, model_flops=197e12 * 256 * 0.5)
    got = analysis.roofline_report(hw=j_analysis.HW, **kw).to_dict()
    assert got == j_analysis.roofline_report(**kw).to_dict()
    h100 = analysis.roofline_report(**kw)
    assert h100.compute_s == kw["flops_per_device"] / 989e12
    for arch, shape in _runnable():
        assert analysis.model_flops_for(get_config(arch), SHAPES_BY_NAME[shape]) == \
            j_analysis.model_flops_for(j_get_config(arch), J_SHAPES_BY_NAME[shape])


# ---------------------------------------------------------------------------
# 4: meshes
# ---------------------------------------------------------------------------

_FAKE_MESH = """
import json, sys
from repro_torch.launch.dryrun import init_fake_group
from repro_torch.launch.mesh import make_production_mesh
multi = sys.argv[1] == "multi"
init_fake_group(512 if multi else 256)
m = make_production_mesh(multi_pod=multi, device="cpu")
print(json.dumps([list(m.shape), list(m.mesh_dim_names), m.device_type]))
"""


@pytest.mark.parametrize("kind,shape,names", [
    ("single", [16, 16], ["data", "model"]),
    ("multi", [2, 16, 16], ["pod", "data", "model"]),
])
def test_production_mesh_on_fake_backend(kind, shape, names):
    out = subprocess.run([sys.executable, "-c", _FAKE_MESH, kind], capture_output=True, text=True,
                         timeout=120, env=_env(),
                         check=True)
    assert json.loads(out.stdout.strip().splitlines()[-1]) == [shape, names, "cpu"]


def test_debug_mesh_on_gloo(tmp_path):
    W.run_ranks(W.debug_mesh_worker, 4, str(tmp_path))
    got = [torch.load(tmp_path / f"rank{r}.pt") for r in range(4)]
    assert [g["coord"] for g in got] == [[0, 0], [0, 1], [1, 0], [1, 1]]
    assert all(g["shape"] == [2, 2] and g["names"] == ["data", "model"] for g in got)


# ---------------------------------------------------------------------------
# 5: sharding rules
# ---------------------------------------------------------------------------

_PARAM_SHAPES = {}


def _param_shapes(arch):
    if arch not in _PARAM_SHAPES:
        jshapes = jax.eval_shape(j_build_model(j_get_config(arch)).init_params,
                                 jax.random.PRNGKey(0))
        tshapes = build_model(get_config(arch), device="cpu").param_shapes()
        _PARAM_SHAPES[arch] = (jshapes, tshapes)
    return _PARAM_SHAPES[arch]


def _jspec_map(tree):
    """{key path: per-dim axes} of a reference PartitionSpec tree."""
    flat = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))[0]
    out = {}
    for path, spec in flat:
        key = tuple(str(getattr(p, "key", getattr(p, "name", p))) for p in path)
        out[key] = rules.spec_axes(tuple(spec))
    return out


def _tspec_map(tree):
    out = {}

    def walk(t, path):
        if isinstance(t, dict):
            for k, v in t.items():
                walk(v, path + (k,))
        else:
            out[path] = rules.spec_axes(t)

    walk(tree, ())
    return out


def _same(jtree, ttree):
    jm, tm = _jspec_map(jtree), _tspec_map(ttree)
    assert set(jm) == set(tm)
    for k in jm:
        # a trailing replicated dim may be left off a PartitionSpec
        n = max(len(jm[k]), len(tm[k]))
        assert jm[k] + ((),) * (n - len(jm[k])) == tm[k] + ((),) * (n - len(tm[k])), k


@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_param_pspecs_equal_reference(arch):
    jshapes, tshapes = _param_shapes(arch)
    assert {k: tuple(v.shape) for k, v in leaves_with_paths(tshapes)} == {
        tuple(str(p.key) for p in path): tuple(leaf.shape)
        for path, leaf in jax.tree_util.tree_flatten_with_path(jshapes)[0]}
    cfg, jcfg = get_config(arch), j_get_config(arch)
    for kind in MESHES:
        jm = _jmesh(kind)
        for serving in (False, True):
            pb = cfg.param_count() * 2.0
            tr = rules.ShardingRules.for_mesh(MESHES[kind], serving=serving, param_bytes=pb)
            jr = j_rules.ShardingRules.for_mesh(jm, serving=serving, param_bytes=pb)
            assert (tr.dp_axes, tr.tp_axis, tr.fsdp_axis) == (jr.dp_axes, jr.tp_axis, jr.fsdp_axis)
            _same(j_rules.param_pspecs(jcfg, jshapes, jm, jr),
                  rules.param_pspecs(cfg, tshapes, MESHES[kind], tr))


@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_batch_and_cache_pspecs_equal_reference(arch):
    cfg, jcfg = get_config(arch), j_get_config(arch)
    b, jb = build_model(cfg, device="cpu"), j_build_model(jcfg)
    for s in ALL_SHAPES:
        if not shape_applicable(cfg, s)[0]:
            continue
        js = J_SHAPES_BY_NAME[s.name]
        for kind in MESHES:
            jm = _jmesh(kind)
            _same(j_rules.batch_pspecs(jcfg, jb.batch_spec(js), jm),
                  rules.batch_pspecs(cfg, b.batch_spec(s), MESHES[kind]))
            if s.kind == "train":
                continue
            _same(j_rules.cache_pspecs(jcfg, jb.cache_spec(js), jm),
                  rules.cache_pspecs(cfg, b.cache_spec(s), MESHES[kind]))


@pytest.mark.parametrize("arch,state_dtype", [("qwen3-1.7b", "fp32"), ("grok-1-314b", "int8"),
                                              ("arctic-480b", "int8")])
def test_opt_state_pspecs_equal_reference(arch, state_dtype):
    cfg, jcfg = get_config(arch), j_get_config(arch)
    assert optimizer_for(cfg).state_dtype == state_dtype
    jshapes, tshapes = _param_shapes(arch)
    for kind in MESHES:
        jm = _jmesh(kind)
        jspecs = j_rules.param_pspecs(jcfg, jshapes, jm)
        tspecs = rules.param_pspecs(cfg, tshapes, MESHES[kind])
        jo = j_opt.opt_state_pspecs(jspecs, jshapes, j_opt.AdamWConfig(state_dtype=state_dtype), jm)
        to = opt_state_pspecs(tspecs, tshapes, optimizer_for(cfg), MESHES[kind])
        _same(jo, to)


def test_placements_of_a_spec():
    from torch.distributed.tensor import Replicate, Shard

    m = MESHES["multi"]
    assert rules.placements((("pod", "data"), None, "model"), m) == (Shard(0), Shard(0), Shard(2))
    assert rules.placements((None, None), m) == (Replicate(),) * 3
    assert rules.local_shape((256, 4096, 2048), (("pod", "data"), "model", None), m) == (8, 256, 2048)


def test_micro_batches_and_optimizer_follow_reference():
    from repro.launch import steps as j_steps

    for arch in ARCH_NAMES:
        cfg, jcfg = get_config(arch), j_get_config(arch)
        assert microbatches_for(cfg) == j_steps.microbatches_for(jcfg)
        assert optimizer_for(cfg).state_dtype == j_steps.optimizer_for(jcfg).state_dtype


# ---------------------------------------------------------------------------
# 6: compressed psum
# ---------------------------------------------------------------------------


def test_compressed_psum_on_four_gloo_ranks(tmp_path):
    """Every rank's sum equals the reference's arithmetic on the same four
    shards: ``quantize``/``dequantize`` per shard, summed in shard order."""
    shards = np.random.default_rng(0).standard_normal((4, 3, 700)).astype(np.float32)
    W.run_ranks(W.compressed_psum_worker, 4, str(tmp_path), shards)
    want = None
    for r in range(4):
        q, s = j_comp.quantize(jnp.asarray(shards[r]))
        d = np.asarray(j_comp.dequantize(q, s, shards[r].shape))
        want = d if want is None else want + d
    for r in range(4):
        got = torch.load(tmp_path / f"rank{r}.pt").numpy()
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)


# ---------------------------------------------------------------------------
# 7: sharded MoE against the reference's shard_map on a 2 x 2 host mesh
# ---------------------------------------------------------------------------

_JAX_MOE = """
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import jax, numpy as np
from repro.configs import get_config, reduced
from repro.launch.mesh import make_debug_mesh
from repro.models.moe import moe_apply_sharded
z = np.load(sys.argv[1])
arch = sys.argv[2]
p = {k: z[k] for k in ("router", "w_gate", "w_up", "w_down")}
mesh = make_debug_mesh(2, 2)
cfg = reduced(get_config(arch))
out = {}
for strategy in sys.argv[4:]:
    f = jax.jit(lambda p, x: moe_apply_sharded(p, x, cfg, mesh, strategy=strategy))
    with mesh:
        o, a = f(p, z["x"])
    out[strategy + "_out"], out[strategy + "_aux"] = np.asarray(o), np.asarray(a)
np.savez(sys.argv[3], **out)
"""


@pytest.mark.parametrize("arch,strategies", [("arctic-480b", ("ep", "a2a")),
                                             ("grok-1-314b", ("tp",))])
def test_moe_apply_sharded_matches_reference(arch, strategies, tmp_path):
    from repro.models.moe import moe_init

    cfg = j_reduced(j_get_config(arch))
    p = jax.tree.map(lambda a: np.asarray(a, np.float32), moe_init(jax.random.PRNGKey(3), cfg))
    x = np.random.default_rng(4).standard_normal((64, cfg.d_model)).astype(np.float32)
    np.savez(tmp_path / "in.npz", x=x, **p)
    subprocess.run([sys.executable, "-c", _JAX_MOE, str(tmp_path / "in.npz"), arch,
                    str(tmp_path / "out.npz"), *strategies], check=True, timeout=120,
                   env=_env(JAX_PLATFORMS="cpu"))
    want = np.load(tmp_path / "out.npz")
    for strategy in strategies:
        d = tmp_path / strategy
        d.mkdir()
        W.run_ranks(W.moe_worker, 4, str(d), arch, p, x, strategy)
        out, aux = torch.load(d / "rank0.pt")
        np.testing.assert_allclose(out.numpy(), want[strategy + "_out"], rtol=0, atol=1e-6)
        np.testing.assert_allclose(float(aux), float(want[strategy + "_aux"]), rtol=1e-5, atol=0)


# ---------------------------------------------------------------------------
# 8: sharded attention
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kw", [dict(causal=True, window=16, softcap=30.0),
                                dict(causal=False, window=0, softcap=0.0)])
def test_attention_prefill_sharded_matches_reference(kw, tmp_path):
    """2 x 2 gloo ranks (batch over data, queries over model, GQA 4 heads
    over 2) against the reference's unsharded ``attention_prefill``: f32
    within 1e-5."""
    from repro.models.layers import attention_prefill

    rng = np.random.default_rng(5)
    B, S, H, KV, D = 2, 64, 4, 2, 16
    q, k, v = (rng.standard_normal(s).astype(np.float32)
               for s in ((B, S, H, D), (B, S, KV, D), (B, S, KV, D)))
    W.run_ranks(W.attention_worker, 4, str(tmp_path), q, k, v, kw)
    pos = jnp.broadcast_to(jnp.arange(S)[None], (B, S))
    want = np.asarray(attention_prefill(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                        q_positions=pos, kv_positions=pos, **kw))
    for r in range(4):
        np.testing.assert_allclose(torch.load(tmp_path / f"rank{r}.pt").numpy(), want,
                                   rtol=0, atol=1e-5)


# ---------------------------------------------------------------------------
# 9: sharded train steps
# ---------------------------------------------------------------------------

STEPS = 3


def _masters(arch):
    """The reference's reduced init as f32 masters (numpy)."""
    jb = j_build_model(j_reduced(j_get_config(arch)))
    p = jb.init_params(jax.random.PRNGKey(0))
    return jax.tree.map(lambda a: np.asarray(a, np.float32)
                        if jnp.issubdtype(a.dtype, jnp.floating) else np.asarray(a), p)


def _batches(arch, n):
    from repro_torch.training.data import DataConfig, SyntheticLM

    data = SyntheticLM(DataConfig(reduced(get_config(arch)).vocab_size, 32, 4))
    return [data.batch_at(i) for i in range(n)]


def _sharded(arch, tmp_path, masters, batches, dtype, strategy="auto"):
    W.run_ranks(W.train_worker, 4, str(tmp_path), arch, masters, batches, len(batches), dtype,
                strategy)
    return torch.load(tmp_path / "rank0.pt")


def _unsharded(arch, masters, batches, dtype):
    """The port's unsharded step: loss_fn over ``dtype`` casts of the
    masters, f32 grads, adamw_update with the cell's optimizer."""
    from repro_torch.training.optimizer import adamw_update, init_opt_state

    cfg = reduced(get_config(arch))
    b = build_model(cfg, device="cpu")
    params = params_from_jax(masters, "cpu")
    opt_cfg = optimizer_for(cfg)
    opt = init_opt_state(params, opt_cfg)
    out = []
    for batch in batches:
        comp = map_tree(lambda p: p.detach().to(dtype).requires_grad_(), params)
        loss = b.loss_fn(comp, {k: torch.from_numpy(v) for k, v in batch.items()})
        loss.backward()
        grads = map_tree(lambda p: p.grad.float(), comp)
        params, opt, m = adamw_update(grads, opt, params, opt_cfg)
        out.append({"loss": float(loss.detach()), "grad_norm": float(m["grad_norm"])})
    return out


def _reference_train(arch, masters, batches, monkeypatch, compute=jnp.bfloat16):
    """The reference's ``build_cell`` train step of the reduced config on
    ``make_debug_mesh(1, 1)``, jitted, from the same masters; ``compute``
    is its compute leaves' type (the step casts to bf16; f32 patches that
    cast in this process)."""
    from repro.launch import steps as j_steps
    from repro.launch.mesh import make_debug_mesh

    monkeypatch.setattr(j_steps, "get_config", lambda a: j_reduced(j_get_config(a)))
    monkeypatch.setitem(j_steps.SHAPES_BY_NAME, "train_t", JShapeSpec("train_t", 32, 4, "train"))
    if compute != jnp.bfloat16:
        cast = j_steps._cast_tree
        monkeypatch.setattr(j_steps, "_cast_tree",
                            lambda t, dt: cast(t, compute if dt == jnp.bfloat16 else dt))
    mesh = make_debug_mesh(1, 1)
    cell = j_steps.build_cell(arch, "train_t", mesh)
    step = jax.jit(cell.step_fn)
    params = jax.tree.map(jnp.asarray, masters)
    opt = j_opt.init_opt_state(params, j_steps.optimizer_for(cell.cfg))
    out = []
    with mesh:
        for batch in batches:
            params, opt, m = step(params, opt, {k: jnp.asarray(v) for k, v in batch.items()})
            out.append({"loss": float(m["loss"]), "grad_norm": float(m["grad_norm"])})
    return out


def _rel(a, b):
    return abs(a - b) / abs(b)


def test_sharded_train_step_f32(tmp_path, monkeypatch):
    """Reduced qwen3, 2 x 2 gloo mesh, f32 compute leaves: three steps'
    losses and grad norms against the reference's ``build_cell`` step in
    f32 and against the port's unsharded step, 1e-5 relative (measured
    2.5e-7 and 1.1e-7)."""
    masters, batches = _masters("qwen3-1.7b"), _batches("qwen3-1.7b", STEPS)
    got = _sharded("qwen3-1.7b", tmp_path, masters, batches, "float32")
    ref = _reference_train("qwen3-1.7b", masters, batches, monkeypatch, jnp.float32)
    want = _unsharded("qwen3-1.7b", masters, batches, torch.float32)
    for g, r, w in zip(got, ref, want):
        for k in ("loss", "grad_norm"):
            assert _rel(g[k], r[k]) < 1e-5, (k, g, r)
            assert _rel(g[k], w[k]) < 1e-5, (k, g, w)


def test_sharded_train_step_bf16_matches_reference_and_trainer(tmp_path, monkeypatch):
    """Reduced qwen3, 2 x 2 gloo mesh, the reference's bf16 step: losses
    within 5e-3 of the reference's ``build_cell`` step and of the port's
    unsharded ``Trainer`` (measured 2.9e-4 and 2.6e-4), grad norms within
    5e-3 relative of both (measured 1.0e-3 and 1.2e-3: bf16 rounding)."""
    from repro_torch.training.data import DataConfig
    from repro_torch.training.optimizer import init_opt_state
    from repro_torch.training.train_loop import Trainer

    arch = "qwen3-1.7b"
    masters, batches = _masters(arch), _batches(arch, STEPS)
    got = _sharded(arch, tmp_path, masters, batches, "bfloat16")
    ref = _reference_train(arch, masters, batches, monkeypatch)
    cfg = reduced(get_config(arch))
    tr = Trainer(build_model(cfg, device="cpu"), data_cfg=DataConfig(cfg.vocab_size, 32, 4),
                 opt_cfg=optimizer_for(cfg))
    tr.params = params_from_jax(masters, "cpu")
    tr.opt_state = init_opt_state(tr.params, tr.opt_cfg)
    mine = [{k: float(v) for k, v in tr.train_step({k: torch.from_numpy(v)
                                                   for k, v in b.items()}).items()}
            for b in batches]
    for g, r, t in zip(got, ref, mine):
        assert abs(g["loss"] - r["loss"]) < 5e-3, (g, r)
        assert abs(g["loss"] - t["loss"]) < 5e-3, (g, t)
        assert _rel(g["grad_norm"], r["grad_norm"]) < 5e-3, (g, r)
        assert _rel(g["grad_norm"], t["grad_norm"]) < 5e-3, (g, t)


@pytest.mark.parametrize("mode", ["chunked_seq", "gather_kv", "heads"])
def test_attention_sharding_modes(mode, tmp_path):
    """Reduced qwen3 (2 KV heads: 'heads' shards them over the 2 model
    ranks), f32, one loss and its grads on a 2 x 2 mesh under each
    attention sharding mode, against the port's unsharded ``loss_fn``:
    loss 1e-5 relative, every grad leaf 1e-5 of its largest entry
    (measured 0 and at most 5.1e-7)."""
    from repro_torch.training.tree import leaves_with_paths as paths

    arch = "qwen3-1.7b"
    masters, (batch,) = _masters(arch), _batches(arch, 1)
    W.run_ranks(W.attn_mode_worker, 4, str(tmp_path), masters, batch, mode)
    loss, grads = torch.load(tmp_path / "rank0.pt")
    b = build_model(reduced(get_config(arch)), device="cpu")
    params = map_tree(lambda t: t.requires_grad_() if t.is_floating_point() else t,
                      params_from_jax(masters, "cpu"))
    want = b.loss_fn(params, {k: torch.from_numpy(v) for k, v in batch.items()})
    want.backward()
    want = float(want.detach())
    assert _rel(loss, want) < 1e-5, (loss, want)
    for (path, g), (_, p) in zip(paths(grads), paths(params)):
        ref = p.grad.float()
        assert float((g - ref).abs().max()) <= 1e-5 * float(ref.abs().max()), path


def test_sharded_moe_train_step_a2a(tmp_path):
    """Reduced grok on the a2a strategy, one bf16 step on 2 x 2: the loss
    is finite and within 5e-3 of the port's unsharded step."""
    arch = "grok-1-314b"
    masters, batches = _masters(arch), _batches(arch, 1)
    got = _sharded(arch, tmp_path, masters, batches, "bfloat16", "a2a")
    want = _unsharded(arch, masters, batches, torch.bfloat16)
    assert np.isfinite(got[0]["loss"]) and np.isfinite(got[0]["grad_norm"])
    assert abs(got[0]["loss"] - want[0]["loss"]) < 5e-3, (got, want)


# ---------------------------------------------------------------------------
# 10: the dry run
# ---------------------------------------------------------------------------


def test_dryrun_one_cell_in_subprocess(tmp_path):
    subprocess.run([sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", "qwen3-1.7b",
                    "--shape", "decode_32k", "--mesh", "single", "--out", str(tmp_path)],
                   check=True, timeout=300, capture_output=True,
                   env=_env())
    rec = json.loads((tmp_path / "single" / "qwen3-1.7b__decode_32k.json").read_text())
    assert rec["status"] == "ok" and rec["chips"] == 256
    assert rec["collectives"]["total_bytes"] > 0
    assert rec["memory"]["argument_bytes_per_device"] > 0


@pytest.mark.parametrize("mesh", ["single", "multi"])
def test_committed_dryrun_sweep_complete(mesh):
    base = ROOT / "results" / "torch" / "dryrun" / mesh
    recs = [json.loads(p.read_text()) for p in sorted(base.glob("*.json"))]
    assert len(recs) == 40
    statuses = [r["status"] for r in recs]
    assert statuses.count("ok") == 33 and statuses.count("skipped") == 7
    assert "error" not in statuses
    for r in recs:
        if r["status"] == "ok":
            assert set(r["collectives"]) >= set(analysis.COLLECTIVES)
            assert r["analytic"]["flops"]["total"] > 0 and r["roofline"]["chips"] == r["chips"]
            assert "H100" in r["roofline_hw"]
            if r["shape"] == "train_4k":
                assert r["collectives"]["all-gather"]["bytes"] > 0


# ---------------------------------------------------------------------------
# 11: without a mesh nothing changed
# ---------------------------------------------------------------------------

# torch_forward_digest.py run on the tree before the distribution slice
BEFORE = {
    "dense": "10cd220721be6ec7c202f1b46cfac21b39453693e4f67656847690e5a6c0e0ef",
    "moe": "f026718d9bce83209e93231de586b1c25a866ecee3fa0ac664c25727121e1e6e",
    "vlm": "a2d8aa471bea69bb099267c4bccb0416ed3ea975be45eba7da4de72050296cd6",
    "hybrid": "169466ca031c182e53240918a2cbe98ada6723913c1b335b78b0dc578ca6246f",
    "ssm": "a5fb87e62eebbda639a8fa48884b1d093b6835c98d9799367b3062c84dadf55f",
    "audio": "cb0d8185ae9279706a4637c2a752c81f5da3090e514e58c2f8537bc0a93f588c",
}


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_no_mesh_paths_bitwise_unchanged(family):
    """loss_fn, prefill_fn and decode_fn of a reduced model per family, on
    the CPU in bf16, bitwise the tree's before the slice."""
    assert digest(FAMILIES[family]) == BEFORE[family]


# ---------------------------------------------------------------------------
# 9 (cont.): Trainer(mesh=), checkpoints onto placements, remesh, the launcher
# ---------------------------------------------------------------------------


def test_trainer_on_mesh_resumes_and_remeshes(tmp_path):
    """``Trainer(mesh=)`` on 2 x 2 gloo ranks: a trainer resumed from the
    unsharded checkpoint onto its placements repeats the uninterrupted
    run's last losses bitwise, and after ``remesh`` onto 1 x 4 the state
    trains on; its first losses are the port's unsharded Trainer's within
    5e-3 (bf16)."""
    from repro_torch.training.data import DataConfig
    from repro_torch.training.optimizer import AdamWConfig, init_opt_state
    from repro_torch.training.train_loop import Trainer

    steps = 5  # one checkpoint, at step 3
    masters = _masters("qwen3-1.7b")
    W.run_ranks(W.trainer_worker, 4, str(tmp_path), masters, steps)
    got = torch.load(tmp_path / "rank0.pt")
    assert got["b"] == got["a"][steps - 2 : steps]
    assert len(got["a"]) == steps + 1 and np.isfinite(got["a"][-1])
    assert "Shard" in got["placements"]
    cfg = reduced(get_config("qwen3-1.7b"))
    tr = Trainer(build_model(cfg, device="cpu"), data_cfg=DataConfig(cfg.vocab_size, 32, 4),
                 opt_cfg=AdamWConfig(lr=3e-3, warmup_steps=2))
    tr.params = params_from_jax(masters, "cpu")
    tr.opt_state = init_opt_state(tr.params, tr.opt_cfg)
    tr.run(steps, log_every=0)
    np.testing.assert_allclose(got["a"][:steps], [m["loss"] for m in tr.metrics], atol=5e-3)


def test_launcher_production_mesh_needs_256_ranks():
    out = subprocess.run([sys.executable, "-m", "repro_torch.launch.train", "--reduced",
                          "--device", "cpu", "--mesh", "production", "--steps", "1"],
                         capture_output=True, text=True, timeout=120, env=_env())
    assert out.returncode != 0 and "needs 256 ranks" in out.stderr


def test_kernel_route_refuses_a_query_offset():
    """On the card the sharded attention body hands a rank's query slice to
    K5 only where the slice starts at 0 (or no mask depends on the offset);
    a slice past 0 raises, it never takes the plain route."""
    from repro_torch.models.layers import kernel_slice_check

    kernel_slice_check(0, causal=True, window=16, contiguous=True)
    kernel_slice_check(512, causal=False, window=0, contiguous=True)
    with pytest.raises(NotImplementedError, match="query offset"):
        kernel_slice_check(512, causal=True, window=0, contiguous=True)
    with pytest.raises(NotImplementedError):
        kernel_slice_check(512, causal=False, window=16, contiguous=True)
    with pytest.raises(ValueError):
        kernel_slice_check(0, causal=True, window=0, contiguous=False)

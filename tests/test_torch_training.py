"""The port's training substrate against the JAX package's, on reduced
qwen3-1.7b on the CPU: the counterparts of tests/test_training.py, each
held against the reference.

The JAX ``Trainer`` runs once per module (fp32 and int8 moments), saving a
checkpoint at step 0 and every 5 steps; the port's ``Trainer`` resumes
those checkpoints (the same format: a JAX checkpoint restores in the port)
and its losses are held to the JAX trainer's.  Both compute in bf16 from
f32 masters, and the two frameworks round bf16 matmuls and sums in
different orders, so the losses part slowly: the largest |d| measured was
8.8e-4 over 30 steps with fp32 moments and 1.6e-3 over 25 with int8,
held to 5e-3.  The data stream, the int8 quantizers and error feedback are
bitwise equal; two ``adamw_update`` calls from the same numpy state and
grads agree within 1e-6 of each leaf's largest value in fp32 moments
(measured 5.8e-7: the global norm's f32 sum, summed in another order, is
7.2e-8 apart), and within 2^-8 (one bf16 ulp) of the largest value plus
2^-8 relative where a moment is stored in bf16 (measured 4.6e-3 of the
largest value).  Within the port, restart is bitwise on the CPU.
"""
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config, reduced
from repro.launch.mesh import make_debug_mesh
from repro.models.registry import build_model as jax_build_model
from repro.training import checkpoint as j_ckpt
from repro.training import compression as j_comp
from repro.training import data as j_data
from repro.training import optimizer as j_opt
from repro.training.train_loop import StragglerMonitor as JStragglerMonitor
from repro.training.train_loop import Trainer as JTrainer
from repro_torch.configs import get_config as t_get_config
from repro_torch.configs import reduced as t_reduced
from repro_torch.models.registry import build_model
from repro_torch.params import params_from_jax
from repro_torch.training import compression
from repro_torch.training.checkpoint import latest_checkpoint, restore_checkpoint
from repro_torch.training.data import DataConfig, SyntheticLM
from repro_torch.training.optimizer import (
    AdamWConfig,
    adamw_update,
    dequantize_blockwise,
    init_opt_state,
    quantize_blockwise,
)
from repro_torch.training.train_loop import StragglerMonitor, Trainer
from repro_torch.training.tree import leaves_with_paths

ARCH = "qwen3-1.7b"
LOSS_TOL = 5e-3  # port vs JAX trainer losses over up to 30 steps (measured <= 1.6e-3)


def _data(cfg):
    return dict(vocab_size=cfg.vocab_size, seq_len=32, global_batch=4)


def _run_jax(tmp, steps, **opt):
    cfg = reduced(get_config(ARCH))
    tr = JTrainer(
        jax_build_model(cfg), make_debug_mesh(1, 1),
        data_cfg=j_data.DataConfig(**_data(cfg)),
        opt_cfg=j_opt.AdamWConfig(lr=3e-3, warmup_steps=5, **opt),
        ckpt_dir=tmp, ckpt_every=5, async_ckpt=False,
    )
    tr.save()  # step 0: the initial masters and zero moments
    tr.run(steps, log_every=0)
    return {"dir": tmp, "losses": [m["loss"] for m in tr.metrics], "trainer": tr}


@pytest.fixture(scope="module")
def jax_fp32(tmp_path_factory):
    return _run_jax(tmp_path_factory.mktemp("jax_fp32"), 30)


@pytest.fixture(scope="module")
def jax_int8(tmp_path_factory):
    return _run_jax(tmp_path_factory.mktemp("jax_int8"), 25, state_dtype="int8")


@pytest.fixture(scope="module")
def bundle():
    return build_model(t_reduced(t_get_config(ARCH)), device="cpu")


def make_trainer(bundle, tmp=None, **kw):
    cfg = bundle.cfg
    return Trainer(
        bundle,
        data_cfg=DataConfig(**_data(cfg)),
        opt_cfg=AdamWConfig(lr=3e-3, warmup_steps=5, **kw.pop("opt", {})),
        ckpt_dir=tmp,
        ckpt_every=kw.pop("ckpt_every", 5),
        **kw,
    )


def from_jax(bundle, run, step, tmp, **kw):
    """A port trainer resumed from the JAX trainer's checkpoint at ``step``."""
    shutil.copytree(run["dir"] / f"step-{step:08d}", tmp / f"step-{step:08d}")
    tr = make_trainer(bundle, tmp, **kw)
    assert tr.resume() and tr.step == step
    return tr


def _losses(tr, start=0):
    return [m["loss"] for m in tr.metrics[start:]]


def test_loss_decreases(bundle, jax_fp32, tmp_path):
    tr = from_jax(bundle, jax_fp32, 0, tmp_path, ckpt_every=100)
    metrics = tr.run(30, log_every=0)
    first = np.mean([m["loss"] for m in metrics[:5]])
    last = np.mean([m["loss"] for m in metrics[-5:]])
    assert last < first - 0.3, f"no learning: {first:.3f} -> {last:.3f}"
    np.testing.assert_allclose(_losses(tr), jax_fp32["losses"], rtol=0, atol=LOSS_TOL)


@pytest.mark.parametrize("step", [0, 5])
def test_jax_checkpoint_resumes_in_port(bundle, jax_fp32, tmp_path, step):
    """A checkpoint of the JAX trainer restores into the port's trainer,
    which then runs to step 10 close to the JAX trainer's own losses."""
    tr = from_jax(bundle, jax_fp32, step, tmp_path, ckpt_every=100)
    tr.run(10, log_every=0)
    np.testing.assert_allclose(_losses(tr), jax_fp32["losses"][step:10], rtol=0, atol=LOSS_TOL)


def test_checkpoint_restart_exact(bundle, jax_fp32, tmp_path):
    tr1 = from_jax(bundle, jax_fp32, 0, tmp_path, async_ckpt=False)
    tr1.run(10, log_every=0)
    # fresh trainer resumes at step 10 and must replay steps 11.. bitwise
    tr2 = make_trainer(bundle, tmp=tmp_path, async_ckpt=False)
    assert tr2.resume()
    assert tr2.step == 10
    tr1.run(15, log_every=0)
    tr2.run(15, log_every=0)
    np.testing.assert_array_equal(_losses(tr1, 10), _losses(tr2))
    np.testing.assert_allclose(_losses(tr1), jax_fp32["losses"][:15], rtol=0, atol=LOSS_TOL)


def _jax_template(run):
    return {"params": run["trainer"].params, "opt": run["trainer"].opt_state}


def test_async_checkpointer(bundle, jax_fp32, tmp_path):
    tr = make_trainer(bundle, tmp=tmp_path, async_ckpt=True)
    tr.run(6, log_every=0)
    tr.ckpt.wait()
    path = latest_checkpoint(tmp_path)
    assert path is not None and path.name == "step-00000005"
    # the port's checkpoint restores in the JAX package, leaf for leaf
    step, state, _ = j_ckpt.restore_checkpoint(path, _jax_template(jax_fp32))
    _, mine, _ = restore_checkpoint(path, {"params": tr.params, "opt": tr.opt_state})
    assert step == 5
    theirs = dict(leaves_with_paths(jax.tree.map(np.asarray, state)))
    for key, t in leaves_with_paths(mine):
        np.testing.assert_array_equal(t.numpy(), theirs[key])


def test_elastic_remesh(bundle):
    tr = make_trainer(bundle)
    tr.run(3, log_every=0)
    tr.remesh("cpu")  # the state moves to a device (here the same one)
    tr.run(6, log_every=0)
    assert tr.step == 6 and tr.device == torch.device("cpu")
    ref = make_trainer(bundle)
    ref.run(6, log_every=0)
    np.testing.assert_array_equal(_losses(tr), _losses(ref))


def test_checkpoint_mesh_agnostic(bundle, jax_fp32, tmp_path):
    """Saved state restores onto a named device, equal leaf for leaf, and
    restores in the JAX package too."""
    tr = make_trainer(bundle, tmp=tmp_path, async_ckpt=False)
    tr.run(5, log_every=0)
    tr.save()
    path = latest_checkpoint(tmp_path)
    template = {"params": tr.params, "opt": tr.opt_state}
    step, state, meta = restore_checkpoint(path, template, device="cpu")
    assert step == 5 and meta["arch"] == ARCH
    for (ka, a), (kb, b) in zip(leaves_with_paths(state), leaves_with_paths(template)):
        assert ka == kb
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    jstep, jstate, _ = j_ckpt.restore_checkpoint(path, _jax_template(jax_fp32))
    want = dict(leaves_with_paths(jax.tree.map(np.asarray, jstate["params"])))
    for key, t in leaves_with_paths(tr.params):
        np.testing.assert_array_equal(t.numpy(), want[key])


def test_straggler_monitor():
    mons = [StragglerMonitor(factor=2.0, abs_floor_s=0.0), JStragglerMonitor(factor=2.0, abs_floor_s=0.0)]
    hits = [[], []]
    for mon, h in zip(mons, hits):
        mon.mitigate = lambda step, dt, h=h: h.append(step)
        for step in range(10):
            mon.observe(step, 0.1)
        assert not mon.events
        mon.observe(10, 1.0)  # 10x the EWMA -> straggler
    assert hits == [[10], [10]]
    assert mons[0].events == mons[1].events


def test_gradient_compression_roundtrip():
    rng = np.random.default_rng(0)
    x = (rng.normal(size=(1000,)) * 0.01).astype(np.float32)
    q, s = compression.quantize(torch.from_numpy(x))
    jq, js = j_comp.quantize(jnp.asarray(x))
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))
    y = compression.compress_roundtrip(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(y, np.asarray(j_comp.compress_roundtrip(jnp.asarray(x))))
    assert np.abs(x - y).max() < 0.01 / 127 * 2


def test_error_feedback_reduces_bias():
    rng = np.random.default_rng(1)
    w = (rng.normal(size=(512,)) * 0.01).astype(np.float32)
    g, jg = {"w": torch.from_numpy(w)}, {"w": jnp.asarray(w)}
    residual, jres = compression.ErrorFeedback.init(g), j_comp.ErrorFeedback.init(jg)
    total = torch.zeros_like(g["w"])
    for _ in range(20):
        sent, residual = compression.ErrorFeedback.apply(g, residual)
        jsent, jres = j_comp.ErrorFeedback.apply(jg, jres)
        np.testing.assert_array_equal(sent["w"].numpy(), np.asarray(jsent["w"]))
        np.testing.assert_array_equal(residual["w"].numpy(), np.asarray(jres["w"]))
        total = total + sent["w"]
    # cumulative transmitted gradient converges to 20x the true gradient
    np.testing.assert_allclose(total.numpy(), w * 20, atol=2e-4)


def test_int8_moment_quantization_roundtrip():
    rng = np.random.default_rng(2)
    x = (rng.normal(size=(7, 300)) * 0.1).astype(np.float32)
    q = quantize_blockwise(torch.from_numpy(x))
    jq = j_opt.quantize_blockwise(jnp.asarray(x))
    for k in ("q", "scale"):
        np.testing.assert_array_equal(q[k].numpy(), np.asarray(jq[k]))
    y = dequantize_blockwise(q, x.shape[-1]).numpy()
    assert y.shape == x.shape
    np.testing.assert_array_equal(y, np.asarray(j_opt.dequantize_blockwise(jq, x.shape[-1])))
    np.testing.assert_allclose(x, y, atol=0.1 * 2 / 127)


def test_int8_optimizer_trains(bundle, jax_int8, tmp_path):
    tr = from_jax(bundle, jax_int8, 0, tmp_path, ckpt_every=100, opt={"state_dtype": "int8"})
    metrics = tr.run(25, log_every=0)
    first = np.mean([m["loss"] for m in metrics[:5]])
    last = np.mean([m["loss"] for m in metrics[-5:]])
    assert last < first - 0.2, f"int8 states failed to learn: {first} -> {last}"
    np.testing.assert_allclose(_losses(tr), jax_int8["losses"], rtol=0, atol=LOSS_TOL)


def test_data_pipeline_deterministic_cursor():
    cfg = DataConfig(vocab_size=128, seq_len=16, global_batch=2, seed=7)
    a = SyntheticLM(cfg).batch_at(42)
    b = SyntheticLM(cfg).batch_at(42)
    np.testing.assert_array_equal(a["tokens"], b["tokens"])
    c = SyntheticLM(cfg).batch_at(43)
    assert not np.array_equal(a["tokens"], c["tokens"])
    ref = j_data.SyntheticLM(j_data.DataConfig(vocab_size=128, seq_len=16, global_batch=2, seed=7))
    for step in (0, 42, 43):
        got, want = SyntheticLM(cfg).batch_at(step)["tokens"], ref.batch_at(step)["tokens"]
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("state_dtype", ["fp32", "bf16", "int8"])
def test_adamw_update_matches_jax(state_dtype):
    """Two updates from the same params and numpy grads (the second reads
    non-zero moments), a stacked [L, ...] leaf included (the per-layer
    path).  fp32 within 1e-6 of the leaf's largest value; a bf16-stored
    moment's rounding may land one bf16 ulp apart, so bf16/int8 states
    within 2^-8 of the largest value plus 2^-8 relative; an
    int8 value may land one step apart where its f32 moment sits at a
    rounding boundary (measured: 1 of 49,152 values)."""
    rng = np.random.default_rng(3)
    shapes = {"embed": (64, 32), "layers": {"w": (3, 32, 300), "n": (3, 32)}, "b": (5,)}
    params = jax.tree.map(lambda s: rng.normal(size=s).astype(np.float32), shapes,
                          is_leaf=lambda s: isinstance(s, tuple))
    grads = [jax.tree.map(lambda p: (rng.normal(size=p.shape) * 0.3).astype(np.float32), params)
             for _ in range(2)]
    jcfg = j_opt.AdamWConfig(lr=1e-2, warmup_steps=3, state_dtype=state_dtype)
    tcfg = AdamWConfig(lr=1e-2, warmup_steps=3, state_dtype=state_dtype)
    jp = jax.tree.map(jnp.asarray, params)
    js = j_opt.init_opt_state(jp, jcfg)
    tp = params_from_jax(params, "cpu")
    ts = init_opt_state(tp, tcfg)
    for g in grads:
        jp, js, jm = j_opt.adamw_update(jax.tree.map(jnp.asarray, g), js, jp, jcfg)
        tp, ts, tm = adamw_update(params_from_jax(g, "cpu"), ts, tp, tcfg)
    tol = 1e-6 if state_dtype == "fp32" else 2.0 ** -8
    np.testing.assert_allclose(float(tm["grad_norm"]), float(jm["grad_norm"]), rtol=1e-6)
    np.testing.assert_allclose(float(tm["lr"]), float(jm["lr"]), rtol=1e-7)
    assert int(ts["step"]) == int(js["step"]) == 2
    want = dict(leaves_with_paths(jax.tree.map(lambda a: np.asarray(a, np.float32),
                                               {"p": jp, "m": js["m"], "v": js["v"]})))
    for key, t in leaves_with_paths({"p": tp, "m": ts["m"], "v": ts["v"]}):
        ref, got = want[key], t.float().numpy()
        if key[-1] == "q":
            assert np.abs(got - ref).max() <= 1 and (got != ref).mean() < 1e-3, "/".join(key)
            continue
        rtol = 0.0 if state_dtype == "fp32" else tol
        np.testing.assert_allclose(got, ref, rtol=rtol, atol=tol * np.abs(ref).max(),
                                   err_msg="/".join(key))

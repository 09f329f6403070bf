"""The MoE train step with the full configs' memory budget, against the JAX
package, on the CPU.

``optimizer_for`` and ``microbatches_for`` key on ``cfg.param_count()``:
grok-1-314b and arctic-480b train with int8 first moments (bf16 second
moments) and 8 micro-batches, which their reduced configs would not get.
Both sides force the full configs' choice here: the port through
``build_cell``'s ``opt_cfg`` and ``n_micro`` overrides, the reference by
patching its ``launch.steps.optimizer_for``/``microbatches_for`` in this
process, as ``test_torch_distribution._reference_train`` patches
``get_config``.

Reduced grok and arctic, every expert with room for every token
(capacity factor E / k: no token drops, so neither a strategy's token
groups nor the rounding can move one), 16 x 128 ``SyntheticLM`` tokens (8
micro-batches of two rows: DTensor's matmul cannot flatten a one-row
micro-batch sharded over 'data', and on 2 x 2 each data rank keeps one
row of each), three steps of the port's sharded step on four gloo ranks
(one spawn per arch: 2 x 2 and 1 x 4, ``ep``, ``tp`` and ``a2a``), held
against the reference's jitted ``build_cell`` step on
``make_debug_mesh(1, 1)`` and against the port's unsharded
``make_train_step``: losses within 5e-3, grad norms within 5e-3 relative.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.configs import reduced as j_reduced
from repro.configs.base import ShapeSpec as JShapeSpec
from repro.models.registry import build_model as j_build_model
from repro.training import optimizer as j_opt
from repro_torch.configs import get_config, reduced
from repro_torch.launch.steps import microbatches_for, optimizer_for
from repro_torch.models.registry import build_model
from repro_torch.params import params_from_jax

import torch_dist_workers as W

MESHES = ("2x2", "1x4")
STRATEGIES = ("ep", "tp", "a2a")
ROWS, SEQ, STEPS = 16, 128, 3


def _room(cfg):
    """Every expert with room for every token: capacity factor E / k."""
    E, k = cfg.moe.num_experts, cfg.moe.experts_per_token
    return cfg.replace(moe=dataclasses.replace(cfg.moe, capacity_factor=E / k))


def _masters(arch):
    """The reference's reduced init as f32 masters (numpy)."""
    p = j_build_model(j_reduced(j_get_config(arch))).init_params(jax.random.PRNGKey(0))
    return jax.tree.map(lambda a: np.asarray(a, np.float32)
                        if jnp.issubdtype(a.dtype, jnp.floating) else np.asarray(a), p)


def _reference(arch, masters, batches):
    """The reference's ``build_cell`` train step of the reduced config
    with room, the full config's optimizer and micro-batch count, jitted
    on ``make_debug_mesh(1, 1)``."""
    from repro.launch import steps as j_steps
    from repro.launch.mesh import make_debug_mesh

    full_opt = j_steps.optimizer_for(j_get_config(arch))
    full_micro = j_steps.microbatches_for(j_get_config(arch))
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(j_steps, "get_config",
                   lambda a: _room(j_reduced(j_get_config(a))))
        mp.setattr(j_steps, "optimizer_for", lambda cfg: full_opt)
        mp.setattr(j_steps, "microbatches_for", lambda cfg: full_micro)
        mp.setitem(j_steps.SHAPES_BY_NAME, "train_m", JShapeSpec("train_m", SEQ, ROWS, "train"))
        mesh = make_debug_mesh(1, 1)
        cell = j_steps.build_cell(arch, "train_m", mesh)
        step = jax.jit(cell.step_fn)
        params = jax.tree.map(jnp.asarray, masters)
        opt = j_opt.init_opt_state(params, full_opt)
        out = []
        with mesh:
            for batch in batches:
                params, opt, m = step(params, opt, {k: jnp.asarray(v) for k, v in batch.items()})
                out.append({"loss": float(m["loss"]), "grad_norm": float(m["grad_norm"])})
    return out, full_opt.state_dtype, full_micro


def _unsharded(arch, masters, batches):
    """The port's unsharded step with the same overrides."""
    from repro_torch.training.optimizer import init_opt_state
    from repro_torch.training.step import make_train_step

    full_cfg = get_config(arch)
    cfg = _room(reduced(full_cfg))
    opt_cfg = optimizer_for(full_cfg)
    step = make_train_step(build_model(cfg, device="cpu"), opt_cfg,
                           n_micro=microbatches_for(full_cfg))
    params = params_from_jax(masters, "cpu")
    opt = init_opt_state(params, opt_cfg)
    out = []
    for batch in batches:
        params, opt, m = step(params, opt, {k: torch.from_numpy(v) for k, v in batch.items()})
        out.append({k: float(v) for k, v in m.items()})
    return out


@pytest.fixture(scope="module")
def moe_train(tmp_path_factory):
    """Per arch, computed once: the port's sharded steps, the reference's
    step and the port's unsharded step."""
    from repro_torch.training.data import DataConfig, SyntheticLM

    cache = {}

    def get(arch):
        if arch not in cache:
            d = tmp_path_factory.mktemp("moe_train")
            masters = _masters(arch)
            data = SyntheticLM(DataConfig(reduced(get_config(arch)).vocab_size, SEQ, ROWS))
            batches = [data.batch_at(i) for i in range(STEPS)]
            W.run_ranks(W.moe_train_worker, 4, str(d), arch, MESHES, masters, batches,
                        STRATEGIES, timeout=600)
            cache[arch] = (torch.load(d / "rank0.pt"), _reference(arch, masters, batches),
                           _unsharded(arch, masters, batches))
        return cache[arch]

    return get


def _rel(a, b):
    return abs(a - b) / abs(b)


@pytest.mark.parametrize("strategy", STRATEGIES)
@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("arch", ["grok-1-314b", "arctic-480b"])
def test_moe_train_step_int8_moments_8_micro(moe_train, arch, mesh, strategy):
    """Three steps of the sharded step on four gloo ranks with int8 first
    moments and 8 micro-batches: losses within 5e-3 and grad norms within
    5e-3 relative of the reference's step and of the port's unsharded
    step.  The reference and the unsharded step dispatch each micro-batch's
    tokens as one group, as ep on 1 x 4 does; a2a and 2 x 2 dispatch fewer
    tokens a group, so their GShard aux losses differ a little (at 16 x 32
    tokens that difference reached 6.1e-3 in a loss and 5.0e-3 in a grad
    norm, and bf16 noise against the reference's step on the same mesh
    5.2e-3 at step 3, so the rows are 128 tokens long).  Measured over the
    12 cases at 16 x 128: losses within 1.97e-3 and grad norms 2.76e-3
    relative of the reference's, 1.93e-3 and 2.85e-3 of the unsharded
    step's; 1 x 4 ep and tp within 1.9e-4 and 1.4e-3 of both."""
    port, (ref, ref_dtype, ref_micro), unsharded = moe_train(arch)
    got = port[mesh][strategy]
    assert got["state_dtype"] == ref_dtype == "int8" and got["n_micro"] == ref_micro == 8
    assert got["m_dtype"] == "torch.int8"
    for g, r, u in zip(got["metrics"], ref, unsharded, strict=True):
        assert np.isfinite(g["loss"]) and np.isfinite(g["grad_norm"])
        assert abs(g["loss"] - r["loss"]) < 5e-3, (g, r)
        assert _rel(g["grad_norm"], r["grad_norm"]) < 5e-3, (g, r)
        assert abs(g["loss"] - u["loss"]) < 5e-3, (g, u)
        assert _rel(g["grad_norm"], u["grad_norm"]) < 5e-3, (g, u)

"""The port's parameter trees and device rule against the JAX package.

Every leaf of the reduced configs (stablelm-12b and deepseek-7b with their
own head shapes) round-trips bitwise through
``params_from_jax`` (bf16 included, without ml_dtypes on the torch side);
the port's own ``init_params`` builds the same tree, shapes, dtypes and
init scales; and with no card every entry point called without
``device="cpu"`` raises instead of running on the host.
"""
import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config, reduced
from repro.models.registry import build_model as jax_build_model
from repro_torch.configs import get_config as t_get_config
from repro_torch.configs import reduced as t_reduced
from repro_torch.models import transformer as t_tf
from repro_torch.models.registry import build_model
from repro_torch.params import params_from_jax
from repro_torch.serving.engine import ServingEngine

ARCHS = ["qwen3-1.7b", "h2o-danube-1.8b", "stablelm-12b", "deepseek-7b"]

# Shape-faithful small configs, built the same way on both sides: reduced()
# sets head_dim 16 and 2 kv heads, which would erase what these two models
# bring (stablelm-12b: head_dim 160 at G = 4; deepseek-7b: G = 1).
SHAPES = {
    "stablelm-12b": dict(num_heads=4, num_kv_heads=1, head_dim=160),
    "deepseek-7b": dict(num_heads=4, num_kv_heads=4),
}


def small(reduce, cfg):
    """``reduce(cfg)`` with the model's own head shape kept (SHAPES)."""
    return reduce(cfg).replace(**SHAPES.get(cfg.name, {}))


def tensor_to_numpy(t):
    """bf16 comes back as its uint16 bit pattern."""
    t = t.contiguous()
    return t.view(torch.uint16).numpy() if t.dtype == torch.bfloat16 else t.numpy()


def _flat(tree, prefix=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _flat(tree[k], prefix + (k,))
    else:
        yield prefix, tree


@pytest.fixture(scope="module", params=ARCHS)
def jax_tree(request):
    cfg = small(reduced, get_config(request.param))
    params = jax_build_model(cfg).init_params(jax.random.PRNGKey(0))
    return request.param, jax.tree.map(np.asarray, params)


def test_params_from_jax_roundtrips_bitwise(jax_tree):
    """Tolerance: none — every leaf's bytes are identical."""
    _, tree = jax_tree
    ported = params_from_jax(tree, "cpu")
    leaves = dict(_flat(ported))
    for path, a in _flat(tree):
        t = leaves[path]
        assert tuple(t.shape) == a.shape, path
        back = tensor_to_numpy(t)
        if a.dtype.name == "bfloat16":
            assert t.dtype == torch.bfloat16, path
            assert np.array_equal(back, a.view(np.uint16)), path
        else:
            assert np.array_equal(back, a), path


def test_init_params_matches_jax_tree(jax_tree):
    """Same tree, shapes and dtypes; init scales within 10% (numbers differ)."""
    name, tree = jax_tree
    cfg = small(t_reduced, t_get_config(name))
    ported = t_tf.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    want = dict(_flat(tree))
    got = dict(_flat(ported))
    assert set(got) == set(want)
    for path, a in want.items():
        t = got[path]
        assert tuple(t.shape) == a.shape, path
        assert str(t.dtype).removeprefix("torch.") == a.dtype.name, path
        std_jax = float(np.asarray(a, np.float32).std())
        std_port = float(t.float().std())
        if std_jax == 0.0:
            assert std_port == 0.0, path
        else:
            assert abs(std_port / std_jax - 1.0) < 0.1, (path, std_port, std_jax)


def test_init_params_is_seeded():
    cfg = t_reduced(t_get_config("qwen3-1.7b"))
    a = t_tf.init_params(cfg, torch.Generator().manual_seed(3), "cpu")
    b = t_tf.init_params(cfg, torch.Generator().manual_seed(3), "cpu")
    assert all(torch.equal(x, y) for (_, x), (_, y) in zip(_flat(a), _flat(b)))


def test_entry_points_need_a_card_unless_cpu_is_asked_for(monkeypatch):
    """Without a CUDA device, the default device raises: nothing falls back
    to the CPU silently."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = t_reduced(t_get_config("qwen3-1.7b"))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_model(cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        t_tf.init_params(cfg, torch.Generator().manual_seed(0))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        t_tf.make_cache(cfg, 1, 16)
    assert t_tf.make_cache(cfg, 1, 16, device="cpu")["k"].device.type == "cpu"
    bundle = build_model(cfg, device="cpu")
    params = bundle.init_params(torch.Generator().manual_seed(0))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ServingEngine(bundle, params, block_size=4, device_blocks=8)
    eng = ServingEngine(bundle, params, block_size=4, device_blocks=8, device="cpu")
    eng.close()


def test_unported_modes_raise():
    cfg = t_reduced(t_get_config("qwen3-1.7b"))
    bundle = build_model(cfg, device="cpu")
    params = bundle.init_params(torch.Generator().manual_seed(0))
    # int8 KV and the audio family are ported; a cache type or family that
    # neither package serves still raises
    with pytest.raises(NotImplementedError, match="kv_cache_dtype=fp8 is not ported"):
        build_model(cfg.replace(kv_cache_dtype="fp8"), device="cpu")
    with pytest.raises(ValueError, match="decode_mode"):
        ServingEngine(bundle, params, decode_mode="ring", device="cpu")
    with pytest.raises(NotImplementedError):
        build_model(cfg.replace(family="diffusion"), device="cpu")

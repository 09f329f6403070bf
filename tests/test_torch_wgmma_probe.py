"""The inputs of the wgmma-vs-mma.sync probe (``repro_torch.bench.wgmma_probe``),
on the CPU: each class holds bf16 values and exercises what it is named
for, and the sequential f32 sum it is held against is the plain k-order
sum.  The probe itself runs on the card (``tests/test_torch_gpu.py``)."""
import numpy as np
import pytest
import torch

from repro_torch.bench import wgmma_probe as wp


@pytest.mark.parametrize("kind", wp.CLASSES)
def test_probe_inputs_are_bf16_values_of_the_right_shapes(kind):
    a, b, c = wp.problems(kind, 3, np.random.default_rng(1))
    assert a.shape == (3, 16, 16) and b.shape == (3, 16, wp.N) and c.shape == (3, 16, wp.N)
    for x in (a, b):
        assert np.array_equal(x, torch.from_numpy(x).bfloat16().float().numpy())
    assert c.dtype == np.float32 and np.isfinite(c).all()


def test_probe_classes_exercise_what_they_are_named_for():
    rng = np.random.default_rng(2)
    terms = lambda a, b: np.abs(a[:, :, :, None] * b[:, None, :, :])  # |a_ik b_kj|
    a, b, c = wp.problems("subnormal", 4, rng)
    prods = terms(a.astype(np.float64), b)
    assert (prods[prods > 0] < 2.0 ** -126).mean() > 0.5  # f32 subnormal products
    a, b, c = wp.problems("large C", 4, rng)
    assert (np.abs(c) >= 2.0 ** 8).all()
    assert np.median(np.abs(c)) > 100 * np.median(terms(a, b).max(axis=2))
    a, b, c = wp.problems("near cancelling", 4, rng)
    s = np.einsum("nik,nkj->nij", a.astype(np.float64), b) + c
    assert np.median(np.abs(s) / terms(a.astype(np.float64), b).sum(axis=2)) < 1e-3
    a, b, _ = wp.problems("exponent spread", 4, rng)
    e = np.log2(np.abs(a[a != 0]))
    assert e.max() - e.min() > 30


def test_sequential_sum_is_the_plain_k_order_f32_sum():
    a, b, c = wp.problems("normal", 2, np.random.default_rng(3))
    want = torch.from_numpy(c.copy())
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    for k in range(16):
        want = want + ta[:, :, k, None] * tb[:, None, k, :]
    assert np.array_equal(wp._sequential_f32(a, b, c), want.numpy())

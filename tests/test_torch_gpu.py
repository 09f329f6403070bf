"""CUDA kernels against their plain PyTorch versions, on the card.

Run on a machine with an NVIDIA GPU and nvcc:

    PYTHONPATH=src python -m pytest -m gpu tests/test_torch_gpu.py

Without a card every test here skips (the check happens inside the
fixture, never at import).  Tolerances are those of tests/test_kernels.py:
1e-5 in float32, 2e-2 in bfloat16; the page copy is exact.  Only
``test_fully_masked_row_kernel_returns_zeros`` holds a query row with no
valid key (the kernel returns zeros there, the dense plain version uniform
weights; the serving path never builds one).
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import kv_block_copy as kbc
from repro_torch.kernels import paged_attention as pa

pytestmark = pytest.mark.gpu

TOLS = {torch.float32: dict(rtol=1e-5, atol=1e-5), torch.bfloat16: dict(rtol=2e-2, atol=2e-2)}


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _t(a, dtype, dev):
    a = np.asarray(a)
    if a.dtype.kind in "iu":
        return torch.from_numpy(a.astype(np.int32)).to(dev)
    return torch.from_numpy(a.astype(np.float32)).to(dtype).to(dev)


def _close(got, want, dtype):
    torch.cuda.synchronize()
    torch.testing.assert_close(got.float(), want.float(), **TOLS[dtype])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize(
    "B,KV,G,D,page,P,N,T,window,softcap",
    [
        (2, 2, 2, 16, 4, 4, 16, 8, 0, 0.0),
        (1, 4, 1, 32, 8, 3, 8, 4, 0, 0.0),
        (3, 1, 4, 16, 4, 5, 32, 8, 12, 0.0),
        (2, 2, 2, 16, 4, 4, 16, 8, 0, 20.0),
        (8, 8, 2, 128, 16, 32, 320, 24, 0, 0.0),  # qwen3-1.7b decode step
        (8, 8, 2, 128, 16, 32, 320, 24, 128, 30.0),
    ],
)
def test_paged_decode_kernel_matches_plain(dev, dtype, B, KV, G, D, page, P, N, T, window, softcap):
    rng = np.random.default_rng(5)
    prefix_len = rng.integers(0, P * page + 1, (B,))
    t_used = rng.integers(1, T + 1, (B,))
    tail_pos = np.full((B, T), -1, np.int32)
    for b in range(B):
        tail_pos[b, : t_used[b]] = prefix_len[b] + np.arange(t_used[b])
    args = [
        _t(rng.normal(size=(B, KV, G, D)), dtype, dev),
        _t(rng.normal(size=(KV, N, page, D)), dtype, dev),
        _t(rng.normal(size=(KV, N, page, D)), dtype, dev),
        _t(rng.integers(0, N, (B, P)), dtype, dev),
        _t(prefix_len, dtype, dev),
        _t(rng.normal(size=(B, KV, T, D)), dtype, dev),
        _t(rng.normal(size=(B, KV, T, D)), dtype, dev),
        _t(tail_pos, dtype, dev),
        _t(prefix_len + t_used - 1, dtype, dev),
    ]
    n0 = pa.paged_decode_attention.launches
    got = pa.paged_decode_attention(*args, softcap=softcap, window=window)
    assert pa.paged_decode_attention.launches == n0 + 1
    _close(got, pa.paged_decode_attention_ref(*args, softcap=softcap, window=window), dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize(
    "B,KV,G,D,page,P,N,C,window,softcap",
    [
        (2, 2, 2, 16, 4, 4, 16, 8, 0, 0.0),
        (1, 4, 1, 32, 8, 3, 8, 16, 0, 0.0),
        (3, 1, 4, 16, 4, 5, 32, 8, 12, 0.0),
        (1, 2, 2, 16, 4, 3, 8, 8, 0, 20.0),
        (4, 8, 2, 128, 16, 16, 320, 32, 0, 0.0),  # qwen3-1.7b prefill chunk
        (4, 8, 2, 128, 16, 16, 320, 32, 128, 30.0),
    ],
)
def test_paged_prefill_kernel_matches_plain(dev, dtype, B, KV, G, D, page, P, N, C, window, softcap):
    rng = np.random.default_rng(7)
    args = [
        _t(rng.normal(size=(B, KV, G, C, D)), dtype, dev),
        _t(rng.normal(size=(KV, N, page, D)), dtype, dev),
        _t(rng.normal(size=(KV, N, page, D)), dtype, dev),
        _t(rng.integers(0, N, (B, P)), dtype, dev),
        _t(rng.integers(0, P - C // page + 1, (B,)) * page, dtype, dev),
        _t(rng.normal(size=(B, KV, C, D)), dtype, dev),
        _t(rng.normal(size=(B, KV, C, D)), dtype, dev),
    ]
    n0 = pa.paged_prefill_attention.launches
    got = pa.paged_prefill_attention(*args, softcap=softcap, window=window)
    assert pa.paged_prefill_attention.launches == n0 + 1
    _close(got, pa.paged_prefill_attention_ref(*args, softcap=softcap, window=window), dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.int32])
@pytest.mark.parametrize("shape", [(16, 8, 2, 32), (32, 448, 8, 128), (5, 3, 1, 3)])
def test_kv_block_copy_kernel_is_exact(dev, dtype, shape):
    """The last shape is not a multiple of 16 bytes: the byte loop."""
    g = torch.Generator(device=dev).manual_seed(0)
    if dtype == torch.int32:
        src = torch.randint(0, 1 << 30, shape, generator=g, device=dev, dtype=dtype)
    else:
        src = torch.randn(shape, generator=g, device=dev).to(dtype)
    idx = torch.randperm(shape[0])[: max(1, shape[0] // 2)]
    n0 = kbc.kv_block_copy.launches
    got = kbc.kv_block_copy(src, idx)
    assert kbc.kv_block_copy.launches == n0 + 1
    torch.cuda.synchronize()
    assert torch.equal(got, kbc.kv_block_copy_ref(src, idx))
    with pytest.raises(IndexError):
        kbc.kv_block_copy(src, torch.tensor([shape[0]]))


def test_gather_payloads_through_kernel(dev):
    g = torch.Generator().manual_seed(0)
    arrays = [torch.randn((28, 16, 8, 128), generator=g).to(torch.bfloat16) for _ in range(4)]
    n0 = kbc.kv_block_copy.launches
    out = kbc.gather_payloads(arrays, dev)
    assert kbc.kv_block_copy.launches == n0 + 1
    assert all(torch.equal(a, b) and b.device.type == "cpu" for a, b in zip(arrays, out))


def test_reduced_engine_on_card_matches_cpu(dev):
    """The reduced qwen3 engine through the kernels agrees with the plain
    versions on the CPU (bf16, 3e-2 — the cross-graph logits tolerance)."""
    from repro_torch.configs import get_config, reduced
    from repro_torch.models.registry import build_model
    from repro_torch.serving.engine import ServingEngine

    cfg = reduced(get_config("qwen3-1.7b"))
    params = build_model(cfg, device="cpu").init_params(torch.Generator().manual_seed(0))

    def to(tree, d):
        return {k: to(v, d) for k, v in tree.items()} if isinstance(tree, dict) else tree.to(d)

    prompt = tuple(range(300, 341))
    logits = {}
    counts = (pa.paged_decode_attention.launches, pa.paged_prefill_attention.launches)
    for d in ("cpu", dev):
        with ServingEngine(build_model(cfg, device=d), to(params, d), block_size=4,
                           device_blocks=64, device=d) as eng:
            logits[str(d)] = eng.prefill_logits(prompt)
    assert pa.paged_decode_attention.launches > counts[0]
    assert pa.paged_prefill_attention.launches > counts[1]
    np.testing.assert_allclose(logits[str(dev)], logits["cpu"], rtol=3e-2, atol=3e-2)


def test_fully_masked_row_kernel_returns_zeros(dev):
    """The kernel feeds only valid keys to its softmax: a row with none
    yields acc / max(l, 1e-30) = 0, where the plain version (like the JAX
    reference) averages every masked value row."""
    B, KV, G, D, page, P, N, T = 2, 2, 2, 16, 4, 2, 8, 4
    g = torch.Generator(device=dev).manual_seed(0)
    rnd = lambda *s: torch.randn(s, generator=g, device=dev)
    tail_pos = torch.full((B, T), -1, dtype=torch.int32, device=dev)
    tail_pos[1, 0] = 3  # row 1 attends its prefix and one tail slot
    args = (
        rnd(B, KV, G, D), rnd(KV, N, page, D), rnd(KV, N, page, D),
        torch.zeros((B, P), dtype=torch.int32, device=dev),
        torch.tensor([0, 3], dtype=torch.int32, device=dev),
        rnd(B, KV, T, D), rnd(B, KV, T, D), tail_pos,
        torch.tensor([0, 3], dtype=torch.int32, device=dev),
    )
    got = pa.paged_decode_attention(*args)
    want = pa.paged_decode_attention_ref(*args)
    torch.cuda.synchronize()
    assert torch.equal(got[0], torch.zeros_like(got[0]))
    _close(got[1], want[1], torch.float32)

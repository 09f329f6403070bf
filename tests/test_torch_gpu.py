"""CUDA kernels against their plain PyTorch versions, on the card.

Run on a machine with an NVIDIA GPU and nvcc:

    PYTHONPATH=src python -m pytest -m gpu tests/test_torch_gpu.py

Without a card every test here skips (the check happens inside the
fixture, never at import).  Tolerances are those of tests/test_kernels.py:
1e-5 in float32, 2e-2 in bfloat16; the page copy is exact.  Only
``test_fully_masked_row_kernel_returns_zeros`` and
``test_paged_attention_zero_length_kernel_returns_zeros`` hold a query row
with no valid key (the kernels return zeros there, the dense plain versions
uniform weights; the serving path never builds one).
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import flash_attention as fa
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


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize(
    "B,H,KV,Sq,Sk,D,causal,window,softcap",
    [
        (1, 4, 4, 32, 32, 16, True, 0, 0.0),
        (2, 4, 2, 64, 64, 32, True, 0, 0.0),
        (1, 2, 1, 48, 48, 16, True, 16, 0.0),
        (1, 2, 2, 32, 32, 16, True, 0, 30.0),
        (2, 2, 2, 40, 72, 16, False, 0, 0.0),
        (1, 8, 8, 128, 128, 64, True, 0, 0.0),
        (1, 4, 2, 150, 150, 80, True, 0, 0.0),  # h2o-danube head_dim
        (1, 16, 8, 512, 512, 128, True, 0, 0.0),  # qwen3-1.7b prefill
        (1, 16, 8, 512, 512, 128, True, 128, 30.0),
    ],
)
def test_flash_attention_kernel_matches_plain(dev, dtype, B, H, KV, Sq, Sk, D, causal, window, softcap):
    """q, k, v arrive as [B, H, S, D] views of [B, S, H, D] activations,
    the layout the model hands over."""
    rng = np.random.default_rng(0)
    q = _t(rng.normal(size=(B, Sq, H, D)), dtype, dev).transpose(1, 2)
    k = _t(rng.normal(size=(B, Sk, KV, D)), dtype, dev).transpose(1, 2)
    v = _t(rng.normal(size=(B, Sk, KV, D)), dtype, dev).transpose(1, 2)
    n0 = fa.flash_attention.launches
    got = fa.flash_attention(q, k, v, causal=causal, window=window, softcap=softcap)
    assert fa.flash_attention.launches == n0 + 1
    assert got.shape == (B, H, Sq, D) and got.transpose(1, 2).is_contiguous()
    want = fa.flash_attention_ref(q, k, v, causal=causal, window=window, softcap=softcap)
    _close(got, want, dtype)


def test_flash_attention_kernel_contiguous_operands(dev):
    rng = np.random.default_rng(1)
    q, k, v = (_t(rng.normal(size=(2, 4, 40, 32)), torch.float32, dev) for _ in range(3))
    got = fa.flash_attention(q, k, v)
    _close(got, fa.flash_attention_ref(q, k, v), torch.float32)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize(
    "B,KV,G,D,page,P,N,softcap",
    [
        (2, 2, 2, 16, 8, 4, 16, 0.0),
        (1, 4, 1, 32, 16, 3, 8, 0.0),
        (3, 1, 8, 64, 8, 5, 32, 0.0),
        (8, 8, 2, 128, 16, 32, 320, 0.0),  # qwen3-1.7b decode widths
        (8, 8, 2, 128, 16, 32, 320, 30.0),
    ],
)
def test_paged_attention_kernel_matches_plain(dev, dtype, B, KV, G, D, page, P, N, softcap):
    rng = np.random.default_rng(2)
    lengths = rng.integers(1, P * page + 1, (B,))
    bt = rng.integers(0, N, (B, P))
    for b in range(B):  # entries past the length are never read
        bt[b, -(-lengths[b] // page):] = -7
    args = [
        _t(rng.normal(size=(B, KV, G, D)), dtype, dev),
        _t(rng.normal(size=(KV, N, page, D)), dtype, dev),
        _t(rng.normal(size=(KV, N, page, D)), dtype, dev),
        _t(bt, dtype, dev),
        _t(lengths, dtype, dev),
    ]
    n0 = pa.paged_attention.launches
    got = pa.paged_attention(*args, softcap=softcap)
    assert pa.paged_attention.launches == n0 + 1
    _close(got, pa.paged_attention_ref(*args, softcap=softcap), dtype)


def test_paged_attention_zero_length_kernel_returns_zeros(dev):
    """A ``lengths[b] == 0`` row: the kernel feeds no key to its softmax and
    returns zeros; the plain version (like the JAX reference) returns the
    mean of every gathered value row."""
    B, KV, G, D, page, P, N = 2, 2, 2, 16, 4, 3, 8
    g = torch.Generator(device=dev).manual_seed(0)
    rnd = lambda *s: torch.randn(s, generator=g, device=dev)
    args = (
        rnd(B, KV, G, D), rnd(KV, N, page, D), rnd(KV, N, page, D),
        torch.tensor([[1, 2, 3], [4, 5, 6]], dtype=torch.int32, device=dev),
        torch.tensor([0, 7], dtype=torch.int32, device=dev),
    )
    got = pa.paged_attention(*args)
    want = pa.paged_attention_ref(*args)
    torch.cuda.synchronize()
    assert torch.equal(got[0], torch.zeros_like(got[0]))
    mean = args[2][:, [1, 2, 3]].reshape(KV, P * page, D).mean(dim=1)  # [KV, D]
    torch.testing.assert_close(want[0], mean[:, None].expand(KV, G, D), rtol=1e-5, atol=1e-5)
    _close(got[1], want[1], torch.float32)


def test_dense_engine_on_card_matches_cpu(dev):
    """The reduced qwen3 dense-mode engine on the card (K5 prefill, plain
    dense decode) against the same weights on the CPU (bf16, 3e-2)."""
    from repro_torch.configs import get_config, reduced
    from repro_torch.models.registry import build_model
    from repro_torch.serving.engine import ServingEngine

    cfg = reduced(get_config("qwen3-1.7b"))
    params = build_model(cfg, device="cpu").init_params(torch.Generator().manual_seed(0))

    def to(tree, d):
        return {k: to(v, d) for k, v in tree.items()} if isinstance(tree, dict) else tree.to(d)

    prompt = tuple(range(300, 341))
    logits, status = {}, {}
    n0 = fa.flash_attention.launches
    for d in ("cpu", dev):
        with ServingEngine(build_model(cfg, device=d), to(params, d), block_size=4,
                           device_blocks=64, cache_len=64, decode_mode="dense", device=d) as eng:
            logits[str(d)] = eng.prefill_logits(prompt)
            r = eng.run(eng.submit(prompt[:20], max_new_tokens=4))
            status[str(d)] = (r.status, len(r.output_tokens))
    assert fa.flash_attention.launches > n0
    assert status[str(dev)] == status["cpu"] == ("finished", 4)
    np.testing.assert_allclose(logits[str(dev)], logits["cpu"], rtol=3e-2, atol=3e-2)


def test_prefill_layer_on_card_needs_contiguous_positions(dev):
    """The card's prefill layer runs K5, which assumes arange(S) positions:
    it refuses a call that does not state them and launches K5 for one
    that does, matching the CPU layer over the same weights (bf16, 3e-2)."""
    from repro_torch.configs import get_config, reduced
    from repro_torch.models import layers as tl
    from repro_torch.models.registry import build_model

    cfg = reduced(get_config("qwen3-1.7b"))
    p_cpu = build_model(cfg, device="cpu").init_params(torch.Generator().manual_seed(0))
    p_cpu = {k: v[0] for k, v in p_cpu["layers"]["attn"].items()}
    p_dev = {k: v.to(dev) for k, v in p_cpu.items()}
    x = torch.randn((2, 24, cfg.d_model), generator=torch.Generator().manual_seed(1)).bfloat16()
    pos = torch.arange(24)[None].expand(2, 24)
    with pytest.raises(ValueError, match="arange"):
        tl.attn_prefill_layer(p_dev, cfg, x.to(dev), pos.to(dev))
    n0 = fa.flash_attention.launches
    got, _ = tl.attn_prefill_layer(p_dev, cfg, x.to(dev), pos.to(dev), contiguous=True)
    assert fa.flash_attention.launches == n0 + 1
    want, _ = tl.attn_prefill_layer(p_cpu, cfg, x, pos, contiguous=True)
    torch.testing.assert_close(got.float().cpu(), want.float(), rtol=3e-2, atol=3e-2)

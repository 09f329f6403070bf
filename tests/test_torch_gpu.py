"""CUDA kernels against their plain PyTorch versions, on the card.

Run on a machine with an NVIDIA GPU and nvcc:

    PYTHONPATH=src python -m pytest -m gpu tests/test_torch_gpu.py

Without a card every test here skips (the check happens inside the
fixture, never at import).  Tolerances are those of tests/test_kernels.py:
1e-5 in float32, 2e-2 in bfloat16; the page copy is exact.  Head dims run
from 16 to 256 (stablelm-12b's 160 and the padded widths' edges), G from 1
(deepseek-7b) to 16, bf16 head dims that are multiples of 8 but not of 16
(24, 40), and head dims the wrappers zero-pad to the vector width (bf16 20
and 100, f32 and bf16 18).  ``test_fully_masked_row_kernel_matches_plain``,
``test_paged_attention_zero_length_kernel_matches_plain`` and
``test_flash_attention_empty_row_kernel_matches_plain`` hold a row with no
valid key to the reference's mean of its value rows.  The recurrent
families (reduced hymba-1.5b and xlstm-350m through ``SnapshotEngine``)
run on the card against the CPU, and the page copy takes odd-sized
``uint8`` snapshot payloads.  K5 runs whisper-small's shapes (non-causal
encoder over 1500 frames, cross attention Sq != Sk over 1500 states, a
ragged 1499); reduced whisper and reduced int8 qwen3 run on the card
against the CPU, and an int8 engine's offload and restore move int8 pages
through K3.  Training: a reduced training step on the card against the
CPU (loss, grads, updated masters), every kernel wrapper refusing a
grad-requiring CUDA input, and ``Trainer`` on the card by default, none of
them launching a kernel.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import gemm
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
        (8, 8, 4, 160, 16, 32, 320, 24, 0, 0.0),  # stablelm-12b decode step
        (8, 8, 4, 160, 16, 32, 320, 24, 128, 30.0),
        (3, 2, 2, 256, 8, 6, 32, 8, 0, 0.0),
        (4, 32, 1, 128, 16, 8, 64, 8, 0, 0.0),  # deepseek-7b: G = 1
        (4, 2, 16, 128, 8, 6, 48, 8, 12, 0.0),  # G = 16: two head groups
        (3, 1, 12, 160, 4, 5, 32, 8, 0, 20.0),  # G = 12: groups of 8 and 4
        (2, 2, 3, 136, 4, 4, 16, 8, 0, 20.0),  # bf16: 10 lanes x 2 slices, 17 of 20 slices
        (3, 1, 1, 152, 8, 3, 16, 8, 12, 0.0),
        (2, 2, 2, 24, 4, 4, 16, 8, 0, 0.0),
        (2, 2, 2, 40, 4, 4, 16, 8, 0, 20.0),
        (2, 2, 2, 20, 4, 4, 16, 8, 0, 0.0),  # padded to 24 in bf16
        (3, 1, 5, 100, 8, 4, 16, 8, 12, 20.0),  # padded to 104 in bf16
        (2, 2, 2, 18, 4, 4, 16, 8, 0, 0.0),  # padded to 20 in f32, 24 in bf16
        (4, 8, 6, 128, 16, 16, 160, 24, 0, 30.0),  # grok-1-314b decode step (G = 6)
        (4, 8, 7, 128, 16, 16, 160, 24, 128, 30.0),  # arctic-480b heads (G = 7)
        (4, 32, 1, 96, 16, 8, 64, 24, 0, 0.0),  # phi-3-vision-4.2b: D = 96 in the 128 layout
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
        (4, 8, 4, 160, 16, 16, 320, 32, 0, 0.0),  # stablelm-12b prefill chunk
        (4, 8, 4, 160, 16, 16, 320, 32, 128, 30.0),
        (2, 2, 2, 256, 8, 6, 32, 16, 0, 0.0),
        (2, 32, 1, 128, 16, 8, 64, 32, 0, 0.0),  # deepseek-7b: G = 1
        (2, 2, 16, 64, 8, 4, 16, 8, 0, 0.0),  # G = 16
        (2, 2, 2, 24, 4, 4, 16, 8, 0, 0.0),
        (2, 2, 2, 40, 4, 4, 16, 8, 6, 20.0),
        (2, 2, 2, 20, 4, 4, 16, 8, 0, 0.0),  # padded to 24 in bf16
        (2, 1, 5, 100, 8, 4, 16, 16, 6, 20.0),  # padded to 104 in bf16
        (2, 2, 2, 18, 4, 4, 16, 8, 0, 0.0),  # padded to 20 in f32, 24 in bf16
        (2, 8, 6, 128, 16, 8, 64, 32, 0, 30.0),  # grok-1-314b prefill chunk (G = 6)
        (2, 8, 7, 128, 16, 8, 64, 32, 128, 30.0),  # arctic-480b heads (G = 7)
        (2, 32, 1, 96, 16, 8, 64, 32, 0, 0.0),  # phi-3-vision-4.2b: D = 96 on 128-column tiles
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


def test_kv_block_copy_refuses_device_indices(dev):
    """Indices are host ints: validating a CUDA index tensor would read it
    back and wait for the card, so the wrapper refuses it before any launch."""
    src = torch.zeros((4, 16), dtype=torch.bfloat16, device=dev)
    n0 = kbc.kv_block_copy.launches
    with pytest.raises(ValueError, match="host ints"):
        kbc.kv_block_copy(src, torch.tensor([1, 2], device=dev))
    assert kbc.kv_block_copy.launches == n0
    assert torch.equal(kbc.kv_block_copy(src, [1, 2]), src[1:3])


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


@pytest.mark.parametrize("dtype,D", [(torch.float32, 16), (torch.bfloat16, 160)], ids=["f32", "D160"])
def test_fully_masked_row_kernel_matches_plain(dev, dtype, D):
    """A row with no valid key (row 0: empty prefix, every tail slot empty)
    gets the reference's plain mean of every gathered value row, both table
    columns and all four tail slots, as the plain version gives it (f32,
    1e-5; bf16 at its tolerance)."""
    B, KV, G, page, P, N, T = 2, 2, 2, 4, 2, 8, 4
    g = torch.Generator(device=dev).manual_seed(0)
    rnd = lambda *s: torch.randn(s, generator=g, device=dev).to(dtype)
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
    _close(got, want, dtype)
    v_all = torch.cat([args[2][:, [0, 0]].reshape(KV, P * page, D), args[6][0]], dim=1).float()
    _close(got[0], v_all.mean(dim=1)[:, None].expand(KV, G, D), dtype)


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
        (1, 32, 8, 512, 512, 160, True, 0, 0.0),  # stablelm-12b prefill
        (1, 32, 8, 200, 200, 160, True, 64, 30.0),
        (1, 4, 2, 100, 100, 256, True, 0, 0.0),
        (1, 4, 1, 60, 90, 256, False, 0, 0.0),
        (1, 32, 32, 130, 130, 128, True, 0, 0.0),  # deepseek-7b: G = 1
        (1, 16, 1, 64, 64, 64, True, 0, 0.0),  # G = 16
        (2, 4, 2, 70, 70, 24, True, 0, 0.0),
        (1, 4, 2, 50, 90, 40, False, 0, 20.0),
        (2, 4, 2, 70, 70, 20, True, 0, 0.0),  # padded to 24 in bf16
        (1, 10, 2, 90, 90, 100, True, 16, 20.0),  # padded to 104 in bf16
        (1, 4, 2, 50, 50, 18, True, 0, 0.0),  # padded to 20 in f32, 24 in bf16
        (1, 25, 5, 40, 40, 64, True, 16, 0.0),  # hymba-1.5b heads (G = 5), reduced window
        (1, 25, 5, 1100, 1100, 64, True, 1024, 0.0),  # hymba-1.5b prefill past its window
        (1, 48, 8, 512, 512, 128, True, 0, 30.0),  # grok-1-314b prefill (G = 6, soft-cap 30)
        (1, 56, 8, 300, 300, 128, True, 0, 30.0),  # arctic-480b heads (G = 7)
        (1, 32, 32, 640, 640, 96, True, 0, 0.0),  # phi-3-vision-4.2b: 576 patches + 64 tokens
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


@pytest.mark.parametrize(
    "B,H,KV,Sq,Sk,D,causal,window,softcap",
    [
        (1, 32, 8, 200, 200, 80, True, 0, 0.0),  # h2o-danube heads, ragged tile edge
        (2, 32, 8, 130, 130, 80, True, 64, 30.0),
        (1, 4, 2, 41, 41, 16, True, 0, 0.0),  # reduced qwen3
        (2, 4, 2, 70, 100, 16, False, 0, 0.0),
        (1, 32, 8, 150, 150, 160, True, 0, 0.0),  # stablelm-12b heads (160 columns)
        (1, 8, 2, 130, 130, 144, True, 64, 30.0),  # 144 runs as 160
        (1, 4, 2, 100, 100, 192, True, 0, 0.0),  # 192 runs as 256 (one stage)
        (1, 4, 2, 130, 70, 256, False, 0, 0.0),
        (2, 4, 2, 41, 41, 24, True, 0, 0.0),  # 24 runs as 32
    ],
)
def test_flash_attention_tensor_core_head_dims(dev, B, H, KV, Sq, Sk, D, causal, window, softcap):
    """bf16 at head_dims 80 (tiles padded to 128 columns), 16, 160, 144 and
    24, and 192 and 256 (one K/V stage per warpgroup) through the
    tensor-core kernel: within 2e-2 of the plain version, and of the tiled
    plain model (f32 weights: the kernel keeps about 16 bits of them)."""
    rng = np.random.default_rng(3)
    bf = torch.bfloat16
    q = _t(rng.normal(size=(B, Sq, H, D)), bf, dev).transpose(1, 2)
    k = _t(rng.normal(size=(B, Sk, KV, D)), bf, dev).transpose(1, 2)
    v = _t(rng.normal(size=(B, Sk, KV, D)), bf, dev).transpose(1, 2)
    kw = dict(causal=causal, window=window, softcap=softcap)
    n0 = fa.flash_attention.launches
    got = fa.flash_attention(q, k, v, **kw)
    assert fa.flash_attention.launches == n0 + 1
    _close(got, fa.flash_attention_ref(q, k, v, **kw), bf)
    _close(got, fa.flash_attention_tiled_ref(q, k, v, **kw), bf)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("offset", [1, 20, 39])
@pytest.mark.parametrize("window,softcap", [(0, 0.0), (12, 0.0), (0, 20.0)])
def test_flash_attention_query_offset_matches_plain(dev, dtype, offset, window, softcap):
    """K5 with ``q_offset``: a slice of 8 query rows (or fewer at the end)
    starting at position ``offset`` over 40 keys, causal, on the SIMT (f32)
    and tensor-core (bf16) kernels, against the plain version with the
    same offset and the same rows of the full plain call."""
    rng = np.random.default_rng(offset)
    q = _t(rng.normal(size=(2, 40, 4, 32)), dtype, dev).transpose(1, 2)
    k = _t(rng.normal(size=(2, 40, 2, 32)), dtype, dev).transpose(1, 2)
    v = _t(rng.normal(size=(2, 40, 2, 32)), dtype, dev).transpose(1, 2)
    kw = dict(causal=True, window=window, softcap=softcap)
    qs = q[:, :, offset : offset + 8]
    n0 = fa.flash_attention.launches
    got = fa.flash_attention(qs, k, v, **kw, q_offset=offset)
    assert fa.flash_attention.launches == n0 + 1
    _close(got, fa.flash_attention_ref(qs, k, v, **kw, q_offset=offset), dtype)
    _close(got, fa.flash_attention_ref(q, k, v, **kw)[:, :, offset : offset + 8], dtype)


def test_flash_attention_query_offset_sharded_prefill_shape(dev):
    """K5 at the second half of a two-rank sequence-sharded prefill of
    qwen3-1.7b: q [4, 16, 1024, 128] (positions 1024-2047) over k/v
    [4, 8, 2048, 128], causal, bf16, against the plain version with the
    same offset."""
    rng = np.random.default_rng(7)
    bf = torch.bfloat16
    q = _t(rng.normal(size=(4, 1024, 16, 128)), bf, dev).transpose(1, 2)
    k = _t(rng.normal(size=(4, 2048, 8, 128)), bf, dev).transpose(1, 2)
    v = _t(rng.normal(size=(4, 2048, 8, 128)), bf, dev).transpose(1, 2)
    got = fa.flash_attention(q, k, v, causal=True, q_offset=1024)
    _close(got, fa.flash_attention_ref(q, k, v, causal=True, q_offset=1024), bf)


# Head dims past 256: every entry point's SIMT split kernel (the head dim
# walked in slices of 512 columns), in both dtypes; 300 is zero-padded to
# 304 in bf16, 640 and 1024 take two slices.  G = 5 with a window and a
# soft-cap, G = 12 (two row groups of 8 at decode).
WIDE_D = [(320, 2, 0, 0.0), (512, 2, 0, 0.0), (320, 5, 24, 30.0), (512, 12, 0, 20.0),
          (300, 3, 0, 0.0), (640, 2, 24, 30.0), (1024, 3, 0, 0.0)]
WIDE_D_IDS = ["D320-G2", "D512-G2", "D320-G5-window-softcap", "D512-G12-softcap", "D300-G3",
              "D640-G2-window-softcap", "D1024-G3"]


def _wide_call(kernel, rng, dtype, dev, D, G, window, softcap):
    """(kernel wrapper, plain version, args, kwargs) at a small wide-head
    shape: 2 sequences, 2 kv heads, pages of 8, prefixes of 0-40 keys."""
    B, KV, page, P, N, T, C = 2, 2, 8, 6, 16, 5, 16
    if kernel == "K5":
        H, S = KV * G, 70
        q = _t(rng.normal(size=(B, S, H, D)), dtype, dev).transpose(1, 2)
        k = _t(rng.normal(size=(B, S, KV, D)), dtype, dev).transpose(1, 2)
        v = _t(rng.normal(size=(B, S, KV, D)), dtype, dev).transpose(1, 2)
        return fa.flash_attention, fa.flash_attention_ref, [q, k, v], dict(
            causal=True, window=window, softcap=softcap)
    if kernel == "K1":
        plen, t_used = [0, 37], [2, 5]
        return (pa.paged_decode_attention, pa.paged_decode_attention_ref,
                _decode_args(rng, dtype, dev, plen, t_used, KV=KV, G=G, D=D, page=page, T=T,
                             P=P, N=N), dict(window=window, softcap=softcap))
    pages = [_t(rng.normal(size=(KV, N, page, D)), dtype, dev) for _ in range(2)]
    bt = _t(rng.permutation(N)[: B * P].reshape(B, P), dtype, dev)
    if kernel == "K4":
        args = [_t(rng.normal(size=(B, KV, G, D)), dtype, dev), *pages, bt,
                _t(np.array([0, 41]), dtype, dev)]
        return pa.paged_attention, pa.paged_attention_ref, args, dict(softcap=softcap)
    args = [_t(rng.normal(size=(B, KV, G, C, D)), dtype, dev), *pages, bt,
            _t(np.array([8, 24]), dtype, dev), _t(rng.normal(size=(B, KV, C, D)), dtype, dev),
            _t(rng.normal(size=(B, KV, C, D)), dtype, dev)]
    return (pa.paged_prefill_attention, pa.paged_prefill_attention_ref, args,
            dict(window=window, softcap=softcap))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("D,G,window,softcap", WIDE_D, ids=WIDE_D_IDS)
@pytest.mark.parametrize("kernel", ["K1", "K2", "K4", "K5"])
def test_wide_head_dim_kernels_match_plain(dev, kernel, dtype, D, G, window, softcap):
    """K1, K2, K4 and K5 past head_dim 256 launch their kernels (no plain
    route) and match the plain versions: 1e-5 in f32, 2e-2 in bf16."""
    fn, plain, args, kw = _wide_call(kernel, np.random.default_rng(D + G), dtype, dev, D, G,
                                     window, softcap)
    n0 = fn.launches
    got = fn(*args, **kw)
    assert fn.launches == n0 + 1 and got.shape[-1] == D
    _close(got, plain(*args, **kw), dtype)


@pytest.mark.parametrize("kernel", ["K1", "K2", "K4", "K5"])
def test_head_dim_past_512_raises_on_card(dev, kernel):
    """Head dim 520, past the 512 that once bounded the kernels: it raises
    nothing now, launches the kernel and matches the plain version (bf16,
    2e-2)."""
    fn, plain, args, kw = _wide_call(kernel, np.random.default_rng(0), torch.bfloat16, dev, 520,
                                     2, 0, 0.0)
    n0 = fn.launches
    got = fn(*args, **kw)
    assert fn.launches == n0 + 1 and got.shape[-1] == 520
    _close(got, plain(*args, **kw), torch.bfloat16)


def test_kernels_launch_on_their_operands_card(dev):
    """Every operand on ``cuda:1`` while ``cuda:0`` is current: K1, K2, K3,
    K4 and K5 (K1/K4 and K5 at a wide and a tensor-core head dim) launch on
    card 1 and equal their plain versions there; operands on two cards
    raise.  Needs two cards."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two cards")
    one = torch.device("cuda", 1)
    torch.cuda.set_device(0)
    rng = np.random.default_rng(11)
    for kernel in ("K1", "K2", "K4", "K5"):
        for dtype, D in ((torch.bfloat16, 128), (torch.float32, 128), (torch.bfloat16, 320)):
            fn, plain, args, kw = _wide_call(kernel, rng, dtype, one, D, 2, 0, 0.0)
            got = fn(*args, **kw)
            assert got.device == one and torch.cuda.current_device() == 0
            _close(got, plain(*args, **kw), dtype)
    pages = torch.randn((8, 16, 2, 128), device=one).to(torch.bfloat16)
    n0 = kbc.kv_block_copy.launches
    got = kbc.kv_block_copy(pages, [3, 1, 7])
    torch.cuda.synchronize(one)
    assert kbc.kv_block_copy.launches == n0 + 1 and got.device == one
    assert torch.equal(got, pages[[3, 1, 7]])
    q, k, v = (torch.randn((1, 2, 16, 64), device=d).to(torch.bfloat16) for d in (one, dev, one))
    with pytest.raises(ValueError, match="every operand"):
        fa.flash_attention(q, k, v)
    assert torch.cuda.current_device() == 0


def test_flash_attention_bf16_head_dim_24_matches_plain(dev):
    """bf16 head dims step by 8 (16-byte loads): 24 runs on the tensor
    cores (tiles zero-padded to 32 columns) and matches the plain version;
    20 is zero-padded to 24 by the wrapper and still takes one kernel
    launch (no other route), and float32, whose loads step by 4, runs 20
    unpadded."""
    rng = np.random.default_rng(4)
    draw = lambda dtype, D: [_t(rng.normal(size=(1, 2, 32, D)), dtype, dev) for _ in range(3)]
    args = draw(torch.bfloat16, 24)
    n0 = fa.flash_attention.launches
    _close(fa.flash_attention(*args), fa.flash_attention_ref(*args), torch.bfloat16)
    assert fa.flash_attention.launches == n0 + 1
    args = draw(torch.bfloat16, 20)
    got = fa.flash_attention(*args)
    assert got.shape == (1, 2, 32, 20) and fa.flash_attention.launches == n0 + 2
    _close(got, fa.flash_attention_ref(*args), torch.bfloat16)
    args = draw(torch.float32, 20)
    _close(fa.flash_attention(*args), fa.flash_attention_ref(*args), torch.float32)


def _decode_args(rng, dtype, dev, plen, t_used, KV=8, G=2, D=128, page=16, T=24, P=None, N=None):
    B = len(plen)
    P = P or -(-max(int(x) for x in plen) // page) or 1
    N = N or max(B * P, 1)
    bt = rng.permutation(N)[: B * P].reshape(B, P) if N >= B * P else rng.integers(0, N, (B, P))
    tail_pos = np.full((B, T), -1, np.int32)
    for b in range(B):
        tail_pos[b, : t_used[b]] = plen[b] + np.arange(t_used[b])
    plen, t_used = np.asarray(plen), np.asarray(t_used)
    return [
        _t(rng.normal(size=(B, KV, G, D)), dtype, dev),
        _t(rng.normal(size=(KV, N, page, D)), dtype, dev),
        _t(rng.normal(size=(KV, N, page, D)), dtype, dev),
        _t(bt, dtype, dev),
        _t(plen, dtype, dev),
        _t(rng.normal(size=(B, KV, T, D)), dtype, dev),
        _t(rng.normal(size=(B, KV, T, D)), dtype, dev),
        _t(tail_pos, dtype, dev),
        _t(np.maximum(plen + t_used - 1, 0), dtype, dev),
    ]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_paged_decode_kernel_long_context(dev, dtype):
    """Eight sequences of 2048 prefix keys (about 67 MB of bf16 K/V, 33
    splits each) plus a 24-slot tail."""
    rng = np.random.default_rng(8)
    args = _decode_args(rng, dtype, dev, [2048] * 8, [1, 24, 5, 17, 9, 24, 2, 13])
    for window, softcap in ((0, 0.0), (1000, 30.0)):
        got = pa.paged_decode_attention(*args, softcap=softcap, window=window)
        _close(got, pa.paged_decode_attention_ref(*args, softcap=softcap, window=window), dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("window", [0, 70])
@pytest.mark.parametrize("G,D", [(2, 128), (4, 160)], ids=["D128", "D160"])
def test_paged_decode_kernel_split_boundaries(dev, dtype, window, G, D):
    """Prefixes on, just before and just past the 64-key split boundaries,
    and a prefix of 0 with the tail only."""
    rng = np.random.default_rng(9)
    plen = [63, 64, 65, 128, 0, 127, 1, 192]
    t_used = [1, 3, 24, 2, 5, 1, 7, 24]
    args = _decode_args(rng, dtype, dev, plen, t_used, P=16, G=G, D=D)
    got = pa.paged_decode_attention(*args, window=window)
    _close(got, pa.paged_decode_attention_ref(*args, window=window), dtype)
    _close(got, pa.paged_decode_attention_split_ref(*args, window=window), dtype)


@pytest.mark.parametrize("G,D", [(2, 128), (4, 160), (16, 64)], ids=["D128", "D160", "G16"])
def test_paged_decode_kernel_batch_position_invariant(dev, G, D):
    """A row alone (with a block table only as wide as it needs) and the
    same row at every place of a batch of 8 give bitwise-equal outputs."""
    rng = np.random.default_rng(10)
    plen = [300, 37, 512, 0, 100, 256, 411, 64]
    t_used = [5, 24, 1, 3, 9, 17, 2, 13]
    args = _decode_args(rng, torch.bfloat16, dev, plen, t_used, N=320, G=G, D=D)
    batch = pa.paged_decode_attention(*args, window=128)
    for b in range(8):
        P_b = max(1, -(-plen[b] // 16))
        one = [a[b : b + 1] for a in args]
        one[1], one[2] = args[1], args[2]  # the page pool is shared
        one[3] = args[3][b : b + 1, :P_b].contiguous()
        alone = pa.paged_decode_attention(*one, window=128)
        torch.cuda.synchronize()
        assert torch.equal(alone[0], batch[b]), f"row {b} differs alone"
        perm = [(i + b) % 8 for i in range(8)]  # row b moved to place 0
        shuffled = [a[perm] if a.shape[0] == 8 and i not in (1, 2) else a for i, a in enumerate(args)]
        moved = pa.paged_decode_attention(*shuffled, window=128)
        torch.cuda.synchronize()
        assert torch.equal(moved[0], batch[b]), f"row {b} differs at place 0"


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
        (8, 8, 4, 160, 16, 32, 320, 0.0),  # stablelm-12b decode widths
        (2, 2, 2, 256, 8, 4, 16, 30.0),
        (4, 32, 1, 128, 16, 8, 64, 0.0),  # deepseek-7b: G = 1
        (3, 2, 16, 64, 8, 5, 32, 0.0),  # G = 16
        (2, 2, 2, 24, 8, 4, 16, 0.0),
        (2, 2, 2, 20, 8, 4, 16, 0.0),  # padded to 24 in bf16
        (3, 1, 5, 100, 8, 4, 16, 30.0),  # padded to 104 in bf16
        (2, 2, 2, 18, 8, 4, 16, 0.0),  # padded to 20 in f32, 24 in bf16
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


def test_paged_attention_zero_length_kernel_matches_plain(dev):
    """A ``lengths[b] == 0`` row gets the reference's mean of every
    gathered value row (all three table columns), as the plain version
    gives it (f32, 1e-5)."""
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
    mean = args[2][:, [1, 2, 3]].reshape(KV, P * page, D).mean(dim=1)  # [KV, D]
    torch.testing.assert_close(want[0], mean[:, None].expand(KV, G, D), rtol=1e-5, atol=1e-5)
    _close(got, want, torch.float32)


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


def _prefill_args(rng, dtype, dev, plen, P, KV=8, G=2, C=32, D=128, page=16, N=None):
    """Chunked-prefill operands: queries [B, KV, G, C, D], a pool of N pages,
    a block table of distinct random pages (P columns) and the chunk's own
    keys; prefixes need not be block-aligned."""
    B = len(plen)
    N = N or B * P
    return [
        _t(rng.normal(size=(B, KV, G, C, D)), dtype, dev),
        _t(rng.normal(size=(KV, N, page, D)), dtype, dev),
        _t(rng.normal(size=(KV, N, page, D)), dtype, dev),
        _t(rng.permutation(N)[: B * P].reshape(B, P), dtype, dev),
        _t(np.asarray(plen), dtype, dev),
        _t(rng.normal(size=(B, KV, C, D)), dtype, dev),
        _t(rng.normal(size=(B, KV, C, D)), dtype, dev),
    ]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("plen,P", [([2048, 2016, 1024, 32], 132), ([2016], 128)],
                         ids=["long-prefix", "lone-prompt"])
def test_paged_prefill_kernel_long_prefix(dev, dtype, plen, P):
    """qwen3-1.7b widths at long prefixes: four sequences of 2048, 2016,
    1024 and 32 prefix keys (17 prefix splits of 128 keys in bfloat16, 528
    pages), and one lone prompt at 2016 keys (the single-request bucket);
    window 0 and a 1000-key window with softcap 30.  bf16 is also held
    against the plain model of its tensor-core arithmetic."""
    rng = np.random.default_rng(15)
    args = _prefill_args(rng, dtype, dev, plen, P)
    for window, softcap in ((0, 0.0), (1000, 30.0)):
        kw = dict(softcap=softcap, window=window)
        n0 = pa.paged_prefill_attention.launches
        got = pa.paged_prefill_attention(*args, **kw)
        assert pa.paged_prefill_attention.launches == n0 + 1
        _close(got, pa.paged_prefill_attention_ref(*args, **kw), dtype)
        if dtype == torch.bfloat16:
            model = pa.paged_prefill_attention_split_ref(*args, **kw, block_k=64, p_dtype=dtype)
            _close(got, model, dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("window,softcap", [(0, 0.0), (300, 30.0)])
def test_paged_prefill_kernel_split_boundaries(dev, dtype, window, softcap):
    """G * C = 128 (h2o-danube's G = 4: two 64-row tiles), prefixes on, one
    before and one past the 128-key split boundaries, an empty prefix, and
    a 300-key window that empties the first splits of the longest row."""
    rng = np.random.default_rng(16)
    plen = [127, 128, 129, 511, 512, 0, 1, 767]
    args = _prefill_args(rng, dtype, dev, plen, 52, G=4)
    kw = dict(softcap=softcap, window=window)
    got = pa.paged_prefill_attention(*args, **kw)
    _close(got, pa.paged_prefill_attention_ref(*args, **kw), dtype)
    _close(got, pa.paged_prefill_attention_split_ref(*args, **kw), dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_paged_prefill_kernel_invalid_page_is_no_key(dev, dtype):
    """A block-table entry outside [0, N) inside the prefix is no key (the
    kernels' rule, which the split plain version shares)."""
    rng = np.random.default_rng(17)
    args = _prefill_args(rng, dtype, dev, [300, 40, 257], 20, C=8, N=64)
    args[3][0, 12] = -1
    args[3][1, 0] = 64
    args[3][2, 16] = 1000
    got = pa.paged_prefill_attention(*args, window=200)
    _close(got, pa.paged_prefill_attention_split_ref(*args, window=200), dtype)


@pytest.mark.parametrize("G,D", [(2, 128), (4, 160)], ids=["D128", "D160"])
def test_paged_prefill_kernel_bitwise_invariant(dev, G, D):
    """bf16: two calls give the same bits, and each row alone (with a block
    table just as wide as it needs, or 24 columns wider) equals the same row
    inside a batch of 4 and at another place of it."""
    rng = np.random.default_rng(18)
    plen = [300, 37, 512, 0]
    args = _prefill_args(rng, torch.bfloat16, dev, plen, 36, N=160, G=G, D=D)
    kw = dict(window=128, softcap=30.0)
    batch = pa.paged_prefill_attention(*args, **kw)
    again = pa.paged_prefill_attention(*args, **kw)
    torch.cuda.synchronize()
    assert torch.equal(batch, again)
    wide = torch.cat([args[3], args[3][:, :24]], dim=1).contiguous()
    for b in range(4):
        one = [a[b : b + 1] for a in args]
        one[1], one[2] = args[1], args[2]  # the page pool is shared
        for table in (args[3][b : b + 1, : max(1, -(-plen[b] // 16))], wide[b : b + 1]):
            one[3] = table.contiguous()
            alone = pa.paged_prefill_attention(*one, **kw)
            torch.cuda.synchronize()
            assert torch.equal(alone[0], batch[b]), f"row {b} differs alone (P={table.shape[1]})"
        perm = [(i + b) % 4 for i in range(4)]  # row b moved to place 0
        moved = [a[perm] if i not in (1, 2) else a for i, a in enumerate(args)]
        out = pa.paged_prefill_attention(*moved, **kw)
        torch.cuda.synchronize()
        assert torch.equal(out[0], batch[b]), f"row {b} differs at place 0"


def test_paged_prefill_bf16_head_dim_24_matches_plain(dev):
    """bf16 head dims step by 8: 24 runs on the tensor cores (tiles
    zero-padded to 32 columns) and matches the plain version and the model
    of its arithmetic; 20 is zero-padded to 24 by the wrapper in bf16 and
    still takes one kernel launch (no other route), and runs unpadded for
    float32 (SIMT kernel)."""
    rng = np.random.default_rng(19)
    draw = lambda dtype, D: _prefill_args(rng, dtype, dev, [5, 16], 2, KV=2, C=8, D=D, page=8)
    args = draw(torch.bfloat16, 24)
    n0 = pa.paged_prefill_attention.launches
    got = pa.paged_prefill_attention(*args)
    assert pa.paged_prefill_attention.launches == n0 + 1
    _close(got, pa.paged_prefill_attention_ref(*args), torch.bfloat16)
    _close(got, pa.paged_prefill_attention_split_ref(*args, block_k=64, p_dtype=torch.bfloat16),
           torch.bfloat16)
    args = draw(torch.bfloat16, 20)
    got = pa.paged_prefill_attention(*args)
    assert got.shape[-1] == 20 and pa.paged_prefill_attention.launches == n0 + 2
    _close(got, pa.paged_prefill_attention_ref(*args), torch.bfloat16)
    args = draw(torch.float32, 20)
    _close(pa.paged_prefill_attention(*args), pa.paged_prefill_attention_ref(*args), torch.float32)


def test_conformance_scenarios_on_card(dev, tmp_path):
    """The seven mode scenarios on the reduced qwen3 engine on the card:
    every gate as on the CPU, the generated descriptor native_sound, and
    the paged-decode, chunked-prefill and page-copy kernels launched."""
    from repro_torch.configs import get_config, reduced
    from repro_torch.core import native_descriptor as nd
    from repro_torch.core.descriptors import load_descriptor
    from repro_torch.core.lowering import LABEL_NATIVE, judge_descriptor
    from repro_torch.models.registry import build_model

    bundle = build_model(reduced(get_config("qwen3-1.7b")), device=dev)
    params = bundle.init_params(torch.Generator().manual_seed(0))
    wrappers = (pa.paged_decode_attention, pa.paged_prefill_attention, kbc.kv_block_copy)
    before = [w.launches for w in wrappers]
    results = nd.run_scenarios(nd.engine_factory(bundle, params), tmp_path / "native")
    launched = [w.launches - n for w, n in zip(wrappers, before)]
    assert all(n > 0 for n in launched), launched
    for mode, res in results.items():
        for gate, v in res["result"]["gates"].items():
            assert v is True or (isinstance(v, str) and v.split("/")[0] == v.split("/")[1]), (
                mode, gate, v)
    path = nd.generate_native_descriptor(results, tmp_path / "desc.json")
    assert [r.label for r in judge_descriptor(load_descriptor(path))] == [LABEL_NATIVE] * 7


def test_float32_head_dim_20_matches_plain(dev):
    """float32 head dims step by 4 (16-byte loads of 4 floats): D = 20, a
    half 8-element slice per lane at decode, through K1, K2, K4 and K5."""
    rng = np.random.default_rng(20)
    f32 = torch.float32
    args = _decode_args(rng, f32, dev, [37, 0, 64], [3, 2, 24], KV=2, G=4, D=20, page=8)
    _close(pa.paged_decode_attention(*args, window=40), pa.paged_decode_attention_ref(*args, window=40), f32)
    k4 = args[:4] + [_t(np.array([9, 0, 64]), f32, dev)]
    _close(pa.paged_attention(*k4), pa.paged_attention_ref(*k4), f32)
    args = _prefill_args(rng, f32, dev, [5, 16], 4, KV=2, C=8, D=20, page=8)
    _close(pa.paged_prefill_attention(*args), pa.paged_prefill_attention_ref(*args), f32)
    q, k, v = (_t(rng.normal(size=(1, n, 40, 20)), f32, dev) for n in (4, 2, 2))
    _close(fa.flash_attention(q, k, v), fa.flash_attention_ref(q, k, v), f32)


def test_wide_head_engine_on_card_matches_cpu(dev):
    """A reduced stablelm-12b with its own head shape (4 query heads over 1
    kv head, head_dim 160) served on the card through the kernels against
    the same weights on the CPU: prefill logits within 3e-2 (bf16, the
    cross-graph tolerance) with the same argmax, in the paged and the dense
    mode."""
    from repro_torch.configs import get_config, reduced
    from repro_torch.models.registry import build_model
    from repro_torch.serving.engine import ServingEngine

    cfg = reduced(get_config("stablelm-12b")).replace(num_heads=4, num_kv_heads=1, head_dim=160)
    params = build_model(cfg, device="cpu").init_params(torch.Generator().manual_seed(0))

    def to(tree, d):
        return {k: to(v, d) for k, v in tree.items()} if isinstance(tree, dict) else tree.to(d)

    prompt = tuple(range(300, 341))
    before = [w.launches for w in (pa.paged_decode_attention, pa.paged_prefill_attention,
                                   fa.flash_attention)]
    for mode in ("paged", "dense"):
        logits, status = {}, {}
        for d in ("cpu", dev):
            with ServingEngine(build_model(cfg, device=d), to(params, d), block_size=4,
                               device_blocks=64, cache_len=64, decode_mode=mode, device=d) as eng:
                logits[str(d)] = eng.prefill_logits(prompt)
                r = eng.run(eng.submit(prompt[:20], max_new_tokens=4))
                status[str(d)] = (r.status, len(r.output_tokens))
        assert status[str(dev)] == status["cpu"] == ("finished", 4), mode
        np.testing.assert_allclose(logits[str(dev)], logits["cpu"], rtol=3e-2, atol=3e-2)
        assert logits[str(dev)].argmax() == logits["cpu"].argmax(), mode
    after = [w.launches for w in (pa.paged_decode_attention, pa.paged_prefill_attention,
                                  fa.flash_attention)]
    assert all(a > b for a, b in zip(after, before)), (before, after)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_empty_row_kernel_matches_plain(dev, dtype):
    """K5's rows with no valid key (B = H = KV = 1, Sq = 8, Sk = 4, D = 16,
    causal, window 2, numpy seed 0: rows 5-7 see no key) get the plain
    mean of the 4 value rows, as the plain version gives it; the rows with
    keys are unchanged (f32 1e-5, bf16 2e-2)."""
    rng = np.random.default_rng(0)
    q, k, v = (_t(rng.normal(size=shape), dtype, dev)
               for shape in ((1, 1, 8, 16), (1, 1, 4, 16), (1, 1, 4, 16)))
    got = fa.flash_attention(q, k, v, causal=True, window=2)
    want = fa.flash_attention_ref(q, k, v, causal=True, window=2)
    _close(got, want, dtype)
    _close(got[0, 0, 5:], v[0, 0].float().mean(dim=0).expand(3, 16), dtype)


@pytest.mark.parametrize("nbytes", [49_243_140, 1_000_003, 22_356_816])
def test_kv_block_copy_snapshot_payloads(dev, nbytes):
    """Snapshot payloads are one flat uint8 page each: 49,243,140 bytes
    (a full-width hymba-1.5b snapshot, 4 mod 16: the byte loop) and an odd
    size take the byte loop, a multiple of 16 (an xlstm-350m snapshot,
    22,356,816 bytes) the vector path; every copy is
    exact, through gather_payloads as the offload connector calls it."""
    g = torch.Generator().manual_seed(nbytes)
    payload = torch.randint(0, 256, (nbytes,), generator=g, dtype=torch.uint8)
    n0, plain = kbc.kv_block_copy.launches, kbc.gather_payloads.plain_copies
    (out,) = kbc.gather_payloads([payload], dev)
    assert kbc.kv_block_copy.launches == n0 + 1 and kbc.gather_payloads.plain_copies == plain
    assert out.device.type == "cpu" and torch.equal(out, payload)


@pytest.mark.parametrize("name", ["hymba-1.5b", "xlstm-350m"])
def test_snapshot_engine_on_card_matches_cpu(dev, name):
    """Reduced hymba-1.5b and xlstm-350m through ``SnapshotEngine`` on the
    card against the same weights on the CPU: prefill logits within 3e-2
    (bf16, the cross-graph tolerance) with the same argmax; on the card an
    offloaded claim restores through the page copy and three batched
    requests decode the tokens of a never-offloaded engine (bitwise within
    the card); hymba's prefills run the flash-attention kernel."""
    from repro_torch.configs import get_config, reduced
    from repro_torch.core.claims import ClaimMode, ClaimState
    from repro_torch.models.registry import build_model
    from repro_torch.serving.snapshot_engine import SnapshotEngine

    cfg = reduced(get_config(name))
    params = build_model(cfg, device="cpu").init_params(torch.Generator().manual_seed(0))

    def to(tree, d):
        return {k: to(v, d) for k, v in tree.items()} if isinstance(tree, dict) else tree.to(d)

    prompt = tuple(range(300, 341))
    batch = {"tokens": torch.tensor([prompt], dtype=torch.int32)}
    cache_len = cfg.sliding_window or 1
    logits = {}
    for d in ("cpu", dev):
        bundle = build_model(cfg, device=d)
        logits[str(d)] = bundle.prefill_fn(to(params, d), {"tokens": batch["tokens"].to(d)},
                                           cache_len)[0][0].float().cpu().numpy()
    np.testing.assert_allclose(logits[str(dev)], logits["cpu"], rtol=3e-2, atol=3e-2)
    assert logits[str(dev)].argmax() == logits["cpu"].argmax()

    bundle, p = build_model(cfg, device=dev), to(params, dev)
    prefix = tuple(range(10, 22))
    prompts = [prefix + (30 + i, 31 + i) for i in range(3)]
    n_copy, n_flash = kbc.kv_block_copy.launches, fa.flash_attention.launches
    out = {}
    for offload in (False, True):
        with SnapshotEngine(bundle, p, device=dev) as eng:
            claim = eng.accept_claim(prefix, ClaimMode.OFFLOADABLE)
            eng.materialize_claim(claim.claim_id)
            if offload:
                assert eng.offload_claim(claim.claim_id)
            reqs = eng.serve_batch(prompts, max_new_tokens=3)
            assert [r.status for r in reqs] == ["finished"] * 3
            assert [r.cached_tokens for r in reqs] == [len(prefix)] * 3
            assert reqs[0].restored_tokens == (len(prefix) if offload else 0)
            assert claim.state == (ClaimState.RESTORED if offload else ClaimState.MATERIALIZED)
            out[offload] = [r.output_tokens for r in reqs]
    assert out[True] == out[False]
    assert kbc.kv_block_copy.launches > n_copy
    assert (fa.flash_attention.launches > n_flash) == (cfg.family == "hybrid")


def _to(tree, d):
    return {k: _to(v, d) for k, v in tree.items()} if isinstance(tree, dict) else tree.to(d)


@pytest.mark.parametrize("name", ["grok-1-314b", "arctic-480b"])
def test_moe_engine_on_card_matches_cpu(dev, name):
    """A reduced MoE model (grok: G = 6 and soft-cap 30; arctic: G = 7 and
    the dense residual MLP) served on the card against the same f32 weights
    on the CPU: prefill logits within 1e-3 and the same greedy tokens.  f32,
    because in bf16 the router's logits tie or nearly tie often, and a
    last-bit difference between the card's and the CPU's products then
    sends a token to another expert (a different, equally valid dispatch)."""
    from repro_torch.configs import get_config, reduced
    from repro_torch.models.registry import build_model
    from repro_torch.serving.engine import ServingEngine

    G = {"grok-1-314b": 6, "arctic-480b": 7}[name]
    cfg = reduced(get_config(name)).replace(num_heads=G, num_kv_heads=1)
    params = build_model(cfg, device="cpu").init_params(torch.Generator().manual_seed(0))
    f32 = lambda t: {k: f32(v) for k, v in t.items()} if isinstance(t, dict) else t.float()
    params = f32(params)
    prompt = tuple(range(300, 341))
    before = [w.launches for w in (pa.paged_decode_attention, pa.paged_prefill_attention)]
    logits, toks = {}, {}
    for d in ("cpu", dev):
        with ServingEngine(build_model(cfg, device=d), _to(params, d), block_size=4,
                           device_blocks=64, device=d) as eng:
            logits[str(d)] = eng.prefill_logits(prompt)
            reqs = [eng.submit(prompt[:20], max_new_tokens=4), eng.submit(prompt[5:30], max_new_tokens=4)]
            eng.run_batch(reqs)
            assert [r.status for r in reqs] == ["finished"] * 2
            toks[str(d)] = [r.output_tokens for r in reqs]
    np.testing.assert_allclose(logits[str(dev)], logits["cpu"], rtol=1e-3, atol=1e-3)
    assert toks[str(dev)] == toks["cpu"]
    after = [w.launches for w in (pa.paged_decode_attention, pa.paged_prefill_attention)]
    assert all(a > b for a, b in zip(after, before)), (before, after)


def _failing_entry(lib, name, rc):
    """The loaded library's entry point ``name`` replaced by a stub that
    launches nothing and returns CUDA status ``rc``; returns an undo."""
    real = getattr(lib, name)

    def stub(*args):
        return rc

    stub.argtypes = real.argtypes
    setattr(lib, name, stub)
    return lambda: setattr(lib, name, real)


@pytest.mark.parametrize("kernel,trigger", [("paged_decode", "decode_launch_failure"),
                                            ("paged_attention", "prefill_launch_failure")],
                         ids=["K1", "K2"])
def test_kernel_launch_failure_fails_closed_on_card(dev, kernel, trigger):
    """K1's (or K2's) launch itself fails: the library's entry point returns
    a nonzero CUDA status (98, cudaErrorInvalidDeviceFunction) for the
    length of one ``run_batch``, so the wrapper's own ``kernel launch failed
    (CUDA error 98)`` reaches the step loop.  Both rows become
    ``*_launch_failure`` refusals (FINISHED_ERROR, the fail-closed witness
    before the terminal), every pin is unwound, and once the entry point is
    back the same engine serves a fresh request.  A sticky CUDA error (an
    illegal address) poisons the context and cannot be tested this way."""
    from repro_torch.configs import get_config, reduced
    from repro_torch.core.analyzer import check_step_interleave_order, validate_event_sequence
    from repro_torch.kernels import build
    from repro_torch.models.registry import build_model
    from repro_torch.serving.engine import ServingEngine

    cfg = reduced(get_config("qwen3-1.7b"))
    bundle = build_model(cfg, device=dev)
    params = bundle.init_params(torch.Generator().manual_seed(0))
    lib = build.load(kernel)
    entry = {"paged_decode": "paged_decode_forward", "paged_attention": "paged_attention_forward"}
    (pa._decode_lib if kernel == "paged_decode" else pa._lib)()  # argtypes set
    with ServingEngine(bundle, params, block_size=4, device_blocks=64, device=dev) as eng:
        r1 = eng.submit(tuple(range(100, 112)), max_new_tokens=2)
        r2 = eng.submit(tuple(range(200, 212)), max_new_tokens=2)
        undo = _failing_entry(lib, entry[kernel], 98)
        try:
            assert eng.run_batch([r1, r2]) == [r1, r2]
        finally:
            undo()
        for r in (r1, r2):
            assert r.status == "error" and trigger in r.error, r.error
            assert "kernel launch failed (CUDA error 98)" in r.error
            fin = [e for e in eng.events.named("request_finished") if e.request_id == r.request_id]
            assert fin and fin[0].payload["status"] == "FINISHED_ERROR"
            wit = [e for e in eng.events.named("fail_closed_refused") if e.request_id == r.request_id]
            assert wit and wit[0].payload["trigger"] == trigger
        assert eng.fail_closed_total() == {trigger: 2}
        assert all(b.ref == 0 for b in eng.pool.blocks.values())
        assert validate_event_sequence(eng.events).passed
        assert check_step_interleave_order(eng.events).passed
        fresh = eng.run(eng.submit(tuple(range(300, 316)), max_new_tokens=3))
        assert fresh.status == "finished" and len(fresh.output_tokens) == 3
        assert eng.fail_closed_total() == {trigger: 2}


@pytest.mark.parametrize(
    "B,H,Sq,Sk,causal",
    [
        (4, 12, 1500, 1500, False),  # whisper-small encoder
        (4, 12, 64, 1500, False),  # cross attention: 64 prompt tokens over 1500 states
        (4, 12, 448, 1500, False),  # cross attention at the longest decoder prefix
        (2, 12, 64, 1499, False),  # a ragged last key tile (1499 = 23 * 64 + 27)
        (4, 12, 64, 64, True),  # decoder self-attention
    ],
    ids=["encoder", "cross64", "cross448", "ragged1499", "decoder"],
)
def test_flash_attention_whisper_shapes(dev, B, H, Sq, Sk, causal):
    """K5 at whisper-small's shapes (12 heads over 12, D 64), bf16, as the
    model hands the operands over: q from a [B, Sq, H, D] activation, k and v
    as views of the [B, Sk, H * D] projections of the encoder states."""
    g = torch.Generator(device=dev).manual_seed(11)
    bf = torch.bfloat16
    q = torch.randn((B, Sq, H, 64), generator=g, device=dev).to(bf).transpose(1, 2)
    proj = lambda: torch.randn((B, Sk, H * 64), generator=g, device=dev).to(bf)
    k, v = (proj().reshape(B, Sk, H, 64).transpose(1, 2) for _ in range(2))
    n0 = fa.flash_attention.launches
    got = fa.flash_attention(q, k, v, causal=causal)
    assert fa.flash_attention.launches == n0 + 1
    _close(got, fa.flash_attention_ref(q, k, v, causal=causal), bf)


def _to(tree, d):
    return {k: _to(v, d) for k, v in tree.items()} if isinstance(tree, dict) else tree.to(d)


def test_whisper_on_card_matches_cpu(dev):
    """Reduced whisper-small through its bundle's prefill_fn and three
    decode_fn steps on the card (K5 for every prefill attention) against the
    same weights on the CPU (bf16, 3e-2)."""
    from repro_torch.configs import get_config, reduced
    from repro_torch.models.registry import build_model

    cfg = reduced(get_config("whisper-small"))
    params = build_model(cfg, device="cpu").init_params(torch.Generator().manual_seed(0))
    rng = np.random.default_rng(0)
    frames = torch.from_numpy(rng.normal(size=(2, 8, cfg.d_model)).astype(np.float32)).to(torch.bfloat16)
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 6)).astype(np.int32))
    out = {}
    for d in ("cpu", dev):
        b = build_model(cfg, device=d)
        n0 = fa.flash_attention.launches
        lg, cache = b.prefill_fn(_to(params, d), {"frames": frames.to(d), "tokens": tokens.to(d)}, 16)
        if d == dev:
            assert fa.flash_attention.launches - n0 == cfg.encoder_layers + 2 * cfg.num_layers
        seq = [lg.cpu()]
        pos = torch.full((2,), 6, dtype=torch.int32)
        for i in range(3):
            lg, cache = b.decode_fn(_to(params, d), cache, seq[-1].argmax(-1).int().to(d), (pos + i).to(d))
            seq.append(lg.cpu())
        out[str(d)] = seq
    for a, c in zip(out[str(dev)], out["cpu"]):
        np.testing.assert_allclose(a.numpy(), c.numpy(), rtol=3e-2, atol=3e-2)
        assert (a.argmax(-1) == c.argmax(-1)).all()


def test_int8_dense_engine_on_card_matches_cpu(dev):
    """Reduced int8 qwen3 in its dense mode on the card against the CPU:
    prefill logits (bf16, 3e-2), the int8 cache's values within one step and
    its scales within bf16, and tokens of a served request."""
    from repro_torch.configs import get_config, reduced
    from repro_torch.models.registry import build_model
    from repro_torch.serving.engine import ServingEngine

    cfg = reduced(get_config("qwen3-1.7b")).replace(kv_cache_dtype="int8")
    params = build_model(cfg, device="cpu").init_params(torch.Generator().manual_seed(0))
    tokens = torch.arange(300, 341, dtype=torch.int32)[None]
    caches, logits, status = {}, {}, {}
    for d in ("cpu", dev):
        b = build_model(cfg, device=d)
        lg, cache = b.prefill_fn(_to(params, d), {"tokens": tokens.to(d)}, 64)
        tok, pos = torch.tensor([7], dtype=torch.int32, device=d), torch.tensor([41], dtype=torch.int32, device=d)
        lg, cache = b.decode_fn(_to(params, d), cache, tok, pos)
        caches[str(d)] = _to(cache, "cpu")
        with ServingEngine(b, _to(params, d), block_size=4, device_blocks=64, cache_len=64, device=d) as eng:
            assert eng.decode_mode == "dense"
            logits[str(d)] = eng.prefill_logits(tuple(range(300, 341)))
            r = eng.run(eng.submit(tuple(range(300, 320)), max_new_tokens=4))
            status[str(d)] = (r.status, len(r.output_tokens))
    assert status[str(dev)] == status["cpu"] == ("finished", 4)
    np.testing.assert_allclose(logits[str(dev)], logits["cpu"], rtol=3e-2, atol=3e-2)
    g, c = caches[str(dev)], caches["cpu"]
    assert g["k"].dtype == torch.int8
    assert (g["k"].int() - c["k"].int()).abs().max() <= 2
    torch.testing.assert_close(g["k_scale"].float(), c["k_scale"].float(), rtol=2e-2, atol=1e-3)


def test_int8_offload_and_restore_launch_k3(dev):
    """An int8 engine's claim offload and restore move int8 pages through
    K3 (``gather_payloads``), never the plain copy, and path A's restored
    tokens equal a never-offloaded engine's that reused the same prefix."""
    from repro_torch.configs import get_config, reduced
    from repro_torch.core.claims import ClaimMode, ClaimState
    from repro_torch.models.registry import build_model
    from repro_torch.serving.engine import ServingEngine

    cfg = reduced(get_config("qwen3-1.7b")).replace(kv_cache_dtype="int8")
    b = build_model(cfg, device=dev)
    params = b.init_params(torch.Generator().manual_seed(0))
    prefix = tuple(range(10, 26))
    kw = dict(block_size=4, device_blocks=64, cache_len=64, device=dev)
    with ServingEngine(b, params, **kw) as ref:
        ref.run(ref.submit(prefix + (30, 31), max_new_tokens=2))
        want = ref.run(ref.submit(prefix + (40, 41), max_new_tokens=3)).output_tokens
    plain0, k3 = kbc.gather_payloads.plain_copies, kbc.kv_block_copy.launches
    with ServingEngine(b, params, **kw) as eng:
        claim = eng.accept_claim(prefix, ClaimMode.OFFLOADABLE)
        r1 = eng.run(eng.submit(prefix + (30, 31), max_new_tokens=2))
        assert eng.pool.k_pages.dtype == torch.int8
        assert eng.offload_claim(claim.claim_id, request_id=r1.request_id)
        r2 = eng.run(eng.submit(prefix + (40, 41), max_new_tokens=3))
        assert r2.status == "finished" and claim.state == ClaimState.RESTORED
        assert r2.restored_tokens == len(prefix) and r2.output_tokens == want
        assert not eng.fail_closed_total()
    assert kbc.kv_block_copy.launches >= k3 + 4  # k and v, offload and restore
    assert kbc.gather_payloads.plain_copies == plain0


def _launch_counts():
    return (fa.flash_attention.launches, kbc.kv_block_copy.launches,
            pa.paged_decode_attention.launches, pa.paged_prefill_attention.launches,
            pa.paged_attention.launches, gemm.gemm.launches)


def test_training_step_on_card_matches_cpu(dev):
    """Reduced qwen3-1.7b: the loss and every grad of one training forward
    and backward on the card against the CPU from the same f32 masters
    (bf16 compute: loss within 2e-2, each grad leaf within 4e-2 of its
    largest |g|, the bf16 tolerance of tests/test_torch_train_archs.py),
    then one ``Trainer`` step on each: the updated masters within two
    step-1 learning rates (an Adam step moves an element by about lr, so a
    grad near zero whose sign differs moves it the other way).  No kernel
    launches."""
    from repro_torch.configs import get_config, reduced
    from repro_torch.models.registry import build_model
    from repro_torch.training.data import DataConfig
    from repro_torch.training.optimizer import AdamWConfig
    from repro_torch.training.train_loop import Trainer
    from repro_torch.training.tree import leaves, map_tree

    cfg = reduced(get_config("qwen3-1.7b"))
    opt = AdamWConfig(lr=3e-3, warmup_steps=5)
    trainers = {}
    for d in ("cpu", dev):
        tr = Trainer(build_model(cfg, device="cpu"), data_cfg=DataConfig(cfg.vocab_size, 32, 4),
                     opt_cfg=opt)
        if d == dev:
            tr.remesh(dev)
        trainers[str(d)] = tr
    before = _launch_counts()
    grads, losses = {}, {}
    for d, tr in trainers.items():
        compute = map_tree(lambda p: p.to(torch.bfloat16).requires_grad_(), tr.params)
        loss = tr.bundle.loss_fn(compute, tr.batch_at(0))
        g = torch.autograd.grad(loss, leaves(compute))
        grads[d], losses[d] = [x.float().cpu() for x in g], float(loss.detach())
    assert abs(losses[str(dev)] - losses["cpu"]) <= 2e-2
    for a, b in zip(grads[str(dev)], grads["cpu"]):
        assert (a - b).abs().max() <= 4e-2 * b.abs().max()
    for tr in trainers.values():
        tr.run(1, log_every=0)
    assert _launch_counts() == before
    lr1 = opt.lr / opt.warmup_steps
    for a, b in zip(leaves(trainers[str(dev)].params), leaves(trainers["cpu"].params)):
        assert a.device.type == "cuda" and a.dtype == torch.float32
        torch.testing.assert_close(a.cpu(), b, rtol=0, atol=2 * lr1)


@pytest.mark.parametrize("kernel", ["K1", "K2", "K3", "K4", "K5"])
def test_kernel_wrappers_refuse_grad_on_card(dev, kernel):
    """A CUDA input that requires grad raises before any launch: the
    kernels return tensors with no grad_fn, so reaching one in a training
    forward would silently drop the gradient of what came before it."""
    bf = dict(dtype=torch.bfloat16, device=dev)
    i32 = dict(dtype=torch.int32, device=dev)
    q = torch.zeros((1, 1, 2, 16), **bf).requires_grad_()
    pages = torch.zeros((1, 2, 16, 16), **bf)
    one = torch.ones((1,), **i32)
    calls = {
        "K1": lambda: pa.paged_decode_attention(
            q, pages, pages, torch.zeros((1, 1), **i32), one, torch.zeros((1, 1, 2, 16), **bf),
            torch.zeros((1, 1, 2, 16), **bf), torch.full((1, 2), -1, **i32), one),
        "K2": lambda: pa.paged_prefill_attention(
            q[:, :, :, None].expand(1, 1, 2, 4, 16), pages, pages, torch.zeros((1, 1), **i32),
            one, torch.zeros((1, 1, 4, 16), **bf), torch.zeros((1, 1, 4, 16), **bf)),
        "K3": lambda: kbc.kv_block_copy(pages[0].requires_grad_(), [1, 0]),
        "K4": lambda: pa.paged_attention(q, pages, pages, torch.zeros((1, 1), **i32), one),
        "K5": lambda: fa.flash_attention(torch.zeros((1, 2, 4, 16), **bf).requires_grad_(),
                                         pages, pages),
    }
    before = _launch_counts()
    with pytest.raises(RuntimeError, match="the kernel has no backward"):
        calls[kernel]()
    assert _launch_counts() == before


def test_trainer_runs_on_card_by_default(dev):
    """``Trainer`` on a bundle built with no device runs on the card: its
    masters and moments live there, two steps give finite losses that fall
    from about ln(V), and no kernel launches."""
    from repro_torch.configs import get_config, reduced
    from repro_torch.models.registry import build_model
    from repro_torch.training.data import DataConfig
    from repro_torch.training.optimizer import AdamWConfig
    from repro_torch.training.train_loop import Trainer
    from repro_torch.training.tree import leaves

    cfg = reduced(get_config("qwen3-1.7b"))
    tr = Trainer(build_model(cfg), data_cfg=DataConfig(cfg.vocab_size, 32, 4),
                 opt_cfg=AdamWConfig(lr=3e-3, warmup_steps=5))
    assert tr.device.type == "cuda"
    before = _launch_counts()
    metrics = tr.run(3, log_every=0)
    assert _launch_counts() == before
    assert all(t.device.type == "cuda" for t in leaves({"p": tr.params, "o": tr.opt_state}))
    losses = [m["loss"] for m in metrics]
    assert np.isfinite(losses).all() and abs(losses[0] - np.log(cfg.vocab_size)) < 0.5
    assert losses[-1] < losses[0]


# ---------------------------------------------------------------------------
# distribution (a one-rank NCCL group in a spawned process, a 1 x 1 mesh)
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def one_rank_card(dev, tmp_path_factory):
    import torch_dist_workers as W

    out = tmp_path_factory.mktemp("card_rank")
    W.run_ranks(W.card_worker, 1, str(out), backend="nccl", timeout=300)
    return torch.load(out / "rank0.pt")


def test_sharded_prefill_launches_k5_on_card(one_rank_card):
    """Reduced qwen3's sharded prefill on the card: K5 once per layer (the
    attention body hands the whole query slice to the kernel), logits the
    unsharded prefill's within bf16 tolerance."""
    got, want = one_rank_card["prefill"]
    assert one_rank_card["prefill_k5"] == 2
    _close(got, want, torch.bfloat16)


def test_sharded_train_step_on_card(one_rank_card):
    """Three sharded steps of reduced qwen3 on the 1 x 1 mesh (every
    parameter Shard-placed over its one-rank axes): losses and grad norms
    the unsharded Trainer's within 1e-3 relative."""
    got, want = one_rank_card["train"]
    np.testing.assert_allclose(got, want, rtol=1e-3)


def test_compressed_psum_one_rank_on_card(one_rank_card):
    assert one_rank_card["psum"]


@pytest.mark.parametrize("strategy", ["ep", "tp", "a2a"])
def test_sharded_moe_on_card(one_rank_card, strategy):
    e, ea = one_rank_card["moe"][strategy]
    assert e <= 2e-2 and ea <= 1e-5


# ---------------------------------------------------------------------------
# four cards: scripts/torch_four_cards.py at reduced size, one rank per card
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def four_cards(dev, tmp_path_factory):
    """The four-card program's cases at reduced size (4 NCCL ranks, one per
    card, and the router over one replica per card); skips below four
    cards."""
    import json
    import subprocess
    import sys
    from pathlib import Path

    if torch.cuda.device_count() < 4:
        pytest.skip("needs four cards")
    root = Path(__file__).resolve().parents[1]
    out = tmp_path_factory.mktemp("four_cards")
    proc = subprocess.run([sys.executable, str(root / "scripts" / "torch_four_cards.py"),
                           "--reduced", "--out", str(out)],
                          capture_output=True, text=True, timeout=900)
    return proc.returncode, json.loads((out / "summary.json").read_text()), proc.stdout[-4000:]


def test_four_cards_every_case_holds(four_cards):
    rc, summary, log = four_cards
    assert rc == 0 and summary["ok"], log
    assert set(summary["cases"]) == {"train", "prefill", "decode", "attention", "psum", "moe",
                                     "grok", "router"}


def test_four_cards_k5_offsets_per_rank(four_cards):
    """Every model rank's attention body launched K5 once per layer with
    its slice's start as q_offset: 0/32 of 64 on 2 x 2, 0/16/32/48 on
    1 x 4."""
    _, summary, _ = four_cards
    ranks = [summary["per_rank"][f"rank{r}"] for r in range(4)]
    assert [rk["device"] for rk in ranks] == [f"cuda:{r}" for r in range(4)]
    assert [rk["prefill"]["2 x 2"]["q_offsets"] for rk in ranks] == [[0], [32], [0], [32]]
    assert [rk["prefill"]["1 x 4"]["q_offsets"] for rk in ranks] == [[0], [16], [32], [48]]
    assert all(rk["prefill"]["1 x 4"]["k5_launches"] == 2 for rk in ranks)


def test_four_cards_router_serves_on_every_card(four_cards):
    _, summary, _ = four_cards
    lc = summary["cases"]["router"]["cards"]["launches_by_card"]
    assert sorted(lc) == [f"cuda:{i}" for i in range(4)]
    assert all(c["K1"] > 0 and c["K2"] > 0 for c in lc.values())
    assert lc["cuda:2"]["K3"] > 0


# ---------------------------------------------------------------------------
# one key order for every route, and the row-invariant GEMM
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("start", [0, 4, 32, 100])
@pytest.mark.parametrize("G", [1, 2, 6, 7])
@pytest.mark.parametrize("D", [64, 96, 128, 160, 256])
def test_routes_give_the_same_bits_on_card(dev, D, G, start):
    """K1 (a decode step per position, the tail at prefix_len + t), K2 (a
    chunk starting at ``start``) and K5 (the whole sequence) give the same
    query over the same keys the same bits in bf16, with a 20-key window
    and soft-cap 30 when G is 6 or 7 (``tests/torch_route_scenes.py``);
    each is within 2e-2 of its plain version."""
    from torch_route_scenes import rows, scene

    kw = dict(window=20, softcap=30.0) if G >= 6 else {}
    sc = scene(start + 16, start, 16, G, D, seed=D + G + start, dtype=torch.bfloat16, device=dev)
    counts = _launch_counts()
    out = (fa.flash_attention(*sc["flash"]["args"], causal=True, **kw),
           pa.paged_prefill_attention(*sc["chunk"]["args"], **kw),
           pa.paged_decode_attention(*sc["decode"]["args"], **kw))
    assert [b - a for a, b in zip(counts, _launch_counts())] == [1, 0, 1, 1, 0, 0]
    _close(out[0], fa.flash_attention_ref(*sc["flash"]["args"], causal=True, **kw), torch.bfloat16)
    _close(out[1], pa.paged_prefill_attention_ref(*sc["chunk"]["args"], **kw), torch.bfloat16)
    _close(out[2], pa.paged_decode_attention_ref(*sc["decode"]["args"], **kw), torch.bfloat16)
    f, c, d = rows(sc, *out)
    torch.cuda.synchronize()
    assert torch.equal(c, f), f"K2 differs from K5 by {float((c.float() - f.float()).abs().max())}"
    assert torch.equal(d, f), f"K1 differs from K5 by {float((d.float() - f.float()).abs().max())}"


@pytest.mark.parametrize("start", [0, 100, 1040])
@pytest.mark.parametrize("G", [2, 7])
@pytest.mark.parametrize("D", [64, 128, 160, 256])
def test_long_routes_give_the_same_bits_on_card(dev, D, G, start):
    """The same bits over a sequence of 1100 keys: 18 splits wrap K5's ring
    of K/V stages (at most 8), and K5 runs with one and with two consumer
    warpgroups per CTA (two row blocks of 64 over one kv head); K5 over the
    chunk's query slice alone (``q_offset`` = start, keys up to the chunk's
    end) gives the same rows too.  K1 and K2 as in
    ``test_routes_give_the_same_bits_on_card``; a 300-key window and
    soft-cap 30 when G is 7."""
    from torch_route_scenes import rows, scene

    kw = dict(window=300, softcap=30.0) if G == 7 else {}
    C = 16
    sc = scene(1100, start, C, G, D, seed=D + G + start, dtype=torch.bfloat16, device=dev)
    q, k, v = sc["flash"]["args"]
    flash = [fa.flash_attention(q, k, v, causal=True, groups=n, **kw) for n in (1, 2)]
    sliced = fa.flash_attention(q[:, :, start:start + C], k[:, :, :start + C], v[:, :, :start + C],
                                causal=True, q_offset=start, **kw)
    chunk = pa.paged_prefill_attention(*sc["chunk"]["args"], **kw)
    decode = pa.paged_decode_attention(*sc["decode"]["args"], **kw)
    _close(flash[0], fa.flash_attention_ref(q, k, v, causal=True, **kw), torch.bfloat16)
    f, c, d = rows(sc, flash[0], chunk, decode)
    f2 = rows(sc, flash[1], chunk, decode)[0]
    fs = sliced[0].reshape(2, G, C, D)
    torch.cuda.synchronize()
    for name, got in (("K5 two warpgroups", f2), ("K5 q_offset", fs), ("K2", c), ("K1", d)):
        assert torch.equal(got, f), f"{name} differs from K5 by {float((got.float() - f.float()).abs().max())}"


def test_wgmma_and_mma_sync_give_the_same_bits_on_card(dev):
    """The probe of bench/wgmma_probe.py: a wgmma k16 step (A from
    registers or shared memory, B K-major or MN-major from a 128-byte-
    swizzled tile) gives mma.sync's bits on every element of five input
    classes (normals, exponent spreads, near-cancelling sums, subnormals,
    large C).  K5 runs its products on wgmma beside K1's and K2's mma.sync
    (branch A of the design), which is sound only while this holds."""
    from repro_torch.bench import wgmma_probe

    report = wgmma_probe.probe(dev, n=256)
    print("wgmma probe:", report)
    assert report["sane"], report
    assert report["equal"], report


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("D", [640, 1024])
def test_wide_routes_give_the_same_bits_on_card(dev, dtype, D):
    """Past head dim 256 every entry point runs the SIMT split kernel over
    the same position splits: K1, K2 and K5 agree bitwise there too."""
    from torch_route_scenes import rows, scene

    sc = scene(80, 64, 16, 2, D, seed=D, dtype=dtype, device=dev)
    out = (fa.flash_attention(*sc["flash"]["args"], causal=True),
           pa.paged_prefill_attention(*sc["chunk"]["args"]),
           pa.paged_decode_attention(*sc["decode"]["args"]))
    f, c, d = rows(sc, *out)
    torch.cuda.synchronize()
    assert torch.equal(c, f) and torch.equal(d, f)
    _close(out[0], fa.flash_attention_ref(*sc["flash"]["args"], causal=True), dtype)


def test_attention_kernels_keep_16_bits_of_p_on_card(dev):
    """P V at about the reference's precision.  Each value row is a unit
    vector (``eye``), so an output column is one key's softmax weight p / l:
    with P split into two bf16 terms (about 16 bits) K1, K2 and K5 round
    nearly every nonzero output to the bf16 of the f32 plain version's,
    where a P rounded once to bf16 (the plain model with ``p_dtype``) gets
    about three in four."""
    from torch_route_scenes import rows, scene

    sc = scene(48, 32, 16, 2, 64, seed=9, dtype=torch.bfloat16, device=dev, eye=True)
    fargs = sc["flash"]["args"]
    exact = fa.flash_attention_ref(*[a.float() for a in fargs], causal=True).bfloat16()
    once = fa.flash_attention_tiled_ref(*fargs, causal=True, p_dtype=torch.bfloat16)
    out = (fa.flash_attention(*fargs, causal=True),
           pa.paged_prefill_attention(*sc["chunk"]["args"]),
           pa.paged_decode_attention(*sc["decode"]["args"]))
    want = rows(sc, exact, out[1], out[2])[0]
    rounded_once = rows(sc, once, out[1], out[2])[0]
    nz = want != 0
    share = lambda got: float((got[nz] == want[nz]).float().mean())
    torch.cuda.synchronize()
    assert share(rounded_once) < 0.9
    for name, got in zip(("K5", "K2", "K1"), rows(sc, *out)):
        assert share(got) >= 0.97, (name, share(got), share(rounded_once))


# qwen3-1.7b's projection shapes (K, N): q/o 2048 x 2048, k/v 2048 x 1024,
# the MLP's 2048 x 6144 and 6144 x 2048, and the tied LM head (embed.T of a
# 151,936 x 2048 table, read in place)
GEMM_SHAPES = [(2048, 2048), (2048, 1024), (2048, 6144), (6144, 2048), (2048, 151936)]
GEMM_M = [1, 3, 8, 24, 32, 64, 65, 127, 128, 129, 224, 512, 4096]


@pytest.mark.parametrize("K,N", GEMM_SHAPES, ids=[f"{k}x{n}" for k, n in GEMM_SHAPES])
def test_gemm_rows_do_not_depend_on_m_on_card(dev, K, N):
    """Each output row of the GEMM is bitwise the same for every M of
    GEMM_M, 1 to 4096 across the tile edges (64 rows: one consumer
    warpgroup; 128: two) as the M = 4096 product's same rows (one
    activation draw), and within 2e-2 of ``torch.matmul``; the LM head's
    weight is the transposed view of its [N, K] table."""
    g = torch.Generator(device=dev).manual_seed(K + N)
    x = (0.5 * torch.randn((4096, K), generator=g, device=dev)).bfloat16()
    if N > 100_000:
        w = (torch.randn((N, K), generator=g, device=dev) * 0.02).bfloat16().T
    else:
        w = (torch.randn((K, N), generator=g, device=dev) / K ** 0.5).bfloat16()
    full = gemm.gemm(x, w)
    torch.cuda.synchronize()
    _close(full, x @ w, torch.bfloat16)
    for M in GEMM_M:
        n0 = gemm.gemm.launches
        part = gemm.gemm(x[:M], w)
        torch.cuda.synchronize()
        assert gemm.gemm.launches == n0 + 1
        assert torch.equal(part, full[:M]), f"M = {M}"


def test_gemm_tied_head_reads_the_table_in_place_on_card(dev):
    """The tied LM head: ``embed.T`` of a 151,936 x 2048 table is read in
    place (no copy) and gives the bits of the same weight laid out [K, N],
    at decode (M = 8) and chunk (M = 32) widths, rows independent of M."""
    g = torch.Generator(device=dev).manual_seed(0)
    embed = (torch.randn((151936, 2048), generator=g, device=dev) * 0.02).bfloat16()
    x = torch.randn((32, 2048), generator=g, device=dev).bfloat16()
    alloc = torch.cuda.memory_allocated(dev)
    tied = gemm.gemm(x, embed.T)
    assert torch.cuda.memory_allocated(dev) - alloc <= tied.numel() * 2 + 2 ** 20
    untied = gemm.gemm(x, embed.T.contiguous())
    torch.cuda.synchronize()
    assert torch.equal(tied, untied)
    assert torch.equal(gemm.gemm(x[:8], embed.T), tied[:8])
    _close(tied, x @ embed.T, torch.bfloat16)


@pytest.mark.parametrize("shape", [(5, 4, 13), (3, 40, 20), (2, 7, 1000)])
def test_gemm_pads_odd_shapes_on_card(dev, shape):
    """K or N not a multiple of 8 is zero-padded before the launch: the
    result matches ``torch.matmul`` (2e-2) and the padded columns are gone."""
    M, K, N = shape
    g = torch.Generator(device=dev).manual_seed(M)
    x = torch.randn((M, K), generator=g, device=dev).bfloat16()
    w = torch.randn((K, N), generator=g, device=dev).bfloat16()
    got = gemm.gemm(x, w)
    assert got.shape == (M, N)
    _close(got, x @ w, torch.bfloat16)


def test_serving_projections_take_the_gemm_on_card(dev):
    """A reduced qwen3 engine's prefill and decode steps launch the GEMM
    (``proj`` with no-grad bf16 operands) and serve a request to the end."""
    from repro_torch.configs import get_config, reduced
    from repro_torch.models.registry import build_model
    from repro_torch.serving.engine import ServingEngine

    cfg = reduced(get_config("qwen3-1.7b"))
    params = build_model(cfg, device="cpu").init_params(torch.Generator().manual_seed(0))
    params = _to(params, dev)
    n0 = gemm.gemm.launches
    with ServingEngine(build_model(cfg, device=dev), params, block_size=4, device_blocks=64,
                       device=dev) as eng:
        req = eng.submit(tuple(range(10, 30)), max_new_tokens=4)
        eng.run(req)
    assert req.status == "finished" and len(req.output_tokens) == 4
    assert gemm.gemm.launches > n0


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("kernel", ["K1", "K2"])
def test_off_position_keys_kernel_matches_plain(dev, kernel, dtype):
    """Keys the position splits cannot hold take the extra splits: decode
    tail slots off ``prefix_len + t`` and a prefix_len past the table (K1),
    a chunk after a prefix_len past the table (K2); each kernel against its
    plain version (1e-5 in f32, 2e-2 in bf16)."""
    from torch_route_scenes import off_position

    args, kw = off_position(kernel, dtype, dev)
    fn, plain = ((pa.paged_decode_attention, pa.paged_decode_attention_ref) if kernel == "K1"
                 else (pa.paged_prefill_attention, pa.paged_prefill_attention_ref))
    n0 = fn.launches
    got = fn(*args, **kw)
    assert fn.launches == n0 + 1
    _close(got, plain(*args, **kw), dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_wide_empty_row_kernel_matches_plain(dev, dtype):
    """Past head dim 256 the split kernel's merge gives a row with no valid
    key (Sq > Sk under a causal window) the mean of the Sk value rows, as
    the plain version does."""
    g = torch.Generator(device=dev).manual_seed(0)
    rnd = lambda *s: torch.randn(s, generator=g, device=dev).to(dtype)
    q, k, v = rnd(1, 2, 8, 320), rnd(1, 1, 4, 320), rnd(1, 1, 4, 320)
    got = fa.flash_attention(q, k, v, causal=True, window=2)
    _close(got, fa.flash_attention_ref(q, k, v, causal=True, window=2), dtype)
    _close(got[0, :, 5:], v[0, 0].float().mean(dim=0).expand(2, 3, 320), dtype)

"""The port's plain kernel versions against the JAX package's oracles.

Each plain PyTorch version (``repro_torch.kernels.*``, what a CPU tensor
runs and what the CUDA kernels are held against on the card) is compared
with ``repro.kernels.ref`` and with the Pallas kernel run in interpret mode
(``repro.kernels.ops``), on the parametrizations of tests/test_kernels.py,
in float32 and bfloat16.  Inputs are drawn with numpy from a seed and
handed to both frameworks.  Tolerances are those of tests/test_kernels.py:
1e-5 in float32, 2e-2 in bfloat16 (the two frameworks round bf16 outputs
from differently ordered f32 sums).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops, ref
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import kv_block_copy as kbc
from repro_torch.kernels import paged_attention as pa
from repro_torch.models.layers import attention_decode

TOLS = {"float32": dict(rtol=1e-5, atol=1e-5), "bfloat16": dict(rtol=2e-2, atol=2e-2)}
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _pair(a, dtype):
    """The same numpy draw as a JAX array and a torch tensor."""
    a = np.asarray(a)
    if a.dtype.kind in "iu":
        return jnp.asarray(a, jnp.int32), torch.from_numpy(a.astype(np.int32))
    return jnp.asarray(a, JDT[dtype]), torch.from_numpy(a.astype(np.float32)).to(TDT[dtype])


def _close(got_t, want_j, dtype):
    np.testing.assert_allclose(
        got_t.float().numpy(), np.asarray(want_j, np.float32), **TOLS[dtype]
    )


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize(
    "B,KV,G,D,page,P,N,T,window,softcap",
    [
        (2, 2, 2, 16, 4, 4, 16, 8, 0, 0.0),
        (1, 4, 1, 32, 8, 3, 8, 4, 0, 0.0),
        (3, 1, 4, 16, 4, 5, 32, 8, 12, 0.0),  # sliding window
        (2, 2, 2, 16, 4, 4, 16, 8, 0, 20.0),  # softcap
    ],
)
def test_paged_decode_plain_matches_jax(dtype, B, KV, G, D, page, P, N, T, window, softcap):
    rng = np.random.default_rng(5)
    prefix_len = rng.integers(1, P * page + 1, (B,))
    t_used = rng.integers(1, T + 1, (B,))
    tail_pos = np.full((B, T), -1, np.int32)
    for b in range(B):
        tail_pos[b, : t_used[b]] = prefix_len[b] + np.arange(t_used[b])
    draws = [
        rng.normal(size=(B, KV, G, D)),
        rng.normal(size=(KV, N, page, D)),
        rng.normal(size=(KV, N, page, D)),
        rng.integers(0, N, (B, P)),
        prefix_len,
        rng.normal(size=(B, KV, T, D)),
        rng.normal(size=(B, KV, T, D)),
        tail_pos,
        prefix_len + t_used - 1,
    ]
    pairs = [_pair(a, dtype) for a in draws]
    jargs = [p[0] for p in pairs]
    targs = [p[1] for p in pairs]
    got = pa.paged_decode_attention(*targs, softcap=softcap, window=window)
    _close(got, ref.paged_decode_attention_ref(*jargs, softcap=softcap, window=window), dtype)
    _close(got, ops.paged_decode_attention(*jargs, softcap=softcap, window=window, interpret=True), dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize(
    "B,KV,G,D,page,P,N,C,window,softcap",
    [
        (2, 2, 2, 16, 4, 4, 16, 8, 0, 0.0),
        (1, 4, 1, 32, 8, 3, 8, 16, 0, 0.0),
        (3, 1, 4, 16, 4, 5, 32, 8, 12, 0.0),  # sliding window
        (1, 2, 2, 16, 4, 3, 8, 8, 0, 20.0),   # softcap
    ],
)
def test_paged_prefill_plain_matches_jax(dtype, B, KV, G, D, page, P, N, C, window, softcap):
    rng = np.random.default_rng(7)
    draws = [
        rng.normal(size=(B, KV, G, C, D)),
        rng.normal(size=(KV, N, page, D)),
        rng.normal(size=(KV, N, page, D)),
        rng.integers(0, N, (B, P)),
        rng.integers(0, P + 1, (B,)) * page,  # block-aligned, including empty
        rng.normal(size=(B, KV, C, D)),
        rng.normal(size=(B, KV, C, D)),
    ]
    pairs = [_pair(a, dtype) for a in draws]
    jargs = [p[0] for p in pairs]
    targs = [p[1] for p in pairs]
    got = pa.paged_prefill_attention(*targs, softcap=softcap, window=window)
    _close(got, ref.paged_prefill_attention_ref(*jargs, softcap=softcap, window=window), dtype)
    _close(got, ops.paged_prefill_attention(*jargs, softcap=softcap, window=window, interpret=True), dtype)


def test_paged_prefill_plain_composes_to_full_causal():
    """Chunk by chunk over landed pages == one full causal attention (f32,
    1e-5): the identity chunked prefill rests on, in the port."""
    rng = np.random.default_rng(9)
    B, KV, G, D, page, C = 1, 2, 2, 16, 4, 8
    S = 4 * C
    H = KV * G
    q_all = rng.normal(size=(B, H, S, D)).astype(np.float32)
    k_all = rng.normal(size=(B, KV, S, D)).astype(np.float32)
    v_all = rng.normal(size=(B, KV, S, D)).astype(np.float32)
    full = np.asarray(ref.flash_attention_ref(jnp.asarray(q_all), jnp.asarray(k_all), jnp.asarray(v_all), causal=True))
    P = S // page
    k_pages = torch.zeros((KV, P, page, D))
    v_pages = torch.zeros((KV, P, page, D))
    bt = torch.arange(P, dtype=torch.int32)[None]
    outs = []
    for lo in range(0, S, C):
        q = torch.from_numpy(q_all[:, :, lo : lo + C]).reshape(B, KV, G, C, D)
        kc = torch.from_numpy(k_all[:, :, lo : lo + C])
        vc = torch.from_numpy(v_all[:, :, lo : lo + C])
        out = pa.paged_prefill_attention(
            q, k_pages, v_pages, bt, torch.tensor([lo], dtype=torch.int32), kc, vc
        )
        outs.append(out.numpy())
        for b0 in range(lo // page, (lo + C) // page):
            k_pages[:, b0] = torch.from_numpy(k_all[0, :, b0 * page : (b0 + 1) * page])
            v_pages[:, b0] = torch.from_numpy(v_all[0, :, b0 * page : (b0 + 1) * page])
    got = np.concatenate(outs, axis=3).reshape(B, H, S, D)
    np.testing.assert_allclose(got, full, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int32"])
def test_kv_block_copy_plain_matches_jax(dtype):
    """Exact: a page gather moves bytes."""
    rng = np.random.default_rng(4)
    N, page, KV, D = 16, 8, 2, 32
    if dtype == "int32":
        src = rng.integers(0, 100, (N, page, KV, D)).astype(np.int32)
        s_j, s_t = jnp.asarray(src), torch.from_numpy(src)
    else:
        s_j, s_t = _pair(rng.normal(size=(N, page, KV, D)), dtype)
    idx = rng.permutation(N)[:5].astype(np.int32)
    got = kbc.kv_block_copy(s_t, torch.from_numpy(idx))
    want = ops.kv_block_copy(s_j, jnp.asarray(idx), interpret=True)
    if dtype == "bfloat16":
        assert np.array_equal(got.view(torch.int16).numpy(), np.asarray(want).view(np.int16))
    else:
        assert np.array_equal(got.numpy(), np.asarray(want))
    assert np.array_equal(np.asarray(ref.kv_block_copy_ref(s_j, jnp.asarray(idx))), np.asarray(want))


def test_gather_payloads_plain_path():
    """Uniform payloads come back as fresh equal tensors in order; mixed
    shapes take the counted per-array copy, chosen from shapes alone."""
    g = torch.Generator().manual_seed(0)
    arrays = [torch.randn((2, 4, 2, 16), generator=g).to(torch.bfloat16) for _ in range(3)]
    before = kbc.gather_payloads.plain_copies
    out = kbc.gather_payloads(arrays, "cpu")
    assert kbc.gather_payloads.plain_copies == before
    for a, b in zip(arrays, out):
        assert torch.equal(a, b) and a.data_ptr() != b.data_ptr()
    mixed = kbc.gather_payloads([arrays[0], arrays[1][:, :2]], "cpu")
    assert kbc.gather_payloads.plain_copies == before + 1
    assert torch.equal(mixed[1], arrays[1][:, :2])


def test_wrappers_raise_on_unsupported_devices():
    """No silent fallback: a tensor that is neither CPU nor a supported CUDA
    operand raises instead of taking the plain version."""
    q = torch.empty((1, 1, 2, 16), device="meta")
    pages = torch.empty((1, 4, 4, 16), device="meta")
    bt = torch.zeros((1, 1), dtype=torch.int32, device="meta")
    ln = torch.zeros((1,), dtype=torch.int32, device="meta")
    tail = torch.empty((1, 1, 4, 16), device="meta")
    tpos = torch.zeros((1, 4), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        pa.paged_decode_attention(q, pages, pages, bt, ln, tail, tail, tpos, ln)
    with pytest.raises(ValueError, match="unsupported device"):
        kbc.kv_block_copy(pages, torch.tensor([0]))


def test_fully_masked_row_reproduces_reference_quirk():
    """A decode row with no valid key (empty prefix, empty tail): the JAX
    reference's dense softmax gives every masked position the same weight,
    so the row is the plain mean of all value rows; the port's plain version
    and the plain model of the split kernel reproduce that (f32, 1e-5), and
    the CUDA kernel is held to the same on the card
    (tests/test_torch_gpu.py).  The serving path never builds such a row."""
    rng = np.random.default_rng(11)
    B, KV, G, D, page, P, N, T = 1, 2, 2, 16, 4, 2, 8, 4
    draws = [
        rng.normal(size=(B, KV, G, D)),
        rng.normal(size=(KV, N, page, D)),
        rng.normal(size=(KV, N, page, D)),
        rng.integers(0, N, (B, P)),
        np.zeros((B,), np.int32),
        rng.normal(size=(B, KV, T, D)),
        rng.normal(size=(B, KV, T, D)),
        np.full((B, T), -1, np.int32),
        np.zeros((B,), np.int32),
    ]
    pairs = [_pair(a, "float32") for a in draws]
    got = pa.paged_decode_attention(*[p[1] for p in pairs])
    want = ref.paged_decode_attention_ref(*[p[0] for p in pairs])
    _close(got, want, "float32")
    v_all = np.concatenate(
        [draws[2][:, draws[3][0]].reshape(KV, P * page, D), draws[6][0]], axis=1
    )  # [KV, P*page + T, D]
    np.testing.assert_allclose(
        got[0].numpy(), np.broadcast_to(v_all.mean(axis=1)[:, None], (KV, G, D)), rtol=1e-5, atol=1e-5
    )
    _close(pa.paged_decode_attention_split_ref(*[p[1] for p in pairs]), want, "float32")


FLASH_CASES = [
    (1, 4, 4, 32, 32, 16, True, 0, 0.0),
    (2, 4, 2, 64, 64, 32, True, 0, 0.0),  # GQA
    (1, 2, 1, 48, 48, 16, True, 16, 0.0),  # sliding window
    (1, 2, 2, 32, 32, 16, True, 0, 30.0),  # softcap
    (2, 2, 2, 40, 72, 16, False, 0, 0.0),  # non-causal, ragged Sq != Sk
    (1, 8, 8, 128, 128, 64, True, 0, 0.0),
]


def _flash_draws(B, H, KV, Sq, Sk, D, dtype):
    rng = np.random.default_rng(0)
    return [
        _pair(rng.normal(size=shape), dtype)
        for shape in ((B, H, Sq, D), (B, KV, Sk, D), (B, KV, Sk, D))
    ]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,H,KV,Sq,Sk,D,causal,window,softcap", FLASH_CASES)
def test_flash_attention_plain_matches_jax(dtype, B, H, KV, Sq, Sk, D, causal, window, softcap):
    pairs = _flash_draws(B, H, KV, Sq, Sk, D, dtype)
    kw = dict(causal=causal, window=window, softcap=softcap)
    got = fa.flash_attention(*[p[1] for p in pairs], **kw)
    assert got.shape == (B, H, Sq, D) and got.dtype == TDT[dtype]
    _close(got, ref.flash_attention_ref(*[p[0] for p in pairs], **kw), dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", [FLASH_CASES[2], FLASH_CASES[4]], ids=["window", "ragged"])
def test_flash_attention_plain_matches_pallas_interpret(dtype, case):
    """Against the Pallas kernel itself, run in interpret mode with the
    block sizes of tests/test_kernels.py."""
    B, H, KV, Sq, Sk, D, causal, window, softcap = case
    pairs = _flash_draws(B, H, KV, Sq, Sk, D, dtype)
    kw = dict(causal=causal, window=window, softcap=softcap)
    got = fa.flash_attention(*[p[1] for p in pairs], **kw)
    want = ops.flash_attention(*[p[0] for p in pairs], **kw, block_q=16, block_k=16, interpret=True)
    _close(got, want, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize(
    "B,KV,G,D,page,P,N",
    [
        (2, 2, 2, 16, 8, 4, 16),
        (1, 4, 1, 32, 16, 3, 8),
        (3, 1, 8, 64, 8, 5, 32),
    ],
)
def test_paged_attention_plain_matches_jax(dtype, B, KV, G, D, page, P, N):
    rng = np.random.default_rng(2)
    draws = [
        rng.normal(size=(B, KV, G, D)),
        rng.normal(size=(KV, N, page, D)),
        rng.normal(size=(KV, N, page, D)),
        rng.integers(0, N, (B, P)),
        rng.integers(1, P * page + 1, (B,)),
    ]
    pairs = [_pair(a, dtype) for a in draws]
    got = pa.paged_attention(*[p[1] for p in pairs])
    _close(got, ref.paged_attention_ref(*[p[0] for p in pairs]), dtype)
    _close(got, ops.paged_attention(*[p[0] for p in pairs], interpret=True), dtype)


def test_paged_attention_matches_dense_decode():
    """Paged attention over a dense cache paged out == the dense decode
    mode's ``attention_decode`` on the same data (f32, 1e-5), the property
    of tests/test_kernels.py held inside the port."""
    rng = np.random.default_rng(3)
    B, KV, G, D, page, P = 2, 2, 2, 16, 8, 4
    S, H = page * P, KV * G
    k_dense = torch.from_numpy(rng.normal(size=(B, S, KV, D)).astype(np.float32))
    v_dense = torch.from_numpy(rng.normal(size=(B, S, KV, D)).astype(np.float32))
    lengths = torch.tensor([S, S // 2], dtype=torch.int32)
    q = torch.from_numpy(rng.normal(size=(B, 1, H, D)).astype(np.float32))
    # page n of sequence b lives at page id b*P + n
    k_pages = k_dense.reshape(B, P, page, KV, D).permute(3, 0, 1, 2, 4).reshape(KV, B * P, page, D)
    v_pages = v_dense.reshape(B, P, page, KV, D).permute(3, 0, 1, 2, 4).reshape(KV, B * P, page, D)
    bt = torch.tensor([[b * P + n for n in range(P)] for b in range(B)], dtype=torch.int32)
    out_paged = pa.paged_attention(q[:, 0].reshape(B, KV, G, D), k_pages, v_pages, bt, lengths)
    kv_positions = torch.arange(S)[None].expand(B, S)
    out_dense = attention_decode(q, k_dense, v_dense, kv_positions=kv_positions, cur_pos=lengths - 1)
    np.testing.assert_allclose(
        out_paged.reshape(B, H, D).numpy(), out_dense.reshape(B, H, D).numpy(), rtol=1e-5, atol=1e-5
    )


def test_paged_attention_zero_length_reproduces_reference_quirk():
    """``lengths[b] == 0``: the reference's dense softmax over a fully
    masked row returns the plain mean of all P * page gathered value rows;
    the plain version and the plain model of the split kernel reproduce it
    (f32, 1e-5), and the CUDA kernel is held to the same on the card
    (tests/test_torch_gpu.py)."""
    rng = np.random.default_rng(12)
    B, KV, G, D, page, P, N = 2, 2, 2, 16, 4, 3, 8
    draws = [
        rng.normal(size=(B, KV, G, D)),
        rng.normal(size=(KV, N, page, D)),
        rng.normal(size=(KV, N, page, D)),
        rng.integers(0, N, (B, P)),
        np.array([0, 5], np.int32),
    ]
    pairs = [_pair(a, "float32") for a in draws]
    got = pa.paged_attention(*[p[1] for p in pairs])
    _close(got, ref.paged_attention_ref(*[p[0] for p in pairs]), "float32")
    mean = draws[2][:, draws[3][0]].reshape(KV, P * page, D).mean(axis=1)
    np.testing.assert_allclose(
        got[0].numpy(), np.broadcast_to(mean[:, None], (KV, G, D)), rtol=1e-5, atol=1e-5
    )
    _close(pa.paged_attention_split_ref(*[p[1] for p in pairs]), got.numpy(), "float32")


def test_new_wrappers_raise_on_unsupported_devices():
    q = torch.empty((1, 2, 8, 16), device="meta")
    kv = torch.empty((1, 1, 8, 16), device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        fa.flash_attention(q, kv, kv)
    pages = torch.empty((1, 4, 4, 16), device="meta")
    bt = torch.zeros((1, 1), dtype=torch.int32, device="meta")
    ln = torch.zeros((1,), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        pa.paged_attention(torch.empty((1, 1, 2, 16), device="meta"), pages, pages, bt, ln)


def _split_case(split, window, softcap, seed=13):
    """Prefixes at, one before and one past a split boundary (split keys =
    ``split``), an in-flight tail, and trailing prefix splits left empty."""
    rng = np.random.default_rng(seed)
    B, KV, G, D, page, P, N, T = 3, 2, 2, 16, 4, 5, 32, 8
    prefix_len = np.array([split, split - 1, split + 1])
    t_used = rng.integers(1, T + 1, (B,))
    tail_pos = np.full((B, T), -1, np.int32)
    for b in range(B):
        tail_pos[b, : t_used[b]] = prefix_len[b] + np.arange(t_used[b])
    return [
        rng.normal(size=(B, KV, G, D)),
        rng.normal(size=(KV, N, page, D)),
        rng.normal(size=(KV, N, page, D)),
        rng.permutation(N)[: B * P].reshape(B, P),
        prefix_len,
        rng.normal(size=(B, KV, T, D)),
        rng.normal(size=(B, KV, T, D)),
        tail_pos,
        prefix_len + t_used - 1,
    ]


@pytest.mark.parametrize("split_pages", [1, 2, 4])
@pytest.mark.parametrize("window,softcap", [(0, 0.0), (6, 0.0), (0, 20.0), (11, 30.0)])
def test_paged_decode_split_plain_matches_jax(split_pages, window, softcap):
    """The split-KV decode kernel's arithmetic (per-split partials, ordered
    merge) against the reference and the Pallas kernel in interpret mode
    (f32, 1e-5).  Page 4, so splits of 4, 8 and 16 keys; the window empties
    the early splits."""
    split = 4 * split_pages
    pairs = [_pair(a, "float32") for a in _split_case(split, window, softcap)]
    jargs, targs = [p[0] for p in pairs], [p[1] for p in pairs]
    m, l, acc = pa.paged_decode_split_partials(*targs, softcap=softcap, window=window, split=split)
    n_pos = -(-(20 + 8) // split)  # position splits over the table's 20 keys and the 8 tail slots
    assert m.shape == (3, 2, n_pos + -(-8 // split), 2) and acc.shape == m.shape + (16,)
    cur = int(targs[8][1])  # row 1: no key past its position, no tail slot off its position
    assert bool(torch.isinf(m[1, :, cur // split + 1 :]).all())
    assert bool(torch.isinf(m[:, :, n_pos:]).all())  # every tail slot sits at prefix_len + t
    got = pa.merge_split_partials(m, l, acc)
    kw = dict(softcap=softcap, window=window)
    _close(got, ref.paged_decode_attention_ref(*jargs, **kw), "float32")
    _close(got, ops.paged_decode_attention(*jargs, **kw, interpret=True), "float32")
    _close(pa.paged_decode_attention_split_ref(*targs, **kw, split=split), got, "float32")


@pytest.mark.parametrize("split_pages", [1, 2, 4])
def test_paged_attention_split_plain_matches_jax(split_pages):
    """``paged_attention`` through the split-KV arithmetic with T = 0 and the
    query at ``lengths`` (f32, 1e-5); lengths at, before and past a split
    boundary."""
    rng = np.random.default_rng(14)
    B, KV, G, D, page, P, N = 3, 2, 2, 16, 4, 5, 32
    split = page * split_pages
    draws = [
        rng.normal(size=(B, KV, G, D)),
        rng.normal(size=(KV, N, page, D)),
        rng.normal(size=(KV, N, page, D)),
        rng.integers(0, N, (B, P)),
        np.array([split, split - 1, split + 1]),
    ]
    pairs = [_pair(a, "float32") for a in draws]
    jargs, targs = [p[0] for p in pairs], [p[1] for p in pairs]
    got = pa.paged_attention_split_ref(*targs, softcap=20.0, split=split)
    _close(got, ref.paged_attention_ref(*jargs, softcap=20.0), "float32")
    _close(got, ops.paged_attention(*jargs, softcap=20.0, interpret=True), "float32")


def _empty_row_partials():
    """Split partials (split 8) of three decode rows, the first with no
    valid key (empty prefix, empty tail)."""
    draws = _split_case(8, 0, 0.0)
    draws[4] = np.array([0, 7, 9])
    draws[7][0] = -1
    draws[8] = np.array([0, 7 + 2, 9 + 3])
    draws[7][1, :3] = 7 + np.arange(3)
    draws[7][2, :] = -1
    draws[7][2, :4] = 9 + np.arange(4)
    pairs = [_pair(a, "float32") for a in draws]
    return pairs, pa.paged_decode_split_partials(*[p[1] for p in pairs], split=8)


def test_paged_decode_split_plain_empty_row_gives_mean():
    """A row with no valid key: each of its splits weights every key
    equally (m = 0, l = the split's key count, 28 = P * page + T keys in
    all), so the merge gives the reference's plain mean of every value row,
    as the kernel does; the other rows match the reference too (f32,
    1e-5)."""
    pairs, (m, l, acc) = _empty_row_partials()
    # the gathered window by gathered index (20 table keys, then 8 tail
    # slots) in four position splits; the split for off-position tail slots
    # stays empty
    assert bool((m[0, :, :4] == 0).all()) and bool(torch.isinf(m[0, :, 4:]).all())
    assert bool((l[0].sum(dim=1) == 5 * 4 + 8).all())
    assert [float(x) for x in l[0, 0, :, 0]] == [8.0, 8.0, 8.0, 4.0, 0.0]
    got = pa.merge_split_partials(m, l, acc)
    want = ref.paged_decode_attention_ref(*[p[0] for p in pairs])
    _close(got, want, "float32")


def test_paged_decode_split_plain_empty_row_gives_zeros():
    """The merge of a row whose splits are all empty (m = -inf, l = 0)
    gives zeros, whatever the accumulators hold: empty splits add
    nothing."""
    _, (m, l, acc) = _empty_row_partials()
    empty = pa.merge_split_partials(torch.full_like(m, -np.inf), torch.zeros_like(l), acc)
    assert torch.equal(empty, torch.zeros_like(empty))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,H,KV,Sq,Sk,D,causal,window,softcap", FLASH_CASES)
def test_flash_attention_tiled_model_matches_jax(dtype, B, H, KV, Sq, Sk, D, causal, window, softcap):
    """An online softmax over 16-key tiles with the weights rounded to bf16
    before PV (the tensor-core kernels' arithmetic before they split P
    into two bf16 terms) against the
    reference at the bf16 tolerance (2e-2: the rounded weights are within
    2^-9 of the reference's f32 ones); with f32 weights it holds 1e-5 in
    float32."""
    pairs = _flash_draws(B, H, KV, Sq, Sk, D, dtype)
    kw = dict(causal=causal, window=window, softcap=softcap)
    want = ref.flash_attention_ref(*[p[0] for p in pairs], **kw)
    targs = [p[1] for p in pairs]
    got = fa.flash_attention_tiled_ref(*targs, **kw, block_k=16, p_dtype=torch.bfloat16)
    _close(got, want, "bfloat16")
    if dtype == "float32":
        exact = fa.flash_attention_tiled_ref(*targs, **kw, block_k=16, p_dtype=torch.float32)
        _close(exact, want, "float32")


def _prefill_split_case(G, C, split, seed=21):
    """Chunked-prefill draws with prefixes at, one before and one past a
    split boundary (split keys = ``split``), an empty prefix and a prefix
    that fills all but one key of the table (page 4, P = 5)."""
    rng = np.random.default_rng(seed)
    B, KV, D, page, P, N = 5, 2, 16, 4, 5, 32
    return [
        rng.normal(size=(B, KV, G, C, D)),
        rng.normal(size=(KV, N, page, D)),
        rng.normal(size=(KV, N, page, D)),
        rng.permutation(N)[: B * P].reshape(B, P),
        np.array([split, split - 1, split + 1, 0, P * page - 1]),
        rng.normal(size=(B, KV, C, D)),
        rng.normal(size=(B, KV, C, D)),
    ]


@pytest.mark.parametrize("split_pages", [1, 2, 4])
@pytest.mark.parametrize("window,softcap", [(0, 0.0), (6, 0.0), (0, 20.0), (11, 30.0)])
def test_paged_prefill_split_plain_matches_jax(split_pages, window, softcap):
    """The bf16 prefill kernel's split arithmetic (per-split partials with
    the chunk as the last split, ordered merge) against the reference and
    the Pallas kernel in interpret mode (f32, 1e-5).  Page 4, so splits of
    4, 8 and 16 keys; the 6-key window empties the early splits of the
    19-key prefix for every chunk row."""
    split = 4 * split_pages
    pairs = [_pair(a, "float32") for a in _prefill_split_case(2, 8, split)]
    jargs, targs = [p[0] for p in pairs], [p[1] for p in pairs]
    kw = dict(softcap=softcap, window=window)
    m, l, acc = pa.paged_prefill_split_partials(*targs, **kw, split=split)
    n_pos = -(-(20 + 8) // split)  # position splits over the table's 20 keys and the chunk
    assert m.shape == (5, 2, n_pos + -(-8 // split), 2, 8) and acc.shape == m.shape + (16,)
    assert bool(torch.isinf(m[3, :, -(-8 // split):]).all())  # the empty prefix: no key past the chunk
    if window:  # splits that end before the first chunk row's window
        first = 19 - window + 1
        assert bool(torch.isinf(m[4, :, : first // split]).all())
    got = pa.merge_split_partials(m, l, acc)
    want_ref = ref.paged_prefill_attention_ref(*jargs, **kw)
    want_pallas = ops.paged_prefill_attention(*jargs, **kw, interpret=True)
    d = max(float(np.abs(got.numpy() - np.asarray(w)).max()) for w in (want_ref, want_pallas))
    print(f"split {split} window {window} softcap {softcap}: max|d| {d:.3e} (limit 1e-5)")
    _close(got, want_ref, "float32")
    _close(got, want_pallas, "float32")
    _close(pa.paged_prefill_attention_split_ref(*targs, **kw, split=split), got, "float32")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("G,C", [(1, 16), (2, 8), (2, 32), (4, 32)])
def test_paged_prefill_tiled_model_matches_jax(dtype, G, C):
    """G * C below, at and above the kernel's 64-row tile.  The split
    arithmetic (8-key splits, a 6-key window, softcap 20) holds the
    reference and the Pallas kernel in interpret mode at the dtype's
    tolerance (1e-5 in f32, 2e-2 in bf16); a model with 4-key tiles in
    each split and the weights rounded to bf16 before PV (coarser than the
    kernels' two bf16 terms) holds them at 2e-2 (the rounded weights are
    within 2^-9 of the reference's f32 ones)."""
    pairs = [_pair(a, dtype) for a in _prefill_split_case(G, C, 8)]
    jargs, targs = [p[0] for p in pairs], [p[1] for p in pairs]
    kw = dict(softcap=20.0, window=6)
    want_ref = ref.paged_prefill_attention_ref(*jargs, **kw)
    want_pallas = ops.paged_prefill_attention(*jargs, **kw, interpret=True)
    exact = pa.paged_prefill_attention_split_ref(*targs, **kw, split=8)
    model = pa.paged_prefill_attention_split_ref(*targs, **kw, split=8, block_k=4,
                                                 p_dtype=torch.bfloat16)
    for name, got, tol in (("split", exact, dtype), ("bf16-P model", model, "bfloat16")):
        d = float(np.abs(got.float().numpy() - np.asarray(want_ref, np.float32)).max())
        print(f"{name} G={G} C={C} {dtype}: max|d| {d:.3e} (limit {TOLS[tol]['atol']})")
        _close(got, want_ref, tol)
        _close(got, want_pallas, tol)


@pytest.mark.parametrize(
    "header,users",
    [
        ("common.cuh", {"paged_attention", "paged_decode", "flash_attention", "gemm"}),
        ("tensor_core.cuh", {"paged_attention", "paged_decode", "flash_attention", "wgmma_probe"}),
        ("split_merge.cuh", {"paged_attention", "paged_decode", "flash_attention"}),
        ("attention_split.cuh", {"paged_attention", "paged_decode", "flash_attention"}),
        ("hopper.cuh", {"flash_attention", "gemm", "wgmma_probe"}),
    ],
)
def test_library_digest_covers_shared_headers(tmp_path, monkeypatch, header, users):
    """A library's name changes when a ``csrc/`` header it includes
    (directly or through another header) changes, and only then: an edited
    header never loads a stale library.  Checked on a copy of ``csrc/``."""
    import shutil

    from repro_torch.kernels import build

    csrc = tmp_path / "csrc"
    shutil.copytree(build.CSRC, csrc)
    monkeypatch.setattr(build, "CSRC", csrc)
    before = {n: build.library_path(n) for n in build.SOURCES}
    (csrc / header).write_text((csrc / header).read_text() + "\n// edited\n")
    after = {n: build.library_path(n) for n in build.SOURCES}
    assert {n for n in build.SOURCES if before[n] != after[n]} == users


# Head dims past 128 (stablelm-12b's 160 and the catalogue's widest, 256),
# 16 query heads per kv head, and a bf16 head dim that is a multiple of 8
# but not of 16: the shapes the kernels' padded widths 160/256, head groups
# of 8 and zero-padded 16-column k-steps take on the card.
WIDE_CASES = [(160, 4), (256, 2), (16, 16), (24, 2)]
WIDE_IDS = ["D160-G4", "D256-G2", "D16-G16", "D24-G2"]
# Head dims that are not a multiple of the 16-byte vector width in one
# dtype or both (bf16 D % 8, f32 D % 4): on the card the wrappers zero-pad
# them on the head axis and pass the unpadded scale; the plain versions and
# the kernels' models compute them directly, as the reference does.
WIDE_CASES += [(20, 2), (100, 5), (18, 2)]
WIDE_IDS += ["D20-G2", "D100-G5", "D18-G2"]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("D,G", WIDE_CASES, ids=WIDE_IDS)
def test_paged_decode_plain_wide_heads_match_jax(dtype, D, G):
    """The plain version and the split kernel's model against the reference
    (1e-5 in f32, 2e-2 in bf16), with a 20-key window."""
    rng = np.random.default_rng(31)
    B, KV, page, P, N, T = 3, 2, 4, 6, 24, 5
    prefix_len = np.array([0, 13, 24])
    t_used = np.array([2, 5, 1])
    tail_pos = np.full((B, T), -1, np.int32)
    for b in range(B):
        tail_pos[b, : t_used[b]] = prefix_len[b] + np.arange(t_used[b])
    draws = [
        rng.normal(size=(B, KV, G, D)), rng.normal(size=(KV, N, page, D)),
        rng.normal(size=(KV, N, page, D)), rng.permutation(N)[: B * P].reshape(B, P), prefix_len,
        rng.normal(size=(B, KV, T, D)), rng.normal(size=(B, KV, T, D)), tail_pos,
        prefix_len + t_used - 1,
    ]
    pairs = [_pair(a, dtype) for a in draws]
    jargs, targs = [p[0] for p in pairs], [p[1] for p in pairs]
    want = ref.paged_decode_attention_ref(*jargs, window=20)
    _close(pa.paged_decode_attention(*targs, window=20), want, dtype)
    _close(pa.paged_decode_attention_split_ref(*targs, window=20, split=8), want, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("D,G", WIDE_CASES, ids=WIDE_IDS)
def test_paged_prefill_plain_wide_heads_match_jax(dtype, D, G):
    """The plain version, the split arithmetic and a model with the
    weights rounded to bf16 before PV (2e-2) against the reference."""
    rng = np.random.default_rng(32)
    B, KV, page, P, N, C = 3, 2, 4, 5, 16, 8
    draws = [
        rng.normal(size=(B, KV, G, C, D)), rng.normal(size=(KV, N, page, D)),
        rng.normal(size=(KV, N, page, D)), rng.permutation(N)[: B * P].reshape(B, P),
        np.array([0, 7, 12]), rng.normal(size=(B, KV, C, D)), rng.normal(size=(B, KV, C, D)),
    ]
    pairs = [_pair(a, dtype) for a in draws]
    jargs, targs = [p[0] for p in pairs], [p[1] for p in pairs]
    kw = dict(softcap=20.0, window=10)
    want = ref.paged_prefill_attention_ref(*jargs, **kw)
    _close(pa.paged_prefill_attention(*targs, **kw), want, dtype)
    _close(pa.paged_prefill_attention_split_ref(*targs, **kw, split=8), want, dtype)
    model = pa.paged_prefill_attention_split_ref(*targs, **kw, split=8, block_k=4, p_dtype=torch.bfloat16)
    _close(model, want, "bfloat16")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("D,G", WIDE_CASES, ids=WIDE_IDS)
def test_paged_attention_plain_wide_heads_match_jax(dtype, D, G):
    """K4's plain version and its split model (T = 0), a zero length
    included, against the reference."""
    rng = np.random.default_rng(33)
    B, KV, page, P, N = 3, 2, 4, 4, 16
    draws = [
        rng.normal(size=(B, KV, G, D)), rng.normal(size=(KV, N, page, D)),
        rng.normal(size=(KV, N, page, D)), rng.integers(0, N, (B, P)), np.array([0, 9, 16]),
    ]
    pairs = [_pair(a, dtype) for a in draws]
    jargs, targs = [p[0] for p in pairs], [p[1] for p in pairs]
    want = ref.paged_attention_ref(*jargs, softcap=20.0)
    _close(pa.paged_attention(*targs, softcap=20.0), want, dtype)
    _close(pa.paged_attention_split_ref(*targs, softcap=20.0, split=8), want, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("D,G", WIDE_CASES, ids=WIDE_IDS)
def test_flash_attention_plain_wide_heads_match_jax(dtype, D, G):
    """K5's plain version and the tiled model with weights rounded to bf16
    before PV (2e-2) against the reference, causal
    with a 24-key window over a ragged 40-key tile edge."""
    B, KV, S = 1, 2, 40
    pairs = _flash_draws(B, KV * G, KV, S, S, D, dtype)
    kw = dict(causal=True, window=24)
    want = ref.flash_attention_ref(*[p[0] for p in pairs], **kw)
    targs = [p[1] for p in pairs]
    _close(fa.flash_attention(*targs, **kw), want, dtype)
    _close(fa.flash_attention_tiled_ref(*targs, **kw, block_k=16, p_dtype=torch.bfloat16), want,
           "bfloat16")


# Head dims past 256: the card runs them on SIMT routes (K1/K4's wide split
# kernel feeding the same merge, K2's and K5's 512-column instantiations);
# their plain versions here against the reference's oracles and the Pallas
# kernels in interpret mode, at small B and S (1e-5 in f32, 2e-2 in bf16),
# K1's split arithmetic too.
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("D", [320, 512])
@pytest.mark.parametrize("kernel", ["K1", "K2", "K4", "K5"])
def test_plain_past_head_dim_256_matches_jax(kernel, dtype, D):
    rng = np.random.default_rng(D)
    B, KV, G, page, P, N, T, C = 2, 2, 2, 4, 4, 16, 3, 8
    if kernel == "K5":
        pairs = _flash_draws(1, KV * G, KV, 32, 32, D, dtype)
        kw = dict(causal=True, window=24, softcap=20.0)
        got = fa.flash_attention(*[p[1] for p in pairs], **kw)
        _close(got, ref.flash_attention_ref(*[p[0] for p in pairs], **kw), dtype)
        want = ops.flash_attention(*[p[0] for p in pairs], **kw, block_q=16, block_k=16,
                                   interpret=True)
        _close(got, want, dtype)
        return
    bt = rng.permutation(N)[: B * P].reshape(B, P)
    pages = [rng.normal(size=(KV, N, page, D)) for _ in range(2)]
    if kernel == "K1":
        plen, t_used = np.array([5, 13]), np.array([2, 3])
        tail_pos = np.full((B, T), -1, np.int32)
        for b in range(B):
            tail_pos[b, : t_used[b]] = plen[b] + np.arange(t_used[b])
        draws = [rng.normal(size=(B, KV, G, D)), *pages, bt, plen, rng.normal(size=(B, KV, T, D)),
                 rng.normal(size=(B, KV, T, D)), tail_pos, plen + t_used - 1]
        kw, plain, oracle, pallas = (dict(window=8, softcap=20.0), pa.paged_decode_attention,
                                     ref.paged_decode_attention_ref, ops.paged_decode_attention)
    elif kernel == "K4":
        draws = [rng.normal(size=(B, KV, G, D)), *pages, bt, np.array([3, 11])]
        kw, plain, oracle, pallas = (dict(softcap=20.0), pa.paged_attention,
                                     ref.paged_attention_ref, ops.paged_attention)
    else:
        draws = [rng.normal(size=(B, KV, G, C, D)), *pages, bt, np.array([0, 6]),
                 rng.normal(size=(B, KV, C, D)), rng.normal(size=(B, KV, C, D))]
        kw, plain, oracle, pallas = (dict(window=10, softcap=20.0), pa.paged_prefill_attention,
                                     ref.paged_prefill_attention_ref, ops.paged_prefill_attention)
    pairs = [_pair(a, dtype) for a in draws]
    jargs, targs = [p[0] for p in pairs], [p[1] for p in pairs]
    got = plain(*targs, **kw)
    _close(got, oracle(*jargs, **kw), dtype)
    _close(got, pallas(*jargs, **kw, interpret=True), dtype)
    if kernel == "K1":
        _close(pa.paged_decode_attention_split_ref(*targs, **kw, split=8), oracle(*jargs, **kw),
               dtype)


def test_flash_attention_empty_row_values():
    """K5's only row with no valid key: Sq > Sk under a causal window (rows
    5-7 here; the model never builds one).  The reference spreads uniform
    weights over the Sk keys (the mean of V), and the port's plain version
    reproduces it (f32, 1e-5).  The Pallas kernel in interpret mode counts
    the zero-padded keys of its last key block too, so its value depends on
    the block size: half the mean at block_k 8 (4 real keys of 8), the mean
    at block_k 4.  The tensor-core kernel (its tiled model here) gives the
    reference's mean too, from the branch that only rows whose sum l is
    still 0 take (f32, 1e-5); tests/test_torch_gpu.py holds both kernels to
    the plain version on the card."""
    pairs = _flash_draws(1, 1, 1, 8, 4, 16, "float32")
    kw = dict(causal=True, window=2)
    jargs, targs = [p[0] for p in pairs], [p[1] for p in pairs]
    mean = np.asarray(jargs[2])[0, 0].mean(axis=0)
    want = np.asarray(ref.flash_attention_ref(*jargs, **kw))
    np.testing.assert_allclose(want[0, 0, 5:], np.broadcast_to(mean, (3, 16)), rtol=1e-5, atol=1e-5)
    _close(fa.flash_attention(*targs, **kw)[:, :, 5:], want[:, :, 5:], "float32")
    for block_k, share in ((8, 0.5), (4, 1.0)):
        got = np.asarray(ops.flash_attention(*jargs, **kw, block_q=8, block_k=block_k, interpret=True))
        np.testing.assert_allclose(got[0, 0, 5:], np.broadcast_to(share * mean, (3, 16)), rtol=1e-5, atol=1e-5)
    tiled = fa.flash_attention_tiled_ref(*targs, **kw, p_dtype=torch.float32)
    _close(tiled, want, "float32")


OFFSET_MODES = {
    "causal": dict(causal=True),
    "causal_window": dict(causal=True, window=12),
    "causal_softcap": dict(causal=True, softcap=20.0),
}


@pytest.mark.parametrize("mode", sorted(OFFSET_MODES))
@pytest.mark.parametrize("offset", [0, 1, 20, 39])
def test_flash_attention_query_offset(mode, offset):
    """K5's ``q_offset``: query row i at position ``offset + i`` over keys
    at ``arange(Sk)``, the body of a sequence-sharded prefill's rank whose
    slice starts at ``offset``.  A slice of up to 8 rows (Sq != Sk = 40)
    equals the same rows of the full call bitwise in float32; it matches
    the reference's ``attention_prefill`` over the slice's positions
    (float32, 1e-5), and the tiled model of the tensor-core kernel's
    arithmetic (weights kept in f32 here) matches the plain version
    (1e-5)."""
    from repro.models.layers import attention_prefill

    S, n = 40, 8
    kw = OFFSET_MODES[mode]
    pairs = _flash_draws(2, 4, 2, S, S, 16, "float32")
    jargs, targs = [p[0] for p in pairs], [p[1] for p in pairs]
    full = fa.flash_attention_ref(*targs, **kw)
    q_slice = targs[0][:, :, offset : offset + n]
    got = fa.flash_attention(q_slice, *targs[1:], **kw, q_offset=offset)
    assert got.shape == q_slice.shape
    assert torch.equal(got, full[:, :, offset : offset + n])
    rows = got.shape[2]
    want = attention_prefill(
        jnp.swapaxes(jargs[0][:, :, offset : offset + rows], 1, 2),
        jnp.swapaxes(jargs[1], 1, 2), jnp.swapaxes(jargs[2], 1, 2),
        q_positions=jnp.broadcast_to(offset + jnp.arange(rows), (2, rows)),
        kv_positions=jnp.broadcast_to(jnp.arange(S), (2, S)), **kw,
    )
    _close(got, jnp.swapaxes(want, 1, 2), "float32")
    tiled = fa.flash_attention_tiled_ref(q_slice, *targs[1:], **kw, q_offset=offset,
                                         block_k=16, p_dtype=torch.float32)
    _close(tiled, np.asarray(got), "float32")

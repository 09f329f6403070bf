"""One key order for every attention route, and a row-invariant GEMM: the
plain models on the CPU.

The card's kernels cut a query row's keys into splits of 64 by absolute
position wherever the keys are stored, compute each split's partial with
one body and fold the partials in ascending order, so a decode step (K1),
a prefill chunk starting anywhere (K2) and a flash prefill (K5) give the
same query over the same keys the same bits.  Their plain split models
(``paged_attention.split_partials`` and the three front ends) keep that
property on the CPU: here they give K1, K2 and K5 bitwise equal rows for
chunk starts 0, 4, 32 and 100, with and without a window and a soft-cap,
at G = 1, 2 and 6 (``tests/torch_route_scenes.py`` lays one sequence out
three ways).  With f32 weights (the reference keeps P in f32) they match
the JAX Pallas kernels in interpret mode and ``repro.kernels.ref`` within
1e-5 in float32; in bfloat16 within 2e-2, the max |d| printed beside
the 7.8e-3 the bf16-P model showed before.  Head dim 640 runs through the
plain versions against the reference's oracles.  The GEMM wrapper's plain
version is ``x @ w`` bitwise, and within the layer tests' bf16 tolerance of
JAX's ``x @ w``; ``layers.proj`` sends no-grad bf16 operands to it.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops, ref
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import gemm
from repro_torch.kernels import paged_attention as pa
from repro_torch.models import layers
from torch_route_scenes import off_position, rows, scene

TOLS = {"float32": dict(rtol=1e-5, atol=1e-5), "bfloat16": dict(rtol=2e-2, atol=2e-2)}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}

MODES = {"plain": dict(), "window_softcap": dict(window=20, softcap=30.0)}


def _j(t):
    """A torch CPU tensor as a JAX array of the same dtype."""
    if t.dtype == torch.int32:
        return jnp.asarray(t.numpy())
    return jnp.asarray(t.float().numpy(), jnp.bfloat16 if t.dtype == torch.bfloat16 else jnp.float32)


def _close(got, want, dtype):
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32), **TOLS[dtype])


def _routes(sc, **kw):
    """The chunk's rows as K5, K2 and K1's plain split models give them."""
    flash = fa.flash_attention_split_ref(*sc["flash"]["args"], causal=True, **kw)
    chunk = pa.paged_prefill_attention_split_ref(*sc["chunk"]["args"], **kw)
    decode = pa.paged_decode_attention_split_ref(*sc["decode"]["args"], **kw)
    return rows(sc, flash, chunk, decode)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("mode", sorted(MODES))
@pytest.mark.parametrize("G", [1, 2, 6])
@pytest.mark.parametrize("start", [0, 4, 32, 100])
def test_plain_split_models_give_every_route_the_same_bits(start, G, mode, dtype):
    """K1, K2 and K5's plain split models: bitwise equal rows for the same
    query over the same keys, whatever the chunk start (the 8-row chunk at
    100 spans the splits [64, 128); at 32 it sits inside split 0)."""
    sc = scene(start + 8, start, 8, G, 16, seed=start + G, dtype=TDT[dtype])
    f, c, d = _routes(sc, **MODES[mode])
    assert torch.equal(c, f) and torch.equal(d, f)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("mode", sorted(MODES))
def test_plain_split_models_match_jax(dtype, mode):
    """The three plain split models with f32 weights against the Pallas
    kernels in interpret mode and ``repro.kernels.ref``: 1e-5 in float32,
    2e-2 in bfloat16 (max |d| printed)."""
    kw = MODES[mode]
    sc = scene(40, 24, 16, 2, 16, seed=3, dtype=TDT[dtype])
    fargs = [_j(a) for a in sc["flash"]["args"]]
    cargs = [_j(a) for a in sc["chunk"]["args"]]
    dargs = [_j(a) for a in sc["decode"]["args"]]
    cases = [
        (fa.flash_attention_split_ref(*sc["flash"]["args"], causal=True, **kw),
         ref.flash_attention_ref(*fargs, causal=True, **kw),
         ops.flash_attention(*fargs, causal=True, **kw, block_q=8, block_k=8, interpret=True)),
        (pa.paged_prefill_attention_split_ref(*sc["chunk"]["args"], **kw),
         ref.paged_prefill_attention_ref(*cargs, **kw),
         ops.paged_prefill_attention(*cargs, **kw, interpret=True)),
        (pa.paged_decode_attention_split_ref(*sc["decode"]["args"], **kw),
         ref.paged_decode_attention_ref(*dargs, **kw),
         ops.paged_decode_attention(*dargs, **kw, interpret=True)),
    ]
    for name, (got, want_ref, want_pallas) in zip(("K5", "K2", "K1"), cases):
        d = max(float(np.abs(got.float().numpy() - np.asarray(w, np.float32)).max())
                for w in (want_ref, want_pallas))
        print(f"{name} {mode} {dtype}: max|d| {d:.3e} (limit {TOLS[dtype]['atol']}; "
              "the bf16-P model read 7.8e-3)")
        _close(got, want_ref, dtype)
        _close(got, want_pallas, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kernel", ["K1", "K2", "K4", "K5"])
def test_plain_head_dim_640_matches_jax(kernel, dtype):
    """Head dim 640 (past the 512 the kernels once stopped at) through the
    plain versions and, for K1, K2 and K5, their split models, against the
    reference's oracles (1e-5 in f32, 2e-2 in bf16)."""
    D, G = 640, 2
    sc = scene(24, 16, 8, G, D, seed=7, dtype=TDT[dtype])
    if kernel == "K5":
        args, kw = sc["flash"]["args"], dict(causal=True, window=12, softcap=20.0)
        want = ref.flash_attention_ref(*[_j(a) for a in args], **kw)
        _close(fa.flash_attention(*args, **kw), want, dtype)
        _close(fa.flash_attention_split_ref(*args, **kw), want, dtype)
        return
    if kernel == "K4":
        a = sc["decode"]["args"]
        args = [a[0], a[1], a[2], a[3], a[4]]
        want = ref.paged_attention_ref(*[_j(x) for x in args], softcap=20.0)
        _close(pa.paged_attention(*args, softcap=20.0), want, dtype)
        _close(pa.paged_attention_split_ref(*args, softcap=20.0), want, dtype)
        return
    key = "chunk" if kernel == "K2" else "decode"
    plain = pa.paged_prefill_attention if kernel == "K2" else pa.paged_decode_attention
    split = (pa.paged_prefill_attention_split_ref if kernel == "K2"
             else pa.paged_decode_attention_split_ref)
    oracle = ref.paged_prefill_attention_ref if kernel == "K2" else ref.paged_decode_attention_ref
    args, kw = sc[key]["args"], dict(window=12, softcap=20.0)
    want = oracle(*[_j(a) for a in args], **kw)
    _close(plain(*args, **kw), want, dtype)
    _close(split(*args, **kw), want, dtype)


def test_plain_split_model_rows_do_not_depend_on_the_batch():
    """A decode row's plain split model in a batch of 8 equals the same row
    alone, bitwise: the model's rows are independent of one another."""
    sc = scene(70, 62, 8, 2, 16, seed=11)
    a = sc["decode"]["args"]
    full = pa.paged_decode_attention_split_ref(*a, window=20, softcap=30.0)
    for b in (0, 3, 7):
        one = [x[b : b + 1] if i not in (1, 2) else x for i, x in enumerate(a)]
        assert torch.equal(pa.paged_decode_attention_split_ref(*one, window=20, softcap=30.0),
                           full[b : b + 1])


@pytest.mark.parametrize("shape", [(1, 64, 48), (3, 5, 64, 24), (32, 40, 16)])
def test_gemm_plain_is_matmul_bitwise(shape):
    """The GEMM wrapper's plain version is ``x @ w``, bitwise, and the
    transposed-table layout (qwen3's tied head, ``embed.T``) too."""
    rng = np.random.default_rng(len(shape))
    K, N = shape[-2], shape[-1]
    x = torch.from_numpy(rng.normal(size=(*shape[:-2], K)).astype(np.float32)).bfloat16()
    w = torch.from_numpy(rng.normal(size=(K, N)).astype(np.float32)).bfloat16()
    assert torch.equal(gemm.gemm(x, w), x @ w)
    table = w.T.contiguous()  # [N, K]
    assert torch.equal(gemm.gemm(x, table.T), x @ table.T)
    assert torch.equal(layers.proj(x, w), x @ w)


def test_gemm_plain_matches_jax():
    """The plain GEMM against JAX's ``x @ w`` on the same bf16 draws, at the
    layer tests' bf16 tolerance (2e-2)."""
    rng = np.random.default_rng(5)
    x = rng.normal(size=(4, 7, 96)).astype(np.float32)
    w = (rng.normal(size=(96, 40)) / np.sqrt(96)).astype(np.float32)
    got = gemm.gemm(torch.from_numpy(x).bfloat16(), torch.from_numpy(w).bfloat16())
    want = jnp.asarray(x, jnp.bfloat16) @ jnp.asarray(w, jnp.bfloat16)
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32), **TOLS["bfloat16"])


def test_proj_keeps_matmul_for_training_and_other_dtypes():
    """``layers.proj`` sends only no-grad bf16 operands to the GEMM: an
    operand that requires grad (training) and float32 operands take
    ``x @ w`` (the GEMM wrapper would refuse the first), with grads."""
    x = torch.randn(3, 8)
    w = torch.randn(8, 4, requires_grad=True)
    out = layers.proj(x.bfloat16(), w.bfloat16())
    out.float().sum().backward()
    assert w.grad is not None
    with pytest.raises(RuntimeError, match="no backward"):
        gemm.gemm(x.bfloat16(), w.bfloat16())
    assert torch.equal(layers.proj(x, w.detach()), x @ w.detach())
    with torch.no_grad():
        assert torch.equal(layers.proj(x.bfloat16(), w.bfloat16()), x.bfloat16() @ w.bfloat16())



@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kernel", ["K1", "K2"])
def test_plain_split_models_take_off_position_keys(kernel, dtype):
    """Keys the position splits cannot hold go to the extra splits by slot
    index (``tests/torch_route_scenes.py``'s ``off_position``): decode tail
    slots off ``prefix_len + t`` (a gap, a slot below the prefix, an empty
    slot) and a prefix_len past the table (K1), a chunk after a prefix_len
    past the table (K2).  The split models match the reference's oracles
    (1e-5 in f32, 2e-2 in bf16) and the Pallas kernels in interpret mode."""
    targs, kw = off_position(kernel, TDT[dtype])
    jargs = [_j(t) for t in targs]
    if kernel == "K1":
        split, oracle, pallas = (pa.paged_decode_attention_split_ref,
                                 ref.paged_decode_attention_ref, ops.paged_decode_attention)
    else:
        split, oracle, pallas = (pa.paged_prefill_attention_split_ref,
                                 ref.paged_prefill_attention_ref, ops.paged_prefill_attention)
    got = split(*targs, **kw)
    _close(got, oracle(*jargs, **kw), dtype)
    _close(got, pallas(*jargs, **kw, interpret=True), dtype)

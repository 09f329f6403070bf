"""The port's recurrent families against the JAX package, on the CPU.

hymba-1.5b (windowed attention beside a selective SSM) and xlstm-350m
(mLSTM + sLSTM blocks) at ``reduced()``: the same numpy-seeded inputs and
the JAX package's own parameters (bridged by ``params_from_jax``) go to
both sides.  Tolerances: float32 within 1e-5 (measured max |d| of the
logits 6.3e-7 on hymba, 2.2e-7 on xLSTM; 3.8e-6 on any f32 state leaf);
bfloat16 logits within 3e-2, the JAX package's own cross-graph logits
tolerance (measured 7.5e-3 and 3.5e-3).  The bf16 leaves of a float32
run's state (hymba's ring k/v) are rounded from f32 values that differ in
the last bits, so they hold one bf16 rounding step (2**-8 relative;
measured 9.8e-4 absolute at values below 4).  A bfloat16 run's state is
compared leaf by leaf in relative norm within 3e-2 (measured at most
1.1e-2): elementwise, the recurrence carries bf16 rounding of activations
that differ between the frameworks.  Packed snapshot payloads are compared
byte for byte.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config, reduced
from repro.models import layers as jlayers
from repro.models import ssm as jssm
from repro.models import xlstm as jxlstm
from repro.models.registry import build_model as jax_build_model
from repro.serving import snapshot_engine as jsnap
from repro_torch.configs import get_config as t_get_config
from repro_torch.configs import reduced as t_reduced
from repro_torch.models import hymba as thymba
from repro_torch.models import layers as tlayers
from repro_torch.models import ssm as tssm
from repro_torch.models import xlstm as txlstm
from repro_torch.models.registry import build_model
from repro_torch.params import params_from_jax
from repro_torch.serving import snapshot_engine as tsnap

ARCHS = ["hymba-1.5b", "xlstm-350m"]
LOGIT_TOL = {"float32": 1e-5, "bfloat16": 3e-2}
TOKENS = np.random.default_rng(0).integers(0, 64, (2, 22))


def _np(t):
    return t.float().numpy() if isinstance(t, torch.Tensor) else np.asarray(t, np.float32)


def _cast(tree, dtype):
    return tree if dtype == "bfloat16" else jax.tree.map(lambda a: a.astype(jnp.float32), tree)


def _bridge(tree):
    return params_from_jax(jax.tree.map(np.asarray, tree), "cpu")


@pytest.fixture(scope="module", params=ARCHS)
def model(request):
    """(name, jax bundle, jax params (bf16), port bundle)."""
    jb = jax_build_model(reduced(get_config(request.param)))
    jp = jb.init_params(jax.random.PRNGKey(0))
    return request.param, jb, jp, build_model(t_reduced(t_get_config(request.param)), device="cpu")


def _state_close(jstate, tstate, dtype):
    """Same leaves (the JAX order), shapes and dtypes; values within the
    module docstring's tolerances."""
    jleaves = jax.tree.leaves(jstate)
    tleaves = list(tsnap._flatten(tstate))
    assert len(jleaves) == len(tleaves)
    for a, (path, b) in zip(jleaves, tleaves):
        assert tuple(b.shape) == a.shape and str(b.dtype).removeprefix("torch.") == a.dtype.name, path
        leaf_tol = 2**-8 if a.dtype.name == "bfloat16" else 1e-5
        a, b = _np(a), _np(b)
        if dtype == "bfloat16":
            assert np.linalg.norm(a - b) <= 3e-2 * max(np.linalg.norm(a), 1e-30), path
        else:
            np.testing.assert_allclose(b, a, rtol=leaf_tol, atol=leaf_tol, err_msg=str(path))


# ------------------------------------------------------------------- layers


@pytest.mark.parametrize("S", [5, 128, 300])
def test_chunked_recurrent_scan_matches_lax_scan(S):
    """A decaying linear recurrence with an output per token (f32, 1e-5):
    carry and stacked outputs as ``lax.scan`` gives them, and the chunk
    length as ``pick_chunk`` picks it."""
    rng = np.random.default_rng(S)
    h0, a, b = rng.normal(size=(3, 4)), rng.uniform(0.5, 1.0, (S, 3, 4)), rng.normal(size=(S, 3, 4))

    def jstep(h, x):
        h = x[0] * h + x[1]
        return h, {"y": h.sum(-1), "h2": h * h}

    def tstep(h, x):
        h = x[0] * h + x[1]
        return h, {"y": h.sum(-1), "h2": h * h}

    f = lambda *arrs: [jnp.asarray(x, jnp.float32) for x in arrs]
    jh, jys = jlayers.chunked_recurrent_scan(jstep, *f(h0), tuple(f(a, b)), chunk=128)
    g = lambda *arrs: [torch.tensor(x, dtype=torch.float32) for x in arrs]
    th, tys = tlayers.chunked_recurrent_scan(tstep, *g(h0), tuple(g(a, b)), chunk=128)
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), rtol=1e-5, atol=1e-5)
    for k in ("y", "h2"):
        assert tys[k].shape == jys[k].shape
        np.testing.assert_allclose(tys[k].numpy(), np.asarray(jys[k]), rtol=1e-5, atol=1e-5)
    for n in (1, S, 2 * S + 1, 257, 300):
        assert tlayers.pick_chunk(n) == jlayers.pick_chunk(n)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("S", [1, 9])
def test_ssm_forward_matches_jax(dtype, S):
    """``ssm_forward`` over S tokens (S = 1 is ``ssm_decode``) from a
    random state: output and new (h, conv) state (f32 1e-5; bf16 3e-2)."""
    cfg = reduced(get_config("hymba-1.5b"))
    tcfg = t_reduced(t_get_config("hymba-1.5b"))
    jp = _cast(jssm.ssm_init(jax.random.PRNGKey(1), cfg), dtype)
    di, _, N, K = jssm._dims(cfg)
    rng = np.random.default_rng(2)
    wdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    x = rng.normal(size=(2, S, cfg.d_model))
    st = {"h": rng.normal(size=(2, di, N)), "conv": rng.normal(size=(2, K - 1, di))}
    jst = {"h": jnp.asarray(st["h"], jnp.float32), "conv": jnp.asarray(st["conv"], jnp.bfloat16)}
    fn = jssm.ssm_decode if S == 1 else jssm.ssm_forward
    jy, jnew = fn(jp, cfg, jnp.asarray(x, wdt), jst)
    tfn = tssm.ssm_decode if S == 1 else tssm.ssm_forward
    ty, tnew = tfn(_bridge(jp), tcfg, torch.tensor(x, dtype=torch.float32).to(
        torch.float32 if dtype == "float32" else torch.bfloat16), _bridge(jst))
    tol = LOGIT_TOL[dtype]
    np.testing.assert_allclose(_np(ty), _np(jy), rtol=tol, atol=tol)
    for k in ("h", "conv"):
        assert str(tnew[k].dtype).removeprefix("torch.") == jnew[k].dtype.name
        np.testing.assert_allclose(_np(tnew[k]), _np(jnew[k]), rtol=tol, atol=tol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("block", ["mlstm", "slstm"])
@pytest.mark.parametrize("S", [1, 9])
def test_xlstm_block_forward_matches_jax(dtype, block, S):
    """One mLSTM or sLSTM block over S tokens from its initial state (m at
    -1e30; S = 1 is ``mlstm_decode`` for the mLSTM block): output and state
    (f32 1e-5; bf16 3e-2)."""
    cfg = reduced(get_config("xlstm-350m"))
    tcfg = t_reduced(t_get_config("xlstm-350m"))
    init = getattr(jxlstm, f"{block}_init")
    jp = _cast(init(jax.random.PRNGKey(3), cfg), dtype)
    wdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    x = np.random.default_rng(4).normal(size=(2, S, cfg.d_model))
    fn = f"{block}_decode" if S == 1 and block == "mlstm" else f"{block}_forward"
    jst = getattr(jxlstm, f"{block}_state")(cfg, 2)
    jy, jnew = getattr(jxlstm, fn)(jp, cfg, jnp.asarray(x, wdt), jst)
    tst = getattr(txlstm, f"{block}_state")(tcfg, 2)
    tx = torch.tensor(x, dtype=torch.float32).to(torch.float32 if dtype == "float32" else torch.bfloat16)
    ty, tnew = getattr(txlstm, fn)(_bridge(jp), tcfg, tx, tst)
    tol = LOGIT_TOL[dtype]
    np.testing.assert_allclose(_np(ty), _np(jy), rtol=tol, atol=tol)
    for k in jnew:
        np.testing.assert_allclose(_np(tnew[k]), _np(jnew[k]), rtol=tol, atol=tol, err_msg=k)


# ------------------------------------------------------------------- models


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_prefill_logits_and_state_match_jax(model, dtype):
    """Full-model prefill of two 22-token rows (past hymba's 16-slot window,
    so the ring keeps the trailing 16 positions): last-position logits and
    the whole recurrent state."""
    _, jb, jp, tb = model
    p = _cast(jp, dtype)
    cache_len = tb.cfg.sliding_window or 1
    lj, sj = jax.jit(lambda p, b: jb.prefill_fn(p, b, cache_len))(
        p, {"tokens": jnp.asarray(TOKENS, jnp.int32)})
    lt, st = tb.prefill_fn(_bridge(p), {"tokens": torch.tensor(TOKENS, dtype=torch.int32)}, cache_len)
    tol = LOGIT_TOL[dtype]
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), rtol=tol, atol=tol)
    assert (lt.argmax(-1).numpy() == np.asarray(lj).argmax(-1)).all()
    _state_close(sj, st, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_steps_after_prefill_match_jax(model, dtype):
    """Four greedy decode steps after the prefill, both sides fed the JAX
    side's tokens: logits each step (f32 1e-5, bf16 3e-2), the same argmax,
    and the state after the last step."""
    _, jb, jp, tb = model
    p = _cast(jp, dtype)
    tp = _bridge(p)
    cache_len = tb.cfg.sliding_window or 1
    jpre = jax.jit(lambda p, b: jb.prefill_fn(p, b, cache_len))
    jdec = jax.jit(jb.decode_fn)
    lj, sj = jpre(p, {"tokens": jnp.asarray(TOKENS, jnp.int32)})
    lt, st = tb.prefill_fn(tp, {"tokens": torch.tensor(TOKENS, dtype=torch.int32)}, cache_len)
    tol = LOGIT_TOL[dtype]
    for i in range(4):
        tok = np.asarray(lj).argmax(-1).astype(np.int32)
        pos = np.full((2,), TOKENS.shape[1] + i, np.int32)
        lj, sj = jdec(p, sj, jnp.asarray(tok), jnp.asarray(pos))
        lt, st = tb.decode_fn(tp, st, torch.from_numpy(tok), torch.from_numpy(pos))
        np.testing.assert_allclose(lt.numpy(), np.asarray(lj), rtol=tol, atol=tol, err_msg=str(i))
        assert (lt.argmax(-1).numpy() == np.asarray(lj).argmax(-1)).all()
    _state_close(sj, st, dtype)


def test_pack_state_bytes_match_jax(model):
    """The port's ``_pack_state`` of the JAX package's float32 snapshot
    (state + logits, bridged) gives the JAX ``_pack_state`` bytes exactly:
    the same leaves in the same order with the same dtypes.  The port's own
    snapshot of the same prompt has the same spec and byte count, and
    ``_unpack_state`` gives the port's state back bitwise."""
    _, jb, jp, tb = model
    p = _cast(jp, "float32")
    cache_len = tb.cfg.sliding_window or 1
    lj, sj = jax.jit(lambda p, b: jb.prefill_fn(p, b, cache_len))(
        p, {"tokens": jnp.asarray(TOKENS[:1], jnp.int32)})
    jpayload, (_, jspec) = jsnap._pack_state({"state": sj, "logits": lj})
    tpayload, tspec = tsnap._pack_state(_bridge({"state": sj, "logits": lj}))
    assert tpayload.dtype == torch.uint8 and np.array_equal(tpayload.numpy(), jpayload)

    lt, st = tb.prefill_fn(_bridge(p), {"tokens": torch.tensor(TOKENS[:1], dtype=torch.int32)},
                           cache_len)
    own, own_spec = tsnap._pack_state({"state": st, "logits": lt})
    assert own.numel() == jpayload.size
    assert [(s, str(d).removeprefix("torch.")) for _, s, d in own_spec] == [
        (tuple(s), d.name) for s, d in jspec]
    back = tsnap._unpack_state(own, own_spec, "cpu")
    for (pa, a), (pb, b) in zip(tsnap._flatten({"state": st, "logits": lt}), tsnap._flatten(back)):
        assert pa == pb and a.dtype == b.dtype and torch.equal(a, b), pa


def test_state_batch_axes_match_jax(model):
    """Each state leaf's batch axis, inferred from B = 1 and B = 2 shapes
    (the port on the meta device), as the JAX package infers it."""
    _, jb, _, tb = model
    want = jax.tree.leaves(jsnap._state_batch_axes(jb))
    got = [a for _, a in tsnap._flatten(tsnap._state_batch_axes(tb))]
    assert got == want
    assert all(t.device.type == "meta" for _, t in tsnap._flatten(tb.make_cache(2, 8, device="meta")))


def test_params_tree_matches_jax(model):
    """``params_from_jax`` carries the vmapped trees (hymba's leading [L],
    xLSTM's [G, n]) bit for bit, and the port's own ``init_params`` builds
    the same tree, shapes and dtypes with init scales within 10%."""
    _, _, jp, tb = model
    want = {path: np.asarray(a) for path, a in tsnap._flatten(jax.tree.map(np.asarray, jp))}
    bridged = dict(tsnap._flatten(_bridge(jp)))
    own = dict(tsnap._flatten(tb.init_params(torch.Generator().manual_seed(0))))
    assert set(bridged) == set(own) == set(want)
    for path, a in want.items():
        b = bridged[path]
        assert tuple(b.shape) == a.shape and str(b.dtype).removeprefix("torch.") == a.dtype.name
        if a.dtype.name == "bfloat16":
            assert np.array_equal(b.view(torch.uint16).numpy(), a.view(np.uint16)), path
        else:
            assert np.array_equal(b.numpy(), a), path
        t = own[path]
        assert tuple(t.shape) == a.shape and t.dtype == b.dtype, path
        std_j, std_t = float(np.asarray(a, np.float32).std()), float(t.float().std())
        if std_j == 0.0:
            assert std_t == 0.0 and torch.equal(t.float(), torch.from_numpy(np.asarray(a, np.float32))), path
        else:
            assert abs(std_t / std_j - 1.0) < 0.1, (path, std_t, std_j)


def test_hymba_ring_after_long_prefill_matches_jax():
    """The ring after a prefill longer than the window (reduced: 16 slots,
    a 20-token prompt): positions 4..19 in slots 0..15, then decode writes
    position 20 at slot 20 % 16 = 4, dropping position 8 while it is still
    inside the window — the JAX package's layout, reproduced."""
    cfg = t_reduced(t_get_config("hymba-1.5b"))
    jb = jax_build_model(reduced(get_config("hymba-1.5b")))
    jp = jb.init_params(jax.random.PRNGKey(0))
    tp = _bridge(jp)
    toks = np.arange(20, 40, dtype=np.int32)[None]
    _, sj = jb.prefill_fn(jp, {"tokens": jnp.asarray(toks)}, 16)
    _, st = thymba.prefill(tp, cfg, {"tokens": torch.from_numpy(toks)}, 16)
    assert st["pos"][0].tolist() == list(range(4, 20)) == np.asarray(sj["pos"])[0].tolist()
    tok, pos = np.array([5], np.int32), np.array([20], np.int32)
    _, sj = jb.decode_fn(jp, sj, jnp.asarray(tok), jnp.asarray(pos))
    _, st = thymba.decode_step(tp, cfg, st, torch.from_numpy(tok), torch.from_numpy(pos))
    assert st["pos"][0].tolist() == np.asarray(sj["pos"])[0].tolist()
    assert st["pos"][0, 4] == 20 and 8 not in st["pos"][0].tolist()

"""The recurrences' f32 contractions (``repro_torch.kernels.contract``) on
the CPU, against the JAX package's einsums and steps.

The five sites, at reduced sizes: the mLSTM step's ``q . C`` and ``q . n``
(``src/repro/models/xlstm.py:77-78``), the sLSTM step's recurrent products
(``:191``), the SSM scan's ``h . C_t`` (``src/repro/models/ssm.py:119``)
and its f32 dt projection (``:72``).  The same numpy inputs from a seed go
to the JAX expression and to the port.

Tolerances: ``contract_ref`` (``torch.matmul``, the plain version) and the
port's steps against JAX within 1e-5 relative to the output's largest
magnitude (the two libraries sum in other orders; measured at most 3e-7);
the CPU route of every step is bitwise the expression it had before the
kernel (``torch.matmul`` at each site; the sLSTM's four products stay four
on the CPU, which one product over the stacked matrices would round
otherwise); ``ordered_contract`` (the kernel's order in torch ops, which
the card tests hold the kernel to bitwise) within gamma_K sum_k |x_k w_kj|
of ``contract_ref``, gamma_K = K 2^-24, the bound of a K-term f32 sum.
The kernel's addressing (``contract.geometry``: the strides the launch
reads, the copies it makes) is replayed on the CPU over each site's live
layouts and held bitwise to ``ordered_contract``, and the CUDA source's
tile enumeration, written out here, covers every row once with its own
matrix.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config, reduced
from repro.models import ssm as jssm
from repro.models import xlstm as jxlstm
from repro_torch.configs import get_config as t_get_config
from repro_torch.configs import reduced as t_reduced
from repro_torch.kernels import contract as ct
from repro_torch.models import layers as tlayers
from repro_torch.models import ssm as tssm
from repro_torch.models import xlstm as txlstm
from repro_torch.params import params_from_jax

B, NH, DH = 3, 4, 16  # reduced xlstm-350m: 4 heads of 16
DI, N, DTR, S = 128, 8, 4, 5  # reduced hymba-1.5b's SSM: d_inner, state, dt rank; tokens


def _site(name, rng):
    """(the JAX expression's output, the port's operands a, b) of one site
    on the same numpy inputs, the port's laid out as the model hands them
    (the output in torch.matmul's shape)."""
    f = lambda *s: rng.normal(size=s).astype(np.float32)
    t = torch.from_numpy
    if name in ("mlstm num", "mlstm den"):
        q_all, C = f(B, S, NH, DH), f(B, NH, DH, DH)
        q = q_all[:, 2]
        if name == "mlstm num":
            want = jnp.einsum("bhd,bhde->bhe", q, C)[:, :, None]
            b = t(C)
        else:
            n = f(B, NH, DH)
            want = jnp.einsum("bhd,bhd->bh", q, n)[..., None, None]
            b = t(n)[..., :, None]
        # q_t as the scan hands it: one token of [S, B, nh, dh]
        a = t(q_all).movedim(1, 0)[2][..., None, :]
        return want, a, b
    if name == "slstm rec":
        h, Rs = f(B, NH * DH), [f(NH, DH, DH) for _ in range(4)]
        hh = h.reshape(B, NH, DH)
        want = jnp.concatenate([jnp.einsum("bhd,hde->bhe", hh, R) for R in Rs], -1)[:, :, None]
        return want, t(h).reshape(B, NH, 1, DH), torch.cat([t(R) for R in Rs], dim=-1)
    if name == "ssm scan":
        h, coef = f(B, DI, N), f(B, S, DTR + 2 * N)
        C_t = coef[:, 3, DTR + N:]
        want = jnp.einsum("bdn,bn->bd", h, C_t)[..., None]
        Ct = t(coef)[..., DTR + N:].movedim(1, 0)[3]  # one token of the scan's [S, B, N]
        return want, t(h), Ct[:, :, None]
    if name == "ssm dt":
        coef, w = f(B, S, DTR + 2 * N), f(DTR, DI)
        want = jnp.asarray(coef[..., :DTR]) @ jnp.asarray(w)
        return want, t(coef)[..., :DTR], t(w)
    raise KeyError(name)


SITES = ["mlstm num", "mlstm den", "slstm rec", "ssm scan", "ssm dt"]


def _rel_close(got, want, rel=1e-5):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=rel, atol=rel * float(np.abs(want).max()))


@pytest.mark.parametrize("site", SITES)
def test_contract_ref_matches_jax_einsum(site):
    """The plain version (and the wrapper on CPU tensors, which takes it)
    against the reference's einsum at each site, within 1e-5 relative."""
    want, a, b = _site(site, np.random.default_rng(SITES.index(site)))
    n0 = ct.contract.launches
    got = ct.contract_ref(a, b)
    _rel_close(got.numpy(), want)
    assert torch.equal(ct.contract(a, b), got)
    assert ct.contract.launches == n0


@pytest.mark.parametrize("site", SITES)
@pytest.mark.parametrize("width", ["reduced", "full"])
def test_ordered_contract_within_gamma_k_of_matmul(site, width):
    """The kernel's order in torch ops against ``torch.matmul``: every
    element within gamma_K sum_k |x_k w_kj|, at the reduced shapes and at
    full width (K 256 for the xLSTM sites; 16 and 100 for the SSM's) with
    2 rows."""
    rng = np.random.default_rng(10 + SITES.index(site))
    if width == "reduced":
        _, a, b = _site(site, rng)
    else:
        f = lambda *s: torch.from_numpy(rng.normal(size=s).astype(np.float32))
        a, b = {"mlstm num": lambda: (f(2, 4, 1, 256), f(2, 4, 256, 256)),
                "mlstm den": lambda: (f(2, 4, 1, 256), f(2, 4, 256, 1)),
                "slstm rec": lambda: (f(2, 4, 1, 256), f(4, 256, 1024)),
                "ssm scan": lambda: (f(2, 3200, 16), f(2, 16, 1)),
                "ssm dt": lambda: (f(2, 3, 100), f(100, 3200))}[site]()
    got, want = ct.ordered_contract(a, b), ct.contract_ref(a, b)
    assert got.shape == want.shape and got.dtype == torch.float32
    assert bool(((got.double() - want.double()).abs() <= ct.sum_bound(a, b)).all())


def _flat(t):
    """t's storage from t's first element on, as a flat float tensor."""
    n = t.untyped_storage().nbytes() // t.element_size() - t.storage_offset()
    return torch.as_strided(t, (n,), (1,))


def _replay(a, b):
    """The kernel's reads, from ``geometry``: row r of x at (r // xn0) xs1
    + (r % xn0) xs0, element (k, j) of matrix w(r) = (r // div) % mod at
    w sw + k sk + j sj, summed in ``ordered_contract``'s order."""
    copy_a, copy_b, out_shape, (R, K, J, div, mod, xn0, xs0, xs1, sw, sk, sj) = ct.geometry(a, b)
    a = a.contiguous() if copy_a else a
    b = b.contiguous() if copy_b else b
    r, k, j = torch.arange(R), torch.arange(K), torch.arange(J)
    x = _flat(a)[((r // xn0) * xs1 + (r % xn0) * xs0)[:, None] + k]  # [R, K]
    w = (r // div) % mod
    W = _flat(b)[w[:, None, None] * sw + k[None, :, None] * sk + j[None, None, :] * sj]
    acc = torch.zeros(())
    for kk in range(K):
        acc = acc + x[:, kk : kk + 1] * W[:, kk, :]
    return acc.reshape(out_shape), (copy_a, copy_b)


@pytest.mark.parametrize("site", SITES)
def test_kernel_addressing_replays_ordered_contract(site):
    """Each site's operands as the model lays them out (a token of the
    scan's [S, B, ...] views, C_t and dt_r as slices of the projection) are
    read in place, and the replayed reads give ``ordered_contract``'s bits."""
    _, a, b = _site(site, np.random.default_rng(20 + SITES.index(site)))
    got, copies = _replay(a, b)
    assert copies == (False, False), copies
    assert torch.equal(got, ct.ordered_contract(a, b))


def test_kernel_addressing_copies_what_it_cannot_stride():
    """Rows over three strided levels, a k that is not contiguous and b's
    matrices over two levels are copied contiguous first; the replay keeps
    ``ordered_contract``'s bits."""
    g = torch.Generator().manual_seed(3)
    r = lambda *s: torch.randn(s, generator=g)
    cases = [(r(2, 3, 4, 6, 5).permute(2, 0, 1, 3, 4)[..., :3, :], r(3, 5, 7), (True, False)),
             (r(3, 5, 4).transpose(1, 2), r(5, 2), (True, False)),
             (r(2, 3, 1, 5), r(3, 2, 5, 4).transpose(0, 1), (False, True))]
    for a, b, want_copies in cases:
        got, copies = _replay(a, b)
        assert copies == want_copies
        assert torch.equal(got, ct.ordered_contract(a, b))


@pytest.mark.parametrize("R,div,mod", [(12, 1, 12), (512, 1, 4), (9600, 3200, 3), (7, 1, 1),
                                       (300, 1, 1), (10, 3, 2), (11, 4, 3)])
def test_tiles_cover_every_row_once(R, div, mod):
    """``csrc/contract.cu``'s enumeration (``contract_forward`` and
    ``contract_cols``), written out: the rows of matrix w are w's blocks of
    div consecutive rows, every mod-th; tiles of RT rows over them (RT from
    the most rows a matrix has) visit every row of [0, R) once, each with
    its own matrix (r // div) % mod."""
    blocks = -(-R // div)
    per_w = -(-blocks // mod) * div
    RT = 1 if per_w <= 1 else 4 if per_w <= 4 else 16
    tiles = -(-per_w // RT)
    seen = []
    for bx in range(min(blocks, mod) * tiles):
        w, i0 = bx // tiles, (bx % tiles) * RT
        for u in range(RT):
            i = i0 + u
            row = (i // div) * mod * div + w * div + i % div
            if row < R:
                assert (row // div) % mod == w
                seen.append(row)
    assert sorted(seen) == list(range(R))


# ------------------------------------------------------------------ the steps

def _t(x):
    return torch.from_numpy(np.asarray(x, np.float32))


def _mlstm_inputs(rng):
    f = lambda *s: rng.normal(size=s).astype(np.float32)
    state = {"C": f(B, NH, DH, DH), "n": f(B, NH, DH), "m": f(B, NH)}
    return state, (f(B, NH, DH), f(B, NH, DH), f(B, NH, DH), f(B, NH), -np.abs(f(B, NH)))


def _mlstm_step_before(state, q, k, v, log_i, log_f):
    """The port's mLSTM step as it was before the contraction kernel."""
    C, n, m = state["C"], state["n"], state["m"]
    f_m = log_f + m
    m_new = torch.maximum(f_m, log_i)
    decay = torch.exp(f_m - m_new)
    inp = torch.exp(log_i - m_new)
    kv = k[..., :, None] * v[..., None, :]
    C = decay[..., None, None] * C + inp[..., None, None] * kv
    n = decay[..., None] * n + inp[..., None] * k
    qr = q[..., None, :]
    num = torch.matmul(qr, C)[..., 0, :]
    den = torch.maximum(torch.abs(torch.matmul(qr, n[..., :, None])[..., 0, 0]), torch.exp(-m_new))
    return {"C": C, "n": n, "m": m_new}, num / den[..., None]


def _slstm_step_before(R, fb, nh, st, xi, xf, xz, xo):
    """The port's sLSTM step as it was before the contraction kernel."""
    Bs, d = xi.shape
    h = st["h"].reshape(Bs, nh, 1, d // nh)
    rec = lambda w: torch.matmul(h, w).reshape(Bs, d)
    i_raw = xi + rec(R["ri"])
    f_raw = xf + rec(R["rf"]) + fb
    z = torch.tanh(xz + rec(R["rz"]))
    o = torch.sigmoid(xo + rec(R["ro"]))
    log_i, log_f = i_raw, torch.nn.functional.logsigmoid(f_raw)
    f_m = log_f + st["m"]
    m_new = torch.maximum(f_m, log_i)
    decay = torch.exp(f_m - m_new)
    inp = torch.exp(log_i - m_new)
    c = decay * st["c"] + inp * z
    n = decay * st["n"] + inp
    h_new = o * c / torch.clamp(n, min=1e-6)
    return {"h": h_new, "c": c, "n": n, "m": m_new}, h_new


def _equal_trees(a, b):
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_equal_trees(a[k], b[k]) for k in a)
    return torch.equal(a, b)


@pytest.mark.parametrize("grad", [False, True], ids=["no_grad", "grad"])
def test_mlstm_step_matches_jax_and_is_bitwise_before_on_cpu(grad):
    """``_mlstm_step`` against ``repro.models.xlstm._mlstm_step`` on the same
    carry and inputs (1e-5 relative), and bitwise the pre-kernel step on
    the CPU, with grad enabled (training) and without (serving)."""
    state, ins = _mlstm_inputs(np.random.default_rng(30))
    jst, jh = jxlstm._mlstm_step({k: jnp.asarray(v) for k, v in state.items()},
                                 *map(jnp.asarray, ins))
    with torch.set_grad_enabled(grad):
        tst, th = txlstm._mlstm_step({k: _t(v) for k, v in state.items()}, *map(_t, ins))
        bst, bh = _mlstm_step_before({k: _t(v) for k, v in state.items()}, *map(_t, ins))
    _rel_close(th.numpy(), jh)
    for k in jst:
        _rel_close(tst[k].numpy(), jst[k])
    assert torch.equal(th, bh) and _equal_trees(tst, bst)


@pytest.mark.parametrize("grad", [False, True], ids=["no_grad", "grad"])
def test_slstm_step_matches_jax_and_is_bitwise_before_on_cpu(grad):
    """``_slstm_step`` (its weights hoisted as ``slstm_forward`` hoists them,
    the stacked ``R["all"]`` beside them without grad) against
    ``repro.models.xlstm._slstm_step`` (1e-5 relative), and bitwise the
    pre-kernel step on the CPU."""
    import jax

    cfg = reduced(get_config("xlstm-350m"))
    jp = jax.tree.map(lambda x: x.astype(jnp.float32),
                      jxlstm.slstm_init(jax.random.PRNGKey(5), cfg))
    rng = np.random.default_rng(31)
    d = cfg.d_model
    f = lambda *s: rng.normal(size=s).astype(np.float32)
    st = {"h": f(B, d), "c": f(B, d), "n": np.abs(f(B, d)), "m": f(B, d)}
    xs = [f(B, d) for _ in range(4)]
    jst, jh = jxlstm._slstm_step(jp, cfg, {k: jnp.asarray(v) for k, v in st.items()},
                                 *map(jnp.asarray, xs))
    p = params_from_jax(jax.tree.map(np.asarray, jp), "cpu")
    with torch.set_grad_enabled(grad):
        R = {w: p[w].float() for w in txlstm._GATES}
        if not grad:
            R["all"] = torch.cat([R[w] for w in txlstm._GATES], dim=-1)
        args = (cfg.num_heads, {k: _t(v) for k, v in st.items()}, *map(_t, xs))
        tst, th = txlstm._slstm_step(R, p["fb"], *args)
        bst, bh = _slstm_step_before(R, p["fb"], *args)
    _rel_close(th.numpy(), jh)
    for k in jst:
        _rel_close(tst[k].numpy(), jst[k])
    assert torch.equal(th, bh) and _equal_trees(tst, bst)


def test_scan_step_matches_jax_and_is_bitwise_before_on_cpu():
    """``ssm._scan_step`` against the reference's scan step
    (``src/repro/models/ssm.py:116-120``: ``h = dA h + dBx``, then
    ``einsum("bdn,bn->bd", h, C_t)``) on a token of the scan's views (1e-5
    relative), and bitwise its pre-kernel expression on the CPU."""
    rng = np.random.default_rng(32)
    f = lambda *s: rng.normal(size=s).astype(np.float32)
    h, dA, dBx, coef = f(B, DI, N), f(B, DI, N), f(B, DI, N), f(B, S, DTR + 2 * N)
    C_t = coef[:, 1, DTR + N:]
    jh = dA * h + dBx
    jy = jnp.einsum("bdn,bn->bd", jh, C_t)
    Ct = _t(coef)[..., DTR + N:].movedim(1, 0)[1]
    th, ty = tssm._scan_step(_t(h), (_t(dA), _t(dBx), Ct))
    _rel_close(th.numpy(), jh)
    _rel_close(ty.numpy(), jy)
    bh = _t(dA) * _t(h) + _t(dBx)
    assert torch.equal(th, bh) and torch.equal(ty, torch.matmul(bh, Ct[:, :, None])[..., 0])


def test_ssm_coeffs_match_jax_and_are_bitwise_before_on_cpu():
    """``ssm._ssm_coeffs`` against ``repro.models.ssm._ssm_coeffs`` with
    float32 parameters (dA, dBx and C within 1e-5 relative), and bitwise
    its pre-kernel expression (``proj``, which is ``x @ w`` in f32) on the
    CPU."""
    import jax

    cfg = reduced(get_config("hymba-1.5b"))
    tcfg = t_reduced(t_get_config("hymba-1.5b"))
    jp = jax.tree.map(lambda x: x.astype(jnp.float32), jssm.ssm_init(jax.random.PRNGKey(6), cfg))
    di = jssm._dims(cfg)[0]
    xc = np.random.default_rng(33).normal(size=(2, S, di)).astype(np.float32)
    want = jssm._ssm_coeffs(jp, cfg, jnp.asarray(xc))
    p = params_from_jax(jax.tree.map(np.asarray, jp), "cpu")
    got = tssm._ssm_coeffs(p, tcfg, _t(xc))
    for g, w in zip(got, want):
        _rel_close(g.numpy(), w)
    _, dtr, Nn, _ = tssm._dims(tcfg)
    coef = tlayers.proj(_t(xc), p["w_xproj"]).float()
    dt = tssm.softplus(tlayers.proj(coef[..., :dtr], p["w_dt"].float()) + p["dt_bias"])
    assert torch.equal(got[0], torch.exp(dt[..., None] * -torch.exp(p["A_log"])))
    assert torch.equal(got[1], (dt * _t(xc))[..., None] * coef[..., dtr:dtr + Nn][..., None, :])


# ------------------------------------------------------------------ dispatch

def test_contract_refuses_grad_and_other_devices():
    """A grad-requiring input raises on the CPU as on the card; a meta
    tensor is neither the CPU nor the card and raises; CPU tensors of
    another dtype take the plain version (the dtype is checked on the card
    only, as the plain version computes any)."""
    a, b = torch.randn(2, 3, requires_grad=True), torch.randn(3, 4)
    n0 = ct.contract.launches
    with pytest.raises(RuntimeError, match="no backward"):
        ct.contract(a, b)
    with torch.no_grad():
        assert torch.equal(ct.contract(a, b), torch.matmul(a, b))
    with pytest.raises(ValueError, match="CUDA"):
        ct.contract(torch.empty(2, 3, device="meta"), torch.empty(3, 4, device="meta"))
    assert ct.contract.launches == n0
    with pytest.raises(ValueError, match="suffix"):
        ct.geometry(torch.randn(2, 3, 1, 5), torch.randn(4, 5, 6))


class _OnCard:
    """A stand-in operand that reports the card as its device (no CUDA
    here): it shows which route ``f32_contract`` picks."""

    device = torch.device("cuda")
    requires_grad = False


def test_f32_contract_routes(monkeypatch):
    """``layers.f32_contract`` hands a no-grad card operand to the kernel's
    wrapper, and a grad-enabled call, a DTensor, a meta tensor or a CPU
    tensor to the plain expression."""
    calls = []
    monkeypatch.setattr(ct, "contract", lambda a, b: calls.append("kernel") or "kernel")
    plain = lambda a, b: calls.append("plain") or "plain"
    with torch.no_grad():
        assert tlayers.f32_contract(_OnCard(), None, plain=plain) == "kernel"
        meta = torch.empty(2, 1, 3, device="meta")
        assert tlayers.f32_contract(meta, torch.empty(2, 3, 4, device="meta")).shape == (2, 1, 4)
        assert tlayers.f32_contract(torch.ones(1, 2), torch.ones(2, 1), plain=plain) == "plain"
    with torch.enable_grad():
        assert tlayers.f32_contract(_OnCard(), None, plain=plain) == "plain"
    monkeypatch.setattr(tlayers, "is_dtensor", lambda t: True)
    with torch.no_grad():
        assert tlayers.f32_contract(_OnCard(), None, plain=plain) == "plain"
    assert calls == ["kernel", "plain", "plain", "plain"]


def test_sites_take_the_plain_route_on_cpu_and_meta(monkeypatch):
    """The model sites never reach the kernel's wrapper off the card: the
    mLSTM and sLSTM blocks and the SSM forward at reduced size on CPU
    tensors, and an mLSTM step on meta tensors (the dry run's one-step
    body), under ``torch.no_grad``."""
    calls = []
    real = ct.contract
    monkeypatch.setattr(ct, "contract", lambda a, b: calls.append(1) or real(a, b))
    tcfg = t_reduced(t_get_config("xlstm-350m"))
    hcfg = t_reduced(t_get_config("hymba-1.5b"))
    g = torch.Generator().manual_seed(0)
    x = torch.randn(2, 3, tcfg.d_model, generator=g).bfloat16()
    with torch.no_grad():
        for block in ("mlstm", "slstm"):
            p = getattr(txlstm, f"{block}_init")(g, tcfg)
            st = getattr(txlstm, f"{block}_state")(tcfg, 2)
            getattr(txlstm, f"{block}_forward")(p, tcfg, x, st)
        p = tssm.ssm_init(g, hcfg)
        tssm.ssm_forward(p, hcfg, torch.randn(2, 3, hcfg.d_model, generator=g).bfloat16(),
                         tssm.ssm_state_init(hcfg, 2))
        meta = lambda *s: torch.empty(s, device="meta")
        st = {"C": meta(2, NH, DH, DH), "n": meta(2, NH, DH), "m": meta(2, NH)}
        new, h = txlstm._mlstm_step(st, meta(2, NH, DH), meta(2, NH, DH), meta(2, NH, DH),
                                    meta(2, NH), meta(2, NH))
    assert h.shape == (2, NH, DH) and new["C"].shape == (2, NH, DH, DH)
    assert calls == []

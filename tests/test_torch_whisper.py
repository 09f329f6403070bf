"""The port's whisper-small (``repro_torch.models.whisper``) against the JAX
package's ``repro.models.whisper`` at the reduced config (2 encoder and 2
decoder layers, d_model 64, 4 heads over 2 kv heads, ``cross_attend_len`` 8).

Same bridged parameters (``params_from_jax``) and numpy draws through both.
Tolerances, as measured on this CPU:

* ``sinusoidal_positions``: f32 ``exp``/``sin``/``cos`` differ between XLA
  and torch in the last f32 ulp, which moves some bf16 roundings by one bf16
  ulp.  At whisper's [1501, 768] table 610 of 1,152,768 entries differ, by
  at most 2^-8 (one bf16 ulp below 1); the test holds every entry to
  2^-8 and the count to 0.1%.  The reduced tables are bitwise equal.
* With float32 weights and the reference's own position table handed to
  both (``sinusoidal_positions`` substituted), ``encode``,
  ``decode_prefill``, ``prefill`` and three ``decode_step``s agree within
  1e-5 (measured max |d| of the logits 1.5e-7).  The caches are bf16 in
  both: bitwise but for one-ulp flips (measured: one entry of ``xk``, by
  4.9e-4), held to one bf16 ulp, 2^-7 relative.
* With bf16 weights and each package's own table, end to end: logits
  within 3e-2 (the JAX package's cross-graph logits tolerance; measured
  max |d| 4.2e-3), cache leaves within 3e-2 relative + 3e-2 absolute
  (measured max |d| 3.1e-2 on ``xv``: one or two bf16 ulps of values up
  to ~4), argmax equal.
* Finding 3 of the reference, reproduced: decode attends all
  ``cross_attend_len`` cross rows, zero-filled ones included.  With 8
  frames, a 6-token prefill plus a teacher-forced decode of the 7th token
  agrees with a 7-token prefill (measured max |d| 4.9e-3 in JAX, 3.9e-3
  in the port); with 4 frames it does not (9.77e-2 in both), and the two
  packages' differences are held to agree within 3e-2.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config, reduced
from repro.models import layers as jl
from repro.models import whisper as jw
from repro.models.registry import build_model as jax_build_model
from repro_torch.configs import get_config as t_get_config
from repro_torch.configs import reduced as t_reduced
from repro_torch.models import layers as tl
from repro_torch.models import transformer as t_tf
from repro_torch.models import whisper as tw
from repro_torch.models.registry import build_model
from repro_torch.params import params_from_jax
from repro_torch.serving.engine import ServingEngine

NAME = "whisper-small"
F32 = dict(rtol=1e-5, atol=1e-5)
XGRAPH = dict(rtol=3e-2, atol=3e-2)
BF16_ULP = 2.0 ** -8  # one bf16 ulp for values in [0.5, 1)


@pytest.fixture(scope="module")
def pair():
    """{weights dtype: (jax cfg, jax params, port cfg, port params)}."""
    cfg = reduced(get_config(NAME))
    tcfg = t_reduced(t_get_config(NAME))
    jp = jax_build_model(cfg).init_params(jax.random.PRNGKey(0))
    out = {}
    for dtype in ("bfloat16", "float32"):
        p = jp if dtype == "bfloat16" else jax.tree.map(lambda a: a.astype(jnp.float32), jp)
        out[dtype] = (cfg, p, tcfg, params_from_jax(jax.tree.map(np.asarray, p), "cpu"))
    return out


@pytest.fixture
def reference_positions(monkeypatch):
    """Hand the reference's own position table to the port (f32 checks)."""

    def table(length, dim, device=None):
        t = np.asarray(jl.sinusoidal_positions(length, dim)).view(np.uint16)
        return torch.from_numpy(t.copy()).view(torch.bfloat16).to(device)

    monkeypatch.setattr(tw, "sinusoidal_positions", table)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.numpy() if x.dtype in (torch.int32, torch.int64) else x.float().numpy()
    return np.asarray(x) if x.dtype == jnp.int32 else np.asarray(x, np.float32)


def _inputs(cfg, B=2, T=8, S=6, seed=0):
    rng = np.random.default_rng(seed)
    frames = rng.normal(size=(B, T, cfg.d_model)).astype(np.float32)
    tokens = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    return frames, tokens


def _frames(frames, dtype):
    jd, td = (jnp.float32, torch.float32) if dtype == "float32" else (jnp.bfloat16, torch.bfloat16)
    return jnp.asarray(frames, jd), torch.from_numpy(frames).to(td)


@pytest.mark.parametrize("length,dim", [(1501, 768), (1500, 768), (449, 768), (9, 64), (64, 64)])
def test_sinusoidal_positions_match(length, dim):
    want = np.asarray(jl.sinusoidal_positions(length, dim), np.float32)
    got = tl.sinusoidal_positions(length, dim)
    assert got.dtype == torch.bfloat16 and got.shape == (length, dim)
    d = np.abs(got.float().numpy() - want)
    assert d.max() <= BF16_ULP
    assert (d > 0).sum() <= 1e-3 * d.size
    if length * dim <= 64 * 64:
        assert (d == 0).all()


def test_params_tree_matches_and_bridges_unchanged(pair):
    """The port's init draws the reference's tree (names, shapes, dtypes);
    params_from_jax carries the stacked enc_layers/dec_layers across and the
    port's layer_params slices them as the reference's scan does."""
    cfg, jp, tcfg, tp = pair["bfloat16"]
    mine = tw.init_params(tcfg, torch.Generator().manual_seed(0), "cpu")

    def flat(tree, prefix=()):
        for k, v in tree.items():
            if isinstance(v, dict):
                yield from flat(v, prefix + (k,))
            else:
                yield prefix + (k,), v

    ref = {p: (tuple(v.shape), str(v.dtype)) for p, v in flat(jax.tree.map(np.asarray, jp))}
    got = {p: (tuple(v.shape), str(v.dtype).removeprefix("torch.")) for p, v in flat(mine)}
    assert got == ref
    bridged = {p: v for p, v in flat(tp)}
    for p, v in flat(jax.tree.map(np.asarray, jp)):
        assert np.array_equal(bridged[p].view(torch.uint16).numpy(), v.view(np.uint16)), p
    enc = t_tf.layer_params(tp["enc_layers"], tcfg.encoder_layers)
    dec = t_tf.layer_params(tp["dec_layers"], tcfg.num_layers)
    assert len(enc) == cfg.encoder_layers and len(dec) == cfg.num_layers
    assert torch.equal(dec[1]["xattn"]["wk"], tp["dec_layers"]["xattn"]["wk"][1])


@pytest.mark.parametrize("kind", ["causal", "non_causal", "cross"])
def test_attn_prefill_layer_non_causal_and_cross(pair, kind):
    """The layer's causal= switch against the reference's
    ``attn_prefill_layer``, and cross attention (T != S keys over
    precomputed encoder keys and values) against the reference's
    ``_cross_attend`` (f32)."""
    cfg, jp, tcfg, tp = pair["float32"]
    lp_j = jax.tree.map(lambda a: a[0], jp["dec_layers"])
    lp_t = t_tf.layer_params(tp["dec_layers"], tcfg.num_layers)[0]
    rng = np.random.default_rng(3)
    B, S, T = 2, 6, 11
    x = rng.normal(size=(B, S, cfg.d_model)).astype(np.float32)
    if kind == "cross":
        kv = rng.normal(size=(2, B, T, cfg.num_kv_heads, cfg.resolved_head_dim)).astype(np.float32)
        want = jw._cross_attend(lp_j, cfg, jnp.asarray(x), jnp.asarray(kv[0]), jnp.asarray(kv[1]))
        got = tw._cross_attend(lp_t, tcfg, torch.from_numpy(x), torch.from_numpy(kv[0]),
                               torch.from_numpy(kv[1]))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)
        return
    causal = kind == "causal"
    pos = np.broadcast_to(np.arange(S), (B, S)).astype(np.int32)
    want, _ = jl.attn_prefill_layer(lp_j["attn"], cfg, jnp.asarray(x), jnp.asarray(pos),
                                    causal=causal, use_rope=False)
    got, (k, _) = tl.attn_prefill_layer(lp_t["attn"], tcfg, torch.from_numpy(x), torch.from_numpy(pos),
                                        causal=causal, use_rope=False, contiguous=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)
    assert k.shape[1] == S


def test_encode_and_decode_prefill_match_f32(pair, reference_positions):
    cfg, jp, tcfg, tp = pair["float32"]
    frames, tokens = _inputs(cfg)
    jf, tf = _frames(frames, "float32")
    je = jw.encode(jp, cfg, jf)
    te = tw.encode(tp, tcfg, tf)
    np.testing.assert_allclose(te.numpy(), np.asarray(je), **F32)
    jx, jys = jw.decode_prefill(jp, cfg, jnp.asarray(tokens), je, collect_cache=True)
    tx, tys = tw.decode_prefill(tp, tcfg, torch.from_numpy(tokens), te, collect_cache=True)
    np.testing.assert_allclose(tx.numpy(), np.asarray(jx), **F32)
    for a, b in zip(tys, jys):
        assert tuple(a.shape) == tuple(b.shape)
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **F32)
    hidden, none = tw.decode_prefill(tp, tcfg, torch.from_numpy(tokens), te)
    assert none is None and torch.equal(hidden, tx)


def _run_both(pair, dtype, frames, tokens, cache_len, steps):
    """prefill then ``steps`` greedy decode steps through both bundles'
    entry points; yields (jax logits, port logits, jax cache, port cache)."""
    cfg, jp, tcfg, tp = pair[dtype]
    jb, tb = jax_build_model(cfg), build_model(tcfg, device="cpu")
    jf, tf = _frames(frames, dtype)
    jlg, jc = jb.prefill_fn(jp, {"frames": jf, "tokens": jnp.asarray(tokens)}, cache_len)
    tlg, tc = tb.prefill_fn(tp, {"frames": tf, "tokens": torch.from_numpy(tokens)}, cache_len)
    yield jlg, tlg, jc, tc
    pos = np.full((tokens.shape[0],), tokens.shape[1], np.int32)
    for i in range(steps):
        tok = np.asarray(jlg).argmax(-1).astype(np.int32)
        jlg, jc = jb.decode_fn(jp, jc, jnp.asarray(tok), jnp.asarray(pos + i))
        tlg, tc = tb.decode_fn(tp, tc, torch.from_numpy(tok), torch.from_numpy(pos + i))
        yield jlg, tlg, jc, tc


@pytest.mark.parametrize("cache_len", [16, 8])
def test_prefill_and_decode_match_f32(pair, reference_positions, cache_len):
    """cache_len 8 with 6 prompt tokens: the third decode step writes the
    clamped slot Sc - 1 and reads the position table at min(pos, Sc)."""
    cfg = pair["float32"][0]
    frames, tokens = _inputs(cfg)
    for jlg, tlg, jc, tc in _run_both(pair, "float32", frames, tokens, cache_len, steps=3):
        np.testing.assert_allclose(tlg.numpy(), np.asarray(jlg), **F32)
        assert (tlg.numpy().argmax(-1) == np.asarray(jlg).argmax(-1)).all()
        assert set(tc) == set(jc) == {"k", "v", "pos", "xk", "xv"}
        for key in jc:
            assert tc[key].dtype == (torch.int32 if key == "pos" else torch.bfloat16)
            np.testing.assert_allclose(_np(tc[key]), _np(jc[key]), rtol=2.0 ** -7, atol=1e-6, err_msg=key)


def test_prefill_and_decode_match_bf16_end_to_end(pair):
    """bf16 weights, each package's own position table, whole entry points."""
    cfg = pair["bfloat16"][0]
    frames, tokens = _inputs(cfg, seed=1)
    for jlg, tlg, jc, tc in _run_both(pair, "bfloat16", frames, tokens, 16, steps=3):
        assert np.isfinite(tlg.numpy()).all()
        np.testing.assert_allclose(tlg.numpy(), np.asarray(jlg), **XGRAPH)
        assert (tlg.numpy().argmax(-1) == np.asarray(jlg).argmax(-1)).all()
        for key in jc:
            np.testing.assert_allclose(_np(tc[key]), _np(jc[key]), **XGRAPH, err_msg=key)


def test_cross_cache_filled_to_the_frames(pair):
    """With fewer frames than cross_attend_len the cross cache's trailing
    rows stay zero in both packages."""
    cfg = pair["bfloat16"][0]
    frames, tokens = _inputs(cfg, T=4)
    _, _, jc, tc = next(_run_both(pair, "bfloat16", frames, tokens, 16, steps=0))
    assert tc["xk"].shape[2] == cfg.cross_attend_len == 8
    assert not tc["xk"][:, :, 4:].any() and not tc["xv"][:, :, 4:].any()
    assert tc["xk"][:, :, :4].abs().sum() > 0
    assert not np.asarray(jc["xk"], np.float32)[:, :, 4:].any()


def _decode_vs_prefill(build, params, frames, tokens):
    """|logits of a 6-token prefill + teacher-forced decode of token 7  -
    logits of a 7-token prefill|, max over the batch."""
    prefill, decode, to = build
    l6, cache = prefill(params, frames, tokens[:, :6])
    l7d, _ = decode(params, cache, to(tokens[:, 6]), to(np.full((tokens.shape[0],), 6, np.int32)))
    l7, _ = prefill(params, frames, tokens)
    return float(np.abs(_np(l7d) - _np(l7)).max())


@pytest.mark.parametrize("n_frames", [8, 4])
def test_decode_attends_every_cross_row(pair, n_frames):
    """The reference's finding 3, in both packages: decode attends all
    cross_attend_len rows.  8 frames fill them and decode agrees with
    prefill; 4 frames leave 4 zero rows that decode attends and prefill
    never saw."""
    cfg, jp, tcfg, tp = pair["bfloat16"]
    frames, tokens = _inputs(cfg, T=n_frames, S=7, seed=2)
    jb, tb = jax_build_model(cfg), build_model(tcfg, device="cpu")
    jf, tf = _frames(frames, "bfloat16")
    j = _decode_vs_prefill(
        (lambda p, f, t: jb.prefill_fn(p, {"frames": jf, "tokens": jnp.asarray(t)}, 16),
         jb.decode_fn, jnp.asarray), jp, frames, tokens)
    t = _decode_vs_prefill(
        (lambda p, f, t: tb.prefill_fn(p, {"frames": tf, "tokens": torch.from_numpy(np.ascontiguousarray(t))}, 16),
         tb.decode_fn, torch.from_numpy), tp, frames, tokens)
    assert abs(j - t) <= XGRAPH["atol"], (j, t)
    if n_frames == cfg.cross_attend_len:
        assert j < 0.02 and t < 0.02, (j, t)
    else:
        assert j > 0.05 and t > 0.05, (j, t)


def test_bundles_without_paged_entry_points():
    """whisper and int8 transformer bundles have no paged functions (as in
    the JAX registry); an int8 engine lands in the dense mode."""
    wb = build_model(t_reduced(t_get_config(NAME)), device="cpu")
    assert wb.prefill_collect_fn is wb.paged_decode_fn is wb.prefill_chunk_fn is None
    assert build_model(t_get_config(NAME).replace(kv_cache_dtype="int8"), device="cpu").cfg.family == "audio"
    cfg8 = t_reduced(t_get_config("qwen3-1.7b")).replace(kv_cache_dtype="int8")
    b8 = build_model(cfg8, device="cpu")
    assert b8.paged_decode_fn is None
    eng = ServingEngine(b8, b8.init_params(torch.Generator().manual_seed(0)), device="cpu",
                        block_size=4, device_blocks=32, cache_len=32)
    assert eng.decode_mode == "dense"
    r = eng.run(eng.submit(tuple(range(1, 10)), max_new_tokens=3))
    assert r.status == "finished" and len(r.output_tokens) == 3
    eng.close()


def test_full_config_matches_reference():
    import dataclasses

    assert dataclasses.asdict(t_get_config(NAME)) == dataclasses.asdict(get_config(NAME))
    assert dataclasses.asdict(t_reduced(t_get_config(NAME))) == dataclasses.asdict(reduced(get_config(NAME)))


def test_make_cache_shapes(pair):
    cfg, _, tcfg, _ = pair["bfloat16"]
    tc = tw.make_cache(tcfg, 3, 10, device="cpu")
    jc = jw.make_cache(cfg, 3, 10)
    assert {k: tuple(v.shape) for k, v in tc.items()} == {k: tuple(v.shape) for k, v in jc.items()}
    assert (tc["pos"] == -1).all()

"""The port's MoE and VLM families against the JAX package.

Reduced grok-1-314b (tanh soft-cap 30, 4 experts top-2, G = 6), reduced
arctic-480b (4 experts top-2 beside the dense residual MLP, G = 7) and
reduced phi-3-vision-4.2b (4 stub patch embeddings, head_dim 96, G = 1) get
the JAX package's parameters bridged by ``params_from_jax``; every input is
made with numpy from a seed and handed to both.  Checked here:

* ``_dispatch``: slot tables exactly equal, gates within 1e-6 (measured
  max |d| 2.4e-7) and the aux loss within a relative 1e-6 (measured 1.3e-7)
  on f32 inputs, forced ties included (duplicated router
  columns: the lower expert index wins, as ``jax.lax.top_k`` orders them);
  the capacity-dispatch invariants of the JAX package's hypothesis test;
* ``capacity_for`` over a grid of T, E, k and capacity factors (exact);
* ``moe_apply_local`` output and aux loss (f32 within 1e-5, measured max
  |d| 4.8e-7; bf16 within 2e-2, measured 1.6e-2: one bf16 step at outputs
  of magnitude 2-4), and the grouped dispatch the paged decode step uses
  equal to separate groups within 1e-6 (measured 4.8e-7);
* ``prefill`` (VLM: with ``patch_embeds``), ``prefill_collect``,
  ``decode_step`` (VLM: positions from P + S), ``prefill_chunk`` and
  ``paged_decode_step`` at transformer level, f32 weights: logits and KV
  within 1e-4 (measured max |d| 4.1e-6), dense decode steps over the bf16
  cache within 1e-3 (measured 3.1e-4);
* the paged engine's greedy tokens, pre-decode logits and projected event
  stream equal to the JAX engine's;
* the capacity coupling, in both packages: the same request alone and
  beside another gets different logits (it loses expert capacity to its
  batch-mate), and the port reproduces the reference in both cases.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config, reduced
from repro.configs.base import ModelConfig as JModelConfig
from repro.configs.base import MoEConfig as JMoEConfig
from repro.models import moe as jax_moe
from repro.models import transformer as jax_tf
from repro.models.registry import build_model as jax_build_model
from repro.serving.engine import ServingEngine as JaxEngine
from repro_torch.configs import ModelConfig, MoEConfig
from repro_torch.configs import get_config as t_get_config
from repro_torch.configs import reduced as t_reduced
from repro_torch.models import moe as t_moe
from repro_torch.models import transformer as t_tf
from repro_torch.models.registry import build_model
from repro_torch.params import params_from_jax
from repro_torch.serving.engine import ServingEngine
from test_torch_params import _flat, tensor_to_numpy

ARCHS = ["grok-1-314b", "arctic-480b", "phi-3-vision-4.2b"]
# Each model's own grouping kept at reduced width: G = 6 and 7 (no other
# served model has either), and phi-3-vision's head_dim 96 at G = 1.
SHAPES = {
    "grok-1-314b": dict(num_heads=6, num_kv_heads=1),
    "arctic-480b": dict(num_heads=7, num_kv_heads=1),
    "phi-3-vision-4.2b": dict(num_heads=4, num_kv_heads=4, head_dim=96),
}
PREFIX = tuple(range(10, 26))  # 16 tokens = 4 blocks of 4
TIMED = {"stage_latency"}


def small(reduce, cfg):
    return reduce(cfg).replace(**SHAPES[cfg.name])


def np32(a):
    return np.asarray(a, np.float32)


def t2n(t):
    return t.detach().float().numpy()


@pytest.fixture(scope="module", params=ARCHS)
def model(request):
    """(name, {dtype: (jax bundle, jax params, port bundle, port params)})."""
    cfg = small(reduced, get_config(request.param))
    jb = jax_build_model(cfg)
    jp = jb.init_params(jax.random.PRNGKey(0))
    tb = build_model(small(t_reduced, t_get_config(request.param)), device="cpu")
    out = {}
    for dtype in ("bfloat16", "float32"):
        p = jp if dtype == "bfloat16" else jax.tree.map(lambda a: a.astype(jnp.float32), jp)
        out[dtype] = (jb, p, tb, params_from_jax(jax.tree.map(np.asarray, p), "cpu"))
    return request.param, out


# ---------------------------------------------------------------------------
# dispatch
# ---------------------------------------------------------------------------


def _cfgs(E, k, cf=1.25):
    kw = dict(name="t", family="moe", num_layers=1, d_model=16, num_heads=2, num_kv_heads=2,
              d_ff=32, vocab_size=64)
    return (JModelConfig(moe=JMoEConfig(num_experts=E, experts_per_token=k, capacity_factor=cf), **kw),
            ModelConfig(moe=MoEConfig(num_experts=E, experts_per_token=k, capacity_factor=cf), **kw))


def _both_dispatch(x, router, k, C):
    j = jax_moe._dispatch(jnp.asarray(x), jnp.asarray(router), k, C)
    t = t_moe._dispatch(torch.from_numpy(x), torch.from_numpy(router), k, C)
    return [np.asarray(a) for a in j], [a.numpy() for a in t]


@pytest.mark.parametrize("T,E,k,C,ties", [
    (16, 4, 2, 10, False),   # reduced grok's prefill chunk capacity
    (37, 8, 2, 3, False),    # most assignments drop
    (12, 128, 2, 1, False),  # arctic's expert count
    (4, 8, 2, 1, False),     # a decode step of 4 rows dispatched together
    (24, 8, 2, 4, True),     # duplicated router columns: exact ties
    (9, 4, 1, 2, True),
])
def test_dispatch_matches_jax(T, E, k, C, ties):
    """Tolerance: none for the slot tables, 1e-6 for the gates, a relative
    1e-6 for the aux loss (a sum of E products in another order)."""
    rng = np.random.default_rng(T * 131 + E)
    d = 16
    x = rng.normal(size=(T, d)).astype(np.float32)
    router = rng.normal(size=(d, E)).astype(np.float32)
    if ties:
        router[:, 1::2] = router[:, 0::2]  # expert 2j+1 ties expert 2j on every token
        x[T // 2:] = x[: T - T // 2]  # repeated tokens compete for the same slots
    (jt, jg, ja), (tt, tg, ta) = _both_dispatch(x, router, k, C)
    assert tt.shape == jt.shape == (E, C)
    np.testing.assert_array_equal(tt, jt)
    np.testing.assert_allclose(tg, jg, rtol=0, atol=1e-6)
    np.testing.assert_allclose(ta, ja, rtol=1e-6, atol=0)
    if ties and k == 1:  # the higher-index twin of a tied pair is never chosen
        assert (tt[1::2] == T).all() and (tt[0::2] < T).any()


def test_top_k_orders_ties_by_lower_index():
    logits = np.array([[1.0, 3.0, 3.0, 2.0, 3.0], [0.5, 0.5, 0.5, 0.5, 0.5]], np.float32)
    jv, ji = jax.lax.top_k(jnp.asarray(logits), 3)
    tv, ti = t_moe._top_k(torch.from_numpy(logits), 3)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    assert ti.tolist() == [[1, 2, 4], [0, 1, 2]]


def test_capacity_for_matches_jax():
    """Tolerance: none (the same Python float expression)."""
    for E in (4, 8, 128):
        for k in (1, 2):
            for cf in (1.0, 1.25, 2.0):
                jcfg, tcfg = _cfgs(E, k, cf)
                for T in (1, 2, 3, 4, 5, 8, 16, 31, 32, 64, 100, 128, 512, 1000):
                    assert t_moe.capacity_for(tcfg, T) == jax_moe.capacity_for(jcfg, T)
    jcfg, tcfg = _cfgs(8, 2)
    assert t_moe.capacity_for(tcfg, 4) == 1  # a 4-row step dispatched together: C = int(1.25)


@pytest.mark.parametrize("dtype,tol", [("float32", 1e-5), ("bfloat16", 2e-2)])
@pytest.mark.parametrize("T", [1, 7, 40])
def test_moe_apply_local_matches_jax(dtype, tol, T):
    jcfg = reduced(get_config("grok-1-314b"))
    tcfg = t_reduced(t_get_config("grok-1-314b"))
    jp = jax_moe.moe_init(jax.random.PRNGKey(3), jcfg)
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    jp = {k: (v if k == "router" else v.astype(jdt)) for k, v in jp.items()}
    tp = params_from_jax(jax.tree.map(np.asarray, jp), "cpu")
    assert tp["router"].dtype == torch.float32
    x = np.random.default_rng(T).normal(size=(T, jcfg.d_model)).astype(np.float32)
    jo, ja = jax_moe.moe_apply_local(jp, jnp.asarray(x, jdt), jcfg)
    to, ta = t_moe.moe_apply_local(tp, torch.from_numpy(x).to(getattr(torch, dtype)), tcfg)
    assert to.dtype == getattr(torch, dtype) and to.shape == (T, jcfg.d_model)
    np.testing.assert_allclose(t2n(to), np32(jo), rtol=tol, atol=tol)
    np.testing.assert_allclose(float(ta), float(ja), rtol=1e-5, atol=1e-6)


def test_grouped_dispatch_equals_separate_groups():
    """``moe_apply_grouped`` over G rows is G separate ``moe_apply_local``
    calls (the reference's ``lax.map`` over decode rows): same slot tables
    per group, outputs within 1e-6 (one batched product instead of G)."""
    jcfg = reduced(get_config("arctic-480b"))
    tcfg = t_reduced(t_get_config("arctic-480b"))
    jp = jax.tree.map(lambda a: a.astype(jnp.float32), jax_moe.moe_init(jax.random.PRNGKey(4), jcfg))
    tp = params_from_jax(jax.tree.map(np.asarray, jp), "cpu")
    x = np.random.default_rng(5).normal(size=(5, 3, jcfg.d_model)).astype(np.float32)
    got, aux = t_moe.moe_apply_grouped(tp, torch.from_numpy(x), tcfg)
    for g in range(5):
        jo, ja = jax_moe.moe_apply_local(jp, jnp.asarray(x[g]), jcfg)
        np.testing.assert_allclose(t2n(got[g]), np32(jo), rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(float(aux[g]), float(ja), rtol=1e-6, atol=0)


hypothesis = pytest.importorskip("hypothesis")
from hypothesis import given, settings  # noqa: E402
from hypothesis import strategies as st  # noqa: E402


@settings(max_examples=20, deadline=None)
@given(T=st.integers(4, 64), E=st.sampled_from([2, 4, 8]), k=st.sampled_from([1, 2]),
       seed=st.integers(0, 100))
def test_moe_dispatch_invariants(T, E, k, seed):
    """The JAX package's capacity-dispatch invariants over the port's
    ``_dispatch``: every slot token id is in [0, T], each (expert, slot)
    holds at most one token, a token appears at most k times, the gates lie
    in [0, 1] and the aux loss is positive."""
    rng = np.random.default_rng(seed)
    d = 16
    x = torch.from_numpy(rng.normal(size=(T, d)).astype(np.float32))
    router = torch.from_numpy(rng.normal(size=(d, E)).astype(np.float32))
    C = t_moe.capacity_for(_cfgs(E, k)[1], T)
    tt, tg, ta = (a.numpy() for a in t_moe._dispatch(x, router, k, C))
    assert tt.shape == (E, C)
    assert ((tt >= 0) & (tt <= T)).all()
    _, counts = np.unique(tt[tt < T], return_counts=True)
    assert (counts <= k).all()
    assert ((tg >= 0) & (tg <= 1)).all() and (tg[tt == T] == 0).all()
    assert float(ta) > 0


# ---------------------------------------------------------------------------
# parameters
# ---------------------------------------------------------------------------


def test_params_from_jax_carries_moe_subtree_bitwise(model):
    """Tolerance: none; the f32 router stays f32, the experts bf16."""
    name, by_dtype = model
    _, jp, _, tp = by_dtype["bfloat16"]
    tree = jax.tree.map(np.asarray, jp)
    leaves = dict(_flat(tp))
    for path, a in _flat(tree):
        back = tensor_to_numpy(leaves[path])
        assert back.shape == a.shape, path
        assert np.array_equal(back, a.view(np.uint16) if a.dtype.name == "bfloat16" else a), path
    if name != "phi-3-vision-4.2b":
        assert leaves[("layers", "moe", "router")].dtype == torch.float32
        assert leaves[("layers", "moe", "w_gate")].dtype == torch.bfloat16
    assert (("layers", "mlp", "w_up") in leaves) == (name != "grok-1-314b")


def test_init_params_matches_jax_tree(model):
    """The port's own init: the reference's tree, shapes and dtypes (the
    expert stacks [L, E, d, ff] as the reference's vmap stacks them)."""
    _, by_dtype = model
    jb, jp, tb, _ = by_dtype["bfloat16"]
    mine = dict(_flat(tb.init_params(torch.Generator().manual_seed(0))))
    ref = dict(_flat(jax.tree.map(np.asarray, jp)))
    assert mine.keys() == ref.keys()
    for path, a in ref.items():
        assert tuple(mine[path].shape) == a.shape, path
        assert str(mine[path].dtype).removeprefix("torch.") == a.dtype.name, path


# ---------------------------------------------------------------------------
# transformer entry points
# ---------------------------------------------------------------------------


def _patch_batch(cfg, tokens, rng):
    """(JAX batch, port batch, P) for ``prefill``: the VLM config gets P
    seeded patch embeddings in front of the tokens."""
    jbatch, tbatch = {"tokens": jnp.asarray(tokens)}, {"tokens": torch.from_numpy(tokens)}
    P = cfg.frontend_len
    if P:
        pe = rng.normal(size=(tokens.shape[0], P, cfg.d_model)).astype(np.float32)
        jbatch["patch_embeds"], tbatch["patch_embeds"] = jnp.asarray(pe), torch.from_numpy(pe)
    return jbatch, tbatch, P


def test_prefill_and_decode_steps_match_jax(model):
    """prefill (VLM: patch prefix, decode from position P + S) and three
    dense decode steps: prefill logits within 1e-4, caches within one bf16
    step, decode logits within 1e-3 (measured max |d| 3.1e-4 on
    phi-3-vision): the dense cache is bf16 in both packages, and a KV entry
    whose f32 values straddle a bf16 rounding boundary is one bf16 step
    apart in the two caches."""
    _, by_dtype = model
    jb, jp, tb, tp = by_dtype["float32"]
    cfg = jb.cfg
    rng = np.random.default_rng(11)
    tokens = rng.integers(0, 64, (3, 12)).astype(np.int32)
    jbatch, tbatch, P = _patch_batch(cfg, tokens, rng)
    jl, jc = jax_tf.prefill(jp, cfg, jbatch, 48)
    tl, tc = tb.prefill_fn(tp, tbatch, 48)
    np.testing.assert_allclose(t2n(tl), np32(jl), rtol=1e-4, atol=1e-4)
    np.testing.assert_array_equal(tc["pos"].numpy(), np.asarray(jc["pos"]))
    assert int(tc["pos"].max()) == P + 11
    pos = np.full(3, P + 12, np.int32)
    for _ in range(3):
        for key in ("k", "v"):
            np.testing.assert_allclose(t2n(tc[key]), np32(jc[key]), rtol=1e-2, atol=1e-2)
        nxt = np.asarray(jl).argmax(-1).astype(np.int32)
        jl, jc = jax_tf.decode_step(jp, cfg, jc, jnp.asarray(nxt), jnp.asarray(pos))
        tl, tc = tb.decode_fn(tp, tc, torch.from_numpy(nxt), torch.from_numpy(pos.copy()))
        np.testing.assert_allclose(t2n(tl), np32(jl), rtol=1e-3, atol=1e-3)
        assert (t2n(tl).argmax(-1) == np.asarray(jl).argmax(-1)).all()
        pos += 1


def test_prefill_collect_matches_jax(model):
    """The monolithic paged prefill with right-padded rows (valid_len) and,
    for the VLM, the patch prefix: logits at P + valid_len - 1 and the full
    collected KV within 1e-4."""
    _, by_dtype = model
    jb, jp, tb, tp = by_dtype["float32"]
    cfg = jb.cfg
    rng = np.random.default_rng(12)
    tokens = rng.integers(0, 64, (2, 16)).astype(np.int32)
    jbatch, tbatch, P = _patch_batch(cfg, tokens, rng)
    jbatch["valid_len"], tbatch["valid_len"] = jnp.asarray([16, 9]), torch.tensor([16, 9])
    jl, jk, jv = jax_tf.prefill_collect(jp, cfg, jbatch)
    tl, tk, tv = tb.prefill_collect_fn(tp, tbatch)
    assert tuple(tk.shape) == jk.shape and tk.shape[2] == P + 16
    np.testing.assert_allclose(t2n(tl), np32(jl), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(t2n(tk), np32(jk), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(t2n(tv), np32(jv), rtol=1e-4, atol=1e-4)


def _paged_state(cfg, rng, B, plen, tail=None):
    L, KV, Dh, page = cfg.num_layers, cfg.num_kv_heads, cfg.resolved_head_dim, 4
    nb = max(1, -(-max(plen) // page))
    N = B * nb
    st = {
        "k_pages": rng.normal(size=(L, KV, N, page, Dh)).astype(np.float32),
        "v_pages": rng.normal(size=(L, KV, N, page, Dh)).astype(np.float32),
        "block_tables": rng.permutation(N).reshape(B, nb).astype(np.int32),
        "prefix_len": np.asarray(plen, np.int32),
    }
    if tail is not None:
        T, used = tail
        st["k_tail"] = rng.normal(size=(L, B, T, KV, Dh)).astype(np.float32)
        st["v_tail"] = rng.normal(size=(L, B, T, KV, Dh)).astype(np.float32)
        tp = np.full((B, T), -1, np.int32)
        for b in range(B):
            tp[b, : used[b]] = plen[b] + np.arange(used[b])
        st["tail_pos"] = tp
    return st


def test_prefill_chunk_matches_jax(model):
    """One prefill chunk over paged prefixes: the chunk's KV within 1e-4
    (layer 1's KV carries layer 0's MoE, dispatched over all B * C tokens)."""
    _, by_dtype = model
    jb, jp, tb, tp = by_dtype["float32"]
    cfg = jb.cfg
    rng = np.random.default_rng(13)
    plen = [8, 0, 12]
    st = _paged_state(cfg, rng, 3, plen)
    tokens = rng.integers(0, 64, (3, 8)).astype(np.int32)
    pos = (np.asarray(plen)[:, None] + np.arange(8)[None]).astype(np.int32)
    jk, jv = jax_tf.prefill_chunk(jp, cfg, {k: jnp.asarray(v) for k, v in st.items()},
                                  jnp.asarray(tokens), jnp.asarray(pos))
    tk, tv = tb.prefill_chunk_fn(tp, {k: torch.from_numpy(v) for k, v in st.items()},
                                 torch.from_numpy(tokens), torch.from_numpy(pos))
    np.testing.assert_allclose(t2n(tk), np32(jk), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(t2n(tv), np32(jv), rtol=1e-4, atol=1e-4)


def test_paged_decode_step_matches_jax(model):
    """Three paged decode steps of 4 rows: logits within 1e-4, tails and
    tail positions equal (the reference maps the rows one by one off the
    TPU, so each row's MoE is dispatched alone, as the port's is)."""
    _, by_dtype = model
    jb, jp, tb, tp = by_dtype["float32"]
    cfg = jb.cfg
    rng = np.random.default_rng(14)
    plen = [8, 4, 12, 0]
    used = [2, 0, 5, 1]
    st = _paged_state(cfg, rng, 4, plen, tail=(8, used))
    js = {k: jnp.asarray(v) for k, v in st.items()}
    ts = {k: torch.from_numpy(v) for k, v in st.items()}
    toks = rng.integers(0, 64, 4).astype(np.int32)
    pos = (np.asarray(plen) + np.asarray(used)).astype(np.int32)
    for _ in range(3):
        jl, js = jax_tf.paged_decode_step(jp, cfg, js, jnp.asarray(toks), jnp.asarray(pos))
        tl, ts = tb.paged_decode_fn(tp, ts, torch.from_numpy(toks), torch.from_numpy(pos.copy()))
        np.testing.assert_allclose(t2n(tl), np32(jl), rtol=1e-4, atol=1e-4)
        np.testing.assert_array_equal(ts["tail_pos"].numpy(), np.asarray(js["tail_pos"]))
        np.testing.assert_allclose(t2n(ts["k_tail"]), np32(js["k_tail"]), rtol=1e-4, atol=1e-4)
        toks = np.asarray(jl).argmax(-1).astype(np.int32)
        pos = pos + 1


# ---------------------------------------------------------------------------
# the capacity coupling, in both packages
# ---------------------------------------------------------------------------


def test_capacity_couples_requests_in_both_packages():
    """One request alone and behind another in the same call: its expert
    slots go first to the batch-mate's tokens, so some of its assignments
    drop and its logits change, in the reference and in the port alike; the
    port's slot tables equal the reference's in both compositions."""
    jcfg = reduced(get_config("grok-1-314b"))
    tcfg = t_reduced(t_get_config("grok-1-314b"))
    jp = jax.tree.map(lambda a: a.astype(jnp.float32), jax_build_model(jcfg).init_params(
        jax.random.PRNGKey(0)))
    tp = params_from_jax(jax.tree.map(np.asarray, jp), "cpu")
    rng = np.random.default_rng(21)
    mine = rng.integers(0, 64, (1, 16)).astype(np.int32)
    other = rng.integers(0, 64, (1, 16)).astype(np.int32)
    pair = np.concatenate([other, mine])

    # the dispatch of the first layer's MoE input, alone and in the pair
    emb = np.asarray(jp["embed"])
    lp = jax.tree.map(lambda a: a[0], jp["layers"])
    for rows in (mine, pair):
        x = emb[rows.reshape(-1)]  # layer 0's MoE sees embeddings after attention; any x will do
        T = x.shape[0]
        C = jax_moe.capacity_for(jcfg, T)
        (jt, jg, _), (tt, tg, _) = _both_dispatch(x, np.asarray(lp["moe"]["router"]), 2, C)
        np.testing.assert_array_equal(tt, jt)
        np.testing.assert_allclose(tg, jg, rtol=0, atol=1e-6)

    j_alone = np32(jax_tf.prefill(jp, jcfg, {"tokens": jnp.asarray(mine)}, 32)[0])[0]
    j_pair = np32(jax_tf.prefill(jp, jcfg, {"tokens": jnp.asarray(pair)}, 32)[0])[1]
    t_alone = t2n(t_tf.prefill(tp, tcfg, {"tokens": torch.from_numpy(mine)}, 32)[0])[0]
    t_pair = t2n(t_tf.prefill(tp, tcfg, {"tokens": torch.from_numpy(pair)}, 32)[0])[1]
    assert np.abs(j_alone - j_pair).max() > 1e-2, "the reference's capacity did not bind"
    np.testing.assert_allclose(t_alone, j_alone, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(t_pair, j_pair, rtol=1e-4, atol=1e-4)


# ---------------------------------------------------------------------------
# the paged engine
# ---------------------------------------------------------------------------


def _projection(log):
    out = {}
    for e in log.events:
        if e.request_id is not None and e.name not in TIMED:
            out.setdefault(e.request_id, []).append((e.name, dict(e.payload)))
    return out


def test_paged_engine_matches_jax(model):
    """Greedy tokens, cached-token counts and the projected per-request
    event stream of two ``run_batch`` calls (the second descends the radix
    index onto the first's pages), and pre-decode logits within 1e-4, equal
    to the JAX engine's at the same batch composition (f32 weights)."""
    _, by_dtype = model
    jb, jp, tb, tp = by_dtype["float32"]
    kw = dict(block_size=4, device_blocks=64)
    je = JaxEngine(jb, jp, cache_len=64, **kw)
    te = ServingEngine(tb, tp, device="cpu", **kw)
    prompts = [PREFIX + (30, 31), PREFIX + (40, 41, 42), tuple(range(100, 137)),
               tuple(range(200, 216))]
    jr = je.run_batch([je.submit(p, max_new_tokens=5) for p in prompts])
    tr = te.run_batch([te.submit(p, max_new_tokens=5) for p in prompts])
    jr += je.run_batch([je.submit(PREFIX + (50, 51), max_new_tokens=5)])
    tr += te.run_batch([te.submit(PREFIX + (50, 51), max_new_tokens=5)])
    for a, b in zip(jr, tr):
        assert (b.status, b.output_tokens, b.cached_tokens) == (a.status, a.output_tokens, a.cached_tokens)
        assert b.status == "finished" and len(b.output_tokens) == 5
    assert tr[-1].cached_tokens == len(PREFIX)
    assert _projection(te.events) == _projection(je.events)
    prompt = tuple(range(300, 340))
    np.testing.assert_allclose(te.prefill_logits(prompt), je.prefill_logits(prompt),
                               rtol=1e-4, atol=1e-4)
    te.close()
    je.close()


def test_dense_and_paged_prefill_differ_under_capacity():
    """The dense mode's prefill runs the whole prompt in one MoE call
    (capacity from T = 40), the paged mode's in chunks of 32 and then row
    by row (capacity from T = 32 and from T = 1), so their logits differ in
    the reference itself far beyond rounding: by more than 1e-2 where the
    logits are of order 0.1 (measured max |d| 0.169).  The port reproduces
    each mode within 1e-4."""
    jcfg = small(reduced, get_config("grok-1-314b"))
    jb = jax_build_model(jcfg)
    jp = jax.tree.map(lambda a: a.astype(jnp.float32), jb.init_params(jax.random.PRNGKey(0)))
    tb = build_model(small(t_reduced, t_get_config("grok-1-314b")), device="cpu")
    tp = params_from_jax(jax.tree.map(np.asarray, jp), "cpu")
    prompt = tuple(range(300, 340))
    logits = {}
    for mode in ("dense", "paged"):
        kw = dict(block_size=4, device_blocks=64, cache_len=64, decode_mode=mode)
        with JaxEngine(jb, jp, **kw) as je, ServingEngine(tb, tp, device="cpu", **kw) as te:
            logits[mode] = je.prefill_logits(prompt)
            np.testing.assert_allclose(te.prefill_logits(prompt), logits[mode], rtol=1e-4, atol=1e-4)
    assert np.abs(logits["dense"] - logits["paged"]).max() > 1e-2

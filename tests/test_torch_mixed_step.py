"""The fused step on the CPU: ``transformer.paged_mixed_step`` (the decode
rows and a prefill chunk in one launch) and ``StepLoop._fused_step``.

Reduced qwen3-1.7b and reduced grok-1-314b (MoE: each decode row its own
group, the chunk one group), the JAX package's parameters bridged by
``params_from_jax``; every input is made with numpy from a seed.

* The fused launch against the port's two launches (``prefill_chunk``,
  the chunk's completed blocks written into their pages as the pool stores
  them, then ``paged_decode_step``) on a scene where one decode row joins:
  its block table names two pages that the chunk writes in the same
  launch.  Logits, tails, tail positions, ``(ck, cv)`` and the page store
  after the step: float32 within a relative 1e-6 (measured 0), bfloat16
  bitwise, on one thread.
* The fused launch against the JAX package's two functions on the same
  scene: float32 within 1e-4, the tolerance of the port's other
  cross-framework paged tests (tests/test_torch_moe.py).
* ``both(pkgs, ...)`` (the shared harness of
  tests/test_torch_failure_paths.py, reduced qwen3 in float32): a burst
  beside live decode rows, with fused steps and fused join steps in the
  port; a launch failure inside a fused step on each side (K2, K1, and the
  projection, which is shared code), each against the reference with the
  matching launch stubbed; a pool too small to reserve without eviction,
  where the chunk steps run split.  The events, tokens, refcounts and
  ``fail_closed_total()`` equal the reference's.
* The port's engine with the fused route against the same engine with it
  off (``_step_mixed = None``): tokens, events (block slots included) and
  page bytes bitwise, at reduced qwen3 and reduced grok in bfloat16.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro_torch.kernels.gemm as gemm_lib
import repro_torch.kernels.paged_attention as pa
import repro_torch.models.layers as layers
from repro.configs import get_config, reduced
from repro.models import transformer as jax_tf
from repro.models.registry import build_model as jax_build_model
from repro_torch.configs import get_config as t_get_config
from repro_torch.configs import reduced as t_reduced
from repro_torch.models.registry import build_model
from repro_torch.models.transformer import MixedStepError
from repro_torch.params import params_from_jax
from repro_torch.serving import scheduler_loop
from repro_torch.serving.engine import ServingEngine
from test_torch_failure_paths import both, observe, pkgs  # noqa: F401  (fixture)
from torch_one_thread import one_torch_thread  # noqa: F401  (autouse fixture)

ARCHS = ["qwen3-1.7b", "grok-1-314b"]
PAGE = 4


@pytest.fixture(scope="module", params=ARCHS)
def model(request):
    """(jax bundle, {dtype: (jax params, port bundle, port params)})."""
    jb = jax_build_model(reduced(get_config(request.param)))
    jp = jb.init_params(jax.random.PRNGKey(0))
    tb = build_model(t_reduced(t_get_config(request.param)), device="cpu")
    out = {}
    for dtype in ("bfloat16", "float32"):
        p = jp if dtype == "bfloat16" else jax.tree.map(lambda a: a.astype(jnp.float32), jp)
        out[dtype] = (p, tb, params_from_jax(jax.tree.map(np.asarray, p), "cpu"))
    return jb, out


def _scene(cfg, dtype, join=True):
    """A step's operands as numpy: three decode rows over their pages and
    tails, a [2, 8] chunk at prefix 8 that completes blocks 2-3 of both its
    rows (into free pages 10-13), and a fourth decode row that joins with
    the chunk's first row: its table names pages 10 and 11, and it replays
    the prompt's last token (position 15) over a prefix of 15.  Without
    ``join`` the fourth row is one more decode row over pages 14-15, and
    the launch writes the pages after its layer loop."""
    rng = np.random.default_rng(7)
    L, KV, Dh = cfg.num_layers, cfg.num_kv_heads, cfg.resolved_head_dim
    N, T, W, B, C = 24, 8, 4, 2, 8
    pages = lambda: rng.normal(size=(L, KV, N, PAGE, Dh)).astype(np.float32)
    state = {
        "k_pages": pages(),
        "v_pages": pages(),
        "block_tables": np.asarray([[4, 5, 0, 0], [6, 7, 8, 0], [9, 0, 0, 0], [0, 1, 10, 11]],
                                   np.int32),
        "prefix_len": np.asarray([7, 12, 3, 15], np.int32),
        "k_tail": rng.normal(size=(L, W, T, KV, Dh)).astype(np.float32),
        "v_tail": rng.normal(size=(L, W, T, KV, Dh)).astype(np.float32),
    }
    used = [2, 1, 3, 0]
    tp = np.full((W, T), -1, np.int32)
    for b in range(W):
        tp[b, : used[b]] = state["prefix_len"][b] + np.arange(used[b])
    state["tail_pos"] = tp
    ctoks = rng.integers(0, cfg.vocab_size, (B, C)).astype(np.int32)
    toks = rng.integers(0, cfg.vocab_size, W).astype(np.int32)
    toks[3] = ctoks[0, 7]
    chunk = {
        "tokens": ctoks,
        "positions": (8 + np.arange(C, dtype=np.int32))[None].repeat(B, 0),
        "block_tables": np.asarray([[0, 1, 0, 0], [2, 3, 0, 0]], np.int32),
        "prefix_len": np.full(B, 8, np.int32),
        "write_blocks": np.asarray([0, 1, 2, 3], np.int64),
        "write_pages": np.asarray([10, 11, 12, 13], np.int64),
        "rows_join": join,
    }
    if not join:
        state["block_tables"][3] = [14, 15, 0, 0]
    cur = (state["prefix_len"] + np.asarray(used)).astype(np.int32)
    if dtype == "bfloat16":  # the store and tails in the activations' type
        for key in ("k_pages", "v_pages", "k_tail", "v_tail"):
            state[key] = np.asarray(jnp.asarray(state[key], jnp.bfloat16).astype(jnp.float32))
    return state, toks, cur, chunk


def _store_blocks(k_pages, v_pages, ck, cv, chunk):
    """What the pool's stores write between the two launches: each
    completed block of the chunk into its page (numpy, every layer)."""
    C = ck.shape[2]
    for blk, page in zip(chunk["write_blocks"], chunk["write_pages"]):
        b, j = divmod(int(blk), C // PAGE)
        k_pages[:, :, page] = ck[:, b, j * PAGE:(j + 1) * PAGE].transpose(0, 2, 1, 3)
        v_pages[:, :, page] = cv[:, b, j * PAGE:(j + 1) * PAGE].transpose(0, 2, 1, 3)


def _t(a, dtype=None):
    t = torch.from_numpy(np.array(a))
    return t.to(dtype) if dtype is not None and t.is_floating_point() else t


def _port_split_and_fused(tb, tp, scene, dtype):
    """(split, fused) outputs of the port: each (logits, state, ck, cv)."""
    state, toks, cur, chunk = scene
    td = getattr(torch, dtype)
    ts = {k: _t(v, td) for k, v in state.items()}
    tc = {k: _t(v) if isinstance(v, np.ndarray) else v for k, v in chunk.items()}
    split = dict(ts, k_pages=ts["k_pages"].clone(), v_pages=ts["v_pages"].clone())
    ck, cv = tb.prefill_chunk_fn(
        tp, dict(split, block_tables=tc["block_tables"], prefix_len=tc["prefix_len"]),
        tc["tokens"], tc["positions"])
    for blk, page in zip(chunk["write_blocks"], chunk["write_pages"]):  # the pool's stores
        b, j = divmod(int(blk), 2)
        split["k_pages"][:, :, page] = ck[:, b, j * PAGE:(j + 1) * PAGE].permute(0, 2, 1, 3)
        split["v_pages"][:, :, page] = cv[:, b, j * PAGE:(j + 1) * PAGE].permute(0, 2, 1, 3)
    lg, st = tb.paged_decode_fn(tp, split, _t(toks), _t(cur))
    fused = dict(ts, k_pages=ts["k_pages"].clone(), v_pages=ts["v_pages"].clone())
    flg, fst, fck, fcv = tb.mixed_step_fn(tp, fused, _t(toks), _t(cur), tc)
    return (lg, st, ck, cv, split), (flg, fst, fck, fcv, fused)


@pytest.mark.parametrize("join", [True, False], ids=["join", "no-join"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mixed_step_equals_the_two_launches(model, dtype, join):
    """Tolerance: float32 a relative 1e-6 with no absolute slack (measured
    0); bfloat16 none (bitwise)."""
    jb, by_dtype = model
    _, tb, tp = by_dtype[dtype]
    (lg, st, ck, cv, sp), (flg, fst, fck, fcv, fp) = _port_split_and_fused(
        tb, tp, _scene(jb.cfg, dtype, join), dtype)
    pairs = [(flg, lg), (fst["k_tail"], st["k_tail"]), (fst["v_tail"], st["v_tail"]),
             (fck, ck), (fcv, cv), (fp["k_pages"], sp["k_pages"]), (fp["v_pages"], sp["v_pages"])]
    assert torch.equal(fst["tail_pos"], st["tail_pos"])
    for got, want in pairs:
        assert got.dtype == want.dtype and got.shape == want.shape
        if dtype == "bfloat16":
            assert torch.equal(got, want)
        else:
            np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-6, atol=0)
    # the joining row read the pages the chunk wrote in the same launch
    before = _t(_scene(jb.cfg, dtype)[0]["k_pages"][:, :, 10], fp["k_pages"].dtype)
    assert not torch.equal(fp["k_pages"][:, :, 10], before)


def test_mixed_step_matches_jax(model):
    """The fused launch against the JAX package's ``prefill_chunk``, the
    blocks' stores and ``paged_decode_step``, float32: logits, tails,
    ``(ck, cv)`` and pages within 1e-4."""
    jb, by_dtype = model
    jp, tb, tp = by_dtype["float32"]
    cfg = jb.cfg
    state, toks, cur, chunk = scene = _scene(cfg, "float32")
    js = {k: v.copy() for k, v in state.items()}
    jck, jcv = jax_tf.prefill_chunk(
        jp, cfg, {k: jnp.asarray(js[k]) for k in ("k_pages", "v_pages")}
        | {"block_tables": jnp.asarray(chunk["block_tables"]),
           "prefix_len": jnp.asarray(chunk["prefix_len"])},
        jnp.asarray(chunk["tokens"]), jnp.asarray(chunk["positions"]))
    jck, jcv = np.asarray(jck, np.float32), np.asarray(jcv, np.float32)
    _store_blocks(js["k_pages"], js["v_pages"], jck, jcv, chunk)
    jl, jst = jax_tf.paged_decode_step(jp, cfg, {k: jnp.asarray(v) for k, v in js.items()},
                                       jnp.asarray(toks), jnp.asarray(cur))
    _, (flg, fst, fck, fcv, fp) = _port_split_and_fused(tb, tp, scene, "float32")
    tol = dict(rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(flg.numpy(), np.asarray(jl, np.float32), **tol)
    np.testing.assert_array_equal(fst["tail_pos"].numpy(), np.asarray(jst["tail_pos"]))
    for key in ("k_tail", "v_tail"):
        np.testing.assert_allclose(fst[key].numpy(), np.asarray(jst[key], np.float32), **tol)
    np.testing.assert_allclose(fck.numpy(), jck, **tol)
    np.testing.assert_allclose(fcv.numpy(), jcv, **tol)
    np.testing.assert_allclose(fp["k_pages"].numpy(), js["k_pages"], **tol)
    np.testing.assert_allclose(fp["v_pages"].numpy(), js["v_pages"], **tol)


@pytest.mark.parametrize("target,side", [("paged_prefill_attention", "chunk"),
                                         ("paged_decode_attention", "decode"),
                                         ("gemm", "shared")])
def test_mixed_step_names_the_side_that_raised(model, monkeypatch, target, side):
    """bfloat16, where the projections take the GEMM."""
    jb, by_dtype = model
    _, tb, tp = by_dtype["bfloat16"]
    state, toks, cur, chunk = _scene(jb.cfg, "bfloat16")

    def boom(*a, **kw):
        raise RuntimeError("injected")

    monkeypatch.setattr(gemm_lib if target == "gemm" else pa, target, boom)
    with pytest.raises(MixedStepError) as e:
        tb.mixed_step_fn(tp, {k: _t(v, torch.bfloat16) for k, v in state.items()}, _t(toks),
                         _t(cur), {k: _t(v) if isinstance(v, np.ndarray) else v
                                   for k, v in chunk.items()})
    assert e.value.side == side and str(e.value.error) == "injected"


# ---------------------------------------------------------------------------
# the step loop against the reference (``both``)
# ---------------------------------------------------------------------------


class _FusedSteps:
    """Counts the port's fused steps and those in which rows joined."""

    def __init__(self):
        self.steps = self.joins = 0
        self._orig = scheduler_loop.StepLoop._fused_step

    def __enter__(self):
        rec = self

        def fused_step(loop, plan):
            rec.steps += 1
            rec.joins += bool(plan.joining)
            return rec._orig(loop, plan)

        scheduler_loop.StepLoop._fused_step = fused_step
        return self

    def __exit__(self, *exc):
        scheduler_loop.StepLoop._fused_step = self._orig


def _burst(pkg, **kw):
    """Three decode streams (one bucket) and a burst admitted beside them:
    two equal 20-token prompts (one bucket: the second stores no block the
    first stored), a 22-token prompt (its last two tokens feed after it
    joins) and a 36-token one."""
    eng = pkg.make(prefill_chunk=8, **kw)
    streams = [eng.submit(tuple(range(100 + 40 * i, 112 + 40 * i)), max_new_tokens=14)
               for i in range(3)]
    burst = [eng.submit(tuple(range(500, 520)), max_new_tokens=2),
             eng.submit(tuple(range(500, 520)), max_new_tokens=2),
             eng.submit(tuple(range(600, 622)), max_new_tokens=3),
             eng.submit(tuple(range(700, 736)), max_new_tokens=2)]
    return eng, streams + burst


def _burst_beside_live_rows(pkg):
    with _FusedSteps() as fused:
        eng, reqs = _burst(pkg, device_blocks=128)
        eng.run_batch(reqs)
    assert all(r.status == "finished" for r in reqs), [r.error for r in reqs]
    assert pkg.analyzer.check_step_interleave_order(eng.events).passed
    assert pkg.analyzer.check_metrics_reconcile(eng.events, eng.metrics).passed
    if pkg.name == "port":
        routes = eng.chunk_routes.as_dict()
        assert routes.get("fused", 0) == fused.steps > 0, routes
        assert fused.joins >= 3  # the last chunk of each burst job beside live rows
        assert len(eng.stage_seconds.samples(stage="mixed_step")) == fused.steps
    eng.pool.assert_consistent()
    out = observe(eng, reqs)
    eng.close()
    return out


def test_burst_beside_live_rows_matches_reference(pkgs):
    both(pkgs, _burst_beside_live_rows)


def _fail_from(fn, n, message):
    """``fn`` for its first ``n`` calls, then a function that raises."""
    calls = [0]

    def launch(*args):
        calls[0] += 1
        if calls[0] > n:
            raise RuntimeError(message)
        return fn(*args)

    return launch


def _fused_step_failure(pkg, side):
    """A (12 tokens) prefills alone and feeds; B's only chunk then rides
    beside A's first decode step, and B joins in that step.  The reference
    stubs the matching launch from that step on (its third chunk launch,
    its second decode launch, or both); the port stubs K2, K1 or the
    projection (``layers.proj``, the GEMM's entry; float32 takes ``x @ w``)
    inside the fused launch."""
    msg = "injected launch failure"
    eng = pkg.make(prefill_chunk=8)
    a = eng.submit(tuple(range(100, 112)), max_new_tokens=4)
    b = eng.submit(tuple(range(300, 308)), max_new_tokens=2)
    restore = []
    if pkg.name == "jax":
        if side in ("chunk", "shared"):
            eng._jit_prefill_chunk = _fail_from(eng._jit_prefill_chunk, 2, msg)
        if side in ("decode", "shared"):
            eng._jit_paged_decode = _fail_from(eng._jit_paged_decode, 1, msg)
    else:
        module, name = {"chunk": (pa, "paged_prefill_attention"),
                        "decode": (pa, "paged_decode_attention"),
                        "shared": (layers, "proj")}[side]
        real, inside = getattr(module, name), [False]

        def stub(*args, **kw):
            if inside[0]:
                raise RuntimeError(msg)
            return real(*args, **kw)

        mixed = eng._step_mixed

        def fused_launch(*args):
            inside[0] = True
            try:
                return mixed(*args)
            finally:
                inside[0] = False

        eng._step_mixed = fused_launch
        setattr(module, name, stub)
        restore.append(lambda: setattr(module, name, real))
    try:
        eng.run_batch([a, b])
    finally:
        for undo in restore:
            undo()
    want = {"chunk": ("finished", "error"), "decode": ("error", "error"),
            "shared": ("error", "error")}[side]
    assert (a.status, b.status) == want, (a.error, b.error)
    trigger = "decode_launch_failure" if side == "decode" else "prefill_launch_failure"
    assert trigger in b.error and msg in b.error
    assert all(r.ref == 0 for r in eng.pool.blocks.values())
    assert pkg.analyzer.check_step_interleave_order(eng.events).passed
    assert pkg.analyzer.check_metrics_reconcile(eng.events, eng.metrics).passed
    if pkg.name == "port":
        assert eng.chunk_routes.as_dict().get("fused") == 1
    eng.pool.assert_consistent()
    out = observe(eng, [a, b])
    eng.close()
    return out


@pytest.mark.parametrize("side", ["chunk", "decode", "shared"])
def test_fused_step_launch_failure_matches_reference(pkgs, side):
    both(pkgs, _fused_step_failure, side)


def _pool_without_free_slots(pkg):
    """18 blocks: the streams pin 9 and the burst's chunks soon need more
    than are free, so those steps run the chunk alone (route
    ``eviction``), evict unpinned blocks or refuse, as the reference."""
    eng, reqs = _burst(pkg, device_blocks=18)
    eng.run_batch(reqs)
    if pkg.name == "port":
        routes = eng.chunk_routes.as_dict()
        assert routes.get("eviction", 0) > 0 and routes.get("fused", 0) > 0, routes
    assert pkg.analyzer.check_step_interleave_order(eng.events).passed
    eng.pool.assert_consistent()
    out = observe(eng, reqs)
    eng.close()
    return out


def test_pool_without_free_slots_runs_split_as_reference(pkgs):
    both(pkgs, _pool_without_free_slots)


# ---------------------------------------------------------------------------
# fused against split within the port, bitwise
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ARCHS)
def test_fused_route_serves_the_split_routes_bits(arch):
    """bfloat16, seed-0 parameters: the engine with the fused route and
    the engine without it serve equal tokens, equal events (the
    ``block_stored`` slots included) and equal page bytes."""
    tb = build_model(t_reduced(t_get_config(arch)), device="cpu")
    params = tb.init_params(torch.Generator().manual_seed(0))
    got = {}
    for fused in (True, False):
        with ServingEngine(tb, params, device="cpu", block_size=PAGE, device_blocks=128,
                           cache_len=64, prefill_chunk=8) as eng:
            if not fused:
                eng._step_mixed = None
            streams = [eng.submit(tuple(range(100 + 40 * i, 112 + 40 * i)), max_new_tokens=8)
                       for i in range(5)]
            burst = [eng.submit(tuple(range(500 + 50 * i, 500 + 50 * i + n)), max_new_tokens=3)
                     for i, n in enumerate((20, 22, 36))]
            eng.run_batch(streams + burst)
            got[fused] = dict(
                tokens=[(r.status, tuple(r.output_tokens)) for r in streams + burst],
                events=[(e.name, e.request_id, tuple(sorted(
                    (k, str(v)) for k, v in e.payload.items())))
                    for e in eng.events.events if e.name not in ("stage_latency",)],
                pages=(eng.pool.k_pages.clone(), eng.pool.v_pages.clone()),
                routes=eng.chunk_routes.as_dict(),
            )
    assert got[True]["routes"].get("fused", 0) > 0
    assert got[False]["routes"].get("fused", 0) == 0
    assert got[True]["tokens"] == got[False]["tokens"]
    assert got[True]["events"] == got[False]["events"]
    assert all(torch.equal(a, b) for a, b in zip(got[True]["pages"], got[False]["pages"]))


def test_reserved_slots_are_the_slots_add_block_takes():
    """``BlockPool.reserve_pages`` takes the slots ``add_block`` would take,
    in its order, and emits nothing; given back they leave the free list as
    it was; a block stored with its slot adopts the bytes a launch wrote
    there (``page_written``) or copies its payload into it."""
    from repro_torch.core.events import EventLog
    from repro_torch.serving.kv_cache import BlockPool

    def pool():
        p = BlockPool(6, EventLog(), device="cpu")
        p.add_block((0,), "a", torch.zeros(2, 1, 1, 2), torch.zeros(2, 1, 1, 2), np.arange(1))
        return p

    taken = pool()
    want = [taken.add_block((i,), f"b{i}", torch.zeros(2, 1, 1, 2), torch.zeros(2, 1, 1, 2),
                            np.arange(1)).page_index for i in range(3)]
    p = pool()
    n_events = len(p._events.events)
    slots = p.reserve_pages(3, (2, 1, 1, 2), torch.float32)
    assert slots == want and len(p._events.events) == n_events
    p.release_pages(slots)
    assert p.reserve_pages(3, (2, 1, 1, 2), torch.float32) == want
    k = torch.arange(4, dtype=torch.float32).reshape(2, 1, 1, 2)
    p.k_pages[:, :, slots[0]] = 7.0
    kept = p.add_block((1,), "x", k, k, np.arange(1), page=slots[0], page_written=True)
    copied = p.add_block((2,), "y", k, -k, np.arange(1), page=slots[1])
    assert kept.page_index == slots[0] and torch.equal(kept.k, torch.full_like(k, 7.0))
    assert copied.page_index == slots[1] and torch.equal(copied.k, k)
    assert torch.equal(copied.v, -k)
    with pytest.raises(ValueError):
        p.reserve_pages(4, (2, 1, 1, 2), torch.float32)


def _empty_prompt_joins(pkg):
    """An empty prompt that asks for no token joins when its job's only
    chunk runs beside a live row: the reference retires it before the
    decode launch, so the port's step runs split (route
    ``retiring_row``), and no token is served."""
    eng = pkg.make(prefill_chunk=8)
    reqs = [eng.submit(tuple(range(100, 112)), max_new_tokens=4),
            eng.submit((), max_new_tokens=0), eng.submit((7,), max_new_tokens=0)]
    eng.run_batch(reqs)
    assert [r.output_tokens for r in reqs[1:]] == [[], []]
    if pkg.name == "port":
        assert eng.chunk_routes.as_dict().get("retiring_row") == 1
    out = observe(eng, reqs)
    eng.close()
    return out


def test_empty_prompt_joining_a_fused_step_matches_reference(pkgs):
    both(pkgs, _empty_prompt_joins)

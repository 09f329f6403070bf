"""The recurrent families' long cells (``repro_torch.bench.long_recurrent``,
smoke phase 21, ``scripts/torch_long_recurrent.py``) against the JAX
package on the CPU.

Reduced xlstm-350m (one group of 1 mLSTM + 1 sLSTM block) and hymba-1.5b
(2 heads over 1, window 16), float32 parameters bridged from the JAX init
(``params_from_jax``), 4,096-token prompts from a numpy seed (256 of
hymba's windows):

* prefill logits and every state leaf of two rows, port against JAX
  (logits 1e-4: measured max |d| 3.1e-7 xlstm, 2.8e-7 hymba; f32 leaves
  1e-4 absolute + relative: measured 9.5e-6 at most; hymba's bf16 ring one
  spacing, 2**-8: 5 of its 2048 keys round to the neighbouring bf16 value,
  9.8e-4);
* a snapshot claim over a 4,096-token prefix through both packages'
  ``SnapshotEngine``s: served from the device, offloaded, restored and
  served again (path A), and refused on a second engine (path B): equal
  ordered event projections, statuses, tokens and claim states;
* decode_32k's 128 rows tiled from the two rows' states, one step at
  position 4,096: xlstm's logits 1e-4 and states as the prefill's
  (measured 3.6e-7, 1.3e-5); hymba's logits 1e-2 and states 1e-3 of each
  leaf's norm (measured 8.4e-4 and 6.3e-5; fed the JAX states both sides
  still part by 4.1e-4): both packages cast the softmax weights to the
  bf16 ring's type before P.V, and over 128 rows some weight lies on a
  bf16 rounding boundary, as in h2o-danube's long_500k test;
* ``decode_fn`` at long_500k's position 524,287 (hymba over its 16-slot
  ring of seeded K/V beside the 4,096-token SSM state; xlstm from its
  state) within 1e-2, as h2o-danube's test (measured 1.9e-7 / 3.2e-4);
* the one-row sharded decode on a one-rank gloo mesh (``build_cell`` at
  global batch 1 for reduced qwen3-1.7b and hymba-1.5b, and hymba's
  ``long_500k`` cell) against the unsharded ``decode_fn``, the cache's
  placements still ``Shard`` on the one-rank axes;
* the cells' own code at a reduced size on the CPU (every check held, the
  cuts recorded, no kernel launched) and its row-variance trace.
"""
import tempfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core.analyzer as j_analyzer
from repro.configs import get_config, reduced
from repro.core.claims import ClaimMode as JClaimMode
from repro.models.registry import build_model as jax_build_model
from repro.serving.snapshot_engine import SnapshotEngine as JaxSnapshotEngine
from repro_torch.bench import long_recurrent as lr
from repro_torch.configs import get_config as t_get_config
from repro_torch.configs import reduced as t_reduced
from repro_torch.core import analyzer as t_analyzer
from repro_torch.core.claims import ClaimMode
from repro_torch.models.registry import build_model
from repro_torch.params import params_from_jax
from repro_torch.serving import snapshot_engine as tsnap
from repro_torch.serving.snapshot_engine import SnapshotEngine
from torch_one_thread import one_torch_thread  # noqa: F401  (autouse fixture)

ARCHS = ["xlstm-350m", "hymba-1.5b"]
S = 4096
LOGITS_ATOL = 1e-4
STATE_TOL = 1e-4
LONG_500K_ATOL = 1e-2  # tests/test_torch_long_context.py's h2o-danube limit
# decode: (logits atol, state tolerance: None = the prefill's, else relative to each leaf's norm)
DECODE_TOL = {"xlstm-350m": (1e-4, None), "hymba-1.5b": (1e-2, 1e-3)}
TIMED = {"stage_latency"}  # payloads carry wall-clock seconds


def _np(t):
    return t.float().numpy() if isinstance(t, torch.Tensor) else np.asarray(t, np.float32)


@pytest.fixture(scope="module", params=ARCHS)
def long_pair(request):
    """Both packages' reduced model over the same f32 parameters, and both
    prefills of two 4,096-token rows."""
    arch = request.param
    cfg = reduced(get_config(arch))
    jb = jax_build_model(cfg)
    jp = jax.tree.map(lambda a: a.astype(jnp.float32), jb.init_params(jax.random.PRNGKey(0)))
    tb = build_model(t_reduced(t_get_config(arch)), device="cpu")
    tp = params_from_jax(jax.tree.map(np.asarray, jp), "cpu")
    toks = np.random.default_rng(32).integers(0, cfg.vocab_size, (2, S)).astype(np.int32)
    cache_len = cfg.sliding_window or 1
    lj, sj = jax.jit(lambda p, b: jb.prefill_fn(p, b, cache_len))(jp, {"tokens": jnp.asarray(toks)})
    lt, st = tb.prefill_fn(tp, {"tokens": torch.from_numpy(toks)}, cache_len)
    return dict(arch=arch, cfg=cfg, jb=jb, jp=jp, tb=tb, tp=tp, toks=toks, lj=lj, sj=sj, lt=lt,
                st=st)


def _states_close(jstate, tstate, rel=None):
    """Same leaves in the JAX order, shapes and dtypes, values within
    STATE_TOL (absolute and relative; bf16 leaves, hymba's ring, one bf16
    spacing: 2**-8), or with ``rel`` within ``rel`` of each leaf's norm."""
    jleaves = jax.tree.leaves(jstate)
    tleaves = list(tsnap._flatten(tstate))
    assert len(jleaves) == len(tleaves)
    for a, (path, b) in zip(jleaves, tleaves):
        assert tuple(b.shape) == a.shape, path
        assert str(b.dtype).removeprefix("torch.") == a.dtype.name, path
        if rel is not None:
            a, b = _np(a), _np(b)
            assert np.linalg.norm(a - b) <= rel * max(np.linalg.norm(a), 1e-30), path
            continue
        tol = 2**-8 if a.dtype.name == "bfloat16" else STATE_TOL
        np.testing.assert_allclose(_np(b), _np(a), rtol=tol, atol=tol, err_msg=str(path))


def test_prefill_4096_tokens_matches_jax(long_pair):
    """Cell (a): two 4,096-token rows, last logits and every state leaf."""
    p = long_pair
    np.testing.assert_allclose(p["lt"].numpy(), np.asarray(p["lj"]), atol=LOGITS_ATOL, rtol=0)
    assert (p["lt"].argmax(-1).numpy() == np.asarray(p["lj"]).argmax(-1)).all()
    _states_close(p["sj"], p["st"])


def _jax_rows(p, idx):
    """The JAX state's rows ``idx`` on each leaf's batch axis (the port's
    axes, leaf for leaf in the JAX order)."""
    axes = [ax for _, ax in tsnap._flatten(tsnap._state_batch_axes(p["tb"]))]
    jaxes = jax.tree.unflatten(jax.tree.structure(p["sj"]), axes)
    return jax.tree.map(lambda ax, a: jnp.take(a, jnp.asarray(idx), axis=ax), jaxes, p["sj"])


def test_decode_128_rows_from_tiled_states_matches_jax(long_pair):
    """Cell (c): decode_32k's 128 rows tiled from the two rows' states,
    each with its own token, one step at position 4,096."""
    p = long_pair
    idx = np.arange(128) % 2
    tstate = lr.take_rows(p["tb"], p["st"], idx.tolist())
    jstate = _jax_rows(p, idx)
    tok = np.random.default_rng(4).integers(0, p["cfg"].vocab_size, 128).astype(np.int32)
    pos = np.full((128,), S, np.int32)
    lj, nj = jax.jit(p["jb"].decode_fn)(p["jp"], jstate, jnp.asarray(tok), jnp.asarray(pos))
    lt, nt = p["tb"].decode_fn(p["tp"], tstate, torch.from_numpy(tok), torch.from_numpy(pos))
    atol, rel = DECODE_TOL[p["arch"]]
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), atol=atol, rtol=0)
    assert (lt.argmax(-1).numpy() == np.asarray(lj).argmax(-1)).all()
    _states_close(nj, nt, rel)


def test_decode_at_long_500k_position_matches_jax(long_pair):
    """Cell (d): one decode at position 524,287: hymba over its 16-slot
    ring holding positions 524,272-524,287 (seeded K/V) beside row 0's
    4,096-token SSM state; xlstm from row 0's state."""
    p = long_pair
    cfg = p["cfg"]
    tstate = lr.take_rows(p["tb"], p["st"], [0])
    jstate = _jax_rows(p, [0])
    if cfg.sliding_window:
        W = cfg.sliding_window
        rng = np.random.default_rng(500)
        k = rng.normal(size=tuple(tstate["k"].shape)).astype(np.float32)
        v = rng.normal(size=tuple(tstate["v"].shape)).astype(np.float32)
        pos = np.arange(lr.LONG_500K - W, lr.LONG_500K, dtype=np.int32)
        ring = np.empty(W, np.int32)
        ring[pos % W] = pos
        jstate = dict(jstate, k=jnp.asarray(k, jstate["k"].dtype), v=jnp.asarray(v, jstate["v"].dtype),
                      pos=jnp.asarray(ring[None]))
        tstate = dict(tstate, k=torch.from_numpy(k).to(tstate["k"].dtype),
                      v=torch.from_numpy(v).to(tstate["v"].dtype), pos=torch.from_numpy(ring[None]))
    tok, cur = np.array([7], np.int32), np.array([lr.LONG_500K - 1], np.int32)
    lj, nj = p["jb"].decode_fn(p["jp"], jstate, jnp.asarray(tok), jnp.asarray(cur))
    lt, nt = p["tb"].decode_fn(p["tp"], tstate, torch.from_numpy(tok), torch.from_numpy(cur))
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), atol=LONG_500K_ATOL, rtol=0)
    assert int(lt.argmax()) == int(np.asarray(lj).argmax())
    if cfg.sliding_window:
        np.testing.assert_array_equal(nt["pos"].numpy(), np.asarray(nj["pos"]))


def _projection(log, key):
    out = {}
    for e in log.events:
        ident = getattr(e, key)
        if ident is not None and e.name not in TIMED:
            out.setdefault(ident, []).append((e.name, dict(e.payload)))
    return out


def _claim_scenario(eng, modes, analyzer, prefix, prompts, path):
    """Path A: materialize, serve from the device, offload, serve after the
    restore; path B: materialize, offload, a failed restore.  Returns what
    both packages must agree on."""
    claim = eng.accept_claim(prefix, modes.OFFLOADABLE)
    eng.materialize_claim(claim.claim_id)
    outs = []
    if path == "A":
        outs.append([(r.status, r.output_tokens, r.cached_tokens)
                     for r in eng.serve_batch(prompts, max_new_tokens=4)])
    eng.offload_claim(claim.claim_id)
    if path == "B":
        eng.connector.injection.resident_claim_load_failure = True
        eng.connector.injection.fail_claim_id = claim.claim_id
    reqs = eng.serve_batch(prompts if path == "A" else prompts[:1], max_new_tokens=4)
    outs.append([(r.status, r.output_tokens, r.cached_tokens, r.restored_tokens) for r in reqs])
    check = analyzer.check_observation_path if path == "A" else analyzer.check_failure_outcome_path
    verdict = check(eng.events, claim.claim_id, reqs[0].request_id)
    assert verdict.passed, verdict.reasons
    assert analyzer.validate_event_sequence(eng.events).passed
    return {"outs": outs, "state": claim.state.value,
            "requests": _projection(eng.events, "request_id"),
            "claims": _projection(eng.events, "claim_id"),
            "fail_closed": eng.fail_closed_total()}


@pytest.mark.parametrize("path", ["A", "B"])
def test_snapshot_claim_over_4096_tokens_matches_jax(long_pair, path):
    """Cell (b): a claim over a 4,096-token prefix, witness path A or B, in
    both packages' ``SnapshotEngine``s."""
    p = long_pair
    prefix = tuple(int(t) for t in p["toks"][0])
    prompts = [prefix + (3, 9), prefix + (11, 2)]
    with JaxSnapshotEngine(p["jb"], p["jp"]) as je:
        want = _claim_scenario(je, JClaimMode, j_analyzer, prefix, prompts, path)
    with SnapshotEngine(p["tb"], p["tp"], device="cpu") as te:
        got = _claim_scenario(te, ClaimMode, t_analyzer, prefix, prompts, path)
    assert got == want
    if path == "A":
        kept, restored = got["outs"]
        assert [o[1] for o in kept] == [o[1] for o in restored]
        assert restored[0][3] == S and got["state"] == "restored"
    else:
        assert got["outs"][0][0][:2] == ("refused", []) and got["state"] == "restoration_failed"


def test_one_row_sharded_decode_on_a_one_rank_mesh():
    """The one-row sharded decode on a one-rank gloo mesh: ``build_cell``
    at global batch 1 (reduced qwen3-1.7b and hymba-1.5b, and hymba's
    long_500k cell at position 524,287) gives the unsharded ``decode_fn``'s
    logits (f32 parameters, 1e-5), with the cache still laid out ``Shard``
    on the one-rank axes (``rules.placements``)."""
    import torch_dist_workers as W

    with tempfile.TemporaryDirectory() as d:
        W.run_ranks(W.one_row_decode_worker, 1, d)
        out = torch.load(f"{d}/rank0.pt")
    assert sorted(out) == ["hymba-1.5b decode_32k", "hymba-1.5b long_500k", "qwen3-1.7b decode_32k"]
    for name, r in out.items():
        assert r["got"].shape == r["want"].shape, name
        torch.testing.assert_close(r["got"], r["want"], rtol=1e-5, atol=1e-5, msg=name)
        assert any(pl.startswith("S(") for pl in r["placements"]), (name, r["placements"])


# ---------------------------------------------------------------- the cells' own code


@pytest.mark.parametrize("arch", ARCHS)
def test_cells_hold_at_reduced_size_on_cpu(arch):
    """``run_cells`` at 64 tokens, 3 rows and 8 decode rows on the CPU
    (plain versions): every check holds, the cuts are recorded, rows are
    bitwise across batch widths, and no kernel launches."""
    cfg = t_reduced(t_get_config(arch))
    bundle = build_model(cfg, device="cpu")
    params = bundle.init_params(torch.Generator().manual_seed(0))
    rec = lr.run_cells(bundle, params, cfg, 64, rows=3, decode_rows_=8, why="a CPU test",
                       log=lambda _: None)
    assert rec["checks"] and all(c["ok"] for c in rec["checks"])
    names = [c["name"] for c in rec["checks"]]
    assert "(b) path A tokens" in names and "(b) path B refused in order" in names
    assert [c["what"] for c in rec["cuts"]] == ["prompt tokens", "(a) prefill rows",
                                                "(c) decode rows"]
    assert rec["claim"]["row0_vs_b1"]["bitwise"] and rec["decode"]["b1"]["bitwise"]
    assert "sharded" not in rec["long_500k"]  # no mesh given
    assert all(not any(c.values()) for c in rec["launches"].values())


def test_row_variance_trace_names_the_first_differing_op():
    """``first_row_variant_op`` names the first op whose row 0 depends on
    the batch width (a sum over the rows: op 1, after the scaling), and
    none for a row-wise function."""
    x = torch.randn(1, 5, 8)

    def row_variant(t):
        return torch.tanh(t * 2.0 + t.sum(0, keepdim=True))

    out = lr.first_row_variant_op(row_variant, x, x.expand(3, 5, 8).contiguous(), 3)
    assert out["op"] == "aten.sum.dim_IntList" and out["index"] == 1 and out["of"] == 4, out
    row_wise = lr.first_row_variant_op(lambda t: torch.tanh(t * 2.0), x,
                                       x.expand(3, 5, 8).contiguous(), 3)
    assert row_wise["op"] is None and row_wise["of"] == 2

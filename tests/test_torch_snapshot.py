"""The port's ``SnapshotEngine`` against the JAX package's, on the CPU.

The four tests of tests/test_snapshot_claims.py and
tests/test_paged_decode.py::test_snapshot_serve_batch, run on the port for
both recurrent families at ``reduced()`` (xlstm-350m: one group of 1 mLSTM
+ 1 sLSTM block; hymba-1.5b: 2 heads over 1, head_dim 32, window 16), and
held against the JAX engine fed the same bridged parameters
(``params_from_jax``), prompts and claim scenarios:

* greedy tokens are equal (float32 weights: the comparison is about the
  algorithm; bf16 rounding at other places in the two frameworks could
  flip a near-tie argmax);
* per-request and per-claim (name, payload) event projections are equal,
  snapshot footprints and transfer byte counts included (the timed
  ``stage_latency`` payloads excepted, as in tests/test_torch_engine.py);
* witness paths A and B pass the port's analyzer;
* a decode-launch failure ends every batch member ``FINISHED_ERROR`` with
  ``decode_launch_failure``;
* within the port, bitwise (bf16, the serving dtype): a restored snapshot
  decodes the same greedy tokens as a cold prefill of the same prompt.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config, reduced
from repro.core.claims import ClaimMode as JClaimMode
from repro.models.registry import build_model as jax_build_model
from repro.serving.snapshot_engine import SnapshotEngine as JaxSnapshotEngine
from repro_torch.configs import get_config as t_get_config
from repro_torch.configs import reduced as t_reduced
from repro_torch.core.analyzer import (
    check_failure_outcome_path,
    check_metrics_reconcile,
    check_observation_path,
    validate_event_sequence,
)
from repro_torch.core.claims import ClaimMode, ClaimState
from repro_torch.models.registry import build_model
from repro_torch.params import params_from_jax
from repro_torch.serving.engine import ServingEngine
from repro_torch.serving.snapshot_engine import SnapshotEngine

ARCHS = ["xlstm-350m", "hymba-1.5b"]
PREFIX = tuple(range(10, 22))
TIMED = {"stage_latency"}  # payloads carry wall-clock seconds


@pytest.fixture(scope="module", params=ARCHS)
def pair(request):
    """{dtype: (jax bundle, jax params, port bundle, port params)}."""
    jb = jax_build_model(reduced(get_config(request.param)))
    jp = jb.init_params(jax.random.PRNGKey(0))
    tb = build_model(t_reduced(t_get_config(request.param)), device="cpu")
    out = {}
    for dtype in ("bfloat16", "float32"):
        p = jp if dtype == "bfloat16" else jax.tree.map(lambda a: a.astype(jnp.float32), jp)
        out[dtype] = (jb, p, tb, params_from_jax(jax.tree.map(np.asarray, p), "cpu"))
    return out


def engines(pair, dtype="float32"):
    jb, jp, tb, tp = pair[dtype]
    return JaxSnapshotEngine(jb, jp), SnapshotEngine(tb, tp, device="cpu")


def port_engine(pair, dtype="bfloat16"):
    _, _, tb, tp = pair[dtype]
    return SnapshotEngine(tb, tp, device="cpu")


def projection(log, key):
    """{id: [(name, payload), ...]} over events carrying that id."""
    out = {}
    for e in log.events:
        ident = getattr(e, key)
        if ident is not None and e.name not in TIMED:
            out.setdefault(ident, []).append((e.name, dict(e.payload)))
    return out


def _offloaded_claim(eng, modes=ClaimMode):
    claim = eng.accept_claim(PREFIX, modes.OFFLOADABLE)
    eng.materialize_claim(claim.claim_id)
    eng.offload_claim(claim.claim_id)
    return claim


def test_snapshot_path_a_observation(pair):
    """Witness path A over a snapshot claim: accepted with the
    state_at_token predicate, materialized, offloaded, restored for the
    request, and the port's analyzer passes; tokens and event projections
    equal the JAX engine's (f32 weights)."""
    je, te = engines(pair)
    jc = _offloaded_claim(je, JClaimMode)
    claim = te.accept_claim(PREFIX, ClaimMode.OFFLOADABLE)
    assert claim.predicate.kind == "state_at_token"
    te.materialize_claim(claim.claim_id)
    assert claim.state == ClaimState.MATERIALIZED
    te.offload_claim(claim.claim_id)
    assert claim.state == ClaimState.OFFLOADED

    req = te.serve(PREFIX + (30, 31), max_new_tokens=2)
    jreq = je.serve(PREFIX + (30, 31), max_new_tokens=2)
    assert req.status == "finished"
    assert req.restored_tokens == len(PREFIX)
    assert claim.state == ClaimState.RESTORED and jc.state.value == claim.state.value
    assert validate_event_sequence(te.events).passed
    v = check_observation_path(te.events, claim.claim_id, req.request_id)
    assert v.passed, v.reasons
    assert check_metrics_reconcile(te.events, te.metrics).passed
    assert (req.output_tokens, req.cached_tokens) == (jreq.output_tokens, jreq.cached_tokens)
    assert projection(te.events, "request_id") == projection(je.events, "request_id")
    assert projection(te.events, "claim_id") == projection(je.events, "claim_id")
    te.close()
    je.close()


def test_snapshot_restore_preserves_decode(pair):
    """Restored state is bit-identical: greedy decode after restore matches
    a cold prefill of the same prompt (bf16, within the port), and the f32
    tokens equal the JAX engine's."""
    prompt = PREFIX + (30, 31)
    with port_engine(pair) as cold_eng:
        cold = cold_eng.serve(prompt, max_new_tokens=3)
    with port_engine(pair) as eng:
        _offloaded_claim(eng)
        warm = eng.serve(prompt, max_new_tokens=3)
    assert warm.restored_tokens == len(PREFIX)
    assert warm.output_tokens == cold.output_tokens

    je, te = engines(pair)
    for eng, modes in ((te, ClaimMode), (je, JClaimMode)):
        _offloaded_claim(eng, modes)
    assert te.serve(prompt, max_new_tokens=3).output_tokens == je.serve(prompt, max_new_tokens=3).output_tokens
    te.close()
    je.close()


def test_snapshot_path_b_fail_closed(pair):
    """A same-claim restore failure is refused fail-closed in order, with
    no recompute fallback; event projections equal the JAX engine's."""
    je, te = engines(pair)
    out = {}
    for eng, modes in ((te, ClaimMode), (je, JClaimMode)):
        claim = _offloaded_claim(eng, modes)
        eng.connector.injection.resident_claim_load_failure = True
        eng.connector.injection.fail_claim_id = claim.claim_id
        out[eng is te] = (claim, eng.serve(PREFIX + (40, 41), max_new_tokens=2))
    claim, req = out[True]
    assert req.status == "refused"
    assert req.output_tokens == []  # fail-closed: no recompute fallback
    assert claim.state == ClaimState.RESTORATION_FAILED
    v = check_failure_outcome_path(te.events, claim.claim_id, req.request_id)
    assert v.passed, v.reasons
    e13 = te.events.named("scheduler_active_request_refused")[0]
    assert e13.payload["blocking_claim_ids"] == [claim.claim_id]
    assert (req.status, req.error) == (out[False][1].status, out[False][1].error)
    assert projection(te.events, "request_id") == projection(je.events, "request_id")
    assert projection(te.events, "claim_id") == projection(je.events, "claim_id")
    assert te.fail_closed_total() == je.fail_closed_total()
    te.close()
    je.close()


def test_snapshot_decode_launch_failure_fails_closed(pair):
    """A decode-step exception must not strand any batch member
    non-terminal: every request ends FINISHED_ERROR through the ordered
    refusal path with ``decode_launch_failure`` attribution, and
    serve_batch itself does not raise."""
    eng = port_engine(pair)

    def boom(params, state, toks, pos):
        raise RuntimeError("injected decode launch failure")

    eng._step_decode = boom
    reqs = eng.serve_batch([PREFIX + (30,), PREFIX + (40,)], max_new_tokens=2)
    assert len(reqs) == 2
    for r in reqs:
        assert r.status == "error"
        assert r.error.startswith("decode_launch_failure:")
        fin = [e for e in eng.events.named("request_finished") if e.request_id == r.request_id]
        assert fin and fin[0].payload["status"] == "FINISHED_ERROR"
        wit = [e for e in eng.events.named("fail_closed_refused") if e.request_id == r.request_id]
        assert wit and wit[0].payload["trigger"] == "decode_launch_failure"
        assert wit[0].payload["scope"] == "decode_step"
    assert eng.fail_closed_total() == {"decode_launch_failure": 2}
    assert validate_event_sequence(eng.events).passed
    eng.close()


def test_snapshot_serve_batch(pair):
    """Snapshot serving decodes a whole batch with states stacked on the
    batch axis through the shared greedy loop: the claim restores once,
    every batch-mate reuses it device-side, and the f32 tokens and event
    projections equal the JAX engine's."""
    je, te = engines(pair)
    prompts = [PREFIX + (30 + i, 31 + i) for i in range(3)]
    out = {}
    for eng, modes in ((te, ClaimMode), (je, JClaimMode)):
        _offloaded_claim(eng, modes)
        out[eng is te] = eng.serve_batch(prompts, max_new_tokens=3)
    reqs = out[True]
    assert [r.status for r in reqs] == ["finished"] * 3
    assert reqs[0].restored_tokens == len(PREFIX)
    assert all(r.cached_tokens == len(PREFIX) for r in reqs)
    assert all(len(r.output_tokens) == 3 for r in reqs)
    assert te.events.named("batch_scheduled")
    assert validate_event_sequence(te.events).passed
    assert [r.output_tokens for r in reqs] == [r.output_tokens for r in out[False]]
    assert projection(te.events, "request_id") == projection(je.events, "request_id")
    assert projection(te.events, "claim_id") == projection(je.events, "claim_id")
    te.close()
    je.close()


def test_snapshot_disk_tier_restore_bitwise(pair):
    """A claim offloaded straight to the disk tier restores the same bytes:
    the restored payload equals the materialized one, and the restored
    engine's tokens equal a never-offloaded engine's (bf16)."""
    prompt = PREFIX + (30, 31)
    with port_engine(pair) as keep:
        c = keep.accept_claim(PREFIX, ClaimMode.OFFLOADABLE)
        before = keep.materialize_claim(c.claim_id).k.clone()
        kept = keep.serve(prompt, max_new_tokens=3)
        assert kept.cached_tokens == len(PREFIX) and kept.restored_tokens == 0
    with port_engine(pair) as eng:
        c = eng.accept_claim(PREFIX, ClaimMode.OFFLOADABLE)
        eng.materialize_claim(c.claim_id)
        assert eng.offload_claim(c.claim_id, tier="disk")
        warm = eng.serve(prompt, max_new_tokens=3)
        assert c.state == ClaimState.RESTORED
        (blk,) = eng._claim_device_blocks(c)
        assert torch.equal(blk.k, before)
    assert warm.output_tokens == kept.output_tokens


def test_serving_engine_takes_the_dense_mode_for_recurrent_bundles(pair):
    """A recurrent bundle has no paged entry points, so ``ServingEngine``
    asked for the paged mode takes the dense one, as the JAX engine does."""
    _, _, tb, tp = pair["bfloat16"]
    assert tb.paged_decode_fn is None and tb.prefill_collect_fn is None
    with ServingEngine(tb, tp, block_size=4, device_blocks=16, device="cpu") as eng:
        assert eng.decode_mode == "dense"

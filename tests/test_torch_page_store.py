"""The port's page store lives on the engine's device, and the paged
kernels read the pool's own tensors (``ServingEngine._device_pages`` is the
identity the reference's docstring names for an accelerator).

(a) The store sits on the engine's device, and every ``_device_pages()``
    call returns the pool's own ``k_pages``/``v_pages`` (same tensors, same
    ``data_ptr``) through a run with radix hits, copy-on-write, a
    readmitted decode tail grown in place, pressure evictions that reuse
    slots, and a claim offloaded to the host tier and restored.
(b) One store seen by every live state serves the bits a snapshot serves:
    the same traffic runs through the engine and through ``CloneEngine``,
    whose ``_device_pages`` hands out fresh clones (the mirror's semantics
    before the store moved to the card).  Greedy tokens, first-decode
    logits and the page bytes are compared bitwise, in the step loop with
    mid-stream joins under ``prefill_chunk=8`` and under a chaos plan whose
    restores retry and fail closed.

Reduced qwen3-1.7b in bfloat16 on the CPU, parameters from
``torch.Generator`` seed 0.  Tolerance: none (bitwise) throughout.
"""
import numpy as np
import pytest
import torch

from repro_torch.bench import scheduler
from repro_torch.bench.common import Model
from repro_torch.configs import get_config, reduced
from repro_torch.core.claims import ClaimState
from repro_torch.core.events import EventLog
from repro_torch.models.registry import build_model
from repro_torch.serving import chaos as ch
from repro_torch.serving.engine import ServingEngine
from repro_torch.serving.kv_cache import BlockPool
from torch_one_thread import one_torch_thread  # noqa: F401  (autouse fixture)
from torch_page_traffic import CloneEngine, chaos_drive, drive, make, same

@pytest.fixture(scope="module")
def model():
    bundle = build_model(reduced(get_config("qwen3-1.7b")), device="cpu")
    return bundle, bundle.init_params(torch.Generator().manual_seed(0))


def test_store_is_the_pools_own_tensors(model):
    """(a): one store on the engine's device, handed out by every call."""
    with make(ServingEngine, model) as eng:
        handed = []
        pages = eng._device_pages

        def checked():
            k, v = pages()
            if eng.pool.k_pages is not None:
                assert k is eng.pool.k_pages and v is eng.pool.v_pages
                handed.append((k.data_ptr(), v.data_ptr()))
            return k, v

        eng._device_pages = checked
        out = drive(eng)
        names = [n for n, _ in out["events"]]
        assert eng.pool.k_pages.device == eng.device == torch.device("cpu")
        assert len(handed) > 20 and len(set(handed)) == 1
        assert handed[0] == (eng.pool.k_pages.data_ptr(), eng.pool.v_pages.data_ptr())
        for name in ("prefix_reuse", "page_cow", "page_extend", "pressure_eviction",
                     "resident_claim_restored"):
            assert name in names, name
        assert out["offloaded"] and out["claim"] == ClaimState.RESTORED
        assert out["fail_closed"] == {}
        assert all(s == "finished" for s, *_ in out["tokens"])


def test_in_place_store_serves_the_snapshot_bits(model):
    """(b): the engine and the clone engine serve the same bits."""
    with make(ServingEngine, model) as eng, make(CloneEngine, model) as ref:
        same(drive(eng), drive(ref))


@pytest.mark.parametrize("chunk,blocks", [(8, 64), (16, 64), (8, 26)],
                         ids=["chunk8", "chunk16", "chunk8-full-pool"])
def test_in_place_store_mid_stream_joins(model, chunk, blocks):
    """(b) in the step loop: steps where chunks of a burst write pages
    while decode rows read the same store.  With 26 blocks the streams pin
    24 of them, so the burst's chunks meet a full pool: a chunk store may
    only take a free slot or refuse, never a slot a decode row reads."""
    got = {}
    for cls in (ServingEngine, CloneEngine):
        with make(cls, model, device_blocks=blocks, prefill_chunk=chunk,
                     max_tokens_per_step=24) as eng:
            streams = [eng.submit(tuple(range(3000 + 50 * i, 3024 + 50 * i)), max_new_tokens=8)
                       for i in range(4)]
            burst = [eng.submit(tuple(range(9000 + 100 * i, 9000 + 100 * i + n)),
                                max_new_tokens=2) for i, n in enumerate((20, 36, 44))]
            eng.run_batch(streams + burst)
            steps = eng.events.named("step_scheduled")
            mixed = sum(1 for e in steps
                        if e.payload["n_decode"] and e.payload["prefill_tokens"])
            got[cls.__name__] = {
                "tokens": [(r.status, tuple(r.output_tokens)) for r in streams + burst],
                "pages": (eng.pool.k_pages.clone(), eng.pool.v_pages.clone()),
                "mixed": mixed,
            }
    assert got["ServingEngine"]["mixed"] > 0, "no chunk ran beside decode rows"
    same(got["ServingEngine"], got["CloneEngine"])


def test_in_place_store_under_chaos(model):
    """(b) under a chaos plan: retried and refused restores."""
    got = []
    for cls in (ServingEngine, CloneEngine):
        plan = ch.FaultPlan(seed=1)
        with make(cls, model, fault_plan=plan, quarantine_after=None) as eng:
            got.append(chaos_drive(eng, plan))
    a = got[0]
    assert a["injected"] == {ch.TRIGGER_TRANSIENT: 2, ch.TRIGGER_PERMANENT: 1}
    assert a["claims"][0] == ClaimState.RESTORED
    assert a["tokens"][0][0] == "finished" and a["tokens"][1][0] != "finished"
    assert a["fail_closed"]
    same(a, got[1])


def test_bare_pool_names_its_device():
    """A bare pool takes its store's device explicitly and allocates there."""
    with pytest.raises(TypeError):
        BlockPool(4, EventLog())
    pool = BlockPool(4, EventLog(), device="cpu")
    k = torch.arange(2 * 4 * 1 * 2, dtype=torch.float32).reshape(2, 4, 1, 2)
    blk = pool.add_block((1, 2, 3, 4), "c", k, -k, np.arange(4))
    assert pool.k_pages.device == torch.device("cpu") and blk.page_index is not None
    assert blk.k.untyped_storage().data_ptr() == pool.k_pages.untyped_storage().data_ptr()
    assert torch.equal(blk.k, k) and torch.equal(blk.v, -k)


def test_store_on_another_device_raises(model):
    """No fallback: an engine never serves from a store that is not on its
    own device."""
    with make(ServingEngine, model) as eng:
        eng.run(eng.submit(tuple(range(10, 22)), max_new_tokens=1))
        eng.pool.k_pages = eng.pool.k_pages.to("meta")
        with pytest.raises(RuntimeError, match="page store on meta"):
            eng._device_pages()


def test_step_trace_records_each_step():
    """``bench.scheduler``'s per-step record on a CPU engine: the identity
    store copies no page, a clone store one store's bytes per call, and
    the tracer's wrappers are gone afterwards."""
    m = Model("cpu", reduced=True)
    res = scheduler.run_traced_rep(m, dec_new=4, burst_lens=[40])
    steps = res["steps"]
    assert [s["step"] for s in steps] == list(range(len(steps)))
    assert all(s["page_h2d_bytes"] == 0 for s in steps)
    assert any(s["rebuilt"] for s in steps) and any(s["prefill_chunk_ms"] > 0 for s in steps)
    assert "cpu" not in vars(torch.Tensor) and "to" not in vars(torch.Tensor)
    with CloneEngine(m.bundle, m.params, device="cpu", **scheduler.ENGINE_KW) as eng:
        with scheduler.StepTrace(eng) as trace:
            eng.run_batch(scheduler.submit_streams(eng, dec_new=2))
        rows = trace.steps()
        store = eng.pool.k_pages.nbytes + eng.pool.v_pages.nbytes
    assert "_device_pages" not in vars(eng)
    assert sum(r["page_h2d_bytes"] for r in rows) >= store
    assert all(r["page_h2d_bytes"] % store == 0 for r in rows)

"""Traffic shared by the page-store tests on the CPU
(``tests/test_torch_page_store.py``) and on the card
(``tests/test_torch_gpu.py``): ``CloneEngine``, whose ``_device_pages``
hands out fresh copies of the store (the mirror's semantics before the
store moved to the engine's device), and the drives whose outcomes the
tests compare between it and the engine."""
import numpy as np
import torch

from repro_torch.core.claims import ClaimMode
from repro_torch.serving import chaos as ch
from repro_torch.serving.engine import ServingEngine

PREFIX = tuple(range(100, 116))  # four blocks of 4: the claimed prefix


class CloneEngine(ServingEngine):
    """Test-only: every ``_device_pages()`` call returns fresh copies of the
    store, so a state keeps the bytes of the moment it took its pages and
    never sees a later write (the old mirror's semantics)."""

    def _device_pages(self):
        k, v = super()._device_pages()
        return k.clone(), v.clone()


def make(cls, model, device="cpu", **kw):
    kw = {"block_size": 4, "device_blocks": 24, "prefill_chunk": 8, **kw}
    return cls(*model, device=device, **kw)


def drive(eng):
    """Radix hits, COW, a tail grown in place, mid-stream joins, pressure
    evictions and an offload/restore cycle; returns what was served."""
    out = {}
    claim = eng.accept_claim(PREFIX, ClaimMode.OFFLOADABLE)
    # step loop: decode streams first, longer prompts join mid-stream
    first = [eng.submit(PREFIX + (7, 8), max_new_tokens=6),
             eng.submit(tuple(range(40, 53)), max_new_tokens=6),
             eng.submit(tuple(range(200, 222)), max_new_tokens=3),
             eng.submit(tuple(range(300, 330)), max_new_tokens=2)]
    eng.run_batch(first)
    out["offloaded"] = eng.offload_claim(claim.claim_id)
    # turn two: the readmitted tail of request 1 is shared by two requests
    # (copy-on-write), then grown by one (in place)
    seq1 = first[1].tokens + tuple(first[1].output_tokens)
    shared = [eng.submit(seq1 + (901, 902), max_new_tokens=3),
              eng.submit(seq1 + (911, 912), max_new_tokens=3)]
    eng.run_batch(shared)
    grow = eng.submit(seq1 + (921,), max_new_tokens=4)
    eng.run_batch([grow])
    out["logits_hit"] = eng.prefill_logits(seq1 + (921, 5, 6))
    # fill the pool (evictions reuse slots), then restore the claim
    fill = [eng.submit(tuple(range(1000 + 40 * i, 1020 + 40 * i)), max_new_tokens=2)
            for i in range(4)]
    eng.run_batch(fill)
    back = eng.submit(PREFIX + (9, 10, 11), max_new_tokens=5)
    eng.run_batch([back])
    out["logits_fresh"] = eng.prefill_logits(tuple(range(500, 519)))
    reqs = first + shared + [grow] + fill + [back]
    out["tokens"] = [(r.status, tuple(r.output_tokens), r.cached_tokens, r.restored_tokens)
                     for r in reqs]
    out["claim"] = claim.state
    out["fail_closed"] = eng.fail_closed_total()
    out["pages"] = (eng.pool.k_pages.clone(), eng.pool.v_pages.clone())
    out["slots"] = sorted((b.block_id, b.page_index) for b in eng.pool.blocks.values())
    out["events"] = [(e.name, e.request_id) for e in eng.events.events
                     if e.name != "stage_latency"]
    eng.pool.assert_consistent()
    return out


def chaos_drive(eng, plan):
    """Two claims offloaded; one restore retries twice and succeeds, the
    other meets a permanent fault and is refused fail-closed."""
    ok = eng.accept_claim(PREFIX, ClaimMode.OFFLOADABLE)
    bad = eng.accept_claim(tuple(range(600, 616)), ClaimMode.OFFLOADABLE)
    eng.run_batch([eng.submit(PREFIX + (1, 2), max_new_tokens=2),
                   eng.submit(tuple(range(600, 616)) + (3,), max_new_tokens=2)])
    assert eng.offload_claim(ok.claim_id) and eng.offload_claim(bad.claim_id)
    plan.schedule(ch.FaultSpec(ch.TRIGGER_TRANSIENT, boundary="host_to_device",
                               claim_id=ok.claim_id, repeats=2),
                  ch.FaultSpec(ch.TRIGGER_PERMANENT, boundary="host_to_device",
                               claim_id=bad.claim_id))
    reqs = [eng.submit(PREFIX + (4, 5, 6), max_new_tokens=4),
            eng.submit(tuple(range(600, 616)) + (7, 8), max_new_tokens=4),
            eng.submit(tuple(range(700, 725)), max_new_tokens=4)]
    eng.run_batch(reqs)
    return {
        "tokens": [(r.status, tuple(r.output_tokens), r.restored_tokens) for r in reqs],
        "claims": (ok.state, bad.state),
        "fail_closed": eng.fail_closed_total(),
        "injected": dict(plan.stats.injected),
        "pages": (eng.pool.k_pages.clone(), eng.pool.v_pages.clone()),
        "events": [(e.name, e.request_id) for e in eng.events.events
                   if e.name != "stage_latency"],
    }


def same(a, b):
    for key in a:
        if key == "pages":
            assert all(torch.equal(x, y) for x, y in zip(a[key], b[key])), "page bytes differ"
        elif key.startswith("logits"):
            assert np.array_equal(a[key], b[key]), key
        else:
            assert a[key] == b[key], key

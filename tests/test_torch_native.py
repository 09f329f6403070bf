"""The port's native descriptor against the JAX package's (CPU).

The seven mode scenarios run on both packages' engines at the reduced
qwen3-1.7b (block_size 4, device_blocks 64, cache_len 64), with the JAX
init's bf16 parameters bridged into the port by ``params_from_jax``.
Checked, as exact equality (gates are booleans and trial counts):

* every gate of every mode equals the JAX package's;
* the routed-reuse router events (``route_decision``, ``route_placement``,
  ``route_reuse_attributed``) equal JAX's, payloads included;
* the descriptor generated from the port's results is ``native_sound`` in
  all seven rows under the port's checker and under the JAX checker
  (whose YAML loader reads the JSON);
* a gate forced false gives ``support: missing`` and a row that is not
  ``native_sound`` (generation is fail-closed);
* the committed descriptor and its results, written by the full-width run
  on the card, are ``native_sound`` in both checkers with every gate true;
* the router accepts replicas on different devices and routes between
  them, as the JAX package's router does.
"""
import copy
import json
from pathlib import Path
from types import SimpleNamespace

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config, reduced
from repro.core import native_descriptor as j_nd
from repro.core.descriptors import load_descriptor as j_load
from repro.core.lowering import judge_descriptor as j_judge
from repro.models.registry import build_model as jax_build_model
from repro.serving.engine import ServingEngine as JaxEngine
from repro_torch.configs import get_config as t_get_config
from repro_torch.configs import reduced as t_reduced
from repro_torch.core import native_descriptor as nd
from repro_torch.core.descriptors import load_all_descriptors, load_descriptor
from repro_torch.core.lowering import LABEL_NATIVE, judge_descriptor
from repro_torch.models.registry import build_model
from repro_torch.params import params_from_jax
from repro_torch.serving.router import KVAwareRouter

ROOT = Path(__file__).resolve().parents[1]
MODES = tuple(nd.SCENARIOS)
ROUTE_EVENTS = ("route_decision", "route_placement", "route_reuse_attributed")


@pytest.fixture(scope="module")
def both(tmp_path_factory):
    """({mode: port result}, {mode: JAX result}) over the same parameters."""
    cfg = reduced(get_config("qwen3-1.7b"))
    jb = jax_build_model(cfg)
    jp = jb.init_params(jax.random.PRNGKey(0))
    tb = build_model(t_reduced(t_get_config("qwen3-1.7b")), device="cpu")
    tp = params_from_jax(jax.tree.map(np.asarray, jp), "cpu")

    def j_make(**kw):
        kw.setdefault("block_size", 4)
        kw.setdefault("device_blocks", 64)
        kw.setdefault("cache_len", 64)
        return JaxEngine(jb, jp, **kw)

    tmp = tmp_path_factory.mktemp("native")
    port = nd.run_scenarios(nd.engine_factory(tb, tp, device="cpu"), tmp / "port")
    ref = j_nd.run_scenarios(tmp / "jax", make_engine=j_make)
    return port, ref, tmp


@pytest.mark.parametrize("mode", MODES)
def test_scenario_gates_match_jax(both, mode):
    port, ref, _ = both
    gates = port[mode]["result"]["gates"]
    assert gates == ref[mode]["result"]["gates"]
    assert all(v is True or (isinstance(v, str) and v.split("/")[0] == v.split("/")[1])
               for v in gates.values()), gates
    assert json.loads(Path(port[mode]["path"]).read_text())["gates"] == gates


def test_soft_priority_counts(both):
    gates = both[0]["soft_priority"]["result"]["gates"]
    assert [gates[k] for k in ("original_lower_priority_lost_first",
                               "swapped_lower_priority_lost_first",
                               "equal_priority_no_priority_separation",
                               "claims_joinable_before_pressure",
                               "no_pre_pressure_claim_loss")] == ["5/5", "5/5", "3/3", "13/13", "13/13"]


def _route_events(res):
    return [{k: v for k, v in e.items() if k not in ("ts", "seq")}
            for e in res["events"] if e["name"] in ROUTE_EVENTS]


def test_router_events_match_jax(both):
    port, ref, _ = both
    got = _route_events(port["routed_reuse"]["result"])
    assert got == _route_events(ref["routed_reuse"]["result"])
    assert [e["name"] for e in got] == ["route_placement", "route_decision", "route_placement",
                                        "route_reuse_attributed", "route_decision",
                                        "route_placement", "route_reuse_attributed"]


def test_generated_descriptor_native_sound_in_both_checkers(both):
    port, _, tmp = both
    path = nd.generate_native_descriptor(port, tmp / "desc.json", {"device": "cpu"})
    rows = judge_descriptor(load_descriptor(path))
    assert [r.mode for r in rows] == list(MODES)
    assert all(r.label == LABEL_NATIVE for r in rows), [(r.mode, r.reasons) for r in rows]
    ref_rows = j_judge(j_load(path))
    assert [(r.backend, r.mode, r.label, r.satisfied, r.missing) for r in ref_rows] == [
        (r.backend, r.mode, r.label, r.satisfied, r.missing) for r in rows]
    assert json.loads(path.read_text())["provenance"]["device"] == "cpu"


@pytest.mark.parametrize("mode", MODES)
def test_failed_gate_writes_support_missing(both, mode):
    port, _, tmp = both
    obligation, gate, _ = nd._MODE_EVIDENCE[mode][0]
    broken = copy.deepcopy(port)
    broken[mode]["result"]["gates"][gate] = False
    path = nd.generate_native_descriptor(broken, tmp / f"broken-{mode}.json")
    doc = json.loads(path.read_text())
    row = next(r for r in doc["rows"] if r["mode"] == mode)
    support = {e["obligation"]: e["support"] for e in row["evidence"]
               if e["anchor"]["note"].startswith(f"gate {gate}=")}
    assert support and set(support.values()) == {"missing"}, support
    labels = {r.mode: r.label for r in judge_descriptor(load_descriptor(path))}
    assert labels[mode] != LABEL_NATIVE
    assert all(labels[m] == LABEL_NATIVE for m in MODES if m != mode)


def test_committed_descriptor_from_the_card():
    """The committed descriptor: full-width qwen3-1.7b on the card, every
    gate true in its results, native_sound in both checkers."""
    path = nd.NATIVE_DESCRIPTOR_PATH
    doc = json.loads(path.read_text())
    prov = doc["provenance"]
    assert doc["backend"] == "repro-torch-native"
    assert prov["config"].startswith("qwen3-1.7b: 28 layers, d_model 2048"), prov
    assert prov["device"].startswith("cuda") and "W" in prov["card"], prov
    mine = [d for d in load_all_descriptors() if d.backend == "repro-torch-native"]
    assert len(mine) == 1
    assert [r.label for r in judge_descriptor(mine[0])] == [LABEL_NATIVE] * 7
    assert [r.label for r in j_judge(j_load(path))] == [LABEL_NATIVE] * 7
    for mode in MODES:
        gates = json.loads((ROOT / prov["results_dir"] / f"{mode}.json").read_text())["gates"]
        assert all(v is True or (isinstance(v, str) and v.split("/")[0] == v.split("/")[1])
                   for v in gates.values()), (mode, gates)


def test_engine_factory_defaults_and_device():
    """The reference's scenario defaults, overridable per engine, on the
    caller's device."""
    tb = build_model(t_reduced(t_get_config("qwen3-1.7b")), device="cpu")
    params = tb.init_params(torch.Generator().manual_seed(0))
    make = nd.engine_factory(tb, params, device="cpu")
    with make() as eng:
        assert (eng.block_size, eng.pool.capacity, eng.decode_mode, str(eng.device)) == (
            4, 64, "paged", "cpu")
    with make(device_blocks=8) as eng:
        assert eng.pool.capacity == 8


class _Replica:
    """A stand-in engine on ``device`` whose pool reports ``cached`` tokens
    of prefix overlap for any prompt."""

    def __init__(self, device, cached):
        self.device = torch.device(device)
        self.block_size = 4
        self.submitted = []
        hit = lambda toks, bs: [SimpleNamespace(tokens=toks[:cached])] if cached else []
        self.pool = SimpleNamespace(used=0, lookup_prefix=hit)
        self.connector = SimpleNamespace(offloaded_lookup_prefix=lambda toks, bs: [])
        self.cached = cached

    def submit(self, tokens, max_new_tokens):
        req = SimpleNamespace(request_id=f"{self.device}-{len(self.submitted)}", tokens=tokens,
                              cached_tokens=self.cached, restored_tokens=0, status="waiting")
        self.submitted.append(req)
        return req

    def run(self, req):
        req.status = "finished"


def test_router_accepts_replicas_on_different_devices():
    """Replicas on two devices (each its own pool) are accepted, and a
    request goes to the one with the larger overlap, as in the JAX
    package's router, which has no device rule."""
    replicas = [_Replica("cpu", 0), _Replica(torch.device("cuda", 0), 8)]
    router = KVAwareRouter(replicas)
    assert router.engines == replicas
    req, rec = router.submit_and_run(tuple(range(12)), max_new_tokens=2)
    assert (rec.worker, rec.route_cost_tokens, rec.overlap_scores) == (1, 4, {0: 0, 1: 8})
    assert req.status == "finished" and replicas[1].submitted == [req] and not replicas[0].submitted
    names = [e.name for e in router.events.events]
    assert names == ["route_decision", "route_placement", "route_reuse_attributed"]
    replicas[1].cached = 0
    replicas[1].pool.lookup_prefix = lambda toks, bs: []
    _, rec = router.submit_and_run(tuple(range(12)), max_new_tokens=2)
    assert rec.worker == 0 and len(replicas[0].submitted) == 1

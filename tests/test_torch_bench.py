"""The port's benches (``repro_torch.bench``) against the reference
benches (``benchmarks/*.py``) on the CPU, at ``reduced()`` size.

The port's engines run on the reference benches' own parameters (the JAX
init of ``default_engine_factory``, PRNGKey 0 in bfloat16, bridged by
``params_from_jax``), so the same seed drives both.  Each test holds the
bench's semantic summary equal to the reference's: the connector gates'
counts and every run's verdict by kind (the port's 131 runs against the
reference bench's committed ``results/connector_gates/aggregate.json``,
and each kind's scenario run once in both packages with equal projected
event streams), path C's counts, the chaos campaign's faults by kind,
counters, outcomes and retries for the same seed (``--fast``'s schedule)
and its quarantine phase, the radix trace's served-before-eviction counts
(``--fast``'s six sessions), the scheduler's step structure in one
isolated and one burst repetition, and the ceilings' token counts.
Timings are not compared.  Everything is written under ``tmp_path``.
"""
import importlib.util
import json
import random
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest

import repro.core.analyzer as j_an
import repro_torch.core.analyzer as t_an
from repro.core.native_descriptor import default_engine_factory
from repro_torch.bench import chaos, connector_gates, kernels, multi_claim, radix, roofline, run
from repro_torch.bench import scheduler
from repro_torch.bench.common import RESULTS_DIR, Model, pct
from repro_torch.params import params_from_jax
from torch_one_thread import one_torch_thread  # noqa: F401  (autouse fixture)

ROOT = Path(__file__).resolve().parents[1]


def _reference(name):
    """``benchmarks/<name>.py`` loaded by path (the directory is no package)."""
    spec = importlib.util.spec_from_file_location(f"ref_{name}", ROOT / "benchmarks" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def ref_make():
    return default_engine_factory()


@pytest.fixture(scope="module")
def model():
    """Reduced qwen3-1.7b on the CPU over the reference benches' parameters."""
    from repro.configs import get_config, reduced
    from repro.models.registry import build_model

    m = Model("cpu", reduced=True)
    jp = build_model(reduced(get_config("qwen3-1.7b"))).init_params(jax.random.PRNGKey(0))
    m.params = params_from_jax(jax.tree.map(np.asarray, jp), "cpu")
    return m


def test_connector_gates_match_reference(model, tmp_path):
    """The port's 131 runs against the reference bench's own 131 (its
    committed aggregate): the same summary and every run's verdict."""
    want = json.loads((ROOT / "results" / "connector_gates" / "aggregate.json").read_text())
    got = connector_gates.run_gates(model, tmp_path)
    assert got == want["summary"]
    assert got["event_sequence_validity"] == "131/131"
    rows = lambda doc: [(r["kind"], r["passed"], r["sequence_valid"]) for r in doc["runs"]]
    assert rows(json.loads((tmp_path / "connector_gates" / "aggregate.json").read_text())) == \
        rows(want)
    connector_gates.check_gates(got)  # holds: no exit


def _project(log):
    return [(e.name, e.request_id, e.claim_id, tuple(e.payload.get("blocking_claim_ids") or ()))
            for e in log.events if e.name != "stage_latency"]


@pytest.mark.parametrize("fail", [False, True], ids=["path_a", "path_b"])
def test_connector_offload_cycle_matches_reference(model, ref_make, fail):
    """Table 8's scenario, run once by both packages' ``offload_cycle``:
    equal projected event streams and analyzer verdicts; on path B's log
    the port's two replayed controls (fallback recompute, generic
    counters) fail closed."""
    ref = _reference("bench_connector_gates")
    jeng, jclaim, jr2 = ref._offload_cycle(ref_make, fail=fail)
    teng, tclaim, tr2 = connector_gates.offload_cycle(model.engine, fail=fail)
    teng.close()
    assert _project(teng.events) == _project(jeng.events)
    jcheck = j_an.check_failure_outcome_path if fail else j_an.check_observation_path
    tcheck = t_an.check_failure_outcome_path if fail else t_an.check_observation_path
    assert jcheck(jeng.events, jclaim.claim_id, jr2.request_id).passed
    assert tcheck(teng.events, tclaim.claim_id, tr2.request_id).passed
    if fail:
        for log in (connector_gates.fallback_recompute_log(teng, tr2.request_id),
                    connector_gates.generic_counters_log(teng)):
            assert not tcheck(log, tclaim.claim_id, tr2.request_id).passed


def test_multi_claim_path_c_matches_reference(model, ref_make, tmp_path):
    want = _reference("bench_multi_claim").run(tmp_path / "ref.json", make_engine=ref_make)
    got = multi_claim.run(model, tmp_path)
    assert got == want == {"target_only_attribution": "3/3", "non_target_restored": "3/3",
                           "non_target_failure_attributions": "0/3"}
    reps = lambda p: [{k: v for k, v in r.items() if k != "event_bytes"}
                      for r in json.loads(p.read_text())["repetitions"]]
    assert reps(tmp_path / "vllm-multi-claim-attribution-control.json") == reps(
        tmp_path / "ref.json")


def _ceiling_view(r):
    drop = {"limit", "card", "model", "logits_max_abs_diff"}
    return {k: ({kk: vv for kk, vv in v.items() if kk not in drop} if isinstance(v, dict) else v)
            for k, v in r.items() if k not in drop}


def test_ceilings_match_reference(model, tmp_path):
    ref = _reference("bench_multi_claim")
    out = tmp_path / "ref.json"
    want = (ref.run_ceiling(out), ref.run_prefill_ceiling(out))
    got = (multi_claim.run_ceiling(model, tmp_path), multi_claim.run_prefill_ceiling(model, tmp_path))
    for g, w in zip(got, want):
        assert _ceiling_view(g) == _ceiling_view(w)
        assert g["meets_2x_criterion"]
    multi_claim.check({"meets_2x_criterion": True}, *got)  # holds: no exit


def test_chaos_campaign_matches_reference(model, ref_make, tmp_path):
    ref = _reference("bench_chaos")
    assert chaos.build_rounds(random.Random(chaos.SEED), False) == ref._build_rounds(
        random.Random(ref.SEED), False)
    want_c = ref.run_campaign(ref_make, fast=True, latency_acc={})
    want_q = ref.run_quarantine_phase(ref_make, latency_acc={})
    got = chaos.run(model, tmp_path, fast=True)
    assert got["campaign"] == want_c
    assert {k: v for k, v in got["quarantine_phase"].items() if k != "artifacts"} == want_q
    assert got["total_injected_faults"] >= 40
    for name in ("chaos_trace.json", "chaos_metrics.prom", "chaos_metrics.json"):
        assert (tmp_path / name).exists()
    assert json.loads((tmp_path / "BENCH_serving.json").read_text())["chaos_campaign"]["seed"] == \
        ref.SEED


def test_radix_trace_matches_reference(model, ref_make, tmp_path):
    ref = _reference("bench_radix")
    trace = ref._session_trace(6, 2)  # --fast
    assert radix.session_trace(6, 2) == trace
    want = {}
    for label, kw in (("shared", {}), ("baseline", {"prefix_sharing": False})):
        eng = ref_make(**kw, **ref.ENGINE_KW)
        want[label] = ref._run_trace(eng, trace)
        ref._check_trace(eng, label)
        want[f"{label}_hits"] = ref._counter_total(eng, "prefix_reuse_hits_total")
        eng.close()
    got = radix.measure(model, tmp_path, fast=True)
    assert got["shared"] == want["shared"] and got["baseline"] == want["baseline"]
    assert got["prefix_reuse_hits_total"] == want["shared_hits"] > 0
    assert want["baseline_hits"] == 0
    assert got["byte_identity_probe"]["equal"]  # bitwise on the CPU in bf16
    assert got["capacity_ratio"] >= radix.CAPACITY_RATIO_MIN
    radix.check(got)  # holds: no exit


def test_scheduler_repetitions_match_reference(model, ref_make):
    """One isolated and one burst repetition (``--fast``'s 16 tokens and
    burst 40/72) through each package's repetition functions: the same
    number of steps, mixed steps, contended and isolated ITL samples and
    admission transitions, so both packages take their ITL and TTFT over
    the same steps."""
    ref = _reference("bench_scheduler")
    jiso = ref.run_iso_rep(ref_make, dec_new=16)
    tiso = scheduler.run_iso_rep(model, dec_new=16)
    assert len(tiso) == len(jiso) > 0
    jb = ref.run_burst_rep(ref_make, dec_new=16, burst_lens=[40, 72])
    tb = scheduler.run_burst_rep(model, dec_new=16, burst_lens=[40, 72])
    for key in ("overlap_deltas", "all_deltas", "join_deltas", "ttfts"):
        assert len(tb[key]) == len(jb[key]), key
    for key in ("n_steps", "mixed_steps", "occupancy_max"):
        assert tb[key] == jb[key], key
    assert len(tb["overlap_deltas"]) > 0


def test_speed_and_identity_gates_exit_1(capsys):
    """A failed gate exits 1, as the reference benches' do."""
    with pytest.raises(SystemExit) as e:
        scheduler.check_itl({"itl_ratio_p99": 2.07,
                             "itl_p99_best_ms": {"isolated": 64.4, "contended": 133.5}})
    assert e.value.code == 1
    with pytest.raises(SystemExit):
        radix.check({"byte_identity_probe": {"equal": False, "max_abs_diff": 0.06},
                     "capacity_ratio": 2.8, "shared": {}, "baseline": {}})
    with pytest.raises(SystemExit):
        radix.check({"byte_identity_probe": {"equal": True}, "capacity_ratio": 1.2,
                     "shared": {"served_before_eviction": 6},
                     "baseline": {"served_before_eviction": 5}})
    with pytest.raises(SystemExit):
        connector_gates.check_gates({**connector_gates.GATES, "false_positive_control_passes":
                                     "1/41"})
    with pytest.raises(SystemExit):
        multi_claim.check({"meets_2x_criterion": False, "speedup": 1.5},
                          {"meets_2x_criterion": True}, {"meets_2x_criterion": True})
    assert "GATE FAILED" in capsys.readouterr().out
    assert pct([3.0, 1.0, 2.0, 4.0], 50) == 2.0 and pct([3.0, 1.0, 2.0, 4.0], 99) == 4.0


def test_kernels_bench_runs_the_plain_versions_on_the_cpu(tmp_path):
    rows = kernels.run("cpu", tmp_path)
    assert [r["name"] for r in rows] == ["flash_attention_256", "paged_attention_8pages",
                                         "kv_block_copy_16x"]
    assert all(r["kernel_ms"] is None and "plain version only" in r["route"] for r in rows)
    assert json.loads((tmp_path / "kernel-bench.json").read_text())["card"] == "cpu"


def test_roofline_names_argument_bytes(tmp_path):
    out = roofline.run(tmp_path)
    assert set(out) == {"single", "multi"}
    md = (tmp_path / "roofline-single.md").read_text()
    assert "argument bytes per device" in md and "peak bytes per device" in md
    rows = json.loads((tmp_path / "roofline-single.json").read_text())
    cells = sorted((RESULTS_DIR / "dryrun" / "single").glob("*.json"))
    assert len(rows) == len(cells)
    ok = [r for r in rows if r["status"] == "ok"]
    assert ok and all(r["peak_GB_per_dev"] >= r["argument_GB_per_dev"] > 0 for r in ok)


def test_run_driver_sections(model, tmp_path):
    res = run.run(["matrix", "bad_lowering", "mutations", "multi_claim"],
                  run.Context(tmp_path, model=model))
    assert res["matrix"]["rc14_audit"] == "14/14"
    assert res["matrix"]["native_sound_backends"] == ["repro-torch-native"]
    assert res["bad_lowering"]["fail_closed"] == res["bad_lowering"]["total"]
    assert res["mutations"] == {"total": 16, "fail_closed": 16}
    assert res["multi_claim"]["target_only_attribution"] == "3/3"
    assert json.loads((tmp_path / "bench-summary.json").read_text())["model"]["card"] == "cpu"


def test_cli_only_and_outputs_under_out_dir(tmp_path):
    out = subprocess.run([sys.executable, "-m", "repro_torch.bench.run", "--device", "cpu",
                          "--reduced", "--only", "matrix,bad_lowering,roofline",
                          "--out-dir", str(tmp_path)],
                         capture_output=True, text=True, timeout=300, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-2000:]
    assert "independent_rc14_audit,14/14" in out.stdout
    assert (tmp_path / "bench-summary.json").exists()
    assert (tmp_path / "lowering-matrix.md").exists()


def test_benches_default_to_results_torch():
    import inspect

    for fn in (connector_gates.run_gates, multi_claim.run, multi_claim.run_serving,
               multi_claim.run_ceiling, multi_claim.run_prefill_ceiling, chaos.run,
               radix.measure, scheduler.measure, kernels.run, roofline.run):
        assert inspect.signature(fn).parameters["out_dir"].default == Path("results/torch")


def test_cli_out_dir_defaults_keep_cpu_runs_off_the_card_results():
    from repro_torch.bench.common import CPU_RESULTS_DIR, parse, parser

    assert parse(parser(None), []).out_dir == RESULTS_DIR
    assert parse(parser(None), ["--device", "cuda"]).out_dir == RESULTS_DIR
    assert parse(parser(None), ["--device", "cpu"]).out_dir == CPU_RESULTS_DIR
    assert parse(parser(None), ["--device", "cpu", "--out-dir", "x"]).out_dir == Path("x")
    assert "results/torch/cpu/" in (ROOT / ".gitignore").read_text()

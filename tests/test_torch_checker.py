"""The port's fail-closed checker against the JAX package's (CPU).

Both packages judge the same descriptors: the port reads its JSON copies
under ``src/repro_torch/core/data``, the JAX package its YAML originals.
Checked here, each as exact equality (no tolerance: the judgment is
symbolic):

* the port's data files equal ``yaml.safe_load`` of the JAX originals;
* the lowering matrix over the four public descriptors has the same
  (backend, mode, adapter depth, label, satisfied, missing, reasons) rows,
  and no public row is ``native_sound``;
* every bad-lowering counterexample fails closed with the JAX suite's
  result; the independent audit reads 14/14 with JAX's rows;
* the 16 mutation controls fail closed with JAX's outcomes (controls 15-16
  replay a failure path served by the port's engine on the CPU);
* the unit rules of ``judge_row`` give JAX's label and reasons;
* no module of the port (its benches under ``repro_torch/bench`` too),
  nothing in ``chip_smoke.py`` or ``scripts/torch_four_cards.py`` and no
  ``examples/torch_*.py`` imports JAX, ml_dtypes, YAML or the JAX package.
"""
import ast
from pathlib import Path

import pytest
import torch
import yaml

from repro.core import bad_lowering as j_bad
from repro.core import independent_audit as j_audit
from repro.core import mutations as j_mut
from repro.core.descriptors import DATA_DIR as J_DATA
from repro.core.descriptors import Anchor as JAnchor
from repro.core.descriptors import Descriptor as JDescriptor
from repro.core.descriptors import DescriptorRow as JRow
from repro.core.descriptors import EvidenceItem as JEvidence
from repro.core.descriptors import load_descriptor as j_load
from repro.core.checker import generate_matrix as j_matrix
from repro.core.lowering import judge_row as j_judge_row
from repro.core.obligations import canonical as j_canonical
from repro_torch.configs import get_config, reduced
from repro_torch.core import bad_lowering, independent_audit, mutations
from repro_torch.core.checker import generate_matrix
from repro_torch.core.descriptors import DATA_DIR, Anchor, Descriptor, DescriptorRow, EvidenceItem
from repro_torch.core.descriptors import load_all_descriptors, load_descriptor
from repro_torch.core.lowering import LABEL_NATIVE, judge_row, load_modes
from repro_torch.core.native_descriptor import engine_factory
from repro_torch.core.obligations import canonical
from repro_torch.models.registry import build_model

ROOT = Path(__file__).resolve().parents[1]
PUBLIC = (
    "dynamo_kv_routing",
    "sglang_hicache_bbe9c7e",
    "tensorrt_llm_1_3_0rc14_container",
    "vllm_patched_connector",
)


def _judgment(r):
    return (r.backend, r.mode, r.adapter_depth, r.label, r.satisfied, r.missing, r.reasons)


@pytest.mark.parametrize("stem", ("modes",) + tuple(f"descriptors/{s}" for s in PUBLIC))
def test_data_json_equals_jax_yaml(stem):
    import json

    port = json.loads((DATA_DIR / f"{stem}.json").read_text())
    assert port == yaml.safe_load((J_DATA / f"{stem}.yaml").read_text())


@pytest.mark.parametrize("stem", PUBLIC)
def test_matrix_matches_jax(stem):
    port = generate_matrix([load_descriptor(DATA_DIR / "descriptors" / f"{stem}.json")])
    ref = j_matrix([j_load(J_DATA / "descriptors" / f"{stem}.yaml")])
    assert [_judgment(r) for r in port] == [_judgment(r) for r in ref]
    assert port and all(r.label != LABEL_NATIVE for r in port)


def test_port_matrix_public_rows_never_native():
    """The port's whole matrix: its own native rows aside, no row of a
    public runtime is native_sound."""
    rows = generate_matrix(load_all_descriptors())
    public = [r for r in rows if r.backend != "repro-torch-native"]
    assert len(public) == len(generate_matrix([
        load_descriptor(DATA_DIR / "descriptors" / f"{s}.json") for s in PUBLIC]))
    assert all(r.label != LABEL_NATIVE for r in public)


def test_checker_write_outputs(tmp_path):
    """The port's matrix artifacts: the four public descriptors and the
    port's own native descriptor, its seven rows the only native_sound."""
    from repro_torch.core import checker

    stats = checker.write_outputs(tmp_path)
    assert stats["native_sound"] == "7"
    assert int(stats["rows"]) == len(generate_matrix(load_all_descriptors()))
    for name in ("lowering-matrix.md", "lowering-matrix.json", "descriptor-provenance.md",
                 "central-result-table.md"):
        assert (tmp_path / name).read_text()


@pytest.mark.parametrize("name", [c.name for c in j_bad.build_counterexamples()])
def test_bad_lowering_case_matches_jax(name):
    port = {r["name"]: r for r in bad_lowering.check_all()}
    ref = {r["name"]: r for r in j_bad.check_all()}
    assert port.keys() == ref.keys()
    assert port[name] == ref[name]
    assert port[name]["fail_closed"], port[name]


def test_bad_lowering_write_outputs(tmp_path):
    assert bad_lowering.write_outputs(tmp_path) == {"total": 10, "fail_closed": 10}
    assert (tmp_path / "bad-lowering-counterexamples.md").exists()


def test_independent_audit_14_of_14(tmp_path):
    port = independent_audit.run_audit(out_dir=tmp_path / "port")
    ref = j_audit.run_audit(out_dir=tmp_path / "jax")
    assert port["agreement"] == "14/14", port["rows"]
    assert port["rows"] == ref["rows"]


@pytest.fixture(scope="module")
def controls():
    cfg = reduced(get_config("qwen3-1.7b"))
    bundle = build_model(cfg, device="cpu")
    params = bundle.init_params(torch.Generator().manual_seed(0))
    make = engine_factory(bundle, params, device="cpu")
    port = {r.name: r for r in mutations.run_all(make)}
    ref = {r.name: r for r in j_mut.run_all()}
    return port, ref, make


def _control_names():
    return [
        "anchor_deleted", "anchor_note_emptied", "support_weakened_to_partial",
        "support_weakened_to_unknown", "support_weakened_to_missing",
        "pressure_atom_unanchored", "pressure_atom_removed", "scope_weakened_to_docs",
        "scope_weakened_to_source_inspection", "tj_precondition_registry_dropped",
        "tj_precondition_token_map_dropped", "depth_weakened_to_telemetry",
        "order_not_preserved", "claim_scope_lost", "wrong_claim_failure_attribution",
        "fallback_recompute_served_output",
    ]


@pytest.mark.parametrize("name", _control_names())
def test_mutation_control_matches_jax(controls, name):
    port, ref, _ = controls
    assert len(port) == len(ref) == 16 and port.keys() == ref.keys()
    p, r = port[name], ref[name]
    assert (p.kind, p.baseline_positive, p.mutated_positive, p.detail) == (
        r.kind, r.baseline_positive, r.mutated_positive, r.detail)
    assert p.baseline_positive and p.fail_closed, p


def test_mutation_write_outputs(controls, tmp_path):
    make = controls[2]
    assert mutations.write_outputs(make, tmp_path) == {"total": 16, "fail_closed": 16}
    assert (tmp_path / "descriptor-evidence-mutation-controls.md").exists()


# ---------------------------------------------------------------------------
# judge_row unit rules (tests/test_checker.py), port and JAX side by side
# ---------------------------------------------------------------------------


def _positive_row(row_cls, ev_cls, anchor_cls, mode="best_effort"):
    mk = lambda o: ev_cls(
        o, support="supported", depth="native", source_class="conformance_trace",
        order_preserved=True, claim_scoped=True,
        anchor=anchor_cls("result", "results/x.json", "gate passed"),
    )
    return row_cls(mode=mode, evidence=[mk(o) for o in load_modes()["modes"][mode]["obligations"]])


def _native_row(R, E, A):
    return _positive_row(R, E, A)


def _adapter_row(R, E, A):
    row = _positive_row(R, E, A)
    row.evidence[0].depth = "telemetry_join"
    row.preconditions = {k: True for k in load_modes()["telemetry_join_preconditions"]}
    return row


def _tj_without_preconditions(R, E, A):
    row = _positive_row(R, E, A)
    row.evidence[0].depth = "telemetry_join"
    return row


def _no_signals(R, E, A):
    return R(mode="expiring")


def _forbidden(R, E, A):
    return R(mode="hard_protected", asserts="conformance", claimed_mapping="active_no_evict",
             approximation_signals=["lots", "of", "signals"])


def _invalid_mode(R, E, A):
    return R(mode="not_a_mode")


def _alias_obligation(R, E, A):
    row = _positive_row(R, E, A, mode="hard_protected")
    for e in row.evidence:
        if e.obligation == "explicit_conflict_action":
            e.obligation = "active_refusal_or_defer"
    return row


@pytest.mark.parametrize("build,label", [
    (_native_row, "native_sound"),
    (_adapter_row, "sound_with_adapter"),
    (_tj_without_preconditions, "unknown"),
    (_no_signals, "unknown"),
    (_forbidden, "rejected"),
    (_invalid_mode, "rejected"),
    (_alias_obligation, "native_sound"),
], ids=["native_needs_all_native", "adapter_depth", "tj_preconditions_missing",
        "unknown_without_signals", "forbidden_lowering", "invalid_mode", "alias"])
def test_judge_row_rule_matches_jax(build, label):
    port = judge_row(Descriptor(backend="t"), build(DescriptorRow, EvidenceItem, Anchor))
    ref = j_judge_row(JDescriptor(backend="t"), build(JRow, JEvidence, JAnchor))
    assert _judgment(port) == _judgment(ref)
    assert port.label == label, port.reasons
    if build is _invalid_mode:
        assert any("invalid lowering claim" in r for r in port.reasons)


def test_alias_active_refusal_or_defer():
    assert canonical("active_refusal_or_defer") == j_canonical("active_refusal_or_defer") == (
        "explicit_conflict_action")


# ---------------------------------------------------------------------------
# the port imports no JAX, no YAML and nothing of the JAX package
# ---------------------------------------------------------------------------

FORBIDDEN = ("jax", "jaxlib", "ml_dtypes", "yaml", "repro")


def _port_sources():
    return (sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
            + sorted((ROOT / "examples").glob("torch_*.py"))
            + [ROOT / "scripts" / "torch_four_cards.py"])


@pytest.mark.parametrize("path", _port_sources(), ids=lambda p: str(p.relative_to(ROOT)))
def test_port_imports_no_jax_yaml_or_reference(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            mods = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            mods = [node.module or ""]
        else:
            continue
        for m in mods:
            assert m.split(".")[0] not in FORBIDDEN, f"{path.name} imports {m}"


def test_port_writes_only_its_own_results():
    """Default outputs of the port's writers sit under results/torch/ and
    src/repro_torch/ (the JAX package's artifacts are never overwritten)."""
    import inspect

    from repro_torch.core import checker, native_descriptor

    for fn in (checker.write_outputs, bad_lowering.write_outputs, mutations.write_outputs,
               independent_audit.run_audit):
        assert inspect.signature(fn).parameters["out_dir"].default == Path("results/torch")
    assert native_descriptor.RESULTS_DIR == Path("results/torch/native")
    assert native_descriptor.NATIVE_DESCRIPTOR_PATH.parent == DATA_DIR / "descriptors"
    assert "repro_torch" in native_descriptor.NATIVE_DESCRIPTOR_PATH.parts

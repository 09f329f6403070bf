"""Descriptor/evidence mutation controls (paper §8.2) — 16 cases, 16/16 must
fail closed.

Each control takes a POSITIVE row (from the real descriptors) or a passing
runtime trace (from a live engine run) and applies one small mutation:
anchor deletion, support weakening, unanchored atoms, docs-only scope,
missing telemetry-join preconditions, depth weakening, order/claim-scope
loss, wrong-claim attribution, post-hoc claim naming, restore-after-reuse
ordering, fallback recompute, generic counters, storage-only evidence,
routing-only evidence.  The checker/analyzer must refuse to upgrade every
mutated artifact — sensitivity, not completeness, is the property
established.
"""
from __future__ import annotations

import copy
import json
from dataclasses import dataclass
from pathlib import Path
from typing import Callable, Dict, List, Tuple

from repro_torch.core.analyzer import check_failure_outcome_path
from repro_torch.core.descriptors import load_all_descriptors
from repro_torch.core.events import EventLog
from repro_torch.core.lowering import judge_row


@dataclass
class MutationResult:
    name: str
    kind: str  # descriptor | evidence_replay
    baseline_positive: bool
    mutated_positive: bool
    detail: str

    @property
    def fail_closed(self) -> bool:
        return self.baseline_positive and not self.mutated_positive


def _find_row(descriptors, backend: str, mode: str, depth: str):
    for d in descriptors:
        if d.backend == backend:
            return d, d.row(mode, depth)
    raise KeyError(f"{backend} ({mode}, {depth})")


def _judge(desc, row) -> bool:
    return judge_row(desc, row).positive


# ---------------------------------------------------------------------------
# descriptor mutations (1-12)
# ---------------------------------------------------------------------------


def descriptor_mutations(descriptors) -> List[MutationResult]:
    out: List[MutationResult] = []

    def run(name: str, backend: str, mode: str, depth: str, mutate: Callable, detail: str):
        desc, row = _find_row(descriptors, backend, mode, depth)
        base = _judge(desc, row)
        mrow = copy.deepcopy(row)
        mutate(mrow)
        out.append(MutationResult(name, "descriptor", base, _judge(desc, mrow), detail))

    TRT = "tensorrt-llm-1.3.0rc14-container"
    SGL = "sglang-hicache-bbe9c7e"
    VLLM = "vllm-patched-connector"
    NATIVE = "repro-torch-native"

    def _set_ev(row, obligation, **kw):
        for e in row.evidence:
            if e.obligation == obligation:
                for k, v in kw.items():
                    if k.startswith("anchor_"):
                        setattr(e.anchor, k[7:], v)
                    else:
                        setattr(e, k, v)

    run(
        "anchor_deleted", TRT, "best_effort", "telemetry_join",
        lambda r: _set_ev(r, "claim_identity", anchor_path=""),
        "claim_identity anchor path deleted -> not anchored (rule 2)",
    )
    run(
        "anchor_note_emptied", TRT, "soft_priority", "telemetry_join",
        lambda r: _set_ev(r, "priority_influence", anchor_note=""),
        "priority_influence anchor note emptied -> not concrete",
    )
    run(
        "support_weakened_to_partial", TRT, "soft_priority", "telemetry_join",
        lambda r: _set_ev(r, "priority_influence", support="partial"),
        "supported -> partial (evidence-gated obligations)",
    )
    run(
        "support_weakened_to_unknown", SGL, "best_effort", "telemetry_join",
        lambda r: _set_ev(r, "materialization_predicate", support="unknown"),
        "supported -> unknown",
    )
    run(
        "support_weakened_to_missing", VLLM, "offloadable", "backend_patch",
        lambda r: _set_ev(r, "restoration_failure_outcome", support="missing"),
        "restoration_failure_outcome removed -> offloadable cannot hold",
    )
    run(
        "pressure_atom_unanchored", TRT, "soft_priority", "telemetry_join",
        lambda r: setattr(r.observed_atoms[0].anchor, "path", ""),
        "pressure_controls_observed atom without trace anchor (rule 3)",
    )
    run(
        "pressure_atom_removed", NATIVE, "soft_priority", "none",
        lambda r: r.observed_atoms.clear(),
        "required observed atom absent",
    )
    run(
        "scope_weakened_to_docs", TRT, "best_effort", "telemetry_join",
        lambda r: [_set_ev(r, e.obligation, source_class="docs") for e in r.evidence],
        "docs-only adapter rows do not become positives (rule 4)",
    )
    run(
        "scope_weakened_to_source_inspection", SGL, "best_effort", "telemetry_join",
        lambda r: [_set_ev(r, e.obligation, source_class="source") for e in r.evidence],
        "source-inspection rows do not become positives (rule 4)",
    )
    run(
        "tj_precondition_registry_dropped", TRT, "best_effort", "telemetry_join",
        lambda r: r.preconditions.update(external_claim_registry=False),
        "missing external accepted-claim registry precondition",
    )
    run(
        "tj_precondition_token_map_dropped", TRT, "soft_priority", "telemetry_join",
        lambda r: r.preconditions.update(deterministic_request_token_map=False),
        "missing deterministic request-token map precondition",
    )
    run(
        "depth_weakened_to_telemetry", VLLM, "offloadable", "backend_patch",
        lambda r: _set_ev(r, "restoration_failure_outcome", depth="telemetry_join"),
        "telemetry cannot create restoration failure outcomes (rule 5/6)",
    )
    run(
        "order_not_preserved", VLLM, "offloadable", "backend_patch",
        lambda r: _set_ev(r, "ordered_lifecycle_events", order_preserved=False),
        "restore-after-reuse / ambiguous order fails closed (rule 7)",
    )
    run(
        "claim_scope_lost", VLLM, "offloadable", "backend_patch",
        lambda r: _set_ev(r, "restoration_failure_outcome", claim_scoped=False),
        "post-hoc / unclaimed attribution fails closed (rule 7)",
    )
    return out


# ---------------------------------------------------------------------------
# evidence replay mutations (near-miss runtime summaries, 15-16)
# ---------------------------------------------------------------------------


def _path_b_events(make_engine) -> Tuple[EventLog, str, str]:
    """Run the live failure-outcome scenario once on an engine from
    ``make_engine`` (``native_descriptor.engine_factory`` on the caller's
    model and device); return (log, claim, request)."""
    from repro_torch.core.claims import ClaimMode
    from repro_torch.core.native_descriptor import PREFIX

    with make_engine() as eng:
        claim = eng.accept_claim(PREFIX, ClaimMode.OFFLOADABLE)
        r1 = eng.submit(PREFIX + (30, 31), max_new_tokens=1)
        eng.run(r1)
        eng.offload_claim(claim.claim_id, request_id=r1.request_id)
        eng.connector.injection.resident_claim_load_failure = True
        eng.connector.injection.fail_claim_id = claim.claim_id
        r2 = eng.submit(PREFIX + (40, 41), max_new_tokens=1)
        eng.run(r2)
    return eng.events, claim.claim_id, r2.request_id


def evidence_replay_mutations(make_engine) -> List[MutationResult]:
    out: List[MutationResult] = []
    log, claim_id, req_id = _path_b_events(make_engine)
    base = check_failure_outcome_path(log, claim_id, req_id).passed

    # 15: wrong-claim failure attribution — swap the claim id on the
    # scheduler-boundary events and re-run the gate for the original claim.
    rows = [e.to_dict() for e in log.events]
    mutated = copy.deepcopy(rows)
    for r in mutated:
        if r["name"] in (
            "scheduler_resident_claim_restoration_failed",
            "offload_worker_transfer_finished",
            "offload_worker_load_failed",
        ) and r.get("claim_id") == claim_id:
            r["claim_id"] = "claim-9999"
        if r["name"] == "scheduler_active_request_refused":
            r["blocking_claim_ids"] = ["claim-9999"]
    wrong = check_failure_outcome_path(EventLog.from_dicts(mutated), claim_id, req_id).passed
    out.append(
        MutationResult(
            "wrong_claim_failure_attribution", "evidence_replay", base, wrong,
            "E4/E11/E12/E13 claim ids swapped to a different claim -> gate must reject",
        )
    )

    # 16: restore-after-reuse ordering / fallback recompute — replace the
    # failure tail with a success finish (recompute served output anyway).
    mutated2 = [
        r
        for r in copy.deepcopy(rows)
        if r["name"]
        not in ("offload_request_finished_pending_jobs", "request_finished")
        or r.get("request_id") != req_id
    ]
    mutated2.append(
        {
            "name": "offload_request_finished_no_pending_jobs",
            "request_id": req_id,
        }
    )
    mutated2.append({"name": "request_finished", "request_id": req_id, "status": "FINISHED_OK"})
    recompute = check_failure_outcome_path(EventLog.from_dicts(mutated2), claim_id, req_id).passed
    out.append(
        MutationResult(
            "fallback_recompute_served_output", "evidence_replay", base, recompute,
            "request served output after claim failure -> fallback recompute rejected",
        )
    )
    return out


def run_all(make_engine) -> List[MutationResult]:
    descriptors = load_all_descriptors()
    return descriptor_mutations(descriptors) + evidence_replay_mutations(make_engine)


def write_outputs(make_engine, out_dir: Path = Path("results/torch")) -> Dict[str, int]:
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    results = run_all(make_engine)
    rows = [
        {
            "name": r.name,
            "kind": r.kind,
            "baseline_positive": r.baseline_positive,
            "mutated_positive": r.mutated_positive,
            "fail_closed": r.fail_closed,
            "detail": r.detail,
        }
        for r in results
    ]
    (out_dir / "descriptor-evidence-mutation-controls.json").write_text(json.dumps(rows, indent=1))
    lines = [
        "# Descriptor/evidence mutation controls",
        "",
        "| control | kind | baseline | mutated | fail-closed |",
        "|---|---|---|---|---|",
    ]
    for r in rows:
        lines.append(
            f"| {r['name']} | {r['kind']} | {'positive' if r['baseline_positive'] else 'neg'} | "
            f"{'positive' if r['mutated_positive'] else 'not positive'} | {r['fail_closed']} |"
        )
    (out_dir / "descriptor-evidence-mutation-controls.md").write_text("\n".join(lines))
    return {"total": len(rows), "fail_closed": sum(r["fail_closed"] for r in rows)}


"""Bad-lowering counterexample suite (paper §9, Table 9).

Feature-table inferences a less strict study might call "supported", checked
against the same obligation relation as the main matrix.  Each case encodes
the naive inference as a synthetic descriptor row; the checker must fail it
closed with the expected label.
"""
from __future__ import annotations

import json
from dataclasses import dataclass
from pathlib import Path
from typing import List, Optional

from repro_torch.core.descriptors import Anchor, Descriptor, DescriptorRow, EvidenceItem
from repro_torch.core.lowering import judge_row

_TJ_PRECONDITIONS = {
    k: True
    for k in (
        "external_claim_registry",
        "stable_claim_id",
        "reusable_object_id",
        "fixed_materialization_predicate",
        "deterministic_request_token_map",
        "fixed_cache_identity",
        "named_observation_point",
        "joinable_backend_events",
        "ambiguity_fails_closed",
    )
}


@dataclass
class Counterexample:
    name: str
    inference: str
    expected_label: str
    why_it_fails: str
    row: DescriptorRow


def _anchor(note: str) -> Anchor:
    return Anchor(kind="trace", path="bad_lowering/synthetic_trace.json", note=note)


def build_counterexamples() -> List[Counterexample]:
    cases: List[Counterexample] = []

    cases.append(
        Counterexample(
            "priority_value_in_event",
            "priority_value_in_event -> soft_priority",
            "approximate",
            "A priority value is block metadata unless priority influence and claim-scoped telemetry are both established.",
            DescriptorRow(
                mode="soft_priority",
                adapter_depth="none",
                asserts="none",
                approximation_signals=["priority_value_in_event"],
                evidence=[
                    EvidenceItem(
                        "priority_influence",
                        support="partial",
                        depth="native",
                        source_class="trace",
                        anchor=_anchor("priority field present in block events"),
                    )
                ],
            ),
        )
    )

    cases.append(
        Counterexample(
            "active_no_evict",
            "active_no_evict -> future_resident hard_protected",
            "rejected",
            "Active no-evict can protect running requests without accepted future-resident claim identity, victim exclusion, explicit conflict action, blocking claim ids, or harm attribution.",
            DescriptorRow(
                mode="hard_protected",
                adapter_depth="none",
                asserts="conformance",
                claimed_mapping="active_no_evict",
                approximation_signals=["guaranteed_no_evict_mode"],
                evidence=[],
            ),
        )
    )

    cases.append(
        Counterexample(
            "duration_metadata",
            "duration_metadata -> expiring",
            "approximate",
            "Duration metadata does not report the claim-scoped boundary where responsibility ends.",
            DescriptorRow(
                mode="expiring",
                adapter_depth="none",
                asserts="none",
                approximation_signals=["duration_field"],
                evidence=[],
            ),
        )
    )

    cases.append(
        Counterexample(
            "storage_tier",
            "storage_tier -> offloadable",
            "approximate",
            "Storage movement does not show restoration before reuse or claim-scoped restoration failure.",
            DescriptorRow(
                mode="offloadable",
                adapter_depth="none",
                asserts="none",
                approximation_signals=["storage_tier"],
                evidence=[],
            ),
        )
    )

    cases.append(
        Counterexample(
            "claim_joined_offload_generic_counters",
            "claim_joined_offload + generic_onboard_counters -> offloadable",
            "approximate",
            "Even a claim-joined offload plus generic onboard counters does not establish claim-joined restore-before-reuse or a restoration-failure outcome.",
            DescriptorRow(
                mode="offloadable",
                adapter_depth="telemetry_join",
                asserts="none",
                approximation_signals=["claim_joined_offload", "generic_onboard_counters"],
                preconditions=dict(_TJ_PRECONDITIONS),
                evidence=[
                    EvidenceItem(
                        "claim_identity",
                        support="supported",
                        depth="telemetry_join",
                        source_class="litmus_trace",
                        order_preserved=True,
                        claim_scoped=True,
                        anchor=_anchor("one claim-joined offload observed"),
                    ),
                    EvidenceItem(
                        "offload_restorability",
                        support="partial",
                        depth="telemetry_join",
                        source_class="litmus_trace",
                        anchor=_anchor("generic onboard counters only"),
                    ),
                ],
            ),
        )
    )

    cases.append(
        Counterexample(
            "same_prompt_block_tier_movement",
            "same_prompt_block_tier_movement -> offloadable",
            "approximate",
            "Corrected TensorRT rc15 rows observed tier movement 0->1 and 1->0 without retention config, but exposed no native claim identity, predicate, failure outcome, lifecycle, or harm/refusal/demotion/expiry attribution.",
            DescriptorRow(
                mode="offloadable",
                adapter_depth="none",
                asserts="none",
                approximation_signals=["same_prompt_block_tier_movement"],
                evidence=[
                    EvidenceItem(
                        "offload_restorability",
                        support="partial",
                        depth="native",
                        source_class="trace",
                        order_preserved=True,
                        claim_scoped=False,
                        anchor=_anchor("tracked hashes moved 0->1 under pressure, 1->0 on reuse"),
                    )
                ],
            ),
        )
    )

    cases.append(
        Counterexample(
            "kv_aware_routing",
            "kv_aware_routing -> routed_reuse",
            "approximate",
            "Routing needs route cost, placement, and future reuse success/failure attributed to an accepted claim.",
            DescriptorRow(
                mode="routed_reuse",
                adapter_depth="none",
                asserts="none",
                approximation_signals=["kv_aware_routing", "overlap_scoring"],
                evidence=[],
            ),
        )
    )

    cases.append(
        Counterexample(
            "block_removed_claim_harm",
            "block_removed -> claim_harm",
            "invalid lowering claim",
            "Removed blocks are ordinary cache behavior unless accepted claim identity, predicate-breaking loss, and claim harm attribution are present.",
            DescriptorRow(
                mode="claim_harm",  # not a ResidentClaim mode at all
                adapter_depth="none",
                asserts="conformance",
                approximation_signals=["block_removed_events"],
                evidence=[],
            ),
        )
    )

    cases.append(
        Counterexample(
            "fallback_recompute",
            "fallback recompute after failed load -> restored offloadable claim",
            "rejected",
            "Recomputing after a failed load is not evidence that the accepted offloaded claim was restored (rejected by the connector gate).",
            DescriptorRow(
                mode="offloadable",
                adapter_depth="none",
                asserts="conformance",
                claimed_mapping="fallback_recompute",
                approximation_signals=["fallback_recompute"],
                evidence=[],
            ),
        )
    )

    cases.append(
        Counterexample(
            "wrong_claim_or_unclaimed_failure",
            "wrong-claim or unclaimed load failure -> restoration failure outcome",
            "rejected",
            "The failure must be tied to the same accepted claim; generic or wrong-claim failures are not claim outcomes (rejected by the connector gate).",
            DescriptorRow(
                mode="offloadable",
                adapter_depth="none",
                asserts="conformance",
                claimed_mapping="wrong_claim_failure",
                approximation_signals=["generic_failure_counters"],
                evidence=[],
            ),
        )
    )

    return cases


def check_all() -> List[dict]:
    desc = Descriptor(backend="bad-lowering-suite")
    out = []
    for case in build_counterexamples():
        judgment = judge_row(desc, case.row)
        if case.expected_label == "invalid lowering claim":
            ok = judgment.label == "rejected" and any(
                "invalid lowering claim" in r for r in judgment.reasons
            )
            got = "invalid lowering claim" if ok else judgment.label
        else:
            ok = judgment.label == case.expected_label
            got = judgment.label
        out.append(
            {
                "name": case.name,
                "inference": case.inference,
                "expected": case.expected_label,
                "got": got,
                "fail_closed": ok and not judgment.positive,
                "why": case.why_it_fails,
            }
        )
    return out


def write_outputs(out_dir: Path = Path("results/torch")) -> dict:
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    rows = check_all()
    (out_dir / "bad-lowering-counterexamples.json").write_text(json.dumps(rows, indent=1))
    lines = [
        "# Bad-lowering counterexamples (Table 9)",
        "",
        "| naive inference | expected | got | fail-closed |",
        "|---|---|---|---|",
    ]
    for r in rows:
        lines.append(f"| {r['inference']} | {r['expected']} | {r['got']} | {r['fail_closed']} |")
    (out_dir / "bad-lowering-counterexamples.md").write_text("\n".join(lines))
    return {"total": len(rows), "fail_closed": sum(r["fail_closed"] for r in rows)}


if __name__ == "__main__":
    print(json.dumps(write_outputs(), indent=1))

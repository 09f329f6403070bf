"""Independent descriptor audit (paper §8.1).

An auditable SECOND implementation of the lowering judgment that
re-derives every TensorRT rc14 row directly from the descriptor's anchored
obligation evidence, mode obligations, adapter-depth rules and
preconditions — deliberately written against the JSON artifacts alone,
WITHOUT importing `core/lowering.py` or reading the generated matrix as the
answer.  Agreement between the two implementations is the audit result
(the paper reports 14/14); disagreement would indicate a checker bug, not
runtime behavior.  Like the paper's audit, this is an independent pass over
curated evidence, not proof that runtime behavior is complete.
"""
from __future__ import annotations

import json
from pathlib import Path
from typing import Dict, List

from repro_torch.core.descriptors import DATA_DIR

_ENFORCEMENT = {
    "victim_exclusion_before_violation",
    "explicit_conflict_action",
    "blocking_claim_ids",
    "restoration_failure_outcome",
}
_ALIAS = {"active_refusal_or_defer": "explicit_conflict_action"}


def _audit_row(row: dict, modes: dict) -> str:
    """Re-derivation of label(d, a, E, m) from first principles."""
    mode_cfg = modes["modes"].get(row["mode"])
    if mode_cfg is None:
        return "rejected"
    required = [_ALIAS.get(o, o) for o in mode_cfg["obligations"]]
    runtime_classes = set(modes["runtime_evidence_classes"])
    depth_table = modes["depths"]
    tj_pre = modes["telemetry_join_preconditions"]

    evidence = row.get("evidence") or []
    pre = row.get("preconditions") or {}
    uses_tj = any(e.get("depth") == "telemetry_join" for e in evidence)
    tj_ok = all(pre.get(k, False) for k in tj_pre) if uses_tj else True

    def item_satisfies(e: dict, obligation: str) -> bool:
        if _ALIAS.get(e["obligation"], e["obligation"]) != obligation:
            return False
        if e.get("support") != "supported":
            return False
        anchor = e.get("anchor") or {}
        if not (anchor.get("kind") and anchor.get("path") and anchor.get("note")):
            return False
        src = e.get("source_class", "docs")
        if src not in runtime_classes:
            return False
        if src in runtime_classes and not (
            e.get("order_preserved") and e.get("claim_scoped")
        ):
            return False
        depth = e.get("depth", "native")
        if depth != "native":
            supplies = depth_table[depth].get("supplies", [])
            if supplies != "all" and obligation not in supplies:
                return False
            if depth == "telemetry_join" and not tj_ok:
                return False
        return True

    satisfied_depths: Dict[str, str] = {}
    for o in required:
        for e in evidence:
            if item_satisfies(e, o):
                satisfied_depths[o] = e.get("depth", "native")
                break
    missing = [o for o in required if o not in satisfied_depths]

    # required observed atoms with concrete anchors
    for atom in mode_cfg.get("required_atoms", []):
        found = next((a for a in row.get("observed_atoms", []) if a["name"] == atom), None)
        anchor = (found or {}).get("anchor") or {}
        if not (anchor.get("kind") and anchor.get("path") and anchor.get("note")):
            missing.append(f"atom:{atom}")

    if not missing:
        if all(d == "native" for d in satisfied_depths.values()):
            return "native_sound"
        return "sound_with_adapter"
    forbidden = {(f["mapping"], f["mode"]) for f in modes["forbidden_lowerings"]}
    if row.get("claimed_mapping") and (row["claimed_mapping"], row["mode"]) in forbidden:
        return "rejected"
    if row.get("asserts") == "conformance" and any(m in _ENFORCEMENT for m in missing):
        return "rejected"
    if row.get("approximation_signals"):
        return "approximate"
    return "unknown"


def run_audit(
    descriptor_name: str = "tensorrt_llm_1_3_0rc14_container.json",
    out_dir: Path = Path("results/torch"),
) -> Dict[str, object]:
    modes = json.loads((DATA_DIR / "modes.json").read_text())
    raw = json.loads((DATA_DIR / "descriptors" / descriptor_name).read_text())

    # the audited rows, re-derived independently
    audited = [
        {
            "mode": r["mode"],
            "adapter_depth": r.get("adapter_depth", "none"),
            "audit_label": _audit_row(r, modes),
        }
        for r in raw["rows"]
    ]

    # the primary checker's labels (loaded only AFTER the audit derivation)
    from repro_torch.core.descriptors import load_descriptor
    from repro_torch.core.lowering import judge_descriptor

    primary = judge_descriptor(load_descriptor(DATA_DIR / "descriptors" / descriptor_name))
    agree = 0
    rows_out = []
    for a, p in zip(audited, primary):
        ok = a["audit_label"] == p.label
        agree += ok
        rows_out.append({**a, "checker_label": p.label, "agree": ok})

    result = {
        "descriptor": raw["backend"],
        "rows": rows_out,
        "agreement": f"{agree}/{len(rows_out)}",
        "note": (
            "independent re-derivation over curated evidence; agreement is a "
            "checker-consistency audit, not proof of runtime completeness"
        ),
    }
    out_dir.mkdir(parents=True, exist_ok=True)
    (out_dir / "tensorrt-rc14-independent-descriptor-audit.json").write_text(
        json.dumps(result, indent=1)
    )
    lines = [
        "# Independent descriptor audit — TensorRT rc14 (paper §8.1)",
        "",
        f"Agreement: **{result['agreement']}**",
        "",
        "| mode | depth | audit | checker | agree |",
        "|---|---|---|---|---|",
    ] + [
        f"| {r['mode']} | {r['adapter_depth']} | {r['audit_label']} | {r['checker_label']} | {r['agree']} |"
        for r in rows_out
    ]
    (out_dir / "tensorrt-rc14-independent-descriptor-audit.md").write_text("\n".join(lines))
    return result


if __name__ == "__main__":
    res = run_audit()
    print(f"{res['descriptor']}: agreement {res['agreement']}")

"""The fail-closed lowering relation:  backend + adapter + evidence |= mode.

Checker core (paper §4):
  supports(e, o)      — e marks o supported and has a concrete anchor.
  anchored(e)         — anchor names kind, path, note; trace anchors must
                        also preserve order and claim scope.
  depth_allowed(a, o) — o is native, or the adapter depth may supply o and
                        its preconditions hold.
  Lower(d, a, E, m)   — every o in O[m] has such evidence.

Labels: native_sound | sound_with_adapter | rejected | approximate | unknown.
Missing required obligations fail closed — there is no "probably fine" path.

The seven checker rules (paper Table 2) are enforced here:
  1. approximation signals never satisfy obligations by themselves;
  2. obligations are evidence-gated (supported + anchored);
  3. observed atoms must be anchored;
  4. docs/source-only evidence cannot produce adapter-scoped positives;
  5. adapter depth constrains obligations;
  6. telemetry cannot create enforcement (encoded in the depth table);
  7. ambiguity fails closed (missing preconditions / scope / order => no).
"""
from __future__ import annotations

import json
from dataclasses import dataclass, field
from functools import lru_cache
from pathlib import Path
from typing import Any, Dict, List, Optional, Tuple

from repro_torch.core.descriptors import DATA_DIR, Descriptor, DescriptorRow, EvidenceItem
from repro_torch.core.obligations import ENFORCEMENT_CRITICAL, canonical

MODES_PATH = DATA_DIR / "modes.json"

LABEL_NATIVE = "native_sound"
LABEL_ADAPTER = "sound_with_adapter"
LABEL_REJECTED = "rejected"
LABEL_APPROX = "approximate"
LABEL_UNKNOWN = "unknown"


@lru_cache(maxsize=4)
def load_modes(path: str = str(MODES_PATH)) -> Dict[str, Any]:
    return json.loads(Path(path).read_text())


@dataclass
class RowJudgment:
    backend: str
    mode: str
    adapter_depth: str
    label: str
    satisfied: Dict[str, str] = field(default_factory=dict)  # obligation -> depth
    missing: List[str] = field(default_factory=list)
    reasons: List[str] = field(default_factory=list)
    non_claim: str = ""

    @property
    def positive(self) -> bool:
        return self.label in (LABEL_NATIVE, LABEL_ADAPTER)


def _anchored(e: EvidenceItem) -> Tuple[bool, str]:
    if not e.anchor.concrete:
        return False, f"{e.obligation}: anchor not concrete (needs kind+path+note)"
    if e.source_class in ("trace", "litmus_trace", "conformance_trace", "controlled_pressure",
                          "failure_injection", "artifact_generated"):
        if not e.order_preserved:
            return False, f"{e.obligation}: trace anchor does not preserve order"
        if not e.claim_scoped:
            return False, f"{e.obligation}: trace anchor not claim-scoped"
    return True, ""


def _depth_allowed(modes: Dict[str, Any], e: EvidenceItem, obligation: str) -> Tuple[bool, str]:
    if e.depth == "native":
        return True, ""
    depth_cfg = modes["depths"].get(e.depth)
    if depth_cfg is None:
        return False, f"{obligation}: unknown adapter depth {e.depth!r}"
    supplies = depth_cfg.get("supplies", [])
    if supplies == "all":
        return True, ""
    if obligation not in supplies:
        return False, f"{obligation}: depth {e.depth} may not supply this obligation"
    return True, ""


def _preconditions_ok(modes: Dict[str, Any], row: DescriptorRow) -> Tuple[bool, str]:
    uses_tj = any(e.depth == "telemetry_join" for e in row.evidence)
    if not uses_tj:
        return True, ""
    for key in modes["telemetry_join_preconditions"]:
        if not row.preconditions.get(key, False):
            return False, f"telemetry_join precondition missing: {key}"
    return True, ""


def _runtime_class(modes: Dict[str, Any], e: EvidenceItem) -> bool:
    return e.source_class in modes["runtime_evidence_classes"]


def judge_row(desc: Descriptor, row: DescriptorRow, modes: Optional[Dict[str, Any]] = None) -> RowJudgment:
    modes = modes or load_modes()
    mode_cfg = modes["modes"].get(row.mode)
    if mode_cfg is None:
        return RowJudgment(
            desc.backend, row.mode, row.adapter_depth, LABEL_REJECTED,
            reasons=[f"invalid lowering claim: {row.mode!r} is not a ResidentClaim mode"],
        )
    required = [canonical(o) for o in mode_cfg["obligations"]]

    reasons: List[str] = []
    satisfied: Dict[str, str] = {}
    missing: List[str] = []

    pre_ok, pre_reason = _preconditions_ok(modes, row)
    if not pre_ok:
        reasons.append(pre_reason)

    by_obligation: Dict[str, List[EvidenceItem]] = {}
    for e in row.evidence:
        by_obligation.setdefault(canonical(e.obligation), []).append(e)

    for o in required:
        found = None
        for e in by_obligation.get(o, []):
            if e.support != "supported":
                reasons.append(f"{o}: support={e.support} (evidence-gated, rule 2)")
                continue
            ok, why = _anchored(e)
            if not ok:
                reasons.append(why)
                continue
            ok, why = _depth_allowed(modes, e, o)
            if not ok:
                reasons.append(why)
                continue
            if not _runtime_class(modes, e):
                reasons.append(
                    f"{o}: source class {e.source_class!r} cannot back a positive row (rule 4)"
                )
                continue
            if e.depth == "telemetry_join" and not pre_ok:
                continue
            found = e
            break
        if found is None:
            missing.append(o)
        else:
            satisfied[o] = found.depth

    # required observed atoms (rule 3: atoms must be anchored)
    for atom_name in mode_cfg.get("required_atoms", []):
        atom = next((a for a in row.observed_atoms if a.name == atom_name), None)
        if atom is None:
            missing.append(f"atom:{atom_name}")
            reasons.append(f"required observed atom {atom_name} absent")
        elif not atom.anchor.concrete:
            missing.append(f"atom:{atom_name}")
            reasons.append(f"observed atom {atom_name} lacks a trace anchor (rule 3)")

    if not missing:
        if all(d == "native" for d in satisfied.values()):
            return RowJudgment(
                desc.backend, row.mode, row.adapter_depth, LABEL_NATIVE,
                satisfied, [], ["all obligations native + anchored"], row.non_claim,
            )
        return RowJudgment(
            desc.backend, row.mode, row.adapter_depth, LABEL_ADAPTER,
            satisfied, [], ["all obligations supplied at allowed adapter depth"], row.non_claim,
        )

    # --- fail-closed classification of the negative space -------------------
    forbidden = {
        (f["mapping"], f["mode"]) for f in modes.get("forbidden_lowerings", [])
    }
    if row.claimed_mapping and (row.claimed_mapping, row.mode) in forbidden:
        reasons.append(
            f"forbidden lowering: {row.claimed_mapping} -> {row.mode} must fail closed"
        )
        return RowJudgment(
            desc.backend, row.mode, row.adapter_depth, LABEL_REJECTED,
            satisfied, missing, reasons, row.non_claim,
        )
    if row.asserts == "conformance" and any(m in ENFORCEMENT_CRITICAL for m in missing):
        reasons.append("asserted conformance misses enforcement-critical obligations")
        return RowJudgment(
            desc.backend, row.mode, row.adapter_depth, LABEL_REJECTED,
            satisfied, missing, reasons, row.non_claim,
        )
    if row.approximation_signals:
        reasons.append(
            "approximation signals present but Lower does not hold (rule 1): "
            + ", ".join(row.approximation_signals)
        )
        return RowJudgment(
            desc.backend, row.mode, row.adapter_depth, LABEL_APPROX,
            satisfied, missing, reasons, row.non_claim,
        )
    reasons.append("evidence inconclusive; no recognized approximation signal exercised")
    return RowJudgment(
        desc.backend, row.mode, row.adapter_depth, LABEL_UNKNOWN,
        satisfied, missing, reasons, row.non_claim,
    )


def judge_descriptor(desc: Descriptor, modes: Optional[Dict[str, Any]] = None) -> List[RowJudgment]:
    modes = modes or load_modes()
    return [judge_row(desc, row, modes) for row in desc.rows]

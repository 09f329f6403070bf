"""Machine-readable backend descriptors: curated, anchored evidence summaries.

A descriptor is an evidence summary for one backend (or container/version of
a backend).  Each row proposes a lowering for one (mode, adapter depth) and
carries per-obligation evidence items.  The checker validates rows against
the mode bundles; it never edits descriptors (the matrix is regenerated, not
hand-written — paper §8.1).

The port keeps its descriptors and the mode table as JSON under its own
``core/data`` (stdlib ``json``, no YAML parser): each curated file holds
exactly what ``yaml.safe_load`` gives for the JAX package's YAML file of
the same stem, and JSON is valid YAML, so either package's loader reads it.
"""
from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Dict, List, Optional

from repro_torch.core.obligations import canonical

DATA_DIR = Path(__file__).parent / "data"
DESCRIPTOR_DIR = DATA_DIR / "descriptors"


@dataclass
class Anchor:
    kind: str = ""  # trace | source | docs | result | artifact
    path: str = ""  # file path or public source reference
    note: str = ""

    @property
    def concrete(self) -> bool:
        return bool(self.kind and self.path and self.note)


@dataclass
class EvidenceItem:
    obligation: str
    support: str = "missing"  # supported | partial | unknown | missing
    depth: str = "native"  # native | telemetry_join | ... | backend_patch
    source_class: str = "docs"
    anchor: Anchor = field(default_factory=Anchor)
    # trace anchors must additionally preserve order and claim scope
    order_preserved: bool = False
    claim_scoped: bool = False


@dataclass
class ObservedAtom:
    name: str
    anchor: Anchor = field(default_factory=Anchor)
    detail: str = ""


@dataclass
class DescriptorRow:
    mode: str
    adapter_depth: str = "none"
    evidence_source: str = "docs"
    asserts: str = "none"  # conformance | observation | none
    claimed_mapping: Optional[str] = None  # feature-name inference being tested
    approximation_signals: List[str] = field(default_factory=list)
    preconditions: Dict[str, bool] = field(default_factory=dict)
    evidence: List[EvidenceItem] = field(default_factory=list)
    observed_atoms: List[ObservedAtom] = field(default_factory=list)
    non_claim: str = ""  # the calibrated non-claim attached to the row


@dataclass
class Descriptor:
    backend: str
    display_name: str = ""
    provenance: Dict[str, Any] = field(default_factory=dict)
    rows: List[DescriptorRow] = field(default_factory=list)
    path: str = ""

    def row(self, mode: str, depth: str = "none") -> DescriptorRow:
        for r in self.rows:
            if r.mode == mode and r.adapter_depth == depth:
                return r
        raise KeyError(f"{self.backend}: no row ({mode}, {depth})")


# ---------------------------------------------------------------------------
# (de)serialization
# ---------------------------------------------------------------------------


def _anchor(d: Optional[Dict[str, Any]]) -> Anchor:
    if not d:
        return Anchor()
    return Anchor(kind=d.get("kind", ""), path=d.get("path", ""), note=d.get("note", ""))


def _evidence(d: Dict[str, Any]) -> EvidenceItem:
    return EvidenceItem(
        obligation=canonical(d["obligation"]),
        support=d.get("support", "missing"),
        depth=d.get("depth", "native"),
        source_class=d.get("source_class", "docs"),
        anchor=_anchor(d.get("anchor")),
        order_preserved=bool(d.get("order_preserved", False)),
        claim_scoped=bool(d.get("claim_scoped", False)),
    )


def row_from_dict(d: Dict[str, Any]) -> DescriptorRow:
    return DescriptorRow(
        mode=d["mode"],
        adapter_depth=d.get("adapter_depth", "none"),
        evidence_source=d.get("evidence_source", "docs"),
        asserts=d.get("asserts", "none"),
        claimed_mapping=d.get("claimed_mapping"),
        approximation_signals=list(d.get("approximation_signals", [])),
        preconditions={k: bool(v) for k, v in (d.get("preconditions") or {}).items()},
        evidence=[_evidence(e) for e in d.get("evidence", [])],
        observed_atoms=[
            ObservedAtom(a["name"], _anchor(a.get("anchor")), a.get("detail", ""))
            for a in d.get("observed_atoms", [])
        ],
        non_claim=d.get("non_claim", ""),
    )


def load_descriptor(path: Path) -> Descriptor:
    raw = json.loads(Path(path).read_text())
    return Descriptor(
        backend=raw["backend"],
        display_name=raw.get("display_name", raw["backend"]),
        provenance=raw.get("provenance", {}),
        rows=[row_from_dict(r) for r in raw.get("rows", [])],
        path=str(path),
    )


def load_all_descriptors(directory: Optional[Path] = None) -> List[Descriptor]:
    directory = directory or DESCRIPTOR_DIR
    return [load_descriptor(p) for p in sorted(Path(directory).glob("*.json"))]


def descriptor_to_dict(desc: Descriptor) -> Dict[str, Any]:
    def clean(obj):
        if dataclasses.is_dataclass(obj):
            return {k: clean(v) for k, v in dataclasses.asdict(obj).items()}
        if isinstance(obj, list):
            return [clean(x) for x in obj]
        return obj

    d = clean(desc)
    d.pop("path", None)
    return d

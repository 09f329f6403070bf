"""Matrix + provenance generation over all descriptors (paper §8.1).

The matrix is regenerated from descriptors and mode obligations — never
edited by hand.  Outputs: results/torch/lowering-matrix.{md,json},
results/torch/descriptor-provenance.md, results/torch/central-result-table.md
(the JAX package's matrix under results/ is its own).
"""
from __future__ import annotations

import json
from dataclasses import asdict
from pathlib import Path
from typing import Dict, List, Optional

from repro_torch.core.descriptors import Descriptor, load_all_descriptors
from repro_torch.core.lowering import (
    LABEL_ADAPTER,
    LABEL_NATIVE,
    RowJudgment,
    judge_descriptor,
    load_modes,
)
from repro_torch.core.obligations import OBLIGATION_CODES, Obligation


def generate_matrix(descriptors: Optional[List[Descriptor]] = None) -> List[RowJudgment]:
    descriptors = descriptors if descriptors is not None else load_all_descriptors()
    out: List[RowJudgment] = []
    for d in descriptors:
        out.extend(judge_descriptor(d))
    return out


def matrix_to_markdown(rows: List[RowJudgment]) -> str:
    lines = [
        "# Generated lowering matrix",
        "",
        "Regenerated from descriptors + modes.json — do not edit.",
        "",
        "| backend | mode | adapter depth | label | missing obligations | non-claim |",
        "|---|---|---|---|---|---|",
    ]
    for r in rows:
        lines.append(
            f"| {r.backend} | {r.mode} | {r.adapter_depth} | **{r.label}** | "
            f"{', '.join(r.missing) or '—'} | {r.non_claim or '—'} |"
        )
    pos = [r for r in rows if r.positive]
    lines += [
        "",
        f"Rows: {len(rows)}; positive: {len(pos)} "
        f"(native_sound: {sum(1 for r in rows if r.label == LABEL_NATIVE)}, "
        f"sound_with_adapter: {sum(1 for r in rows if r.label == LABEL_ADAPTER)})",
    ]
    return "\n".join(lines)


def _code(obligation: str) -> str:
    try:
        return OBLIGATION_CODES[Obligation(obligation)]
    except ValueError:
        return obligation


def provenance_to_markdown(descriptors: List[Descriptor]) -> str:
    """Per-positive-row anchor list with compact obligation codes (§8.1)."""
    lines = [
        "# Descriptor provenance for positive rows",
        "",
        "| descriptor | mode / depth / evidence | anchors | obligations | non-claim |",
        "|---|---|---|---|---|",
    ]
    for d in descriptors:
        for row, judg in zip(d.rows, judge_descriptor(d)):
            if not judg.positive:
                continue
            codes = ", ".join(_code(o) for o in judg.satisfied)
            anchors = "; ".join(
                sorted({e.anchor.path for e in row.evidence if e.anchor.concrete})
            )
            lines.append(
                f"| {Path(d.path).name if d.path else d.backend} | "
                f"{row.mode} / {row.adapter_depth} / {row.evidence_source} | "
                f"{anchors} | {codes} | {row.non_claim} |"
            )
    return "\n".join(lines)


def central_result_table(rows: List[RowJudgment]) -> str:
    """The paper's Table 6-style summary per substrate."""
    by_backend: Dict[str, List[RowJudgment]] = {}
    for r in rows:
        by_backend.setdefault(r.backend, []).append(r)
    lines = [
        "# Central result table",
        "",
        "| substrate | best current evidence | labels |",
        "|---|---|---|",
    ]
    for backend, rs in sorted(by_backend.items()):
        pos = [r for r in rs if r.positive]
        best = (
            "; ".join(f"{r.mode}@{r.adapter_depth}={r.label}" for r in pos)
            if pos
            else "substrate / approximation rows only"
        )
        counts: Dict[str, int] = {}
        for r in rs:
            counts[r.label] = counts.get(r.label, 0) + 1
        lines.append(
            f"| {backend} | {best} | "
            + ", ".join(f"{k}:{v}" for k, v in sorted(counts.items()))
            + " |"
        )
    return "\n".join(lines)


def write_outputs(out_dir: Path = Path("results/torch")) -> Dict[str, str]:
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    descriptors = load_all_descriptors()
    rows = generate_matrix(descriptors)
    (out_dir / "lowering-matrix.md").write_text(matrix_to_markdown(rows))
    (out_dir / "lowering-matrix.json").write_text(
        json.dumps([asdict(r) for r in rows], indent=1)
    )
    (out_dir / "descriptor-provenance.md").write_text(provenance_to_markdown(descriptors))
    (out_dir / "central-result-table.md").write_text(central_result_table(rows))
    return {
        "rows": str(len(rows)),
        "native_sound": str(sum(1 for r in rows if r.label == LABEL_NATIVE)),
        "sound_with_adapter": str(sum(1 for r in rows if r.label == LABEL_ADAPTER)),
    }


if __name__ == "__main__":
    stats = write_outputs()
    print(json.dumps(stats, indent=1))

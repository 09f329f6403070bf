"""Lint framework: file contexts, suppression comments, findings, report.

A copy of the JAX package's ``analysis/framework.py`` (the port keeps its
own).  Self-contained on the stdlib (``ast``, ``re``, ``json``) — the only
project imports are the port's schemas the rules cross-check (pulled in
lazily by the rules themselves, never by this module), so the linter can
parse and judge a broken tree without executing it.
"""
from __future__ import annotations

import ast
import json
import re
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, Iterable, List, Optional, Sequence

# "# lint: allow[rule-id] reason..." — trailing on the offending line, or a
# standalone comment on the line directly above it.
_SUPPRESS_RE = re.compile(r"#\s*lint:\s*allow\[([a-z0-9-]+)\]\s*(.*)$")


@dataclass(frozen=True)
class Suppression:
    rule: str
    line: int  # line the comment sits on
    reason: str


@dataclass
class Finding:
    rule: str
    path: str
    line: int
    message: str
    hint: str
    suppressed: bool = False
    suppress_reason: str = ""

    def location(self) -> str:
        return f"{self.path}:{self.line}"

    def to_dict(self) -> Dict[str, object]:
        return {
            "rule": self.rule,
            "file": self.path,
            "line": self.line,
            "message": self.message,
            "hint": self.hint,
            "suppressed": self.suppressed,
            "suppress_reason": self.suppress_reason,
        }


@dataclass
class FileContext:
    """One parsed source file plus its suppression comments."""

    path: Path
    rel: str  # repo-relative display path
    source: str
    tree: ast.AST
    suppressions: List[Suppression] = field(default_factory=list)

    @property
    def module_stem(self) -> str:
        return self.path.stem

    @property
    def package_rel(self) -> str:
        """Path relative to the scanned root, POSIX separators."""
        return self.rel.replace("\\", "/")

    def suppression_for(self, rule: str, line: int) -> Optional[Suppression]:
        """A suppression applies to findings on its own line or the line
        directly below it (so multi-line calls can carry it above)."""
        for s in self.suppressions:
            if s.rule == rule and s.line in (line, line - 1):
                return s
        return None


def _parse_suppressions(source: str) -> List[Suppression]:
    out: List[Suppression] = []
    for i, text in enumerate(source.splitlines(), start=1):
        m = _SUPPRESS_RE.search(text)
        if m:
            out.append(Suppression(rule=m.group(1), line=i, reason=m.group(2).strip()))
    return out


def load_files(paths: Sequence[str], root: Optional[Path] = None) -> List[FileContext]:
    """Collect every ``.py`` file under the given paths (files or dirs)."""
    root = Path(root) if root else Path.cwd()
    files: List[Path] = []
    for p in paths:
        pth = Path(p)
        if pth.is_dir():
            files.extend(sorted(pth.rglob("*.py")))
        elif pth.suffix == ".py":
            files.append(pth)
    out: List[FileContext] = []
    for f in files:
        source = f.read_text()
        try:
            tree = ast.parse(source, filename=str(f))
        except SyntaxError as e:
            raise SystemExit(f"{f}: cannot lint a file that does not parse: {e}")
        try:
            rel = str(f.resolve().relative_to(root.resolve()))
        except ValueError:
            rel = str(f)
        out.append(
            FileContext(
                path=f, rel=rel, source=source, tree=tree,
                suppressions=_parse_suppressions(source),
            )
        )
    return out


class Rule:
    """A lint rule: inspects every file (cross-file state allowed) and
    yields raw findings; run_rules applies suppressions."""

    rule_id: str = ""
    doc: str = ""

    def run(self, files: List[FileContext]) -> Iterable[Finding]:  # pragma: no cover
        raise NotImplementedError


def apply_suppressions(files: List[FileContext], findings: List[Finding]) -> List[Finding]:
    """Mark findings covered by a ``lint: allow`` comment as suppressed.
    A suppression WITHOUT a reason does not suppress — it becomes its own
    finding, so every allow[] in the tree documents why."""
    by_rel = {f.rel: f for f in files}
    out: List[Finding] = []
    for fnd in findings:
        ctx = by_rel.get(fnd.path)
        sup = ctx.suppression_for(fnd.rule, fnd.line) if ctx else None
        if sup is not None:
            if sup.reason:
                fnd.suppressed = True
                fnd.suppress_reason = sup.reason
            else:
                out.append(
                    Finding(
                        rule=fnd.rule,
                        path=fnd.path,
                        line=sup.line,
                        message=f"suppression allow[{fnd.rule}] carries no reason",
                        hint="write '# lint: allow[rule-id] <why this site is deliberate>'",
                    )
                )
        out.append(fnd)
    return out


def run_rules(files: List[FileContext], rules: Sequence[Rule]) -> List[Finding]:
    findings: List[Finding] = []
    for rule in rules:
        findings.extend(rule.run(files))
    findings = apply_suppressions(files, findings)
    seen = set()
    unique: List[Finding] = []
    for f in findings:
        key = (f.rule, f.path, f.line, f.message)
        if key not in seen:
            seen.add(key)
            unique.append(f)
    unique.sort(key=lambda f: (f.path, f.line, f.rule))
    return unique


def report_dict(
    paths: Sequence[str], rules: Sequence[Rule], findings: List[Finding]
) -> Dict[str, object]:
    active = [f for f in findings if not f.suppressed]
    return {
        "tool": "repro_torch.analysis.lint",
        "paths": list(paths),
        "rules": [{"id": r.rule_id, "doc": r.doc} for r in rules],
        "counts": {
            "findings": len(active),
            "suppressed": len(findings) - len(active),
            "by_rule": {
                r.rule_id: sum(1 for f in active if f.rule == r.rule_id) for r in rules
            },
        },
        "findings": [f.to_dict() for f in findings],
    }


def write_report(path: Path, report: Dict[str, object]) -> None:
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps(report, indent=1) + "\n")


# --- small AST helpers shared by the rules -----------------------------------


def dotted_name(node: ast.AST) -> str:
    """'a.b.c' for nested Attribute/Name chains, '' when dynamic."""
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return ""


def call_name(call: ast.Call) -> str:
    return dotted_name(call.func)


def literal_str(node: Optional[ast.AST]) -> Optional[str]:
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        return node.value
    return None


def walk_functions(tree: ast.AST):
    for node in ast.walk(tree):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            yield node

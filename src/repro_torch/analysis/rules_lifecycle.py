"""L2 — pin/unpin balance, and L3 — fail-closed exception paths.

L2 is the static twin of the chunked-prefill pinning invariant:
a chain pinned while it grows must be unwound on EVERY exit, including
exception exits — a leaked pin silently shrinks the evictable pool until
admission refuses work that should have fit.  A function that calls
``pin_chain`` must therefore also unpin on an exception path (an
``except`` handler or ``finally`` block), or carry a suppression naming
where ownership transfers to.  Raw ``.ref`` twiddles outside
``kv_cache.py`` are findings too: the named pair is the auditable
surface.

L3 is the fail-closed doctrine applied to ``except`` handlers in
``serving/``: a handler must re-raise, invoke a refusal helper (the
trigger-attributed fail-closed paths), or carry the caught fault to its
join point (``<x>.error = ...`` — the transfer queue's poisoned-job
pattern).  A handler that does none of these swallows an outcome the
event log will never witness.  In ``kernels/`` the rule is stricter: a
handler must re-raise, with no refusal helper and no carried fault.  That
is the port's no-fallback rule made static: a wrapper that catches a build
or launch error and goes on with its plain version hides the kernel's
failure from the engine, whose step loop is where a launch error becomes a
fail-closed refusal.
"""
from __future__ import annotations

import ast
from typing import Iterable, List

from repro_torch.analysis.framework import FileContext, Finding, Rule

_PIN = "pin_chain"
_UNPIN = "unpin_chain"

# Helpers whose call inside a handler constitutes a trigger-attributed
# fail-closed outcome (each ends in ordered refusal events + counter).
REFUSAL_HELPERS = frozenset(
    {
        "_refuse_allocation",
        "_fail_closed_error",
        "_refuse",
        "abort",
        "_job_fault_at_join",
        "_finish_error",
    }
)


def _calls_named(tree: ast.AST, names) -> List[ast.Call]:
    out = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Call):
            fn = node.func
            if isinstance(fn, ast.Name) and fn.id in names:
                out.append(node)
            elif isinstance(fn, ast.Attribute) and fn.attr in names:
                out.append(node)
    return out


class PinBalanceRule(Rule):
    rule_id = "pin-balance"
    doc = (
        "every pin_chain has an unpin_chain on an exception exit in the same "
        "function; raw .ref twiddles only in kv_cache.py"
    )

    def run(self, files: List[FileContext]) -> Iterable[Finding]:
        for ctx in files:
            # raw refcount manipulation outside the defining module
            if ctx.module_stem != "kv_cache":
                for node in ast.walk(ctx.tree):
                    if (
                        isinstance(node, ast.AugAssign)
                        and isinstance(node.target, ast.Attribute)
                        and node.target.attr == "ref"
                    ):
                        yield Finding(
                            rule=self.rule_id,
                            path=ctx.rel,
                            line=node.lineno,
                            message="raw block .ref manipulation outside kv_cache.py",
                            hint="use pin_chain/unpin_chain — the pair is what "
                            "this rule can audit",
                        )

            for fn in [
                n
                for n in ast.walk(ctx.tree)
                if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))
            ]:
                pins = _calls_named(fn, {_PIN})
                if not pins:
                    continue
                # an unpin on an exception exit: inside any except handler
                # or finally block of this function
                unwound = False
                for node in ast.walk(fn):
                    if isinstance(node, ast.Try):
                        for h in node.handlers:
                            if any(_calls_named(s, {_UNPIN}) for s in h.body):
                                unwound = True
                        if any(_calls_named(s, {_UNPIN}) for s in node.finalbody):
                            unwound = True
                if not unwound:
                    for pin in pins:
                        yield Finding(
                            rule=self.rule_id,
                            path=ctx.rel,
                            line=pin.lineno,
                            message=f"pin_chain in '{fn.name}' has no unpin_chain "
                            "on any exception exit",
                            hint="wrap in try/finally (or unwind in an except "
                            "handler); if ownership transfers, suppress with "
                            "the releasing site named",
                        )


def _handler_is_fail_closed(handler: ast.ExceptHandler) -> bool:
    for node in ast.walk(handler):
        if isinstance(node, ast.Raise):
            return True
        if isinstance(node, ast.Call):
            fn = node.func
            name = fn.attr if isinstance(fn, ast.Attribute) else getattr(fn, "id", "")
            if name in REFUSAL_HELPERS:
                return True
        # fault-carrying: the caught exception is assigned to an .error
        # attribute and re-raised at the join point (transfer queue jobs)
        if isinstance(node, ast.Assign):
            for tgt in node.targets:
                if isinstance(tgt, ast.Attribute) and tgt.attr == "error":
                    return True
    return False


def _handler_reraises(handler: ast.ExceptHandler) -> bool:
    return any(isinstance(node, ast.Raise) for node in ast.walk(handler))


class FailClosedExceptRule(Rule):
    rule_id = "fail-closed-except"
    doc = (
        "except handlers in serving/ must re-raise, call a refusal helper, or "
        "carry the fault to its join point — no silent swallows; in kernels/ "
        "they must re-raise (no fallback to the plain version)"
    )

    def run(self, files: List[FileContext]) -> Iterable[Finding]:
        for ctx in files:
            rel = ctx.package_rel.replace("\\", "/")
            in_kernels = "kernels/" in rel
            if "serving/" not in rel and not in_kernels:
                continue
            for node in ast.walk(ctx.tree):
                if not isinstance(node, ast.Try):
                    continue
                for handler in node.handlers:
                    caught = (
                        ast.unparse(handler.type) if handler.type is not None else "BaseException"
                    )
                    if in_kernels:
                        if _handler_reraises(handler):
                            continue
                        yield Finding(
                            rule=self.rule_id,
                            path=ctx.rel,
                            line=handler.lineno,
                            message=f"except {caught} in a kernel module does not "
                            "re-raise",
                            hint="let the build or launch error propagate: the "
                            "engine's step loop turns it into a fail-closed "
                            "refusal, and a plain-version fallback hides it",
                        )
                        continue
                    if _handler_is_fail_closed(handler):
                        continue
                    yield Finding(
                        rule=self.rule_id,
                        path=ctx.rel,
                        line=handler.lineno,
                        message=f"except {caught} swallows without re-raise or "
                        "fail-closed refusal",
                        hint="re-raise, call a refusal helper with trigger "
                        "attribution, assign the fault to its join point, or "
                        "suppress with the reason the swallow is safe",
                    )

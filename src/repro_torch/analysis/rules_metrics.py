"""L4 — metric drift (the JAX package's rule, checked against the port's
``serving/metrics.py`` registry and ``core/analyzer.py`` reconcile rules).

The paper's central distinction: observability-shaped primitives are
weaker than accepted obligations because a counter can drift from the
semantics it summarizes and nothing fails.  The runtime answer is
``analyzer.check_metrics_reconcile`` (metric == event-log witness, both
directions); the static answer is this rule, which proves the *coverage*
of that reconciliation never silently narrows:

  - every metric family registered anywhere through one of the
    registration methods of the port's ``MetricsRegistry``
    (``registry.counter/gauge/histogram("name", ...)``) must appear in a
    reconcile rule in ``core/analyzer.py`` or in the EXEMPT table below
    (with the reason it has no event witness);
  - every family name the reconcile rules reference must still be
    registered somewhere (a rename that orphans a rule fails);
  - an EXEMPT entry for a family that IS reconciled is stale and fails;
  - ``.increment(...)`` on a receiver that cannot be resolved to a
    registered family is a finding (suppress where binding is dynamic).
"""
from __future__ import annotations

import ast
from typing import Dict, Iterable, List, Tuple

from repro_torch.analysis.framework import FileContext, Finding, Rule, literal_str

_REGISTER_METHODS = frozenset({"counter", "gauge", "histogram"})


def register_methods() -> frozenset:
    """The registration methods, checked against the port's registry: a
    method renamed there would otherwise hide every family it registers."""
    from repro_torch.serving.metrics import MetricsRegistry

    missing = [m for m in sorted(_REGISTER_METHODS) if not callable(getattr(MetricsRegistry, m, None))]
    if missing:
        raise RuntimeError(f"MetricsRegistry no longer has {missing}: update rules_metrics.py")
    return _REGISTER_METHODS
# analyzer helpers whose literal second argument names a reconciled family
_RECONCILE_HELPERS = frozenset({"_counter_series", "_histogram_counts"})

# Families deliberately outside metric<->event reconciliation.  Every entry
# carries the reason; a stale entry (family reconciled after all, or no
# longer registered) is itself a finding.
EXEMPT: Dict[str, str] = {
    "scheduler_step_occupancy": "gauge: last-step load factor, point-in-time by design",
    "tier_blocks": "gauge: point-in-time tier occupancy, no event witness",
    "tier_bytes": "gauge: point-in-time tier occupancy, no event witness",
    "tier_quarantined": "gauge: current quarantine flag; the transition is the "
    "tier_quarantined EVENT, which the tracing layer pairs",
    "decode_stall_steps_total": "structurally-unreachable counter (stays 0), "
    "not reconciled against events",
    "transfer_jobs_executed_total": "queue-internal liveness counter, "
    "mirrors the transfer queue's executed_jobs",
    "transfer_worker_deaths_total": "queue-internal liveness counter, "
    "mirrors the transfer queue's worker_deaths",
    "transfer_queue_retries_total": "queue-internal backoff counter; the "
    "engine-visible mirror transfer_retries_total IS reconciled (rule 4)",
    "chaos_faults_injected_total": "plan ground truth: the FaultPlan's own "
    "counters, not the event log",
    "pages_shared": "gauge: point-in-time count of device pages with more than "
    "one live reference, no event witness",
}


class MetricDriftRule(Rule):
    rule_id = "metric-drift"
    doc = (
        "registered metric families are reconciled against the event log "
        "(analyzer.check_metrics_reconcile) or explicitly exempted"
    )

    def run(self, files: List[FileContext]) -> Iterable[Finding]:
        register = register_methods()
        registered: Dict[str, Tuple[str, int]] = {}
        attr_to_family: Dict[str, str] = {}
        reconciled: Dict[str, Tuple[str, int]] = {}
        increments: List[Tuple[FileContext, ast.Call, str]] = []

        for ctx in files:
            for node in ast.walk(ctx.tree):
                if isinstance(node, ast.Call):
                    fn = node.func
                    attr = fn.attr if isinstance(fn, ast.Attribute) else getattr(fn, "id", "")
                    if (
                        isinstance(fn, ast.Attribute)
                        and attr in register
                        and len(node.args) >= 2
                    ):
                        name = literal_str(node.args[0])
                        if name is not None:
                            registered.setdefault(name, (ctx.rel, node.lineno))
                    if attr in _RECONCILE_HELPERS and len(node.args) >= 2:
                        name = literal_str(node.args[1])
                        if name is not None:
                            reconciled.setdefault(name, (ctx.rel, node.lineno))
                    if isinstance(fn, ast.Attribute) and attr == "increment":
                        increments.append((ctx, node, ""))
                # map attribute/name -> family for increment resolution
                if isinstance(node, ast.Assign) and isinstance(node.value, ast.Call):
                    call = node.value
                    if (
                        isinstance(call.func, ast.Attribute)
                        and call.func.attr in register
                        and call.args
                    ):
                        fam = literal_str(call.args[0])
                        if fam is None:
                            continue
                        for tgt in node.targets:
                            if isinstance(tgt, ast.Attribute):
                                attr_to_family[tgt.attr] = fam
                            elif isinstance(tgt, ast.Name):
                                attr_to_family[tgt.id] = fam

        # direction 1: registered but neither reconciled nor exempt
        for name, (rel, line) in sorted(registered.items()):
            if name in reconciled:
                continue
            if name in EXEMPT:
                continue
            yield Finding(
                rule=self.rule_id,
                path=rel,
                line=line,
                message=f"metric family {name!r} registered but not reconciled "
                "in analyzer.check_metrics_reconcile",
                hint="add a reconcile rule tying it to its event witness, or "
                "an EXEMPT entry (rules_metrics.py) with the reason",
            )
        # direction 2: reconciled but no longer registered anywhere
        for name, (rel, line) in sorted(reconciled.items()):
            if name not in registered:
                yield Finding(
                    rule=self.rule_id,
                    path=rel,
                    line=line,
                    message=f"reconcile rule references {name!r} but no "
                    "registration exists",
                    hint="the family was renamed or removed — update the "
                    "analyzer rule",
                )
        # stale exemptions (a family that IS reconciled must not also be
        # exempt — the table would mask a future de-reconciliation)
        for name in sorted(EXEMPT):
            if name in reconciled:
                rel, line = reconciled[name]
                yield Finding(
                    rule=self.rule_id,
                    path=rel,
                    line=line,
                    message=f"EXEMPT entry for {name!r} is stale: the family IS "
                    "reconciled",
                    hint="drop the exemption from rules_metrics.py",
                )

        # unresolvable .increment receivers
        for ctx, call, _ in increments:
            recv = call.func.value
            attr = recv.attr if isinstance(recv, ast.Attribute) else getattr(recv, "id", "")
            if attr and attr in attr_to_family:
                continue
            yield Finding(
                rule=self.rule_id,
                path=ctx.rel,
                line=call.lineno,
                message=f".increment() receiver '{attr or ast.unparse(recv)}' does "
                "not resolve to a registered metric family",
                hint="assign the family from registry.counter(...) where the "
                "linter can see it, or suppress where binding is dynamic",
            )

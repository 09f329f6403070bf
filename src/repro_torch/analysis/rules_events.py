"""L1 — emit-site discipline (the JAX package's rule, checked against the
port's ``core/events.py``).

Event emission is the witness surface the whole lowering relation stands
on; the analyzer can only replay what the boundary modules chose to
emit.  This rule proves three things about every ``*.emit(...)`` call
and every direct ``Event(...)`` construction in the tree:

  1. the call lives in a sanctioned boundary module — models, kernels,
     training, launch, analysis and the non-boundary core modules must not grow
     emit sites a chaos campaign has never audited;
  2. the event name is a literal resolvable against
     ``core.events.ALL_EVENT_NAMES`` (a dynamic name defeats every
     static payload check downstream and is only legal on the replay
     path, with a suppression);
  3. the payload keyword set satisfies ``PAYLOAD_SCHEMA`` (required
     keys present) and introduces nothing outside
     ``PAYLOAD_OPTIONAL`` — the static twin of the runtime validation
     in ``EventLog.emit``.
"""
from __future__ import annotations

import ast
from typing import Iterable, List

from repro_torch.analysis.framework import FileContext, Finding, Rule, literal_str

# The event-emitting boundary taxonomy, as module stems of the port's tree.
# The first group is the transfer/scheduler boundary set from the paper's
# lowering relation (serving/); the second group are the remaining
# sanctioned emitters: the engine front-ends (serving/engine.py for KV
# chains, serving/snapshot_engine.py for recurrent-state snapshots), the
# block-pool store/evict boundary, the router, the claim ledger and the
# event layer itself (core/).  Everything else — models, kernels, configs,
# analysis — is emit-free by construction.
BOUNDARY_MODULES = frozenset(
    {
        "core_engine",
        "offload",
        "transfer_queue",
        "tiers",
        "scheduler_loop",
        "chaos",
        "metrics",
        "tracing",
    }
) | frozenset(
    {
        "engine",
        "snapshot_engine",
        "kv_cache",
        "router",
        "claims",
        "events",
    }
)

# Dedicated Event fields accepted by EventLog.emit as keywords — never
# part of the payload dict (the blast-radius projection surface).
_EMIT_PARAMS = frozenset({"request_id", "claim_id", "ts", "_validate"})

# Direct Event(...) construction is only legal where the type is defined.
_EVENT_CTOR_MODULES = frozenset({"events"})


class EmitSiteRule(Rule):
    rule_id = "emit-site"
    doc = (
        "events.emit()/Event() only in boundary modules, with literal names "
        "in ALL_EVENT_NAMES and payload keyword sets matching PAYLOAD_SCHEMA"
    )

    def run(self, files: List[FileContext]) -> Iterable[Finding]:
        from repro_torch.core.events import ALL_EVENT_NAMES, PAYLOAD_OPTIONAL, PAYLOAD_SCHEMA

        for ctx in files:
            for node in ast.walk(ctx.tree):
                if not isinstance(node, ast.Call):
                    continue
                if (
                    isinstance(node.func, ast.Name)
                    and node.func.id == "Event"
                    and ctx.module_stem not in _EVENT_CTOR_MODULES
                ):
                    yield Finding(
                        rule=self.rule_id,
                        path=ctx.rel,
                        line=node.lineno,
                        message="direct Event() construction outside core/events.py",
                        hint="emit through an EventLog so seq/ts stamping and "
                        "payload validation apply",
                    )
                    continue
                if not (isinstance(node.func, ast.Attribute) and node.func.attr == "emit"):
                    continue

                if ctx.module_stem not in BOUNDARY_MODULES:
                    yield Finding(
                        rule=self.rule_id,
                        path=ctx.rel,
                        line=node.lineno,
                        message=f"emit site in non-boundary module '{ctx.module_stem}'",
                        hint="route the event through a boundary module "
                        "(see BOUNDARY_MODULES in repro_torch/analysis/rules_events.py)",
                    )

                name = literal_str(node.args[0]) if node.args else None
                if name is None:
                    yield Finding(
                        rule=self.rule_id,
                        path=ctx.rel,
                        line=node.lineno,
                        message="event name is not a string literal",
                        hint="pass the event name literally so the payload "
                        "schema is statically checkable",
                    )
                    continue
                if name not in ALL_EVENT_NAMES:
                    yield Finding(
                        rule=self.rule_id,
                        path=ctx.rel,
                        line=node.lineno,
                        message=f"unknown event name {name!r}",
                        hint="add it to core/events.py NATIVE_EVENTS + "
                        "PAYLOAD_SCHEMA or fix the typo",
                    )
                    continue

                if any(kw.arg is None for kw in node.keywords):
                    yield Finding(
                        rule=self.rule_id,
                        path=ctx.rel,
                        line=node.lineno,
                        message=f"emit of {name!r} splats **kwargs — payload "
                        "not statically checkable",
                        hint="pass payload keys explicitly, or suppress on the "
                        "replay path where runtime validation covers it",
                    )
                    continue

                provided = frozenset(
                    kw.arg for kw in node.keywords if kw.arg not in _EMIT_PARAMS
                )
                required = PAYLOAD_SCHEMA[name]
                optional = PAYLOAD_OPTIONAL.get(name, frozenset())
                missing = required - provided
                unknown = provided - required - optional
                if missing:
                    yield Finding(
                        rule=self.rule_id,
                        path=ctx.rel,
                        line=node.lineno,
                        message=f"emit of {name!r} missing required payload "
                        f"keys {sorted(missing)}",
                        hint="carry the full witness payload or adjust "
                        "PAYLOAD_SCHEMA if the contract really changed",
                    )
                if unknown:
                    yield Finding(
                        rule=self.rule_id,
                        path=ctx.rel,
                        line=node.lineno,
                        message=f"emit of {name!r} carries undeclared payload "
                        f"keys {sorted(unknown)}",
                        hint="declare them in PAYLOAD_SCHEMA/PAYLOAD_OPTIONAL "
                        "so the analyzer and tracing layer know the shape",
                    )

"""ResidentClaim obligations (paper Table 1) and their compact codes (§8.1)."""
from __future__ import annotations

from enum import Enum


class Obligation(str, Enum):
    CLAIM_IDENTITY = "claim_identity"
    EXPLICIT_ACCEPTANCE = "explicit_acceptance"
    MATERIALIZATION_PREDICATE = "materialization_predicate"
    FOOTPRINT_ACCOUNTING = "footprint_accounting"
    ORDERED_LIFECYCLE_EVENTS = "ordered_lifecycle_events"
    CLAIM_MATERIALIZED_EVENT = "claim_materialized_event"
    CLAIM_DEMOTED_BEFORE_LOSS = "claim_demoted_before_loss"
    CLAIM_EXPIRED_BOUNDARY = "claim_expired_boundary"
    OFFLOAD_RESTORABILITY = "offload_restorability"
    RESTORATION_FAILURE_OUTCOME = "restoration_failure_outcome"
    VICTIM_EXCLUSION_BEFORE_VIOLATION = "victim_exclusion_before_violation"
    EXPLICIT_CONFLICT_ACTION = "explicit_conflict_action"
    BLOCKING_CLAIM_IDS = "blocking_claim_ids"
    CLAIM_HARM_ATTRIBUTION = "claim_harm_attribution"
    CLAIM_SCOPED_TELEMETRY = "claim_scoped_telemetry"
    PRIORITY_INFLUENCE = "priority_influence"
    ROUTE_COST_ATTRIBUTION = "route_cost_attribution"
    PLACEMENT_ATTRIBUTION = "placement_attribution"
    REUSE_ROUTING_ATTRIBUTION = "reuse_routing_attribution"


# Backward-compatible alias kept by the checker (paper §3):
# active_refusal_or_defer -> explicit_conflict_action
OBLIGATION_ALIASES = {"active_refusal_or_defer": Obligation.EXPLICIT_CONFLICT_ACTION.value}

# Compact provenance codes (paper §8.1)
OBLIGATION_CODES = {
    Obligation.CLAIM_IDENTITY: "I",
    Obligation.EXPLICIT_ACCEPTANCE: "A",
    Obligation.MATERIALIZATION_PREDICATE: "P",
    Obligation.FOOTPRINT_ACCOUNTING: "F",
    Obligation.ORDERED_LIFECYCLE_EVENTS: "L",
    Obligation.CLAIM_MATERIALIZED_EVENT: "M",
    Obligation.CLAIM_DEMOTED_BEFORE_LOSS: "D",
    Obligation.CLAIM_EXPIRED_BOUNDARY: "E",
    Obligation.OFFLOAD_RESTORABILITY: "R",
    Obligation.RESTORATION_FAILURE_OUTCOME: "RF",
    Obligation.VICTIM_EXCLUSION_BEFORE_VIOLATION: "V",
    Obligation.EXPLICIT_CONFLICT_ACTION: "X",
    Obligation.BLOCKING_CLAIM_IDS: "B",
    Obligation.CLAIM_HARM_ATTRIBUTION: "H",
    Obligation.CLAIM_SCOPED_TELEMETRY: "T",
    Obligation.PRIORITY_INFLUENCE: "Pr",
    Obligation.ROUTE_COST_ATTRIBUTION: "RC",
    Obligation.PLACEMENT_ATTRIBUTION: "PL",
    Obligation.REUSE_ROUTING_ATTRIBUTION: "RR",
}

# Obligations whose absence under an asserted conformance mapping makes the
# row *rejected* rather than merely approximate (telemetry cannot create
# enforcement — paper Table 2).
ENFORCEMENT_CRITICAL = frozenset(
    {
        Obligation.VICTIM_EXCLUSION_BEFORE_VIOLATION.value,
        Obligation.EXPLICIT_CONFLICT_ACTION.value,
        Obligation.BLOCKING_CLAIM_IDS.value,
        Obligation.RESTORATION_FAILURE_OUTCOME.value,
    }
)


def canonical(obligation: str) -> str:
    return OBLIGATION_ALIASES.get(obligation, obligation)

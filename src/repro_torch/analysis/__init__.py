"""Static claim-lifecycle invariant linter for the port (stdlib ``ast`` only).

The counterpart of the JAX package's ``analysis`` package, with the same
module names and, where a rule carries over, the same rule ids.  The port's
``core/analyzer.py`` replays event logs to enforce ordered lifecycle
events, claim-scoped outcomes and fail-closed refusal dynamically; these
rules prove the same properties of the source tree:

  emit-site            (L1)  event emission happens only at boundary
                             modules, with literal names and payload
                             keyword sets matching the port's
                             core/events.py PAYLOAD_SCHEMA
  pin-balance          (L2)  every pin_chain is matched by an
                             unpin_chain on exception exits
  fail-closed-except   (L3)  no except handler in serving/ silently
                             swallows — re-raise, refuse with trigger
                             attribution, or carry the fault; in kernels/
                             every handler re-raises (no wrapper falls
                             back to its plain version)
  metric-drift         (L4)  every family registered through the port's
                             serving/metrics.py is either reconciled
                             against the event log or explicitly exempted
  nondeterminism       (L5)  no wall-clock or unseeded randomness; a
                             torch random draw names its generator
  device-path-purity   (L6)  no event, metric, clock read or device-to-host
                             sync in models/ or the kernel wrappers, which
                             run once per layer per step

Run: ``python -m repro_torch.analysis.lint src/repro_torch [--strict]``.
Suppress a deliberate finding per site with a trailing or preceding
comment: ``# lint: allow[rule-id] <reason>`` — a reason is mandatory.
"""

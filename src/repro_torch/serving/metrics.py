"""Claim-scoped metrics registry: labeled counters, gauges and histograms
with Prometheus text exposition and a JSON snapshot.

The paper's central distinction (§3) is that observability-shaped
primitives — counters, events, routing hints — are *weaker* than accepted
obligations: a counter can drift from the semantics it claims to summarize
and nothing fails.  This repo holds its own telemetry to the stronger
standard: every family exported here is **reconcilable against the ordered
event log** (core/analyzer.check_metrics_reconcile), so a metric that
disagrees with the witness events is a fail-closed finding in the test
suite, not a silently lying dashboard.

Design notes:

  - This module is a LEAF (no serving imports), like chaos.py — every
    layer (tiers, queue, connector, engines, chaos) can depend on it
    without cycles.
  - One registry per engine (``EngineCore.metrics``): campaign harnesses
    spin up hundreds of engines and must never share counter state.
  - Thread safety: the transfer worker thread observes histograms and
    bumps counters concurrently with the engine thread; every mutation
    takes the registry-wide lock (contention is negligible at this
    scale and the lock makes exposition a consistent snapshot).
  - Histograms keep their raw samples alongside the cumulative buckets.
    Bucket counts are the Prometheus surface; the samples back the exact
    p50/p95/p99 percentiles exported to results/BENCH_serving.json
    (bounded workloads — campaign-scale, not fleet-scale, memory).
  - ``fail_closed_total{trigger=...}`` (previously chaos.FailClosedCounters)
    is now ONE counter family in this registry — the single counting
    path.  ``EngineCore.fail_closed_total()`` remains as a dict view.
"""
from __future__ import annotations

import json
import math
import threading
from typing import Any, Dict, Iterable, List, Optional, Sequence, Tuple

__all__ = [
    "CounterFamily",
    "GaugeFamily",
    "HistogramFamily",
    "LATENCY_BUCKETS",
    "MetricsRegistry",
]

# Explicit bucket bounds for every *_seconds histogram in the serving
# stack (documented in docs/observability.md).  Spans sub-millisecond
# kernel launches through multi-second cold-compile prefills.
LATENCY_BUCKETS: Tuple[float, ...] = (
    0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05,
    0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0,
)


def _label_key(label_names: Tuple[str, ...], labels: Dict[str, str]) -> Tuple[str, ...]:
    if set(labels) != set(label_names):
        raise ValueError(
            f"labels {sorted(labels)} != declared label names {sorted(label_names)}"
        )
    return tuple(str(labels[n]) for n in label_names)


def _prom_labels(label_names: Tuple[str, ...], key: Tuple[str, ...]) -> str:
    if not label_names:
        return ""
    inner = ",".join(f'{n}="{v}"' for n, v in zip(label_names, key))
    return "{" + inner + "}"


class _Family:
    """One metric family: a name, help text, declared label names, and a
    child per label-value combination."""

    kind = "untyped"

    def __init__(self, name: str, help: str, label_names: Sequence[str], lock: threading.Lock):
        self.name = name
        self.help = help
        self.label_names = tuple(label_names)
        self._lock = lock

    def _key(self, labels: Dict[str, str]) -> Tuple[str, ...]:
        return _label_key(self.label_names, labels)


class CounterFamily(_Family):
    """Monotonic counter family.  ``inc(n, **labels)`` is the general form;
    ``increment(value)`` keeps the old FailClosedCounters call shape for
    exactly-one-label families (label value as the positional arg)."""

    kind = "counter"

    def __init__(self, name, help, label_names, lock):
        super().__init__(name, help, label_names, lock)
        self._values: Dict[Tuple[str, ...], float] = {}

    def inc(self, n: float = 1, **labels: str) -> None:
        if n < 0:
            raise ValueError("counters only go up")
        key = self._key(labels)
        with self._lock:
            self._values[key] = self._values.get(key, 0) + n

    def increment(self, label_value: str, n: float = 1) -> None:
        """Single-label sugar (the fail_closed_total{trigger} call shape)."""
        if len(self.label_names) != 1:
            raise ValueError(f"{self.name} has labels {self.label_names}, not exactly one")
        self.inc(n, **{self.label_names[0]: label_value})

    def value(self, **labels: str) -> float:
        with self._lock:
            return self._values.get(self._key(labels), 0)

    def get(self, label_value: str) -> float:
        return self.value(**{self.label_names[0]: label_value})

    def total(self) -> float:
        with self._lock:
            return sum(self._values.values())

    def as_dict(self) -> Dict[str, float]:
        """Single-label families: {label value: count}, sorted (the
        ``EngineCore.fail_closed_total()`` view)."""
        if len(self.label_names) > 1:
            raise ValueError(f"{self.name}: as_dict() needs <= 1 label")
        with self._lock:
            items = {(k[0] if k else ""): _num(v) for k, v in self._values.items()}
        return dict(sorted(items.items()))

    def _snapshot(self) -> Dict[str, Any]:
        return {
            "type": self.kind,
            "help": self.help,
            "label_names": list(self.label_names),
            "series": [
                {"labels": dict(zip(self.label_names, k)), "value": _num(v)}
                for k, v in sorted(self._values.items())
            ],
        }

    def _exposition(self) -> List[str]:
        lines = [f"# HELP {self.name} {self.help}", f"# TYPE {self.name} counter"]
        for k, v in sorted(self._values.items()):
            lines.append(f"{self.name}{_prom_labels(self.label_names, k)} {_num(v)}")
        return lines


class GaugeFamily(_Family):
    kind = "gauge"

    def __init__(self, name, help, label_names, lock):
        super().__init__(name, help, label_names, lock)
        self._values: Dict[Tuple[str, ...], float] = {}

    def set(self, value: float, **labels: str) -> None:
        with self._lock:
            self._values[self._key(labels)] = value

    def value(self, **labels: str) -> float:
        with self._lock:
            return self._values.get(self._key(labels), 0)

    def as_dict(self) -> Dict[str, float]:
        if len(self.label_names) > 1:
            raise ValueError(f"{self.name}: as_dict() needs <= 1 label")
        with self._lock:
            return dict(
                sorted({(k[0] if k else ""): _num(v) for k, v in self._values.items()}.items())
            )

    _snapshot = CounterFamily._snapshot

    def _exposition(self) -> List[str]:
        lines = [f"# HELP {self.name} {self.help}", f"# TYPE {self.name} gauge"]
        for k, v in sorted(self._values.items()):
            lines.append(f"{self.name}{_prom_labels(self.label_names, k)} {_num(v)}")
        return lines


class _HistogramChild:
    __slots__ = ("bucket_counts", "sum", "count", "samples")

    def __init__(self, n_buckets: int):
        self.bucket_counts = [0] * n_buckets  # per-bucket (non-cumulative)
        self.sum = 0.0
        self.count = 0
        self.samples: List[float] = []


class HistogramFamily(_Family):
    """Histogram family with explicit bucket upper bounds (+Inf implicit).

    Exposition follows the Prometheus convention: cumulative ``_bucket``
    series with ``le`` labels, plus ``_sum`` and ``_count``.  Raw samples
    are retained for exact percentile export (bench summaries)."""

    kind = "histogram"

    def __init__(self, name, help, label_names, buckets: Sequence[float], lock):
        super().__init__(name, help, label_names, lock)
        bounds = tuple(float(b) for b in buckets)
        if list(bounds) != sorted(bounds) or len(set(bounds)) != len(bounds):
            raise ValueError(f"{name}: bucket bounds must be strictly increasing")
        self.buckets = bounds
        self._children: Dict[Tuple[str, ...], _HistogramChild] = {}

    def _child(self, labels: Dict[str, str]) -> _HistogramChild:
        key = self._key(labels)
        child = self._children.get(key)
        if child is None:
            child = self._children[key] = _HistogramChild(len(self.buckets) + 1)
        return child

    def observe(self, value: float, **labels: str) -> None:
        value = float(value)
        with self._lock:
            child = self._child(labels)
            i = len(self.buckets)
            for j, b in enumerate(self.buckets):
                if value <= b:
                    i = j
                    break
            child.bucket_counts[i] += 1
            child.sum += value
            child.count += 1
            child.samples.append(value)

    def count(self, **labels: str) -> int:
        """Observation count — for the family total, omit labels on a
        labeled family."""
        with self._lock:
            if not labels and self.label_names:
                return sum(c.count for c in self._children.values())
            key = self._key(labels) if (labels or not self.label_names) else None
            child = self._children.get(key)
            return child.count if child else 0

    def samples(self, **labels: str) -> List[float]:
        """Raw observations (family-wide when labels omitted)."""
        with self._lock:
            if not labels and self.label_names:
                out: List[float] = []
                for c in self._children.values():
                    out.extend(c.samples)
                return out
            key = self._key(labels) if (labels or not self.label_names) else None
            child = self._children.get(key)
            return list(child.samples) if child else []

    def percentiles(self, qs: Iterable[float] = (50, 95, 99), **labels) -> Dict[str, float]:
        """Exact percentiles over the raw samples (p50/p95/p99 export)."""
        xs = sorted(self.samples(**labels))
        out: Dict[str, float] = {}
        for q in qs:
            if not xs:
                out[f"p{q:g}"] = float("nan")
                continue
            # nearest-rank on the sorted samples
            rank = max(0, min(len(xs) - 1, math.ceil(q / 100 * len(xs)) - 1))
            out[f"p{q:g}"] = xs[rank]
        return out

    def _snapshot(self) -> Dict[str, Any]:
        series = []
        for key, child in sorted(self._children.items()):
            cum = 0
            buckets = {}
            for bound, n in zip(self.buckets, child.bucket_counts):
                cum += n
                buckets[f"{bound:g}"] = cum
            buckets["+Inf"] = child.count
            series.append(
                {
                    "labels": dict(zip(self.label_names, key)),
                    "count": child.count,
                    "sum": child.sum,
                    "buckets": buckets,
                }
            )
        return {
            "type": self.kind,
            "help": self.help,
            "label_names": list(self.label_names),
            "buckets": [f"{b:g}" for b in self.buckets],
            "series": series,
        }

    def _exposition(self) -> List[str]:
        lines = [f"# HELP {self.name} {self.help}", f"# TYPE {self.name} histogram"]
        for key, child in sorted(self._children.items()):
            cum = 0
            for bound, n in zip(self.buckets, child.bucket_counts):
                cum += n
                le = dict(zip(self.label_names, key))
                le["le"] = f"{bound:g}"
                inner = ",".join(f'{k}="{v}"' for k, v in le.items())
                lines.append(f"{self.name}_bucket{{{inner}}} {cum}")
            le = dict(zip(self.label_names, key))
            le["le"] = "+Inf"
            inner = ",".join(f'{k}="{v}"' for k, v in le.items())
            lines.append(f"{self.name}_bucket{{{inner}}} {child.count}")
            lbl = _prom_labels(self.label_names, key)
            lines.append(f"{self.name}_sum{lbl} {child.sum}")
            lines.append(f"{self.name}_count{lbl} {child.count}")
        return lines


def _num(v: float):
    """ints stay ints in JSON/exposition (counter readability)."""
    return int(v) if float(v).is_integer() else float(v)


class MetricsRegistry:
    """Engine-scoped registry.  ``counter``/``gauge``/``histogram`` are
    get-or-create: re-registration with the same type returns the existing
    family (modules attach lazily), a type clash raises."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._families: Dict[str, _Family] = {}

    def _register(self, cls, name: str, help: str, labels: Sequence[str], **kw) -> Any:
        with self._lock:
            fam = self._families.get(name)
            if fam is not None:
                if not isinstance(fam, cls) or fam.label_names != tuple(labels):
                    raise ValueError(
                        f"metric {name!r} already registered as {fam.kind} "
                        f"with labels {fam.label_names}"
                    )
                return fam
            fam = cls(name, help, labels, lock=self._lock, **kw)
            self._families[name] = fam
            return fam

    def counter(self, name: str, help: str, labels: Sequence[str] = ()) -> CounterFamily:
        return self._register(CounterFamily, name, help, labels)

    def gauge(self, name: str, help: str, labels: Sequence[str] = ()) -> GaugeFamily:
        return self._register(GaugeFamily, name, help, labels)

    def histogram(
        self,
        name: str,
        help: str,
        labels: Sequence[str] = (),
        buckets: Sequence[float] = LATENCY_BUCKETS,
    ) -> HistogramFamily:
        return self._register(HistogramFamily, name, help, labels, buckets=buckets)

    def get(self, name: str) -> Optional[_Family]:
        with self._lock:
            return self._families.get(name)

    # -- export ----------------------------------------------------------------
    def snapshot(self) -> Dict[str, Any]:
        """JSON-able view of every family (the reconciliation input)."""
        with self._lock:
            fams = list(self._families.items())
        return {name: fam._snapshot() for name, fam in sorted(fams)}

    def to_json(self) -> str:
        return json.dumps(self.snapshot(), indent=1)

    def prometheus_text(self) -> str:
        """Prometheus text exposition format (0.0.4)."""
        with self._lock:
            fams = list(self._families.items())
        lines: List[str] = []
        for _, fam in sorted(fams):
            lines.extend(fam._exposition())
        return "\n".join(lines) + "\n"

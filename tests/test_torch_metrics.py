"""tests/test_metrics.py held against the port (no model).

Every test of the JAX package's metrics-registry and event-clock units
runs on both packages (``pkg`` = ``jax``: ``repro.serving.metrics`` and
``repro.core.events``; ``port``: ``repro_torch.serving.metrics`` and
``repro_torch.core.events``) with the reference test's assertions, and
the exports are held string for string: the Prometheus exposition and the
JSON snapshot of the same calls are equal across the two packages.
"""
import json
import threading
from types import SimpleNamespace

import pytest

import repro.core.events as j_events
import repro.serving.metrics as j_metrics
import repro_torch.core.events as t_events
import repro_torch.serving.metrics as t_metrics

PKGS = {
    "jax": SimpleNamespace(MetricsRegistry=j_metrics.MetricsRegistry,
                           LATENCY_BUCKETS=j_metrics.LATENCY_BUCKETS,
                           EventLog=j_events.EventLog),
    "port": SimpleNamespace(MetricsRegistry=t_metrics.MetricsRegistry,
                            LATENCY_BUCKETS=t_metrics.LATENCY_BUCKETS,
                            EventLog=t_events.EventLog),
}


@pytest.fixture(params=sorted(PKGS))
def m(request):
    return PKGS[request.param]


# ---------------------------------------------------------------------------
# registry semantics
# ---------------------------------------------------------------------------


def test_counter_inc_value_and_total(m):
    reg = m.MetricsRegistry()
    c = reg.counter("requests_total", "requests", labels=("status",))
    c.inc(status="ok")
    c.inc(n=2, status="refused")
    assert c.value(status="ok") == 1
    assert c.value(status="refused") == 2
    assert c.value(status="never") == 0
    assert c.total() == 3


def test_counter_failclosed_compat_surface(m):
    """increment(label_value), get, as_dict, total: the call shapes the
    chaos and engine code use."""
    reg = m.MetricsRegistry()
    c = reg.counter("fail_closed_total", "fail-closed outcomes", labels=("trigger",))
    c.increment("permanent_io")
    c.increment("permanent_io")
    c.increment("corruption")
    assert c.get("permanent_io") == 2
    assert c.get("missing") == 0
    assert c.as_dict() == {"corruption": 1, "permanent_io": 2}  # sorted
    assert c.total() == 3


def test_unlabeled_counter_and_gauge(m):
    reg = m.MetricsRegistry()
    c = reg.counter("restores_total", "restores")
    c.inc()
    c.inc(n=3)
    assert c.value() == 4
    g = reg.gauge("pool_blocks", "blocks", labels=("tier",))
    g.set(7, tier="host")
    g.set(2, tier="disk")
    g.set(5, tier="host")  # gauges overwrite
    assert g.value(tier="host") == 5
    assert g.as_dict() == {"disk": 2, "host": 5}


def test_get_or_create_and_type_clash(m):
    reg = m.MetricsRegistry()
    a = reg.counter("x_total", "x", labels=("k",))
    b = reg.counter("x_total", "x", labels=("k",))
    assert a is b  # modules attach lazily to the same family
    with pytest.raises(ValueError):
        reg.gauge("x_total", "x", labels=("k",))
    with pytest.raises(ValueError):
        reg.counter("x_total", "x", labels=("other",))  # label clash
    assert reg.get("x_total") is a
    assert reg.get("missing") is None


def test_histogram_buckets_counts_and_percentiles(m):
    reg = m.MetricsRegistry()
    h = reg.histogram("lat_seconds", "latency", labels=("stage",), buckets=(0.1, 1.0))
    for v in (0.05, 0.5, 0.5, 2.0):
        h.observe(v, stage="decode")
    h.observe(0.5, stage="prefill")
    assert h.count(stage="decode") == 4
    assert h.count(stage="prefill") == 1
    assert h.count() == 5  # family-wide when labels are omitted
    assert sorted(h.samples(stage="decode")) == [0.05, 0.5, 0.5, 2.0]
    p = h.percentiles(qs=(50, 99), stage="decode")
    assert p["p50"] == 0.5 and p["p99"] == 2.0
    with pytest.raises(ValueError):
        reg.histogram("bad_seconds", "x", buckets=(1.0, 0.5))  # not increasing


def test_default_latency_buckets_strictly_increasing(m):
    assert list(m.LATENCY_BUCKETS) == sorted(m.LATENCY_BUCKETS)
    assert len(set(m.LATENCY_BUCKETS)) == len(m.LATENCY_BUCKETS)
    assert tuple(m.LATENCY_BUCKETS) == tuple(PKGS["jax"].LATENCY_BUCKETS)


# ---------------------------------------------------------------------------
# export surfaces
# ---------------------------------------------------------------------------


def _exposition_registry(m):
    reg = m.MetricsRegistry()
    c = reg.counter("fail_closed_total", "fail-closed outcomes", labels=("trigger",))
    c.increment("permanent_io")
    h = reg.histogram("lat_seconds", "latency", buckets=(0.1, 1.0))
    h.observe(0.05)
    h.observe(0.5)
    return reg


def test_prometheus_exposition_format(m):
    text = _exposition_registry(m).prometheus_text()
    assert "# HELP fail_closed_total fail-closed outcomes" in text
    assert "# TYPE fail_closed_total counter" in text
    assert 'fail_closed_total{trigger="permanent_io"} 1' in text
    assert "# TYPE lat_seconds histogram" in text
    # cumulative buckets + the implicit +Inf (bounds render %g: 1.0 -> "1")
    assert 'lat_seconds_bucket{le="0.1"} 1' in text
    assert 'lat_seconds_bucket{le="1"} 2' in text
    assert 'lat_seconds_bucket{le="+Inf"} 2' in text
    assert "lat_seconds_count 2" in text
    assert "lat_seconds_sum" in text
    assert text == _exposition_registry(PKGS["jax"]).prometheus_text()


def _snapshot_registry(m):
    reg = m.MetricsRegistry()
    reg.counter("c_total", "c", labels=("k",)).inc(k="a")
    reg.gauge("g", "g").set(3.5)
    h = reg.histogram("h_seconds", "h", buckets=(1.0,))
    h.observe(0.5)
    return reg


def test_snapshot_json_round_trip(m):
    snap = json.loads(_snapshot_registry(m).to_json())  # serializable end to end
    assert snap["c_total"]["type"] == "counter"
    assert snap["c_total"]["series"] == [{"labels": {"k": "a"}, "value": 1}]
    assert snap["g"]["series"][0]["value"] == 3.5
    hs = snap["h_seconds"]
    assert hs["type"] == "histogram" and hs["buckets"] == ["1"]  # %g-formatted
    (series,) = hs["series"]
    assert series["count"] == 1 and series["sum"] == 0.5
    assert series["buckets"] == {"1": 1, "+Inf": 1}  # cumulative
    assert snap == json.loads(_snapshot_registry(PKGS["jax"]).to_json())


def test_counters_thread_safe_under_contention(m):
    reg = m.MetricsRegistry()
    c = reg.counter("n_total", "n", labels=("t",))
    h = reg.histogram("d_seconds", "d", buckets=(0.5,))
    N, T = 500, 8

    def work(i):
        for _ in range(N):
            c.increment(f"t{i % 2}")
            h.observe(0.1)

    threads = [threading.Thread(target=work, args=(i,)) for i in range(T)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert c.total() == N * T
    assert h.count() == N * T


# ---------------------------------------------------------------------------
# Event.ts + seq monotonicity (the two-clock contract)
# ---------------------------------------------------------------------------


def test_event_ts_stamped_and_json_round_trip(m):
    log = m.EventLog()
    a = log.emit("request_initialized", request_id="r1", n_tokens=4, claim_metadata=[])
    b = log.emit("request_finished", request_id="r1", status="FINISHED_OK", ts=123.5)
    assert a.ts > 0  # stamped from the monotonic clock
    assert b.ts == 123.5  # an explicit override is honoured
    dicts = [e.to_dict() for e in log.events]
    assert dicts[0]["ts"] == a.ts
    restored = m.EventLog.from_dicts(dicts)
    assert [e.ts for e in restored.events] == [a.ts, b.ts]
    assert [e.seq for e in restored.events] == [a.seq, b.seq]
    json.dumps(dicts)  # ts survives serialization
    # the port reads the reference's rows and the reference the port's
    other = PKGS["jax"].EventLog if m is PKGS["port"] else PKGS["port"].EventLog
    assert [e.to_dict() for e in other.from_dicts(dicts).events] == dicts


def test_ts_not_in_payload(m):
    """``ts`` is a field, not payload: per-request (name, payload)
    projections never see wall-clock noise."""
    log = m.EventLog()
    e = log.emit("request_initialized", request_id="r1", n_tokens=4, claim_metadata=[])
    assert "ts" not in e.payload


def test_seq_strictly_monotonic_under_concurrent_emitters(m):
    """One log, many threads: ``seq`` strictly monotonic and gap-free;
    ``ts`` rides along but is never the order."""
    log = m.EventLog()
    N, T = 400, 8

    def emitter(i):
        for _ in range(N):
            log.emit("stage_latency", stage=f"t{i}", seconds=0.0)

    threads = [threading.Thread(target=emitter, args=(i,)) for i in range(T)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    seqs = [e.seq for e in log.events]
    assert len(seqs) == N * T
    assert seqs == sorted(seqs)
    assert len(set(seqs)) == len(seqs)  # strict: no duplicates
    assert seqs == list(range(seqs[0], seqs[0] + len(seqs)))  # gap-free
    assert all(e.ts > 0 for e in log.events)

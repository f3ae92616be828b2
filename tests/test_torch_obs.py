"""The port's telemetry copy: histogram percentiles follow numpy's
convention, spans land in ``"<name>.ms"``, counters/gauges sum and
overwrite, spans carry their fields and nesting to the sinks as the
reference's do, ``Registry.merge`` folds registries in as the reference's
does (in either order), and ``simulate --trace`` writes the session's
spans as JSON lines (no GPU)."""
import numpy as np
import pytest

from repro_torch import obs, runtime


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One host thread: the tensors here are small, and parallel test
    workers must not oversubscribe the CPU."""
    with runtime.pinned_threads(1):
        yield


@pytest.mark.parametrize("n", [1, 2, 7, 100])
def test_histogram_percentiles_match_numpy(n):
    vals = np.random.default_rng(n).exponential(size=n)
    h = obs.Histogram(vals.tolist())
    for p in (0.0, 50.0, 95.0, 99.0, 100.0):
        assert h.percentile(p) == pytest.approx(np.percentile(vals, p),
                                                rel=1e-12)
    s = h.summary()
    assert s["count"] == n and s["p50"] == pytest.approx(np.median(vals))
    assert obs.Histogram().summary() == {"count": 0}


def test_registry_spans_counters_gauges():
    reg = obs.Registry()
    with reg.span("outer"):
        with reg.span("inner"):
            pass
    with pytest.raises(RuntimeError):
        with reg.span("inner"):
            raise RuntimeError("boom")
    reg.count("c", 2)
    reg.count("c")
    reg.gauge("g", 1.0)
    reg.gauge("g", 5.0)
    snap = reg.snapshot()
    assert snap["histograms"]["inner.ms"]["count"] == 2
    assert snap["histograms"]["outer.ms"]["count"] == 1
    assert snap["counters"] == {"c": 3.0} and snap["gauges"] == {"g": 5.0}
    reg.reset()
    assert reg.snapshot() == {"counters": {}, "gauges": {}, "histograms": {}}


# ------------------------------------------------- sinks and span fields

def test_span_fields_nesting_and_events_match_reference():
    """The same spans in the reference's registry and the port's give the
    same events (timestamps and durations aside)."""
    from repro import obs as jobs

    events = {}
    for name, mod in (("port", obs), ("ref", jobs)):
        reg = mod.Registry()
        sink = reg.add_sink(mod.ListSink())
        with reg.span("session.finalize", count=7, algorithm="spectral",
                      engine="host") as info:
            with reg.span("session.finalize.cluster", engine="host"):
                reg.event("note", value=3)
        assert info["ms"] >= 0.0
        events[name] = [{k: v for k, v in e.items() if k not in ("ts", "ms")}
                        for e in sink.events]
        assert all(e["event"] != "span" or e["ms"] >= 0.0
                   for e in sink.events)
    assert events["port"] == events["ref"]
    assert events["port"][1] == {
        "event": "span", "name": "session.finalize.cluster", "engine": "host",
        "parent": "session.finalize", "depth": 1}


def apply_op(reg, op):
    kind, name, value = op
    if kind == "count":
        reg.count(name, value)
    elif kind == "gauge":
        reg.gauge(name, value)
    else:
        reg.observe(name, value)


def merged(mod, *op_lists):
    """A fresh registry of ``mod`` with one registry per op list merged in,
    in the order given."""
    out = mod.Registry()
    for ops in op_lists:
        reg = mod.Registry()
        for op in ops:
            apply_op(reg, op)
        out.merge(reg)
    return out.snapshot()


MERGE_OPS = (
    [("count", "a", 1.0), ("obs", "h", 3.0), ("gauge", "g", 2.0),
     ("count", "b", 2.5), ("obs", "h", -1.0)],
    [("count", "a", -4.0), ("obs", "h", 1.0), ("gauge", "g", 5.0),
     ("obs", "k", 0.5), ("count", "c", 7.0)],
)


@pytest.mark.parametrize("order", [(0, 1), (1, 0)])
def test_registry_merge_matches_reference(order):
    """Counters sum, gauges keep the last merged write, histogram values
    pool: the port's snapshot equals the reference's for the same ops,
    merged in the same order; counters and histograms are the same in
    either order."""
    from repro import obs as jobs

    lists = [MERGE_OPS[i] for i in order]
    got, want = merged(obs, *lists), merged(jobs, *lists)
    assert got == want
    assert got["gauges"]["g"] == lists[-1][2][2]
    other = merged(obs, *reversed(lists))
    assert got["counters"] == other["counters"]
    assert got["histograms"] == other["histograms"]
    h = obs.Histogram([1.0])
    h.merge(obs.Histogram([2.0, 3.0]))
    assert h.values == [1.0, 2.0, 3.0]


def test_merge_order_independent_property():
    """The reference's hypothesis property (``tests/test_obs.py``) on the
    port's registry."""
    hypothesis = pytest.importorskip("hypothesis")
    from hypothesis import given, settings, strategies as st

    op = st.tuples(st.sampled_from(["count", "obs"]),
                   st.sampled_from(["a", "b", "c"]),
                   st.floats(-100, 100, allow_nan=False))

    @settings(max_examples=50, deadline=None)
    @given(st.lists(op, max_size=30), st.lists(op, max_size=30))
    def check(ops1, ops2):
        sa, sb = merged(obs, ops1, ops2), merged(obs, ops2, ops1)
        assert set(sa["counters"]) == set(sb["counters"])
        for k in sa["counters"]:
            assert sa["counters"][k] == pytest.approx(sb["counters"][k],
                                                      abs=1e-9)
        for k in set(sa["histograms"]) | set(sb["histograms"]):
            ha, hb = sa["histograms"][k], sb["histograms"][k]
            assert ha["count"] == hb["count"]
            for f in ("min", "max", "p50", "p95", "p99"):
                assert ha[f] == pytest.approx(hb[f], abs=1e-9)

    check()


def test_sinks_attach_detach_and_close(tmp_path, capsys):
    reg = obs.Registry()
    path = tmp_path / "trace.jsonl"
    jsonl = reg.add_sink(obs.JsonlSink(str(path)))
    seen = reg.add_sink(obs.ListSink())
    console = reg.add_sink(obs.ConsoleSink(registry=reg))
    with reg.span("a", n=np.int64(3)):
        reg.count("c", 2)
    reg.reset()                          # aggregates go, sinks stay
    reg.gauge("g", 1.5)
    reg.observe("h", 2.0)
    reg.event("e", x=np.float32(0.5))
    reg.remove_sink(seen)
    reg.event("after")
    reg.close_sinks()
    reg.event("closed")                  # no sink left to receive it
    got = obs.read_jsonl(str(path))
    assert [e["event"] for e in got] == ["span", "e", "after"]
    assert got[0]["n"] == 3 and got[1]["x"] == 0.5
    assert [e["event"] for e in seen.events] == ["span", "e"]
    err = capsys.readouterr().err
    assert "[obs] 3 events" in err and "gauge   g = 1.5" in err
    assert "hist    h: n=1" in err
    assert jsonl._f.closed


def test_simulate_trace_holds_the_session_spans(tmp_path):
    from repro_torch.launch.simulate import main

    path = tmp_path / "trace.jsonl"
    out = main(["--clients", "512", "--clusters", "4", "--wave", "200",
                "--device", "cpu", "--trace", str(path)])
    events = obs.read_jsonl(str(path))
    spans = [e for e in events if e["event"] == "span"]
    ingest = [e for e in spans if e["name"] == "session.ingest"]
    assert [e["wave"] for e in ingest] == [200, 200, 112]
    assert [e["offset"] for e in ingest] == [0, 200, 400]
    assert all(e["mode"] == "params" and e["depth"] == 0 for e in ingest)
    (fin,) = [e for e in spans if e["name"] == "session.finalize"]
    assert fin["count"] == 512 and fin["algorithm"] == "kmeans-device"
    assert fin["engine"] == "device" and fin["ms"] > 0
    inner = {e["name"] for e in spans if e.get("parent") == "session.finalize"}
    assert inner == {"session.finalize.cluster.execute",
                     "session.finalize.mean.execute"}
    assert out["obs"]["histograms"]["session.finalize.ms"]["count"] == 1
    # the sink is detached after the run
    assert obs.GLOBAL._sinks == []

"""The port's telemetry copy: histogram percentiles follow numpy's
convention, spans land in ``"<name>.ms"``, counters/gauges sum and
overwrite, spans carry their fields and nesting to the sinks as the
reference's do, ``Registry.merge`` folds registries in as the reference's
does (in either order), and ``simulate --trace`` writes the session's
spans as JSON lines (no GPU).  The session's ingest splits into the
slot table's assign, the device write, the commit and the eviction, and
every span reaches a recording ``torch.profiler`` as a host range on its
thread (``obs/bridge.py``), while ``obs/core.py`` stays stdlib-only."""
import numpy as np
import pytest
import torch

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


# ------------------------------------------------ the session's ingest spans

INGEST_CHILDREN = {"session.ingest.assign", "session.ingest.write",
                   "session.ingest.commit", "session.evict"}


def keyed_waves(session, sketch_only, steps=5, w=16, joiners=4):
    """A keyed federation under a window of 2 waves: a first wave, then
    per step a re-upload of half the ids and a few never-seen joiners,
    so that every later ingest evicts."""
    gen = torch.Generator().manual_seed(7)

    def upload(ids):
        if sketch_only:
            session.ingest(sketches=torch.randn(len(ids), 4, generator=gen),
                           client_ids=ids)
        else:
            session.ingest({"theta": torch.randn(len(ids), 6,
                                                 generator=gen)},
                           client_ids=iter(ids))

    upload(list(range(w)))
    nxt = w
    for step in range(steps):
        upload([i + (step % 2) * w // 2 for i in range(w // 2)])
        upload(list(range(nxt, nxt + joiners)))
        nxt += joiners


@pytest.mark.parametrize("sketch_only", [False, True])
def test_session_ingest_spans_nest_and_split_the_call(sketch_only):
    """``session.ingest`` is a root span over the whole call, with the
    slot table's assign, the device write, the commit and the eviction as
    its children, whose times it holds; every ``session.evict`` carries
    the evictions it counted."""
    from repro_torch.core.engine.session import AggregationSession

    obs.reset()
    sink = obs.add_sink(obs.ListSink())
    try:
        session = AggregationSession(64, sketch_dim=4, staleness="max_age=2",
                                     device="cpu")
        counted = []
        orig = session.evict_stale

        def evict_stale():
            before = obs.snapshot()["counters"].get("session.evictions", 0)
            out = orig()
            counted.append(obs.snapshot()["counters"].get(
                "session.evictions", 0) - before)
            return out

        session.evict_stale = evict_stale
        keyed_waves(session, sketch_only)
        session.snapshot()
    finally:
        obs.remove_sink(sink)
    spans = [e for e in sink.events if e["event"] == "span"]
    roots = [i for i, e in enumerate(spans) if e["name"] == "session.ingest"]
    assert len(roots) == 11
    mode = "sketches" if sketch_only else "params"
    start = 0
    for i in roots:
        root = spans[i]
        assert root["depth"] == 0 and "parent" not in root
        assert root["mode"] == mode and root["wave"] in (16, 8, 4)
        kids = spans[start:i]
        assert [e["name"] for e in kids] == ["session.ingest.assign",
                                             "session.ingest.write",
                                             "session.ingest.commit",
                                             "session.evict"]
        assert all(e["depth"] == 1 and e["parent"] == "session.ingest"
                   for e in kids)
        assert sum(e["ms"] for e in kids) <= root["ms"]
        start = i + 1
    # the snapshot's eviction runs outside any ingest
    (last,) = [e for e in spans[start:] if e["name"] == "session.evict"]
    assert last["depth"] == 0
    evicts = [e for e in spans if e["name"] == "session.evict"]
    assert [e["evicted"] for e in evicts] == counted
    assert sum(counted) > 0 and min(counted) == 0
    snap = obs.snapshot()
    assert sum(counted) == snap["counters"]["session.evictions"]
    for name in INGEST_CHILDREN | {"session.ingest"}:
        assert snap["histograms"][f"{name}.ms"]["count"] == len(
            [e for e in spans if e["name"] == name])


def test_session_drops_the_slot_gauges_and_the_client_counter():
    from repro_torch.core.engine.session import AggregationSession

    obs.reset()
    session = AggregationSession(64, sketch_dim=4, staleness="max_age=2",
                                 device="cpu")
    keyed_waves(session, sketch_only=True, steps=2)
    snap = obs.snapshot()
    assert not [g for g in snap["gauges"] if g.startswith("session.slots")]
    assert "session.ingest.clients" not in snap["counters"]
    assert snap["counters"]["session.ingest.bytes"] > 0


def test_rejected_keyed_wave_keeps_the_session_and_closes_its_spans():
    from repro_torch.core.engine.session import AggregationSession

    session = AggregationSession(8, sketch_dim=4, device="cpu")
    session.ingest(sketches=torch.zeros(4, 4), client_ids=range(4))
    obs.reset()
    with pytest.raises(ValueError, match="duplicate"):
        session.ingest(sketches=torch.zeros(2, 4), client_ids=[9, 9])
    assert session.count == 4 and session.clock == 1
    hists = obs.snapshot()["histograms"]
    assert set(hists) == {"session.ingest.ms", "session.ingest.assign.ms"}
    assert obs.GLOBAL._stack() == []


# ------------------------------------------------------- the profiler bridge

def test_core_imports_no_torch():
    import ast
    import inspect

    from repro_torch.obs import core

    tree = ast.parse(inspect.getsource(core))
    names = {a.name.split(".")[0] for node in ast.walk(tree)
             if isinstance(node, ast.Import) for a in node.names}
    names |= {node.module.split(".")[0] for node in ast.walk(tree)
              if isinstance(node, ast.ImportFrom) and node.module}
    assert names <= {"__future__", "contextlib", "math", "threading", "time",
                     "typing"}, names


def test_bridge_is_installed_and_opens_no_range_without_a_profiler():
    from repro_torch.obs import bridge, core

    assert core._host_range is bridge.host_range
    assert bridge.host_range("session.ingest") is None


def _host_events(prof):
    """``(name, start_ns, end_ns, thread)`` of the trace's host events."""
    from torch.autograd import DeviceType

    return [(e.name(), e.start_ns(), e.start_ns() + e.duration_ns(),
             e.start_thread_id())
            for e in prof.profiler.kineto_results.events()
            if e.device_type() == DeviceType.CPU]


def test_spans_reach_the_profiler_as_nested_host_events_on_their_thread():
    from torch.profiler import ProfilerActivity, profile, record_function

    from repro_torch.core.engine.session import AggregationSession

    session = AggregationSession(64, sketch_dim=4, staleness="max_age=2",
                                 device="cpu")
    keyed_waves(session, sketch_only=False, steps=1)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with record_function("test.main"):
            session.ingest({"theta": torch.zeros(4, 6)},
                           client_ids=range(100, 104))
    events = _host_events(prof)
    (main,) = [e for e in events if e[0] == "test.main"]
    by_name = {e[0]: e for e in events if e[0].startswith("session.")}
    assert set(by_name) == INGEST_CHILDREN | {"session.ingest"}
    assert all(e[3] == main[3] for e in by_name.values())
    root = by_name["session.ingest"]
    assert main[1] <= root[1] and root[2] <= main[2]
    kids = sorted((by_name[n] for n in INGEST_CHILDREN), key=lambda e: e[1])
    assert [e[0] for e in kids] == ["session.ingest.assign",
                                    "session.ingest.write",
                                    "session.ingest.commit", "session.evict"]
    for a, b in zip(kids, kids[1:]):
        assert a[2] <= b[1]
    assert root[1] <= kids[0][1] and kids[-1][2] <= root[2]
    # the write's tensor work nests inside the write's range
    write = by_name["session.ingest.write"]
    ops = [e for e in events if e[0].startswith("aten::")
           and root[1] <= e[1] <= root[2]]
    assert any(write[1] <= e[1] and e[2] <= write[2] for e in ops)


"""The readers of the session's ingest spans on a made-up run: each sums
its spans over the rounds run outside the profiler (the harness hands
over only those rounds' spans) into a round's mean, and reads nothing
where the program has no such span, or (``ingest_span_ms``) where its
``session.ingest`` has no children."""
import pytest

from odcl_bench import harness

from conftest import REPO

SPANS = {"session.ingest.ms": [300.0, 20.0, 310.0, 25.0],
         "session.ingest.assign.ms": [60.0, 1.0, 70.0, 2.0],
         "session.ingest.commit.ms": [100.0, 3.0, 110.0, 4.0],
         "session.evict.ms": [90.0, 0.5, 95.0, 0.5, 7.0],
         "session.finalize.cluster.execute.ms": [6.0, 7.0]}


def ctx(spans, rounds=5, traced=3):
    """A run of ``rounds`` rounds, the first ``traced`` under the
    profiler."""
    return {"spans": spans, "rounds": [0.9] * rounds, "traced_rounds": traced}


@pytest.mark.parametrize("name, want", [
    ("ingest_span_ms", (300.0 + 20.0 + 310.0 + 25.0) / 2),
    ("slot_table_ms", (60.0 + 1.0 + 70.0 + 2.0 + 100.0 + 3.0 + 110.0
                       + 4.0) / 2),
    ("evict_ms", (90.0 + 0.5 + 95.0 + 0.5 + 7.0) / 2),
])
def test_a_rounds_mean_over_the_rounds_outside_the_profiler(name, want):
    read = harness.reader(name, REPO).read
    assert read(ctx(SPANS)) == pytest.approx(want, rel=1e-12)
    # the same spans over twice the rounds: half the mean
    assert read(ctx(SPANS, rounds=7)) == pytest.approx(want / 2, rel=1e-12)


@pytest.mark.parametrize("name", ["ingest_span_ms", "slot_table_ms",
                                  "evict_ms"])
def test_none_without_values(name):
    read = harness.reader(name, REPO).read
    assert read(ctx({})) is None
    assert read(ctx({k: [] for k in SPANS})) is None
    # no round outside the profiler
    assert read(ctx(SPANS, rounds=3)) is None
    # an older program: its ``session.ingest`` timed the write alone,
    # and had no children
    old = {"session.ingest.ms": [5.0, 1.0],
           "session.finalize.cluster.execute.ms": [6.0]}
    assert read(ctx(old)) is None


def test_the_slot_table_needs_both_of_its_spans():
    read = harness.reader("slot_table_ms", REPO).read
    half = {k: v for k, v in SPANS.items() if k != "session.ingest.commit.ms"}
    assert read(ctx(half)) is None


def test_the_three_readers_are_km_metrics_of_the_session_layer():
    bench = harness.load_bench(REPO)
    entries = {m["name"]: m for m in bench["per_layer"]}
    for name in ("ingest_span_ms", "slot_table_ms", "evict_ms"):
        m = entries[name]
        assert (m["unit"], m["better"], m["source"], m["layer"],
                m["moves"]) == ("ms", "lower", "program_span", "session",
                                "memory_peak_gb")
        assert m["workloads"] == ["km-1m-round", "km-1m-refresh"]
    assert [m["name"] for m in bench["per_layer"][-3:]] == [
        "ingest_span_ms", "slot_table_ms", "evict_ms"]

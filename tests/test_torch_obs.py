"""The port's telemetry copy: histogram percentiles follow numpy's
convention, spans land in ``"<name>.ms"``, and counters/gauges sum and
overwrite (no GPU, no JAX)."""
import numpy as np
import pytest

from repro_torch import obs


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

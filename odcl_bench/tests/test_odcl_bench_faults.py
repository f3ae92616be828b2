"""A run with the timed path broken underneath comes out not correct:
the harness's look for a card is skipped (the run is on the CPU at a
tiny size) and the rest of a run is driven, once for each fault a cell
of one card can have, and for the mixes' guarantees: the sliding
window's evictions, and a refresh where the drift gauge trips.  (No cell
spans chips, so the fault of a missing exchange between chips has no
cell.)"""
import numpy as np
import pytest

from odcl_bench import harness
from repro_torch.core.engine import aggregate, session, staleness

CELLS = ["km-1m-round", "cc-4k-round", "km-1m-refresh"]


@pytest.fixture
def window_only(monkeypatch):
    """A flag that is up while the window's rounds run (round g >= 1)."""
    state = {"on": False}
    original = harness.Loop.round

    def round_(self, g, mark=None):
        state["on"] = g >= 1
        return original(self, g, mark)

    monkeypatch.setattr(harness.Loop, "round", round_)
    return state


def _unchanged_ingest(monkeypatch, window):
    """The ingest keeps its state: the window's waves write nothing."""
    original = session.AggregationSession._write_rows

    def write(self, buf, rows, values):
        if not window["on"]:
            original(self, buf, rows, values)

    monkeypatch.setattr(session.AggregationSession, "_write_rows", write)


def _unchanged_round(monkeypatch, window):
    """The round keeps its state: the window's finalizes hand back the
    round served before, computing nothing."""
    original = session.AggregationSession.finalize_snapshot

    def finalize(self, snap, **kwargs):
        if window["on"] and self.served_round is not None:
            return self.served_round.out
        return original(self, snap, **kwargs)

    monkeypatch.setattr(session.AggregationSession, "finalize_snapshot",
                        finalize)


def _half_mean(monkeypatch, window):
    """Half of the clients left out of the mean, the mean taken over the
    rest (every client still gets its cluster's row)."""
    original = aggregate.cluster_reps

    def reps(labels, kk, params, aggregator, shard=None, then=None):
        h = labels.shape[0] // 2
        half = {k: v[:h] for k, v in params.items()}
        return original(labels[:h], kk, half, aggregator, shard, then)

    monkeypatch.setattr(aggregate, "cluster_reps", reps)


def _altered_label(monkeypatch, window):
    """One client's label altered where the round produces it."""
    original = session.materialize_round

    def materialize(new_params, res, state):
        new_state, labels, info, uniq, first = original(new_params, res,
                                                        state)
        labels = np.array(labels)
        labels[0] = (labels[0] + 1) % len(uniq)
        return new_state, labels, info, uniq, first

    monkeypatch.setattr(session, "materialize_round", materialize)


def _late_eviction(monkeypatch, window):
    """The sliding window evicts a row one wave late once the window
    runs."""
    def evict(self, ages):
        return np.asarray(ages) > self.max_age + int(window["on"])

    monkeypatch.setattr(staleness.SlidingWindow, "evict", evict)


def _never_refreshed(monkeypatch, window):
    """The drift-triggered refresh never fires once the window runs."""
    original = session.AggregationSession.maybe_refinalize

    def maybe(self, threshold=1.5):
        return None if window["on"] else original(self, threshold)

    monkeypatch.setattr(session.AggregationSession, "maybe_refinalize",
                        maybe)


@pytest.mark.parametrize("cell,fault", [("km-1m-round", _late_eviction),
                                        ("km-1m-refresh", _late_eviction),
                                        ("km-1m-refresh", _never_refreshed)])
def test_a_broken_guarantee_is_not_correct(tiny_root, monkeypatch,
                                           window_only, cell, fault):
    fault(monkeypatch, window_only)
    result = harness.run(cell, 2 ** 31 + 78, 0.2, False, device="cpu",
                         root=tiny_root)
    assert result["correct"] is False, result["checks"]


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("fault", [_unchanged_ingest, _unchanged_round,
                                   _half_mean, _altered_label])
def test_a_broken_round_is_not_correct(tiny_root, monkeypatch, window_only,
                                       cell, fault):
    fault(monkeypatch, window_only)
    result = harness.run(cell, 2 ** 31 + 77, 0.2, False, device="cpu",
                         root=tiny_root)
    assert result["correct"] is False, result["checks"]


@pytest.mark.parametrize("cell", CELLS)
def test_the_same_run_unbroken_is_correct(tiny_root, cell):
    result = harness.run(cell, 2 ** 31 + 77, 0.2, False, device="cpu",
                         root=tiny_root)
    assert result["correct"] is True, result["checks"]

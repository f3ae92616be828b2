"""The port's concurrent serving (``repro_torch/serving/``) on the CPU.

The counterparts of ``tests/test_serving.py``:

* queue and future mechanics without a session (backpressure, caller-
  and server-side timeouts, drain and drop shutdown);
* the RouteServer front end: batched answers equal to direct
  ``session.route``, the params path, the lifecycle guards;
* the ingest-while-finalize contract: a round computed on a snapshot
  while ingest goes on serves EXACTLY what a serialized replay (the same
  keyed waves in clock order, finalize right after the snapshot's
  clock) serves, port against port, bit for bit;
* a round computed on a worker thread leaves the served round alone
  until ``install_round``;
* the threaded stress test and a smoke run of the loadgen's schema.

Every join and every wait has a time limit, so a hang fails the test.
"""
import contextlib
import threading
import time

import numpy as np
import pytest
import torch

from repro_torch import obs, runtime
from repro_torch.core.engine.session import AggregationSession
from repro_torch.serving import (
    BackpressureError,
    RequestQueue,
    RouteFuture,
    RouteServer,
    RouteTimeout,
    ServerClosed,
    ServingError,
)
from repro_torch.serving.batching import _Request
from repro_torch.serving.loadgen import make_population


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One host thread: the tensors here are small, and parallel test
    workers must not oversubscribe the CPU."""
    with runtime.pinned_threads(1):
        yield


DIM = 16
K = 4
CPU = "cpu"
WAIT = 60.0


def _population(clients=256, seed=0):
    rows, _, _ = make_population(clients=clients, clusters=K,
                                 sketch_dim=DIM, seed=seed)
    return rows


def _served_session(rows, *, capacity=None, wave=64, seed=0):
    """Keyed ingest in waves and a cold finalize; returns (session, log)
    with log holding (clock, ids, wave_rows), the replay source."""
    session = AggregationSession(capacity or len(rows), sketch_dim=DIM,
                                 seed=seed, device=CPU)
    log = []
    for lo in range(0, len(rows), wave):
        chunk = rows[lo:lo + wave]
        ids = list(range(lo, lo + len(chunk)))
        session.ingest(sketches=chunk, client_ids=ids)
        log.append((session.clock, ids, chunk))
    session.finalize(algorithm="kmeans-device", k=K)
    return session, log


def _replay(log, round_clocks, *, capacity, seed=0):
    """The serialized-equivalence oracle: a fresh session, the SAME keyed
    waves in clock order, and a finalize (then warm refinalizes) right
    after each recorded snapshot clock."""
    replay = AggregationSession(capacity, sketch_dim=DIM, seed=seed,
                                device=CPU)
    waves = sorted(log, key=lambda w: w[0])
    clocks = [c for c, _, _ in waves]
    assert len(set(clocks)) == len(clocks), "duplicated wave commit"
    applied = 0

    def ingest_upto(clk):
        nonlocal applied
        while applied < len(waves) and waves[applied][0] <= clk:
            c, ids, chunk = waves[applied]
            replay.ingest(sketches=chunk, client_ids=ids)
            assert replay.clock == c
            applied += 1

    for i, clk in enumerate(round_clocks):
        ingest_upto(clk)
        if i == 0:
            replay.finalize(algorithm="kmeans-device", k=K)
        else:
            replay.refinalize()
    return replay


def _assert_same_round(live, rep):
    assert live.clock == rep.clock
    assert live.n_clusters == rep.n_clusters
    assert torch.equal(live.centers, rep.centers)
    np.testing.assert_array_equal(live.first_idx, rep.first_idx)
    np.testing.assert_array_equal(live.out[1], rep.out[1])
    assert live.finalized_d2 == rep.finalized_d2


@contextlib.contextmanager
def serving(srv):
    srv.start()
    try:
        yield srv
    finally:
        srv.stop(drain=True, timeout=WAIT)


def _join(threads):
    for t in threads:
        t.join(WAIT)
    assert not any(t.is_alive() for t in threads), "a thread hung"


# ------------------------------------------------- queue mechanics

def _req(deadline=None):
    return _Request(np.zeros(DIM, np.float32), RouteFuture(),
                    time.monotonic(), deadline)


def test_queue_backpressure_nonblocking_and_timed():
    q = RequestQueue(2)
    q.put(_req()), q.put(_req())
    with pytest.raises(BackpressureError, match="full"):
        q.put(_req(), block=False)
    t0 = time.monotonic()
    with pytest.raises(BackpressureError, match="full"):
        q.put(_req(), block=True, timeout=0.05)
    assert time.monotonic() - t0 >= 0.04
    with pytest.raises(ValueError, match=">= 1"):
        RequestQueue(0)


def test_queue_next_batch_coalesces_and_respects_max_batch():
    q = RequestQueue(16)
    for _ in range(5):
        q.put(_req())
    assert len(q.next_batch(3, 0.0)) == 3
    assert len(q.next_batch(8, 0.0)) == 2


def test_queue_waits_for_stragglers_within_the_window():
    q = RequestQueue(16)
    q.put(_req())
    late = threading.Timer(0.02, lambda: q.put(_req()))
    late.start()
    batch = q.next_batch(8, 0.5)
    _join([late])
    assert len(batch) == 2


def test_queue_stop_drop_returns_backlog_and_rejects_puts():
    q = RequestQueue(8)
    q.put(_req()), q.put(_req())
    dropped = q.stop(drop=True)
    assert len(dropped) == 2 and len(q) == 0
    assert q.next_batch(4, 0.0) is None
    with pytest.raises(ServerClosed):
        q.put(_req())


def test_future_caller_side_timeout_and_single_use():
    fut = RouteFuture()
    with pytest.raises(RouteTimeout, match="no route result"):
        fut.result(0.01)
    fut.set_result(3)
    assert fut.result(0.01) == 3 and fut.done()
    assert fut.done_at is not None
    bad = RouteFuture()
    bad.set_error(ServerClosed("gone"))
    with pytest.raises(ServerClosed, match="gone"):
        bad.result(0.01)


# ------------------------------------------------- server routes

def test_server_batched_routes_match_direct():
    rows = _population()
    session, _ = _served_session(rows)
    expect = np.asarray(session.route(rows[:32]))
    obs.reset()
    with serving(RouteServer(session, max_batch=8,
                             max_wait_ms=1.0)) as srv:
        futs = [srv.submit(r) for r in rows[:32]]
        got = np.asarray([f.result(WAIT) for f in futs])
        single = srv.route(rows[7], timeout=WAIT)
        tensor = srv.route(torch.from_numpy(rows[9]), timeout=WAIT)
    np.testing.assert_array_equal(got, expect)
    assert single == expect[7] and tensor == expect[9]
    assert srv.route_direct(rows[7]) == expect[7]
    flushes = obs.snapshot()["histograms"]["serving.flush_size"]
    assert flushes["max"] <= 8 and flushes["count"] >= 4


def test_server_params_route_path():
    rng = np.random.default_rng(0)
    theta = np.concatenate([
        j * 30.0 + rng.standard_normal((16, 8)).astype(np.float32)
        for j in range(2)])
    session = AggregationSession(32, sketch_dim=DIM, seed=0, device=CPU)
    session.ingest({"theta": torch.from_numpy(theta)})
    session.finalize(algorithm="kmeans-device", k=2)
    with serving(RouteServer(session)) as srv:
        for i in (3, 20):
            probe = {"theta": theta[i]}
            got = srv.route(params=probe, timeout=WAIT)
            assert got == session.route(params={"theta": torch.from_numpy(
                theta[i])})
    # the per-request path takes a sketch tensor as it comes
    sketch = session.sketch_params({"theta": torch.from_numpy(theta[3:4])})
    assert srv.route_direct(sketch[0]) == session.route(
        params={"theta": torch.from_numpy(theta[3])})


def test_server_submit_validation_and_lifecycle():
    rows = _population(64)
    session, _ = _served_session(rows, wave=64)
    srv = RouteServer(session)
    srv.start(), srv.start()                      # idempotent
    with pytest.raises(ValueError, match="exactly one"):
        srv.submit(rows[0], params={"theta": rows[0]})
    with pytest.raises(ValueError, match="exactly one"):
        srv.submit()
    with pytest.raises(ValueError, match=r"\(16,\)"):
        srv.submit(rows[:2])
    srv.stop(timeout=WAIT)
    with pytest.raises(ServerClosed):
        srv.submit(rows[0])
    with pytest.raises(ServerClosed):
        srv.start()
    with pytest.raises(ValueError, match="max_batch"):
        RouteServer(session, max_batch=0)
    with pytest.raises(ValueError, match="max_wait_ms"):
        RouteServer(session, max_wait_ms=-1.0)


def test_routes_before_a_finalize_fail_with_the_session_error():
    session = AggregationSession(8, sketch_dim=DIM, device=CPU)
    session.ingest(sketches=_population(8))
    obs.reset()
    with serving(RouteServer(session)) as srv:
        with pytest.raises(ValueError, match="finalize"):
            srv.route(_population(8)[0], timeout=WAIT)
    assert obs.snapshot()["counters"]["serving.flush_errors"] == 1


def test_server_side_deadline_expires_requests():
    rows = _population(64)
    session, _ = _served_session(rows, wave=64)
    obs.reset()
    with serving(RouteServer(session, max_wait_ms=200.0)) as srv:
        fut = srv.submit(rows[0], timeout=0.001)
        with pytest.raises(RouteTimeout, match="expired"):
            fut.result(WAIT)
    assert obs.snapshot()["counters"].get("serving.timeouts") == 1


def test_server_backpressure_and_drop_shutdown():
    rows = _population(64)
    session, _ = _served_session(rows, wave=64)
    obs.reset()
    srv = RouteServer(session, queue_depth=2, block_on_full=False)
    futs = [srv.submit(rows[0]), srv.submit(rows[1])]
    with pytest.raises(BackpressureError):
        srv.submit(rows[2])
    assert obs.snapshot()["counters"]["serving.backpressure"] == 1
    srv.stop(drain=False, timeout=WAIT)
    for fut in futs:
        with pytest.raises(ServerClosed):
            fut.result(1.0)


def test_server_drain_serves_backlog_on_stop():
    rows = _population(64)
    session, _ = _served_session(rows, wave=64)
    srv = RouteServer(session, max_batch=4, max_wait_ms=50.0)
    futs = [srv.submit(r) for r in rows[:8]]      # queued, no batcher yet
    srv.start()
    srv.stop(drain=True, timeout=WAIT)
    got = np.asarray([f.result(WAIT) for f in futs])
    np.testing.assert_array_equal(got, np.asarray(session.route(rows[:8])))


def test_flushes_are_padded_to_powers_of_two():
    rows = _population(64)
    session, _ = _served_session(rows, wave=64)
    seen = []
    real = session.route

    def spy(pts, **kw):
        seen.append(len(pts))
        return real(pts, **kw)
    session.route = spy
    srv = RouteServer(session, max_batch=8, max_wait_ms=50.0)
    futs = [srv.submit(r) for r in rows[:11]]     # flushes of 8 and 3
    srv.start()
    srv.stop(drain=True, timeout=WAIT)
    got = [f.result(WAIT) for f in futs]
    assert seen == [8, 4]
    np.testing.assert_array_equal(got, real(rows[:11]))


# ------------------------------------------------- ingest while finalize

def test_ingest_during_finalize_serves_snapshot_bit_exact():
    rows = _population(256)
    session, log = _served_session(rows, capacity=512)
    extra = _population(64, seed=9)
    with serving(RouteServer(session)) as srv:
        fut = srv.finalize(background=True, algorithm="kmeans-device", k=K)
        snap_clock = session.clock
        _, clk = srv.ingest(sketches=extra,
                            client_ids=list(range(256, 320)))
        log.append((clk, list(range(256, 320)), extra))
        assert clk == snap_clock + 1
        out = fut.result(WAIT)
    assert out[2]["snapshot_clock"] == snap_clock
    served = session.served_round
    assert served.clock == snap_clock          # known-stale by one wave
    assert session.clock == snap_clock + 1
    replay = _replay(log, [snap_clock], capacity=512)
    _assert_same_round(served, replay.served_round)


def test_sync_finalize_through_server_matches_session():
    rows = _population(128)
    session, log = _served_session(rows)
    with serving(RouteServer(session)) as srv:
        out = srv.finalize(algorithm="kmeans-device", k=K)
    assert out[2]["snapshot_clock"] == session.clock
    replay = _replay(log, [session.clock], capacity=128)
    _assert_same_round(session.served_round, replay.served_round)


def test_refinalize_requires_prior_finalize():
    session = AggregationSession(64, sketch_dim=DIM, seed=0, device=CPU)
    session.ingest(sketches=_population(64)[:32], client_ids=range(32))
    with serving(RouteServer(session)) as srv:
        with pytest.raises(ValueError, match="prior finalize"):
            srv.refinalize()
        assert srv.maybe_refinalize() is None      # no drift, no config


def test_a_round_on_a_worker_leaves_the_served_round_until_install():
    rows = _population(128)
    session, _ = _served_session(rows)
    before = session.served_round
    probe = session.route(rows[:16])
    session.ingest(sketches=rows[:64] + 5.0, client_ids=range(64))
    snap = session.snapshot()
    done = {}

    def worker():
        done["round"] = session.compute_round(snap, warm=True,
                                              **session.finalize_config)
    t = threading.Thread(target=worker)
    t.start()
    _join([t])
    out, served = done["round"]
    assert session.served_round is before
    np.testing.assert_array_equal(session.route(rows[:16]), probe)
    assert served.clock == snap.clock and out[2]["refinalize"] == "warm"
    session.install_round(out, served)
    assert session.served_round is served
    assert session.drift is None


def test_maybe_refinalize_runs_in_the_background_once():
    rows = _population(128)
    session, _ = _served_session(rows)
    session.route(rows[:8] + 50.0)                # drifted traffic
    with serving(RouteServer(session)) as srv:
        srv._finalize_lock.acquire()              # a round in flight
        assert srv.maybe_refinalize(threshold=1.5) is None
        srv._finalize_lock.release()
        fut = srv.maybe_refinalize(threshold=1.5)
        out = fut.result(WAIT)
    assert out[2]["refinalize"] == "warm"
    assert session.drift is None


# ------------------------------------------------- threaded stress

def test_stress_threads_and_serialized_replay():
    """3 ingest threads re-uploading keyed waves, 4 route callers and
    drift-triggered background warm refinalizes, all at once.  Every
    request resolves exactly once, and the final served round equals the
    serialized replay of the logged waves and round snapshots bit for
    bit."""
    clients, n_ingesters, n_callers = 384, 3, 4
    rows = _population(clients)
    session, log = _served_session(rows, capacity=512, wave=128)
    round_clocks = [session.served_round.clock]
    log_lock = threading.Lock()
    stop_routing = threading.Event()
    counts = [None] * n_callers
    obs.reset()
    srv = RouteServer(session, max_batch=16, max_wait_ms=1.0,
                      queue_depth=256)
    srv.start()

    def ingester(tid):
        rng = np.random.default_rng(100 + tid)
        for _ in range(5):
            ids = rng.choice(clients, size=64, replace=False)
            chunk = (rows[ids] + 0.2 * rng.standard_normal(
                (len(ids), DIM)).astype(np.float32))
            _, clk = srv.ingest(sketches=chunk,
                                client_ids=[int(i) for i in ids])
            with log_lock:
                log.append((clk, [int(i) for i in ids], chunk))
            time.sleep(0.003)

    def caller(tid):
        rng = np.random.default_rng(200 + tid)
        n_sub = n_done = n_to = 0
        while not stop_routing.is_set():
            sk = rows[rng.integers(0, clients)]
            n_sub += 1
            try:
                srv.route(sk, timeout=WAIT)
                n_done += 1
            except RouteTimeout:
                n_to += 1
        counts[tid] = (n_sub, n_done, n_to)

    ingesters = [threading.Thread(target=ingester, args=(t,), daemon=True)
                 for t in range(n_ingesters)]
    callers = [threading.Thread(target=caller, args=(t,), daemon=True)
               for t in range(n_callers)]
    rounds = []
    for t in ingesters + callers:
        t.start()
    deadline = time.monotonic() + WAIT
    while any(t.is_alive() for t in ingesters):
        assert time.monotonic() < deadline, "ingest threads hung"
        fut = srv.maybe_refinalize(threshold=-1.0, background=True)
        if fut is not None:
            rounds.append(fut)
        time.sleep(0.02)
    _join(ingesters)
    if not rounds:
        # a loaded machine: no drift-triggered round landed inside the
        # ingest window; force one under live route traffic
        rounds.append(srv.refinalize(background=True))
    # one last round over a quiet buffer, so the served round is final
    rounds.append(srv.refinalize(background=True))
    results = [f.result(WAIT) for f in rounds]
    stop_routing.set()
    _join(callers)
    srv.stop(timeout=WAIT)

    assert all(c is not None for c in counts)
    n_sub = sum(c[0] for c in counts)
    n_done = sum(c[1] for c in counts)
    n_to = sum(c[2] for c in counts)
    assert n_done + n_to == n_sub and n_to == 0
    snap = obs.snapshot()["counters"]
    assert snap.get("serving.requests", 0) == n_sub
    assert snap.get("serving.flush_errors", 0) == 0
    assert n_done > 0 and len(results) >= 2

    round_clocks += [r[2]["snapshot_clock"] for r in results]
    assert round_clocks == sorted(round_clocks)
    served = session.served_round
    assert served.clock == round_clocks[-1] == session.clock
    replay = _replay(log, round_clocks, capacity=512)
    _assert_same_round(served, replay.served_round)


# ------------------------------------------------- loadgen smoke

def test_loadgen_smoke_report_schema():
    from repro_torch.serving import loadgen

    report = loadgen.run(clients=128, clusters=K, sketch_dim=DIM,
                         callers=(2,), duration_s=0.4, max_batch=16,
                         queue_depth=64, open_rate=None, ingest=True,
                         device=CPU)
    assert report["bench"] == "serving"
    assert report["schema_version"] == loadgen.SCHEMA_VERSION == 1
    assert report["config"]["card"] == "cpu"
    assert "callers=2" in report["criterion"]
    assert len(report["rows"]) == 3            # direct, batched, ingest
    for row in report["rows"]:
        for key in ("mode", "batched", "qps", "n_requests", "n_errors",
                    "timeouts", "drops", "flush_size_p50",
                    "backpressure", "ingest_waves",
                    "refinalize_under_load_ms", "clients"):
            assert key in row
        assert row["n_errors"] == 0 and row["drops"] == 0
        assert row["timeouts"] == 0 and row["flush_errors"] == 0
        # every batched request went out in one flush, at a power-of-two
        # bucket of at most max_batch rows; a direct row flushes nothing
        buckets = {int(b): n for b, n in row["flushes_by_bucket"].items()}
        assert set(buckets) <= {1, 2, 4, 8, 16}
        if not row["batched"]:
            assert buckets == {}
        else:
            assert 0 < sum(buckets.values()) <= row["n_requests"]
    under = report["rows"][-1]
    assert under["ingest_waves"] > 0
    assert under["refinalize_under_load_ms"] is not None
    assert under["refinalize_window_ms"] > 0
    assert (under["n_requests_during_refinalize"] == 0
            or under["route_p99_ms_during_refinalize"] is not None)


def test_loadgen_main_open_loop_writes_the_report(tmp_path, capsys):
    from repro_torch.serving import loadgen

    out = tmp_path / "bench.json"
    rc = loadgen.main(["--clients", "64", "--clusters", "2",
                       "--sketch-dim", "8", "--callers", "1",
                       "--duration", "0.2", "--no-ingest",
                       "--open-rate", "200", "--device", "cpu",
                       "--out", str(out)])
    assert rc == 0 and out.exists()
    import json
    report = json.loads(out.read_text())
    assert [r["mode"] for r in report["rows"]] == ["closed", "closed",
                                                   "open"]
    assert report["rows"][-1]["offered_rate"] == 200.0
    assert "wrote" in capsys.readouterr().out


def test_server_stop_reports_a_finalize_that_does_not_end():
    rows = _population(64)
    session, _ = _served_session(rows, wave=64)
    srv = RouteServer(session).start()
    srv._finalize_lock.acquire()
    with pytest.raises(ServingError, match="did not end"):
        srv.stop(timeout=0.05)
    srv._finalize_lock.release()


@pytest.mark.parametrize("n,max_batch,want", [
    (1, 64, 1), (2, 64, 2), (3, 64, 4), (5, 64, 8), (33, 64, 64),
    (64, 64, 64), (40, 48, 48), (48, 48, 48)])
def test_flush_bucket_pads_to_the_next_power_of_two(n, max_batch, want):
    from repro_torch.serving.server import flush_bucket

    assert flush_bucket(n, max_batch) == want

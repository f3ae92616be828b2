"""The route server over a client-sharded session, on the CPU: ingest and
rounds through rank 0's ``RouteServer`` while the servers of the other
ranks follow its ordered log (``serving/oplog.py``).

* One 4-rank world (spawned gloo processes, one module-scoped run, each
  rank pinned to one thread) drives every case of ``CASES`` in order.
  The parent runs the unmeshed counterparts: the same calls through an
  unmeshed server, and the serialized replays of rank 0's logs.
* Every rank ends at rank 0's clock with rank 0's served round, bit for
  bit (the followers apply the same entries and run the same rounds).
  Labels equal the unmeshed ones; centers and cluster models within
  rtol 1e-6 (the all-reduce sums in another order).  Rank 0's round
  under threads equals the serialized replay of its log on a meshed
  session of the same ranks, bit for bit.
* The reference runs the sequence case through its ``RouteServer`` over
  a meshed session on four forced host devices, in a process of its own
  (its program cache ignores shardings, ROADMAP queue C).  Both seed
  with ``init="spectral"``, which draws nothing (farthest points in the
  top-k singular subspace): the reference cannot replay a finalize
  warm-started from ``init_centers`` (its warm refinalize passes
  ``init_centers`` twice, ROADMAP queue C), so the seeding is not
  carried across as the other parity tests carry it.
"""
import os
import socket
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch import runtime

REPO = Path(__file__).resolve().parents[1]
RANKS = 4
CAP, DIM, K = 512, 8, 4
WAIT = 60.0
WORLD_TIMEOUT = 300
CENTER_RTOL = 1e-6


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One host thread a process: the tensors are small, and the four
    ranks and the parallel test workers must not oversubscribe the CPU."""
    with runtime.pinned_threads(1):
        yield


# ------------------------------------------------------------- the inputs

def population(clients=384, seed=0):
    from repro_torch.serving.loadgen import make_population

    rows, _, _ = make_population(clients=clients, clusters=K,
                                 sketch_dim=DIM, seed=seed)
    return rows


def federation():
    """Two-leaf client models in K blobs, client i in blob i % K."""
    rng = np.random.default_rng(3)
    centers = rng.normal(size=(K, 6)) * 10.0
    theta = (centers[np.arange(256) % K]
             + 0.1 * rng.normal(size=(256, 6))).astype(np.float32)
    return {"w": theta[:, :4], "b": theta[:, 4:]}


def _rank(mesh) -> int:
    from repro_torch.sharding.clients import client_axis_of

    return client_axis_of(mesh).rank


def _session(mesh, **kw):
    from repro_torch.core.engine.session import AggregationSession

    return AggregationSession(kw.pop("capacity", CAP), sketch_dim=DIM,
                              seed=0, mesh=mesh, device="cpu", **kw)


def _server(sess, **kw):
    from repro_torch.serving.server import RouteServer

    kw = {"max_batch": 16, "max_wait_ms": 0.5, **kw}
    return RouteServer(sess, **kw).start()


def _round(sess) -> dict:
    served = sess.served_round
    return {"clock": sess.clock, "served_clock": served.clock,
            "labels": np.asarray(served.out[1]),
            "centers": served.centers.numpy(),
            "first_idx": np.asarray(served.first_idx),
            "d2": served.finalized_d2, "n_clusters": served.n_clusters}


def _share(mesh, obj):
    """Rank 0's object on every rank (the world group, no server open)."""
    import torch.distributed as dist

    box = [obj if _rank(mesh) == 0 else None]
    dist.broadcast_object_list(box, src=0)
    return box[0]


# -------------------------------------------------------------- the cases

def sequence(srv, sess, rows) -> dict:
    """Ingests, a sync finalize, a background finalize with a wave
    ingested while it computes, a warm refinalize, and a drift-triggered
    background refinalize after drifted routes: on rank 0 of a mesh, or
    unmeshed."""
    spectral = {"init": "spectral"}
    for lo in (0, 128):
        srv.ingest(sketches=rows[lo:lo + 128],
                   client_ids=list(range(lo, lo + 128)))
    srv.finalize(k=K, algo_options=spectral)
    fut = srv.finalize(background=True, k=K, algo_options=spectral)
    snap_clock = sess.clock
    _, clk = srv.ingest(sketches=rows[256:320],
                        client_ids=list(range(256, 320)))
    out = fut.result(WAIT)
    bg = {"snap_clock": snap_clock, "wave_clock": clk,
          "round_clock": out[2]["snapshot_clock"],
          "served_clock": sess.served_round.clock,
          "clock_after": sess.clock}
    srv.refinalize()
    for p in rows[:16] + 50.0:
        srv.route(p, timeout=WAIT)
    fut = srv.maybe_refinalize(threshold=1.5)
    bg["maybe_fired"] = fut is not None
    if fut is not None:
        bg["maybe_mode"] = fut.result(WAIT)[2]["refinalize"]
    return bg


def case_sequence(mesh, extra):
    from repro_torch.serving.batching import ServingError

    sess = _session(mesh)
    srv = _server(sess)
    got, refused = {}, {}
    if _rank(mesh) == 0:
        got = sequence(srv, sess, extra["rows"])
    else:
        for what, call in (
                ("ingest", lambda: srv.ingest(sketches=extra["rows"][:4])),
                ("finalize", lambda: srv.finalize(k=K)),
                ("refinalize", lambda: srv.refinalize()),
                ("maybe_refinalize", lambda: srv.maybe_refinalize())):
            try:
                call()
                refused[what] = None
            except ServingError as e:
                refused[what] = str(e)
    srv.stop(timeout=WAIT)
    return {**_round(sess), "background": got, "refused": refused}


def case_params(mesh, extra):
    """Parameter waves through rank 0's server: a finalize, one more wave,
    a warm refinalize; the cluster models."""
    fed = {k: torch.from_numpy(v) for k, v in federation().items()}
    sess = _session(mesh, capacity=256)
    srv = _server(sess)
    if _rank(mesh) == 0:
        for lo in (0, 64, 128):
            srv.ingest({k: v[lo:lo + 64] for k, v in fed.items()},
                       client_ids=list(range(lo, lo + 64)))
        srv.finalize(k=K)
        srv.ingest({k: v[192:] for k, v in fed.items()},
                   client_ids=list(range(192, 256)))
        srv.refinalize()
    srv.stop(timeout=WAIT)
    models = sess.cluster_models()
    return {**_round(sess),
            "models": np.concatenate([models["w"].numpy(),
                                      models["b"].numpy()], axis=1)}


def case_refusals(mesh, extra):
    """A bad wave, a missing k and an unknown algorithm raise on rank 0
    and send nothing; the followers go on."""
    from repro_torch import obs

    rows = extra["rows"]
    sess = _session(mesh)
    sess.ingest(sketches=rows[:128], client_ids=list(range(128)))
    sess.finalize(k=K)

    def sent():
        return obs.snapshot()["counters"].get("serving.log.entries", 0)

    srv = _server(sess)
    errors, before, after = {}, sent(), None
    if _rank(mesh) == 0:
        for what, call in (
                ("wave", lambda: srv.ingest(sketches=np.zeros((4, DIM + 1),
                                                              np.float32))),
                ("k", lambda: srv.finalize(k=None)),
                ("algorithm", lambda: srv.finalize(algorithm="no-such",
                                                   k=K))):
            try:
                call()
                errors[what] = None
            except (ValueError, KeyError) as e:
                errors[what] = type(e).__name__
        after = sent()
        srv.ingest(sketches=rows[128:192], client_ids=list(range(128, 192)))
        srv.finalize(k=K)
    srv.stop(timeout=WAIT)
    return {**_round(sess), "errors": errors, "sent_before": before,
            "sent_after": after, "entries": sent() - before}


def case_run_row(mesh, extra):
    """``loadgen.run_row(ingest=True)`` on rank 0, unchanged, over a
    meshed ``build_session``; the other ranks follow its server."""
    from repro_torch.serving import loadgen

    session, rows = loadgen.build_session(clients=2048, clusters=K,
                                          sketch_dim=DIM, seed=0,
                                          device="cpu", mesh=mesh)
    row = None
    if _rank(mesh) == 0:
        row = loadgen.run_row(session, rows, mode="closed", batched=True,
                              callers=4, duration_s=0.6, ingest=True,
                              ingest_log=[], max_batch=16, max_wait_ms=0.5)
    else:
        _server(session).stop(timeout=WAIT)
    return {**_round(session), "row": row,
            "mode": session.served_round.out[2]["refinalize"]}


def case_stress(mesh, extra):
    """Rank 0: an ingest thread re-uploading keyed waves, 4 route callers
    and drift-triggered background refinalizes at once, then a last
    refinalize, with the threads switching every 10 us.  Then every rank
    replays rank 0's log serially on a meshed session."""
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        return _stress(mesh, extra)
    finally:
        sys.setswitchinterval(interval)


def _stress(mesh, extra):
    from repro_torch.serving.batching import RouteTimeout

    rows = extra["rows"]
    sess = _session(mesh)
    log = []
    for lo in range(0, 384, 128):
        ids = list(range(lo, lo + 128))
        sess.ingest(sketches=rows[lo:lo + 128], client_ids=ids)
        log.append((sess.clock, ids, rows[lo:lo + 128]))
    sess.finalize(k=K)
    clocks = [sess.served_round.clock]
    srv = _server(sess, queue_depth=256)
    counts = None
    if _rank(mesh) == 0:
        stop = threading.Event()
        counts = [None] * 4

        def ingester():
            rng = np.random.default_rng(100)
            for _ in range(6):
                ids = [int(i) for i in rng.choice(384, 64, replace=False)]
                chunk = rows[ids] + 0.2 * rng.standard_normal(
                    (64, DIM)).astype(np.float32)
                _, clk = srv.ingest(sketches=chunk, client_ids=ids)
                log.append((clk, ids, chunk))
                time.sleep(0.01)

        def caller(tid):
            rng = np.random.default_rng(200 + tid)
            n_sub = n_done = 0
            while not stop.is_set():
                n_sub += 1
                try:
                    srv.route(rows[rng.integers(0, 384)], timeout=WAIT)
                    n_done += 1
                except RouteTimeout:
                    pass
            counts[tid] = (n_sub, n_done)

        threads = [threading.Thread(target=ingester, daemon=True)] + [
            threading.Thread(target=caller, args=(t,), daemon=True)
            for t in range(4)]
        for t in threads:
            t.start()
        rounds = []
        deadline = time.monotonic() + WAIT
        while threads[0].is_alive() and time.monotonic() < deadline:
            fut = srv.maybe_refinalize(threshold=-1.0)
            if fut is not None:
                rounds.append(fut)
            time.sleep(0.02)
        threads[0].join(WAIT)
        rounds.append(srv.refinalize(background=True))
        clocks += [f.result(WAIT)[2]["snapshot_clock"] for f in rounds]
        stop.set()
        for t in threads[1:]:
            t.join(WAIT)
    srv.stop(timeout=WAIT)
    log, clocks = _share(mesh, (log, clocks))
    live = _round(sess)
    replay = _replay(mesh, log, clocks)
    return {**live, "replay": _round(replay), "log": log,
            "round_clocks": clocks, "counts": counts}


def _replay(mesh, log, clocks):
    """The serialized replay: the SAME keyed waves in clock order, the
    cold finalize right after the first round clock and a warm
    refinalize right after each later one."""
    replay = _session(mesh)
    waves = sorted(log, key=lambda w: w[0])
    done = 0
    for i, clk in enumerate(clocks):
        while done < len(waves) and waves[done][0] <= clk:
            c, ids, chunk = waves[done]
            replay.ingest(sketches=chunk, client_ids=ids)
            assert replay.clock == c
            done += 1
        if i == 0:
            replay.finalize(k=K)
        else:
            replay.refinalize()
    return replay


def case_late_close(mesh, extra):
    """Rank 0 stops with a 0.5 s timeout while the followers open their
    servers 2 s late: rank 0's stop raises; the followers then take the
    close and acknowledge it."""
    from repro_torch.serving.batching import ServingError

    sess = _session(mesh)
    if _rank(mesh) != 0:
        time.sleep(2.0)
        _server(sess).stop(timeout=WAIT)
        return {"error": None}
    srv = _server(sess)
    try:
        srv.stop(timeout=0.5)
        return {"error": None}
    except ServingError as e:
        return {"error": str(e)}


def case_divergence(mesh, extra):
    """Rank 1's session is one wave ahead before it follows: the first
    entry it applies fails its clock check.  Its stop and its routes
    raise; rank 0's stop raises once every rank has taken the close."""
    from repro_torch.serving.batching import ServingError

    rows = extra["rows"]
    rank = _rank(mesh)
    sess = _session(mesh)
    sess.ingest(sketches=rows[:64], client_ids=list(range(64)))
    sess.finalize(k=K)
    if rank == 1:
        sess.ingest(sketches=rows[64:128], client_ids=list(range(64, 128)))
    srv = _server(sess)
    out = {"stop": None, "route": None}
    if rank == 0:
        srv.ingest(sketches=rows[128:192], client_ids=list(range(128, 192)))
    deadline = time.monotonic() + WAIT
    while rank == 1 and out["route"] is None and time.monotonic() < deadline:
        try:                  # routes are served until the divergence
            srv.route(rows[0], timeout=WAIT)
        except ServingError as e:
            out["route"] = str(e)
    try:
        srv.stop(timeout=WAIT)
    except ServingError as e:
        out["stop"] = str(e)
    if rank == 1:
        # its thread still takes the entries up to the close and answers
        # it; the world goes on after that
        srv._following.join(WAIT)
    return out


CASES = {"sequence": case_sequence, "params": case_params,
         "refusals": case_refusals, "run_row": case_run_row,
         "stress": case_stress, "late_close": case_late_close,
         "divergence": case_divergence}
SERVED = ("sequence", "params", "refusals", "run_row", "stress")


# ------------------------------------------------------------ the world

def _rank_main(rank: int, port: int, out_dir: str, extra: dict) -> None:
    from repro_torch.launch.mesh import client_mesh

    with runtime.pinned_threads(1):
        mesh = client_mesh(RANKS, backend="gloo", device="cpu", rank=rank,
                           init_method=f"tcp://localhost:{port}")
        results = {name: case(mesh, extra) for name, case in CASES.items()}
        torch.distributed.destroy_process_group()
    torch.save(results, os.path.join(out_dir, f"rank{rank}.pt"))


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


REFERENCE = r"""
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import numpy as np
import jax
from jax.sharding import Mesh
from repro.core.engine import AggregationSession
from repro.serving import RouteServer

src, dst = sys.argv[1:3]
inp = np.load(src)
rows = inp["rows"]
mesh = Mesh(np.array(jax.devices()), ("data",))     # Auto axes
sess = AggregationSession(%(cap)d, sketch_dim=%(dim)d, seed=0, mesh=mesh)
spectral = {"init": "spectral"}
with RouteServer(sess, max_batch=16, max_wait_ms=0.5) as srv:
    for lo in (0, 128):
        srv.ingest(sketches=rows[lo:lo + 128],
                   client_ids=list(range(lo, lo + 128)))
    srv.finalize(k=%(k)d, algo_options=spectral)
    fut = srv.finalize(background=True, k=%(k)d, algo_options=spectral)
    snap_clock = sess.clock
    srv.ingest(sketches=rows[256:320], client_ids=list(range(256, 320)))
    fut.result(120.0)
    srv.refinalize()
    for p in rows[:16] + 50.0:
        srv.route(p, timeout=120.0)
    fut = srv.maybe_refinalize(threshold=1.5)
    fut.result(120.0)
served = sess.served_round
np.savez(dst, labels=np.asarray(served.out[1]),
         centers=np.asarray(served.centers), clock=sess.clock,
         served_clock=served.clock, snap_clock=snap_clock,
         devices=len(sess._sketches.sharding.device_set))
""" % {"cap": CAP, "dim": DIM, "k": K}


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """Start the reference's process, run the 4-rank world, then collect
    both.  Returns ``{"ranks": [results of rank r], "reference": npz,
    "extra": the shared inputs}``."""
    import torch.multiprocessing as mp

    tmp = tmp_path_factory.mktemp("mesh_route_server")
    extra = {"rows": population()}
    np.savez(tmp / "in.npz", **extra)
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"), JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)
    ref = subprocess.Popen(
        [sys.executable, "-c", REFERENCE, str(tmp / "in.npz"),
         str(tmp / "ref.npz")], stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True, env=env, cwd=REPO)
    try:
        ctx = mp.start_processes(_rank_main, args=(_free_port(), str(tmp),
                                                   extra),
                                 nprocs=RANKS, join=False,
                                 start_method="spawn")
        deadline = time.monotonic() + WORLD_TIMEOUT
        while not ctx.join(timeout=5):
            if time.monotonic() > deadline:
                for p in ctx.processes:
                    p.kill()
                pytest.fail(f"the {RANKS}-rank world ran past "
                            f"{WORLD_TIMEOUT} s")
        ranks = [torch.load(tmp / f"rank{r}.pt", weights_only=False)
                 for r in range(RANKS)]
        out, err = ref.communicate(timeout=WORLD_TIMEOUT)
        assert ref.returncode == 0, out + err
        reference = dict(np.load(tmp / "ref.npz"))
    finally:
        if ref.poll() is None:
            ref.kill()
            ref.wait()
    yield {"ranks": ranks, "reference": reference, "extra": extra}


def _assert_same(got: dict, want: dict) -> None:
    """Two served rounds equal bit for bit."""
    for key in ("clock", "served_clock", "d2", "n_clusters"):
        assert got[key] == want[key], key
    for key in ("labels", "centers", "first_idx"):
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)


def _unmeshed_sequence(extra) -> dict:
    sess = _session(None)
    srv = _server(sess)
    bg = sequence(srv, sess, extra["rows"])
    srv.stop(timeout=WAIT)
    return {**_round(sess), "background": bg}


# ------------------------------------------------------------------ tests

@pytest.mark.parametrize("name", SERVED)
def test_every_rank_ends_on_rank_0s_round(world, name):
    first = world["ranks"][0][name]
    for r in range(1, RANKS):
        _assert_same(world["ranks"][r][name], first)


def test_background_round_stays_on_its_snapshot(world):
    """As ``tests/test_serving.py``'s ingest-during-finalize: the round
    is built from the snapshot, one wave behind the clock."""
    bg = world["ranks"][0]["sequence"]["background"]
    assert bg["wave_clock"] == bg["snap_clock"] + 1
    assert bg["round_clock"] == bg["served_clock"] == bg["snap_clock"]
    assert bg["clock_after"] == bg["snap_clock"] + 1
    assert bg["maybe_fired"] and bg["maybe_mode"] == "warm"


def test_followers_refuse_ingest_and_rounds_naming_rank_0(world):
    assert world["ranks"][0]["sequence"]["refused"] == {}
    for r in range(1, RANKS):
        refused = world["ranks"][r]["sequence"]["refused"]
        assert set(refused) == {"ingest", "finalize", "refinalize",
                                "maybe_refinalize"}
        assert all(m is not None and "rank 0's server" in m
                   for m in refused.values())


def test_sequence_equals_the_unmeshed_server(world):
    got = world["ranks"][0]["sequence"]
    want = _unmeshed_sequence(world["extra"])
    assert got["background"] == want["background"]
    assert got["clock"] == want["clock"]
    np.testing.assert_array_equal(got["labels"], want["labels"])
    np.testing.assert_allclose(got["centers"], want["centers"],
                               rtol=CENTER_RTOL, atol=1e-6)


def test_sequence_equals_the_meshed_reference(world):
    got, want = world["ranks"][0]["sequence"], world["reference"]
    assert int(want["devices"]) == RANKS      # the reference did shard
    assert got["clock"] == int(want["clock"])
    assert got["served_clock"] == int(want["served_clock"])
    assert got["background"]["snap_clock"] == int(want["snap_clock"])
    np.testing.assert_array_equal(got["labels"], want["labels"])
    np.testing.assert_allclose(got["centers"], want["centers"],
                               rtol=CENTER_RTOL, atol=1e-6)


def test_stress_round_equals_the_meshed_serialized_replay(world):
    """Every rank's replay of rank 0's log on the mesh serves rank 0's
    round bit for bit."""
    got = world["ranks"][0]["stress"]
    assert len(got["round_clocks"]) >= 2
    for r in range(RANKS):
        mine = world["ranks"][r]["stress"]
        _assert_same(mine, mine["replay"])


def test_stress_labels_equal_the_unmeshed_replay(world):
    got = world["ranks"][0]["stress"]
    replay = _replay(None, got["log"], got["round_clocks"])
    assert replay.clock == got["served_clock"]
    np.testing.assert_array_equal(np.asarray(replay.served_round.out[1]),
                                  got["labels"])
    np.testing.assert_allclose(replay.served_round.centers.numpy(),
                               got["centers"], rtol=CENTER_RTOL, atol=1e-6)


def test_stress_every_request_resolves(world):
    counts = world["ranks"][0]["stress"]["counts"]
    assert all(c is not None and c[0] == c[1] and c[1] > 0 for c in counts)
    for r in range(1, RANKS):
        assert world["ranks"][r]["stress"]["counts"] is None


def test_parameter_waves_give_the_unmeshed_cluster_models(world):
    fed = {k: torch.from_numpy(v) for k, v in federation().items()}
    sess = _session(None, capacity=256)
    srv = _server(sess)
    for lo in (0, 64, 128):
        srv.ingest({k: v[lo:lo + 64] for k, v in fed.items()},
                   client_ids=list(range(lo, lo + 64)))
    srv.finalize(k=K)
    srv.ingest({k: v[192:] for k, v in fed.items()},
               client_ids=list(range(192, 256)))
    srv.refinalize()
    srv.stop(timeout=WAIT)
    models = sess.cluster_models()
    want = np.concatenate([models["w"].numpy(), models["b"].numpy()], axis=1)
    got = world["ranks"][0]["params"]
    np.testing.assert_array_equal(got["labels"],
                                  np.asarray(sess.served_round.out[1]))
    np.testing.assert_allclose(got["models"], want, rtol=CENTER_RTOL,
                               atol=1e-6)


def test_run_row_under_ingest_on_rank_0(world):
    got = world["ranks"][0]["run_row"]
    row = got["row"]
    assert row["n_errors"] == row["timeouts"] == row["flush_errors"] == 0
    assert row["ingest_waves"] > 0 and row["n_requests"] > 0
    assert row["refinalize_under_load_ms"] is not None
    assert got["mode"] == "warm"
    for r in range(1, RANKS):
        assert world["ranks"][r]["run_row"]["row"] is None


def test_refusals_stay_on_rank_0(world):
    """Nothing of a refused call is sent: rank 0's log sent no entry for
    them, and every rank took the same two entries and the close."""
    got = world["ranks"][0]["refusals"]
    assert got["errors"] == {"wave": "ValueError", "k": "ValueError",
                             "algorithm": "KeyError"}
    assert got["sent_after"] == got["sent_before"]
    assert got["clock"] == 2 and got["served_clock"] == 2
    for r in range(RANKS):
        assert world["ranks"][r]["refusals"]["entries"] == 3


def test_a_close_never_acknowledged_raises_on_rank_0(world):
    assert "did not acknowledge the close" in (
        world["ranks"][0]["late_close"]["error"] or "")
    for r in range(1, RANKS):
        assert world["ranks"][r]["late_close"]["error"] is None


def test_a_follower_that_diverges_fails(world):
    """Rank 1's stop and routes raise its divergence; rank 0's stop raises
    on the clocks; the other followers stop cleanly."""
    got = [world["ranks"][r]["divergence"] for r in range(RANKS)]
    assert "diverged" in (got[0]["stop"] or "")
    assert "rank 1 diverged" in (got[1]["stop"] or "")
    assert "diverged" in (got[1]["route"] or "")
    assert got[2]["stop"] is None and got[3]["stop"] is None


# ---------------------------------------------------------- the log alone

def test_log_entries_round_trip_their_bytes():
    """An entry's tensors come back bit for bit, bf16 and int64 among
    them, with the tree, the ids and the scalars around them."""
    from repro_torch.core.engine.session import SessionSnapshot
    from repro_torch.serving.oplog import decode, encode

    gen = torch.Generator().manual_seed(0)
    wave = {"w": torch.randn(3, 4, generator=gen).to(torch.bfloat16),
            "blocks": [torch.arange(6).reshape(2, 3), torch.ones(0, 2)],
            "scale": torch.tensor(2.5, dtype=torch.float64)}
    entry = {"kind": "ingest", "wave": wave,
             "sketches": np.arange(8, dtype=np.float32).reshape(2, 4),
             "client_ids": [np.int64(7), "a", (1, 2)], "clock": 12,
             "snap": SessionSnapshot(sketches=torch.zeros(1, 2),
                                     params=None, weights=None, count=1,
                                     clock=3)}
    body = encode(entry)
    assert body.dtype == torch.uint8 and body.ndim == 1
    got = decode(body.clone())
    assert got["kind"] == "ingest" and got["clock"] == 12
    assert got["client_ids"] == [7, "a", (1, 2)]
    for key in ("w", "scale"):
        assert got["wave"][key].dtype == wave[key].dtype
        assert torch.equal(got["wave"][key], wave[key])
    assert torch.equal(got["wave"]["blocks"][0], wave["blocks"][0])
    assert got["wave"]["blocks"][1].shape == (0, 2)
    assert torch.equal(got["sketches"], torch.from_numpy(entry["sketches"]))
    assert isinstance(got["snap"], SessionSnapshot)
    assert got["snap"].clock == 3

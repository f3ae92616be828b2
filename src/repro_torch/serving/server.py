"""RouteServer: an ``AggregationSession`` behind a thread-safe, batching
serving front end (the port of ``repro/serving/server.py``).

Concurrent callers submit route requests; a batcher thread coalesces
them into ONE batched ``route()`` per flush (one ``kmeans_assign``
launch); a finalize runs on a snapshot of the live rows on a worker
thread while ingest and routes go on, and is installed by one swap.

Locking model, three locks, never nested except as noted:

* ``_ingest_lock`` serializes ``ingest`` against ``snapshot``: every
  snapshot lands between wave commits at a definite session clock, so
  any interleaving of ingest, route and finalize serves a round equal to
  the sequential replay "the same keyed waves in clock order, finalize
  right after wave ``snapshot_clock``".
* ``_serve_lock`` serializes the batcher's ``session.route`` (and
  ``route_direct``) against ``install_round``.
* ``_finalize_lock`` admits ONE finalize or refinalize at a time (the
  warm-start cache is shared state); ``maybe_refinalize`` takes it
  without blocking.

Streams, on a CUDA session.  A round runs on the server's own
``torch.cuda.Stream`` (``_round_stream``), whichever thread computes it;
ingests and routes run on their threads' current streams, and every wait
of the session is local to the stream it waits for, so the round does
not serialize them.  The snapshot's copy is queued on the snapshotting
thread's stream and an event is recorded behind it: the round stream
waits for that event before it reads the copy, and every later ingest's
stream waits for it before it overwrites the buffers; the snapshotting
thread does not wait.  ``compute_round`` records the copy's use on the
round stream.  Under the serve lock the round stream is synchronized
before ``install_round``, so the first route that reads the new centers
finds them complete.  A served round's tensors are dropped only when no
route reads them: routes hold the serve lock and end with a host
transfer, which waits for their work.
The ``stream`` variant of ``kmeans_assign`` keeps its scratch per
(device, stream); the round stream is used by one thread at a time (the
finalize lock), and the batcher's flushes of at most 256 rows take the
``small`` variant, which has no scratch.

Under a client mesh (a session built with ``mesh=``) every rank opens a
server over its session.  Rank 0's is the controller, as the reference's
single controller is: callers ingest and run rounds through it alone,
and it applies each call first and then sends it, under the ingest lock,
to the other ranks' servers (``serving/oplog.py``): an ingest with its
wave, a round with its arguments right after its snapshot, and on
``stop`` a close.  The others follow from ``start`` to ``stop``: a thread
applies the entries in rank 0's order, snapshots where rank 0 did (at
rank 0's clock, checked) and runs each round on a worker thread on the
round stream, so it goes on taking entries while a round all-reduces
with rank 0's.  Their ``ingest`` and round calls raise.  Routes are
legal on every rank: the served centers are replicated.  A round's
arguments are checked on rank 0 before it is sent; an entry that fails
on a follower is a divergence, which that rank's ``stop`` (and every
later ``submit``) raises.  Rank 0's ``stop`` waits until every rank has
applied the close and checks that they agree on the clock.

Example, serving while uploading::

    from repro_torch.core.engine.session import AggregationSession
    from repro_torch.serving import RouteServer

    session = AggregationSession(capacity=4096, sketch_dim=64)
    session.ingest(sketches=first_wave)
    session.finalize(algorithm="kmeans-device", k=8)

    with RouteServer(session, max_batch=64, max_wait_ms=2.0) as srv:
        cid = srv.route(probe_sketch, timeout=1.0)
        srv.ingest(sketches=next_wave, client_ids=ids)
        srv.refinalize(background=True)          # ingest keeps going
"""
from __future__ import annotations

import contextlib
import threading
import time
from typing import Optional

import numpy as np
import torch

from repro_torch import obs
from repro_torch.core.federated import FederatedState
from repro_torch.device import resolve_device
from repro_torch.serving.batching import (
    BackpressureError,
    RequestQueue,
    RouteFuture,
    RouteTimeout,
    ServerClosed,
    ServingError,
    _Request,
)
from repro_torch.serving.oplog import OpLog, encode
from repro_torch.sharding.clients import client_axis_of
from repro_torch.utils import tree_map

__all__ = [
    "RouteServer",
    "RouteFuture",
    "BackpressureError",
    "RouteTimeout",
    "ServerClosed",
    "ServingError",
]


def flush_bucket(n: int, max_batch: int) -> int:
    """The row count a padded flush of ``n`` requests launches at: the
    next power of two, at most ``max_batch``."""
    bucket = 1
    while bucket < n:
        bucket *= 2
    return max(n, min(bucket, max_batch))


class RouteServer:
    """Concurrent serving front end over one ``AggregationSession``.

    Args:
      session: the session to serve (finalized or not: routes fail with
        the session's own ``ValueError`` until a round exists).  Its
        device is where the server runs; a CUDA session needs a GPU.
        Over a meshed session, rank 0's server is the controller and
        every other rank's follows it (see the module docstring).
      max_batch: largest number of requests fused into one route.
      max_wait_ms: micro-batching window past a flush's head request.
      queue_depth: bound of the request queue (backpressure when full).
      block_on_full: ``submit`` on a full queue blocks (default) or
        raises ``BackpressureError``.
      pad_buckets: pad each flush up to the next power of two (repeating
        the last probe), so routes launch at log2(max_batch) + 1 shapes.
    """

    def __init__(self, session, *, max_batch: int = 64,
                 max_wait_ms: float = 2.0, queue_depth: int = 256,
                 block_on_full: bool = True, pad_buckets: bool = True):
        if max_batch < 1:
            raise ValueError("max_batch must be >= 1")
        if max_wait_ms < 0:
            raise ValueError("max_wait_ms must be >= 0")
        self.device = resolve_device(getattr(session, "device", None))
        self.session = session
        self.max_batch = int(max_batch)
        self.max_wait_s = float(max_wait_ms) / 1e3
        self.block_on_full = bool(block_on_full)
        self.pad_buckets = bool(pad_buckets)
        self._queue = RequestQueue(queue_depth)
        self._ingest_lock = threading.Lock()
        self._serve_lock = threading.Lock()
        self._finalize_lock = threading.Lock()
        self._round_stream = (torch.cuda.Stream(self.device)
                              if self.device.type == "cuda" else None)
        # recorded behind the last snapshot's copy (CUDA sessions only)
        self._snapped: Optional[torch.cuda.Event] = None
        self._batcher: Optional[threading.Thread] = None
        self._closed = False
        # under a mesh: the ordered log, rank 0 sending, the others
        # following on a thread of their own
        mesh = getattr(session, "mesh", None)
        self._log = (None if mesh is None else OpLog(
            client_axis_of(mesh, session.client_axis)))
        self._follower = self._log is not None and self._log.axis.rank != 0
        self._log_closed = False
        self._following: Optional[threading.Thread] = None
        self._ended = threading.Event()     # a follower's close, or failure
        self._diverged: Optional[BaseException] = None

    # ---------------------------------------------------------- lifecycle

    def start(self) -> "RouteServer":
        """Start the batcher thread (idempotent)."""
        if self._closed:
            raise ServerClosed("server already stopped")
        if self._batcher is None:
            self._batcher = threading.Thread(
                target=self._batcher_loop, name="repro-route-batcher",
                daemon=True)
            self._batcher.start()
        if self._follower and self._following is None:
            self._following = threading.Thread(
                target=self._follow, name="repro-log-follower", daemon=True)
            self._following.start()
        return self

    def stop(self, *, drain: bool = True,
             timeout: Optional[float] = None) -> None:
        """Stop taking requests and shut the batcher down: ``drain=True``
        flushes the queued backlog first, ``drain=False`` fails it with
        ``ServerClosed``.  Waits for an in-flight background finalize;
        with ``timeout`` each wait raises ``ServingError`` after that many
        seconds instead of waiting on.  Under a mesh rank 0 then sends the
        close and waits for every rank to apply it; a follower waits for
        the close (and raises its divergence, if it had one)."""
        self._closed = True
        dropped = self._queue.stop(drop=not drain)
        for req in dropped:
            req.future.set_error(
                ServerClosed("server stopped before this request ran"))
        if self._batcher is not None:
            self._batcher.join(timeout)
            if self._batcher.is_alive():
                raise ServingError(f"the batcher did not stop within "
                                   f"{timeout}s")
            self._batcher = None
        if self._follower:
            self._await_close(timeout)
            return
        if not self._finalize_lock.acquire(
                timeout=-1 if timeout is None else timeout):
            raise ServingError(f"a finalize did not end within {timeout}s")
        try:
            if self._log is not None and not self._log_closed:
                with self._ingest_lock:
                    self._log_closed = True
                    self._close_log(timeout)
        finally:
            self._finalize_lock.release()

    def _close_log(self, timeout) -> None:
        """Rank 0: the close, and every rank's acknowledgement of it."""
        clock = self.session.clock
        try:
            lo, hi = self._log.close(encode({"kind": "close",
                                             "clock": clock}), clock, timeout)
        except (TimeoutError, RuntimeError) as exc:
            raise ServingError(f"a follower did not acknowledge the close "
                               f"within {timeout}s: {exc}") from exc
        if lo != hi:
            raise ServingError(f"the ranks ended at clocks {lo}..{hi}: a "
                               "follower diverged from rank 0's log")

    def _await_close(self, timeout) -> None:
        if self._following is None:
            raise ServingError("a follower follows rank 0's log from "
                               "start() to stop(): this one never started")
        if not self._ended.wait(timeout):
            raise ServingError(f"rank 0's close did not come within "
                               f"{timeout}s")
        if self._diverged is not None:
            raise ServingError(
                f"rank {self._log.axis.rank} diverged from rank 0's log: "
                f"{self._diverged!r}") from self._diverged

    def __enter__(self) -> "RouteServer":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop(drain=True)

    # ------------------------------------------------------------- routes

    def submit(self, sketch=None, *, params=None,
               timeout: Optional[float] = None) -> RouteFuture:
        """Enqueue one route request; returns its ``RouteFuture``.

        Pass a ``(sketch_dim,)`` sketch or one client's parameter tree
        (sketched with the session's projection).  ``timeout`` bounds the
        backpressure wait and the request's serving deadline."""
        if self._closed:
            raise ServerClosed("server already stopped")
        if self._diverged is not None:
            raise ServingError("this rank diverged from rank 0's log") \
                from self._diverged
        if (sketch is None) == (params is None):
            raise ValueError("pass exactly one of sketch or params=")
        if params is not None:
            wave = tree_map(lambda l: torch.as_tensor(l)[None], params)
            sketch = self.session.sketch_params(wave)[0]
        if isinstance(sketch, torch.Tensor):
            sketch = sketch.detach().cpu().numpy()
        sk = np.asarray(sketch, np.float32)
        if sk.shape != (self.session.sketch_dim,):
            raise ValueError(
                f"route sketch must be ({self.session.sketch_dim},), "
                f"got {sk.shape}")
        now = time.monotonic()
        future = RouteFuture()
        req = _Request(sk, future, now,
                       None if timeout is None else now + timeout)
        self._queue.put(req, block=self.block_on_full, timeout=timeout)
        obs.count("serving.requests")
        return future

    def route(self, sketch=None, *, params=None,
              timeout: Optional[float] = None) -> int:
        """Submit one request and wait for its cluster id."""
        return self.submit(sketch, params=params,
                           timeout=timeout).result(timeout)

    def route_direct(self, sketch):
        """Per-request baseline: one route for this caller alone,
        bypassing the queue and the batcher."""
        with self._serve_lock:
            return self.session.route(sketch)

    # ------------------------------------------------------------- ingest

    def _controls(self, what: str) -> None:
        if self._follower:
            raise ServingError(
                f"{what} goes through rank 0's server, the controller of "
                f"the mesh; rank {self._log.axis.rank}'s follows its log")

    def _open_log(self) -> None:
        """Under the ingest lock: the log takes no entry after the close."""
        if self._log_closed:
            raise ServerClosed("server already stopped: its log is closed")

    def ingest(self, wave=None, *, sketches=None, client_ids=None):
        """Thread-safe ingest; returns ``(rows_or_offset, clock)`` with
        ``clock`` the session clock right after this wave (the replay key
        of the serialized-equivalence contract)."""
        self._controls("ingest")
        if client_ids is not None:
            client_ids = list(client_ids)
        with self._ingest_lock:
            body = None
            if self._log is not None:
                self._open_log()
                if isinstance(wave, FederatedState):
                    wave = wave.params
                body = encode({"kind": "ingest", "wave": wave,
                               "sketches": sketches,
                               "client_ids": client_ids,
                               "clock": self.session.clock + 1})
            result = self._ingest_locked(wave, sketches, client_ids)
            if body is not None:
                self._log.send(body)
            return result, self.session.clock

    def _ingest_locked(self, wave, sketches, client_ids):
        if self._snapped is not None:
            # the last snapshot's copy reads the rows this may overwrite
            torch.cuda.current_stream(self.device).wait_event(self._snapped)
        return self.session.ingest(wave, sketches=sketches,
                                   client_ids=client_ids)

    # ----------------------------------------------------------- finalize

    def finalize(self, *, background: bool = False, **kwargs):
        """Snapshot and finalize: synchronous by default (returns the
        round tuple); ``background=True`` computes on a worker thread
        while ingest and routes go on and returns a ``RouteFuture``."""
        self._controls("finalize")
        return self._start_round(warm=False, kwargs=kwargs,
                                 background=background)

    def refinalize(self, *, background: bool = False):
        """Replay the last finalize configuration warm-started."""
        self._controls("refinalize")
        cfg = self.session.finalize_config
        if cfg is None:
            raise ValueError("refinalize() needs a prior finalize()")
        return self._start_round(warm=True, kwargs=cfg,
                                 background=background)

    def maybe_refinalize(self, threshold: float = 1.5, *,
                         background: bool = True):
        """Drift-triggered warm re-finalize; ``None`` when drift is at or
        below ``threshold``, unmeasured, or a finalize is in flight.
        Under a mesh rank 0's drift and lock decide."""
        self._controls("maybe_refinalize")
        d = self.session.drift
        if d is None or d <= threshold:
            return None
        cfg = self.session.finalize_config
        if cfg is None:
            return None
        obs.count("session.refinalize.triggered")
        return self._start_round(warm=True, kwargs=cfg,
                                 background=background, non_blocking=True)

    def _start_round(self, *, warm: bool, kwargs: dict, background: bool,
                     non_blocking: bool = False):
        if self._log is not None:
            # a bad algorithm or k raises here, before anything is sent
            self.session.resolve_round(**kwargs)
        if not self._finalize_lock.acquire(blocking=not non_blocking):
            return None
        try:
            with self._ingest_lock:
                if self._log is not None:
                    self._open_log()
                snap, copied = self._snapshot_locked()
                if self._log is not None:
                    self._log.send(encode({"kind": "round", "warm": warm,
                                           "kwargs": kwargs,
                                           "clock": snap.clock}))
        except BaseException:
            self._finalize_lock.release()
            raise
        if not background:
            try:
                return self._run_round(snap, copied, warm, kwargs)
            finally:
                self._finalize_lock.release()
        future = RouteFuture()
        worker = threading.Thread(
            target=self._round_worker,
            args=(snap, copied, warm, kwargs, future),
            name="repro-finalize-worker", daemon=True)
        worker.start()
        return future

    def _snapshot_locked(self):
        """Under the ingest lock: the snapshot, and on a CUDA session the
        event recorded behind its copy."""
        snap = self.session.snapshot()
        if self._round_stream is not None:
            self._snapped = torch.cuda.Event()
            self._snapped.record(torch.cuda.current_stream(self.device))
        return snap, self._snapped

    def _round_worker(self, snap, copied, warm, kwargs, future):
        try:
            future.set_result(self._run_round(snap, copied, warm, kwargs))
        except BaseException as exc:       # noqa: BLE001 (relayed)
            future.set_error(exc)
        finally:
            self._finalize_lock.release()

    def _on_round_stream(self):
        if self._round_stream is None:
            return contextlib.nullcontext()
        return torch.cuda.stream(self._round_stream)

    def _run_round(self, snap, copied, warm, kwargs):
        t0 = time.perf_counter()
        if copied is not None:
            self._round_stream.wait_event(copied)
        with self._on_round_stream():
            out, served = self.session.compute_round(snap, warm=warm,
                                                     **kwargs)
        with self._serve_lock:
            if self._round_stream is not None:
                self._round_stream.synchronize()
            self.session.install_round(out, served)
        name = ("serving.refinalize_under_load.ms" if warm
                else "serving.finalize_under_load.ms")
        obs.observe(name, (time.perf_counter() - t0) * 1e3)
        return out

    # ----------------------------------------------------------- follower

    def _follow(self) -> None:
        """A follower's thread: apply rank 0's entries in order until its
        close, then acknowledge it.  After a divergence the entries are
        taken and dropped, so that the close is still acknowledged (with
        clock -1, which rank 0's ``stop`` raises on)."""
        try:
            while True:
                entry = self._log.receive()
                if entry["kind"] == "close":
                    break
                if self._diverged is None:
                    try:
                        self._apply(entry)
                    except BaseException as exc:  # noqa: BLE001 (raised by stop)
                        self._diverge(exc)
            # the last round ends before the close is acknowledged
            with self._finalize_lock:
                pass
            if self._diverged is None:
                try:
                    self._check_clock("close", entry["clock"],
                                      self.session.clock)
                except ServingError as exc:
                    self._diverge(exc)
            self._log.acknowledge(-1 if self._diverged is not None
                                  else self.session.clock)
        except BaseException as exc:       # noqa: BLE001 (raised by stop)
            self._diverge(exc)
        finally:
            self._ended.set()

    def _apply(self, entry: dict) -> None:
        if entry["kind"] == "ingest":
            with self._ingest_lock:
                self._ingest_locked(entry["wave"], entry["sketches"],
                                    entry["client_ids"])
            self._check_clock("ingest", entry["clock"], self.session.clock)
        else:
            self._follow_round(entry)

    def _check_clock(self, what: str, want: int, got: int) -> None:
        if got != want:
            raise ServingError(f"{what} at clock {got}, rank 0's at {want}")

    def _follow_round(self, entry: dict) -> None:
        """Snapshot where rank 0 did, then compute on a worker thread (one
        round at a time, in log order) while the entries go on."""
        self._finalize_lock.acquire()
        try:
            if self._diverged is not None:     # the last round failed
                raise self._diverged
            with self._ingest_lock:
                snap, copied = self._snapshot_locked()
            self._check_clock("snapshot", entry["clock"], snap.clock)
        except BaseException:
            self._finalize_lock.release()
            raise
        threading.Thread(
            target=self._follower_round_worker,
            args=(snap, copied, entry["warm"], entry["kwargs"]),
            name="repro-finalize-worker", daemon=True).start()

    def _follower_round_worker(self, snap, copied, warm, kwargs):
        try:
            self._run_round(snap, copied, warm, kwargs)
        except BaseException as exc:       # noqa: BLE001 (raised by stop)
            self._diverge(exc)
        finally:
            self._finalize_lock.release()

    def _diverge(self, exc: BaseException) -> None:
        if self._diverged is None:
            self._diverged = exc
        self._ended.set()

    # ------------------------------------------------------------ batcher

    def _batcher_loop(self) -> None:
        while True:
            batch = self._queue.next_batch(self.max_batch, self.max_wait_s)
            if batch is None:
                return
            now = time.monotonic()
            live = []
            for req in batch:
                if req.deadline is not None and now > req.deadline:
                    obs.count("serving.timeouts")
                    req.future.set_error(RouteTimeout(
                        "request expired before a flush served it "
                        f"({(now - req.enqueued_at) * 1e3:.1f}ms queued)"))
                else:
                    live.append(req)
            if not live:
                continue
            pts = np.stack([r.sketch for r in live])
            n = len(live)
            if self.pad_buckets:
                bucket = flush_bucket(n, self.max_batch)
                if bucket > n:
                    pts = np.concatenate(
                        [pts, np.repeat(pts[-1:], bucket - n, axis=0)])
            try:
                with self._serve_lock:
                    served = self.session.served_round
                    labels = self.session.route(pts)
                    staleness = (None if served is None
                                 else self.session.clock - served.clock)
            except Exception as exc:       # e.g. "route() needs finalize()"
                obs.count("serving.flush_errors")
                for req in live:
                    req.future.set_error(exc)
                continue
            obs.observe("serving.flush_size", float(n))
            if staleness is not None:
                obs.observe("serving.staleness_at_serve", float(staleness))
            labels = np.atleast_1d(np.asarray(labels))
            done = time.monotonic()
            for req, label in zip(live, labels):
                obs.observe("serving.request.ms",
                            (done - req.enqueued_at) * 1e3)
                req.future.set_result(int(label))

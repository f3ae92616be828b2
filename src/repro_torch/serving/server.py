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

Under a client mesh (a session built with ``mesh=``) the server routes:
the served centers are replicated, so a route is one rank's own work and
sends no collective.  Ingest and rounds through the server are refused
there: each would need every rank inside the call (ROADMAP.md, queue A).

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
        return self

    def stop(self, *, drain: bool = True,
             timeout: Optional[float] = None) -> None:
        """Stop taking requests and shut the batcher down: ``drain=True``
        flushes the queued backlog first, ``drain=False`` fails it with
        ``ServerClosed``.  Waits for an in-flight background finalize;
        with ``timeout`` each of the two waits raises ``ServingError``
        after that many seconds instead of waiting on."""
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
        if not self._finalize_lock.acquire(
                timeout=-1 if timeout is None else timeout):
            raise ServingError(f"a finalize did not end within {timeout}s")
        self._finalize_lock.release()

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

    def _refuse_meshed(self, what: str) -> None:
        if self.session.mesh is not None:
            raise ValueError(
                f"{what} through a RouteServer over a client-sharded "
                "session is not ported: every rank would have to enter "
                "the call (ROADMAP.md, queue A); call the session's own "
                f"{what} on every rank, and route through the server")

    def ingest(self, wave=None, *, sketches=None, client_ids=None):
        """Thread-safe ingest; returns ``(rows_or_offset, clock)`` with
        ``clock`` the session clock right after this wave (the replay key
        of the serialized-equivalence contract)."""
        self._refuse_meshed("ingest")
        with self._ingest_lock:
            if self._snapped is not None:
                # the last snapshot's copy reads the rows this may overwrite
                torch.cuda.current_stream(self.device).wait_event(
                    self._snapped)
            result = self.session.ingest(wave, sketches=sketches,
                                         client_ids=client_ids)
            return result, self.session.clock

    # ----------------------------------------------------------- finalize

    def finalize(self, *, background: bool = False, **kwargs):
        """Snapshot and finalize: synchronous by default (returns the
        round tuple); ``background=True`` computes on a worker thread
        while ingest and routes go on and returns a ``RouteFuture``."""
        return self._start_round(warm=False, kwargs=kwargs,
                                 background=background)

    def refinalize(self, *, background: bool = False):
        """Replay the last finalize configuration warm-started."""
        cfg = self.session.finalize_config
        if cfg is None:
            raise ValueError("refinalize() needs a prior finalize()")
        return self._start_round(warm=True, kwargs=cfg,
                                 background=background)

    def maybe_refinalize(self, threshold: float = 1.5, *,
                         background: bool = True):
        """Drift-triggered warm re-finalize; ``None`` when drift is at or
        below ``threshold``, unmeasured, or a finalize is in flight."""
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
        self._refuse_meshed("refinalize" if warm else "finalize")
        if not self._finalize_lock.acquire(blocking=not non_blocking):
            return None
        try:
            with self._ingest_lock:
                snap = self.session.snapshot()
                if self._round_stream is not None:
                    self._snapped = torch.cuda.Event()
                    self._snapped.record(
                        torch.cuda.current_stream(self.device))
                copied = self._snapped
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

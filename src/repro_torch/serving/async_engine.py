"""Async serving front-end: one asyncio generator per request over the
stepwise ``Engine`` (torch counterpart of repro/serving/async_engine.py).

``AsyncEngine`` is the layer that turns the engine into a *service*: the
blocking ``Engine.step()`` loop runs on a dedicated background thread, and
each client coroutine consumes its own request through::

    aeng = AsyncEngine(engine, max_queued=32)
    async for out in aeng.generate(prompt, SamplingParams(max_tokens=32)):
        send(out.new_token_ids)          # RequestOutput, incremental

Three service behaviours the synchronous Engine cannot offer by itself:

* **Per-request streams under live arrival** — requests are submitted from
  any number of coroutines at any time; the worker thread keeps stepping
  whatever is active, and each committed ``RequestOutput`` is routed to its
  request's stream.  Tokens stay BIT-IDENTICAL to a solo ``Engine.run()``
  of the same (prompt, SamplingParams): the engine's per-request key
  streams and schedule-invariant commit rules guarantee that arrival
  interleaving changes only *when* work runs, never *what* it computes.
* **Cancellation → abort** — when a consumer's task is cancelled (or the
  generator is closed early, e.g. an HTTP client disconnects), the
  request's ``Engine.abort()`` runs on the worker thread and its pool
  pages return to the free list immediately, un-blocking queued admissions
  on the next step.
* **Backpressure** — a bounded admission gate: at most ``max_queued``
  requests may sit in the engine's QUEUED state.  Over-limit submits
  either await capacity (``wait=True``, the default) or fail fast with
  ``QueueFullError`` (``wait=False`` — the server maps this to HTTP 429).
  The permit releases when the request leaves QUEUED (admitted into a
  batch slot, or aborted while waiting), so the gate bounds *waiting*
  work, not concurrency.

Threading contract (single-writer): ``Engine.add_request`` touches only
host-side queues and is called from the event-loop thread; ``step()`` and
``abort()`` (which touch device pools and page tables) run exclusively on
the worker thread — aborts are routed to it as commands.  torch keeps the
current CUDA device and stream per thread, so the worker first makes the
engine's device current (``torch.cuda.set_device`` of the index the engine
resolved when it was built, ``engine.resolve_device``): every kernel launch
and every stream-keyed kernel scratch buffer lives on that one thread.
Outputs cross back via ``loop.call_soon_threadsafe``, so stream consumers
never see a torn update.
"""
from __future__ import annotations

import asyncio
import collections
import dataclasses
import threading
from typing import Any, AsyncIterator, Deque, Dict, List, Optional

import torch

from repro_torch.serving.api import RequestOutput, SamplingParams
from repro_torch.serving.engine import Engine
from repro_torch.serving.request import RequestState

__all__ = ["AsyncEngine", "QueueFullError"]


class QueueFullError(RuntimeError):
    """Raised by ``generate(wait=False)`` when the admission queue is at
    ``max_queued`` — the fail-fast half of the backpressure contract."""


_ABORTED = object()  # stream sentinel: request aborted, no final output
_CLOSED = object()  # stream sentinel: engine shut down


@dataclasses.dataclass
class _Stream:
    """Loop-side mailbox for one request's outputs."""

    queue: asyncio.Queue
    finished: bool = False


class AsyncEngine:
    """Async wrapper around ``Engine``: background step loop + per-request
    async iterators + bounded-admission backpressure.

    The wrapped engine must be used exclusively through this object once
    the worker starts.  Use as an async context manager (or call
    ``aclose()``) so the worker thread is joined deterministically::

        async with AsyncEngine(engine) as aeng:
            outs = [o async for o in aeng.generate(prompt, sp)]
    """

    def __init__(self, engine: Engine, *, max_queued: int = 16,
                 idle_poll_s: float = 0.02):
        if max_queued < 1:
            raise ValueError(f"max_queued must be >= 1, got {max_queued}")
        self.engine = engine
        self.max_queued = max_queued
        self._idle_poll_s = idle_poll_s
        self._loop: Optional[asyncio.AbstractEventLoop] = None
        self._thread: Optional[threading.Thread] = None
        self._stopping = False
        self._worker_error: Optional[BaseException] = None
        # loop-thread state
        self._streams: Dict[int, _Stream] = {}
        self._pending = 0  # submitted-but-not-yet-admitted (QUEUED) count
        self._waiters: Deque[asyncio.Future] = collections.deque()
        # worker-shared state (guarded by _lock)
        self._lock = threading.Lock()
        self._cmds: Deque[tuple] = collections.deque()
        self._awaiting_admission: set = set()
        self._wake = threading.Event()
        # published stats snapshot: built on whichever thread owns the
        # engine at the time (here, before the worker exists; afterwards
        # the worker republishes after each step) and swapped in with ONE
        # attribute assignment — atomic under the GIL, so stats() always
        # reads a complete, same-moment view
        self._snapshot: dict = engine.stats_snapshot()

    # -- lifecycle -----------------------------------------------------------

    def _ensure_started(self) -> None:
        if self._worker_error is not None:
            raise RuntimeError("AsyncEngine worker died") from self._worker_error
        if self._stopping:
            raise RuntimeError("AsyncEngine is closed")
        loop = asyncio.get_running_loop()
        if self._loop is None:
            self._loop = loop
            self._thread = threading.Thread(
                target=self._worker, name="async-engine-step", daemon=True
            )
            self._thread.start()
        elif self._loop is not loop:
            raise RuntimeError("AsyncEngine is bound to a different event loop")

    async def __aenter__(self) -> "AsyncEngine":
        self._ensure_started()
        return self

    async def __aexit__(self, *exc) -> None:
        await self.aclose()

    async def aclose(self) -> None:
        """Abort every open request, stop the worker, join the thread."""
        if self._thread is None:
            self._stopping = True
            return
        for rid, stream in list(self._streams.items()):
            if not stream.finished:
                self._enqueue_cmd(("abort", rid))
        self._stopping = True
        self._wake.set()
        await asyncio.get_running_loop().run_in_executor(
            None, self._thread.join
        )

    # -- backpressure gate ---------------------------------------------------

    async def _acquire_slot(self, wait: bool) -> None:
        if self._pending < self.max_queued and not self._waiters:
            self._pending += 1
            return
        if not wait:
            raise QueueFullError(
                f"admission queue full ({self._pending}/{self.max_queued} "
                "queued requests)"
            )
        fut = self._loop.create_future()
        self._waiters.append(fut)
        try:
            await fut  # resolved by _release_slot with the permit pre-taken
        except asyncio.CancelledError:
            # NB: cancelling the awaiting task also cancels `fut`, so
            # fut.done() alone cannot distinguish "granted" from
            # "cancelled while waiting" — only a RESULT means the permit
            # was handed over (and must be returned).
            if fut.cancelled() or not fut.done():
                try:
                    self._waiters.remove(fut)  # never granted: withdraw
                except ValueError:
                    pass
            else:  # granted concurrently with the cancel
                self._release_slot()
            raise

    def _release_slot(self) -> None:
        """Loop-thread: a request left QUEUED — hand its permit onward."""
        self._pending -= 1
        while self._waiters:
            fut = self._waiters.popleft()
            if not fut.done():
                self._pending += 1
                fut.set_result(None)
                return

    def queue_depth(self) -> int:
        """Requests currently holding an admission permit (QUEUED)."""
        return self._pending

    # -- submission / consumption --------------------------------------------

    async def generate(
        self,
        prompt: Any,
        sampling_params: Optional[SamplingParams] = None,
        *,
        wait: bool = True,
    ) -> AsyncIterator[RequestOutput]:
        """Submit a prompt and stream its ``RequestOutput``s as rounds
        commit tokens.  The final output has ``finished=True``; its
        cumulative ``token_ids`` are bit-identical to a synchronous
        ``Engine.run()`` of the same (prompt, SamplingParams).

        Backpressure: when ``max_queued`` requests are already waiting for
        admission, ``wait=True`` suspends until a permit frees while
        ``wait=False`` raises ``QueueFullError`` immediately.

        Cancelling the consuming task (or closing the generator early)
        aborts the request on the worker thread: its pool pages are freed
        immediately and the stream ends."""
        self._ensure_started()
        await self._acquire_slot(wait)
        # re-check AFTER the (possibly long) permit wait: aclose() may have
        # stopped the worker meanwhile, and a submit landing after its exit
        # would hang on a stream nothing will ever feed.  Everything from
        # here to the stream registration below is synchronous on the loop
        # thread, so aclose() cannot interleave — a later aclose() sees the
        # registered stream and aborts it.
        if self._stopping or self._worker_error is not None:
            self._release_slot()
            self._ensure_started()  # raises the closed/died error
        try:
            # loop-thread submit: add_request only touches host-side queues
            # (the worker's step() pops from the same thread-safe deque)
            rid = self.engine.add_request(prompt, sampling_params)
        except Exception:
            self._release_slot()
            raise
        stream = _Stream(queue=asyncio.Queue())
        self._streams[rid] = stream
        with self._lock:
            self._awaiting_admission.add(rid)
        self._wake.set()
        try:
            while True:
                item = await stream.queue.get()
                if item is _ABORTED or item is _CLOSED:
                    return
                if isinstance(item, BaseException):
                    raise item
                yield item
                if item.finished:
                    return
        finally:
            if not stream.finished:
                # consumer bailed (cancelled / early close / error): free
                # the request's pages right away
                stream.finished = True
                self._enqueue_cmd(("abort", rid))
            self._streams.pop(rid, None)
            # the stream is done either way: drop the engine-side Request
            # bookkeeping once the worker has retired it (a long-lived
            # server would otherwise accumulate every request ever served)
            self._enqueue_cmd(("release", rid))

    async def abort(self, request_id: int) -> None:
        """Abort a request by id (the disconnect path when the consumer
        cannot cancel the generator itself)."""
        self._ensure_started()
        self._enqueue_cmd(("abort", request_id))

    # -- stats ---------------------------------------------------------------

    def stats(self) -> dict:
        """JSON-safe service stats: queue/backpressure depth, slot and page
        residency, throughput counters, and the fused PAR telemetry when
        par_mode="wdos".

        Engine-side numbers come from ONE published snapshot
        (``Engine.stats_snapshot`` built on the worker thread after each
        step), so queue depth, active count, and pool residency describe
        the same moment — no separately-raced reads of a stepping engine.
        Only the loop-owned backpressure fields are added here."""
        out = dict(self._snapshot)
        out["pending_admission"] = self._pending
        out["max_queued"] = self.max_queued
        return out

    @property
    def metrics(self):
        """The engine's ``MetricsRegistry`` (what GET /metrics renders)."""
        return self.engine.metrics

    @property
    def tracer(self):
        """The engine's span tracer (NULL_TRACER unless one was passed)."""
        return self.engine.tracer

    def flight_snapshot(self, dump: bool = False) -> dict:
        """The engine's flight-recorder snapshot (GET /debug/flight).
        Safe to call from the loop thread while the worker steps: the
        recorder serializes reads against the worker's record() with its
        own lock, so the view is internally consistent."""
        return self.engine.flight_snapshot(dump=dump)

    # -- worker thread -------------------------------------------------------

    def _enqueue_cmd(self, cmd: tuple) -> None:
        with self._lock:
            self._cmds.append(cmd)
        self._wake.set()

    def _post(self, rid: int, item) -> None:
        """Loop-thread callback: route one item into its request's stream."""
        stream = self._streams.get(rid)
        if stream is None or stream.finished:
            return
        if item is _ABORTED or item is _CLOSED or isinstance(item, BaseException):
            stream.finished = True
        elif getattr(item, "finished", False):
            stream.finished = True
        stream.queue.put_nowait(item)

    def _worker(self) -> None:
        eng = self.engine
        loop = self._loop
        try:
            if eng.device.type == "cuda":
                torch.cuda.set_device(eng.device)
            while True:
                with self._lock:
                    cmds = list(self._cmds)
                    self._cmds.clear()
                self._wake.clear()
                releases: List[int] = []
                posts: List[tuple] = []
                for cmd in cmds:
                    if cmd[0] == "abort":
                        rid = cmd[1]
                        if eng.abort(rid):
                            posts.append((rid, _ABORTED))
                    elif cmd[0] == "release":
                        releases.append(cmd[1])
                has_work = eng.has_unfinished()
                if has_work:
                    for out in eng.step():
                        posts.append((out.request_id, out))
                # always: an abort can release a QUEUED request's permit
                # even when no step ran
                self._check_admissions()
                # releases LAST: the permit bookkeeping above must still
                # see the Request before its record drops
                for rid in releases:
                    eng.release_request(rid)
                if has_work or cmds:
                    # republish the stats snapshot: single attribute
                    # assignment (atomic under the GIL), so a concurrent
                    # stats() sees either the old or the new complete view.
                    # Published BEFORE the outputs below so that by the
                    # time a consumer observes its stream finish/abort,
                    # stats() already reflects that state (freed pages,
                    # decremented active count)
                    self._snapshot = eng.stats_snapshot()
                for rid, item in posts:
                    loop.call_soon_threadsafe(self._post, rid, item)
                if not has_work:
                    if self._stopping:
                        break
                    # idle: sleep until a submit/abort/stop wakes us
                    self._wake.wait(timeout=self._idle_poll_s)
            loop.call_soon_threadsafe(self._close_streams)
        except BaseException as e:  # engine bug: fail every open stream
            self._worker_error = e
            loop.call_soon_threadsafe(self._close_streams, e)

    def _check_admissions(self) -> None:
        """Worker: release backpressure permits for requests that left
        QUEUED this step (admitted to a slot, or aborted while waiting)."""
        with self._lock:
            awaiting = list(self._awaiting_admission)
        released: List[int] = []
        for rid in awaiting:
            req = self.engine._requests.get(rid)
            # a missing record means the request already finished AND was
            # released — its permit must come back too
            if req is None or req.state is not RequestState.QUEUED:
                released.append(rid)
        if released:
            with self._lock:
                self._awaiting_admission.difference_update(released)
            for _ in released:
                self._loop.call_soon_threadsafe(self._release_slot)

    def _close_streams(self, error: Optional[BaseException] = None) -> None:
        for rid, stream in list(self._streams.items()):
            if not stream.finished:
                self._post(rid, error if error is not None else _CLOSED)

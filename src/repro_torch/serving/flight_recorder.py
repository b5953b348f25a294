"""Engine flight recorder: a bounded ring of per-round records with
anomaly triggers and JSON postmortems (a copy of
repro/serving/flight_recorder.py, which imports no JAX either).

The metrics registry and the tracer answer "what is the engine doing *now*"
(gauges) and "what has it done *in total*" (counters).  What it cannot
answer is "what happened in the thirty rounds *before* things went
wrong" — the question every production incident starts with.  This
module keeps that answer resident: every engine round appends one small
host-side record (plan shape, acceptance deltas, pool/queue gauges,
round wall) to a ``deque(maxlen=capacity)``, and four anomaly detectors
watch the stream:

* ``slow_round`` — the round wall exceeded ``slow_factor`` x the rolling
  median of the ring (armed only after ``warmup`` rounds so compile
  stalls don't trip it);
* ``acceptance_collapse`` — the windowed accept rate over the last
  ``accept_window`` drafting rounds fell below ``accept_floor`` (the
  draft model has stopped predicting the target — speculation is now
  pure overhead);
* ``pool_exhausted`` — requests are queued while either KV pool has zero
  free pages (admission is blocked on capacity, not policy);
* ``admission_stall`` — ``stall_rounds`` consecutive rounds saw queued
  work but zero admissions (head-of-line livelock: the queue head's
  worst case never fits).

Each detector fires ONCE per episode (on the False→True transition;
re-arms when the condition clears), increments ``anomalies_total{kind}``
in the shared registry, and captures a postmortem: the full ring, the
triggering record, and the tail of the tracer's event buffer.  Postmortems
stay in a small in-memory deque (served at ``GET /debug/flight``) and are
additionally written to ``dump_dir`` as JSON files when one is configured.

Cost model: recording is O(1) appends of a ~15-key dict per round plus
one ``statistics.median`` over at most ``capacity`` floats — no device
syncs, no tracing requirement, and it never touches sampling math, so
tokens stay bit-identical with the recorder on (the same contract as the
tracer's; tests/test_torch_observability.py).  All public methods take an
internal lock, so the server thread may snapshot while the engine thread
records.
"""
from __future__ import annotations

import json
import os
import statistics
import threading
from collections import deque
from typing import Deque, Dict, List, Optional

__all__ = ["FlightRecorder", "ANOMALY_KINDS"]

ANOMALY_KINDS = (
    "slow_round",
    "acceptance_collapse",
    "pool_exhausted",
    "admission_stall",
)


class FlightRecorder:
    """Bounded per-round ring buffer + anomaly triggers + postmortems.

    ``record()`` is called by the engine once per round (including empty
    rounds — pool exhaustion *manifests* as empty rounds); ``snapshot()``
    and ``dump()`` may be called from any thread."""

    def __init__(
        self,
        capacity: int = 256,
        *,
        metrics=None,  # Optional[MetricsRegistry]
        tracer=None,  # Optional[Tracer] — tail of its events in postmortems
        dump_dir: Optional[str] = None,
        slow_factor: float = 4.0,
        warmup: int = 16,
        accept_floor: float = 0.1,
        accept_window: int = 8,
        stall_rounds: int = 16,
        trace_tail: int = 64,
        max_postmortems: int = 4,
    ):
        self.enabled = capacity > 0
        self.capacity = capacity
        self.tracer = tracer
        self.dump_dir = dump_dir
        self.slow_factor = slow_factor
        self.warmup = warmup
        self.accept_floor = accept_floor
        self.accept_window = accept_window
        self.stall_rounds = stall_rounds
        self.trace_tail = trace_tail
        self._lock = threading.Lock()
        self._ring: Deque[dict] = deque(maxlen=max(capacity, 1))
        self._postmortems: Deque[dict] = deque(maxlen=max_postmortems)
        self._rounds = 0
        self._stall_run = 0  # consecutive queued-but-nothing-admitted rounds
        self._active: set = set()  # anomaly kinds currently in-episode
        self._counts: Dict[str, int] = {k: 0 for k in ANOMALY_KINDS}
        self._m_anomalies = None
        if metrics is not None:
            self._m_anomalies = metrics.counter(
                "anomalies_total",
                "Flight-recorder anomaly episodes, by trigger kind",
                ("kind",),
            )
            for kind in ANOMALY_KINDS:  # materialize all series at 0
                self._m_anomalies.labels(kind=kind).inc(0)

    # -- recording -----------------------------------------------------------

    def record(self, rec: dict) -> List[str]:
        """Append one round record; detect anomalies against the PRIOR
        ring state; return the kinds that fired this round (empty for a
        healthy round).  ``rec`` must carry: ``wall_s``, ``drafted``,
        ``accepted``, ``admitted`` (all per-round deltas), ``queued``,
        ``active``, and ``free_pages`` ({"target": n, "draft": n})."""
        if not self.enabled:
            return []
        with self._lock:
            fired = self._detect(rec)
            rec = dict(rec)
            rec["seq"] = self._rounds
            if fired:
                rec["anomalies"] = fired
            self._ring.append(rec)
            self._rounds += 1
            for kind in fired:
                self._counts[kind] += 1
                self._postmortems.append(self._postmortem(kind, rec))
        # metrics/disk outside the lock: counter families have their own
        # lock, and a slow disk write must not block a /debug/flight read
        for kind in fired:
            if self._m_anomalies is not None:
                self._m_anomalies.labels(kind=kind).inc()
            if self.dump_dir:
                self._write_dump(kind, rec)
        return fired

    def _detect(self, rec: dict) -> List[str]:
        """Evaluate all triggers vs the ring as it stood BEFORE this
        record; episode semantics — a kind fires only on its False→True
        transition and re-arms when its condition clears."""
        now: Dict[str, bool] = {}

        walls = [r["wall_s"] for r in self._ring if r.get("wall_s", 0) > 0]
        now["slow_round"] = bool(
            len(walls) >= self.warmup
            and rec.get("wall_s", 0.0)
            > self.slow_factor * statistics.median(walls)
        )

        recent = list(self._ring)[-(self.accept_window - 1):] + [rec]
        drafted = sum(r.get("drafted", 0) for r in recent)
        accepted = sum(r.get("accepted", 0) for r in recent)
        now["acceptance_collapse"] = bool(
            self._rounds + 1 >= self.warmup
            and drafted > 0
            and len(recent) >= self.accept_window
            and accepted / drafted < self.accept_floor
        )

        free = rec.get("free_pages", {})
        now["pool_exhausted"] = bool(
            rec.get("queued", 0) > 0
            and (free.get("target", 1) == 0 or free.get("draft", 1) == 0)
        )

        if rec.get("queued", 0) > 0 and rec.get("admitted", 0) == 0:
            self._stall_run += 1
        else:
            self._stall_run = 0
        now["admission_stall"] = self._stall_run >= self.stall_rounds

        fired = []
        for kind in ANOMALY_KINDS:
            if now[kind] and kind not in self._active:
                fired.append(kind)
        # re-arm cleared kinds; keep in-episode kinds latched
        self._active = {k for k in ANOMALY_KINDS if now[k]}
        return fired

    # -- postmortems ---------------------------------------------------------

    def _postmortem(self, kind: str, rec: dict) -> dict:
        tail: List[dict] = []
        if self.tracer is not None and getattr(self.tracer, "enabled", False):
            tail = self.tracer.events()[-self.trace_tail:]
        return {
            "kind": kind,
            "fired_at_round": rec["seq"],
            "record": rec,
            "ring": list(self._ring),
            "trace_tail": tail,
        }

    def _write_dump(self, kind: str, rec: dict) -> None:
        try:
            os.makedirs(self.dump_dir, exist_ok=True)
            path = os.path.join(
                self.dump_dir, f"flight_{kind}_r{rec['seq']}.json"
            )
            with self._lock:
                pm = next(
                    (p for p in reversed(self._postmortems)
                     if p["kind"] == kind), None
                )
            with open(path, "w") as f:
                json.dump(pm, f)
        except OSError:
            pass  # a full disk must never take the engine down

    # -- read side -----------------------------------------------------------

    def snapshot(self) -> dict:
        """JSON-safe view: config, anomaly counts, the ring, and retained
        postmortems.  What ``GET /debug/flight`` serves."""
        with self._lock:
            return {
                "enabled": self.enabled,
                "capacity": self.capacity,
                "rounds_recorded": self._rounds,
                "anomalies": dict(self._counts),
                "active_episodes": sorted(self._active),
                "ring": list(self._ring),
                "postmortems": list(self._postmortems),
            }

    def dump(self, path: Optional[str] = None, reason: str = "manual") -> dict:
        """On-demand postmortem (``GET /debug/flight?dump=1`` or an
        operator signal): snapshot + trace tail, optionally written to
        ``path`` (or an auto-named file in ``dump_dir``)."""
        snap = self.snapshot()
        snap["reason"] = reason
        if self.tracer is not None and getattr(self.tracer, "enabled", False):
            snap["trace_tail"] = self.tracer.events()[-self.trace_tail:]
        if path is None and self.dump_dir:
            path = os.path.join(
                self.dump_dir, f"flight_{reason}_r{snap['rounds_recorded']}.json"
            )
        if path:
            try:
                os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
                with open(path, "w") as f:
                    json.dump(snap, f)
                snap["dumped_to"] = path
            except OSError:
                pass
        return snap

"""Span tracer: per-request timelines exportable as Chrome-trace JSON
(loadable in Perfetto / ``chrome://tracing``) and as structured JSONL
(a copy of repro/serving/tracing.py, which imports no JAX either).

The point of tracing here is to make the WDOS schedule *visible*: with
``par_mode="wdos"`` different requests draft and verify out of phase
inside shared fused dispatches, and the only honest way to check (or
debug) that staggering is a timeline with one track per batch row.  The
engine emits spans at dispatch boundaries only — the tracer never
synchronizes the device and never touches device values, so it cannot add
host syncs to the decode loop or perturb bit-identity (the parity suites
run unchanged with tracing enabled; tests/test_torch_observability.py).

Span hierarchy the engine emits (docs/OBSERVABILITY.md draws it):

    engine track:   step#k [par_mode] > draft_phase / verify_phase (off)
                                      > fused_slot (wdos)
    row<i> track:   admit > prefill > {draft | verify}* > commit > finish
    http track:     request / disconnect / completion instants (server)

Every span/instant carries the request id in ``args`` where one applies,
so a request's life is greppable across tracks — and the same events
stream to a JSONL file (one JSON object per line) when the tracer is
built with ``jsonl_path=...``, which is the machine-tailable log a
serving deployment wants.

Off by default: the engine holds ``NULL_TRACER`` unless one is passed
(``Engine(..., trace=Tracer())``), and every ``NULL_TRACER`` method is a
constant-time no-op — the disabled fast path is one attribute check per
instrumentation site.

Export: ``to_chrome_trace()`` returns the Chrome Trace Event JSON dict
(``{"traceEvents": [...]}``, complete/``"X"`` events with microsecond
timestamps plus ``thread_name`` metadata per track); ``export(path)``
writes it.  Load it in https://ui.perfetto.dev or ``chrome://tracing``.
"""
from __future__ import annotations

import json
import threading
import time
from contextlib import contextmanager
from typing import Dict, List, Optional, Tuple

__all__ = ["Tracer", "NullTracer", "NULL_TRACER", "validate_chrome_trace"]


class Tracer:
    """Collects spans/instants on named tracks; thread-safe.

    Timestamps are seconds relative to tracer construction (one shared
    ``time.perf_counter`` origin), converted to integer microseconds at
    export.  ``rec()`` takes explicit boundaries so callers can reuse a
    wall-clock reading they already took for telemetry — zero extra clock
    reads on instrumented paths that already time themselves."""

    enabled = True

    def __init__(self, jsonl_path: Optional[str] = None):
        self._t0 = time.perf_counter()
        self._lock = threading.Lock()
        self._events: List[dict] = []
        self._jsonl = open(jsonl_path, "w") if jsonl_path else None

    # -- clock ----------------------------------------------------------------

    def now(self) -> float:
        """Seconds since tracer start (the span timebase)."""
        return time.perf_counter() - self._t0

    # -- recording ------------------------------------------------------------

    def _emit(self, ev: dict) -> None:
        with self._lock:
            self._events.append(ev)
            if self._jsonl is not None:
                self._jsonl.write(json.dumps(ev) + "\n")

    def rec(self, track: str, name: str, t0: float, t1: float,
            cat: str = "", **args) -> None:
        """One complete span [t0, t1] (tracer-relative seconds) on `track`."""
        self._emit({
            "ph": "X", "track": track, "name": name, "cat": cat,
            "ts": t0, "dur": max(t1 - t0, 0.0), "args": args,
        })

    def instant(self, track: str, name: str, cat: str = "", **args) -> None:
        self._emit({
            "ph": "i", "track": track, "name": name, "cat": cat,
            "ts": self.now(), "args": args,
        })

    @contextmanager
    def span(self, track: str, name: str, cat: str = "", **args):
        t0 = self.now()
        try:
            yield
        finally:
            self.rec(track, name, t0, self.now(), cat, **args)

    # -- export ---------------------------------------------------------------

    def events(self) -> List[dict]:
        with self._lock:
            return list(self._events)

    def to_chrome_trace(self) -> dict:
        """Chrome Trace Event format: one pid, one tid per track (in
        first-seen order), ``thread_name`` metadata so Perfetto labels the
        tracks, microsecond integer timestamps."""
        tids: Dict[str, int] = {}
        out: List[dict] = []
        for ev in self.events():
            track = ev["track"]
            tid = tids.get(track)
            if tid is None:
                tid = tids[track] = len(tids)
                out.append({
                    "ph": "M", "name": "thread_name", "pid": 0, "tid": tid,
                    "args": {"name": track},
                })
            ce = {
                "ph": ev["ph"], "name": ev["name"], "cat": ev["cat"] or "serving",
                "pid": 0, "tid": tid, "ts": round(ev["ts"] * 1e6),
                "args": ev["args"],
            }
            if ev["ph"] == "X":
                ce["dur"] = max(round(ev["dur"] * 1e6), 1)
            else:
                ce["s"] = "t"  # thread-scoped instant
            out.append(ce)
        return {"traceEvents": out, "displayTimeUnit": "ms"}

    def export(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(self.to_chrome_trace(), f)

    def close(self) -> None:
        with self._lock:
            if self._jsonl is not None:
                self._jsonl.close()
                self._jsonl = None


class NullTracer(Tracer):
    """The disabled fast path: every method is a constant-time no-op.
    Shared as ``NULL_TRACER`` — the engine's default when no tracer is
    passed, so instrumentation sites need no ``if`` guards."""

    enabled = False

    def __init__(self):  # no clock read, no lock, no buffers
        pass

    def now(self) -> float:
        return 0.0

    def rec(self, *a, **kw) -> None:
        pass

    def instant(self, *a, **kw) -> None:
        pass

    @contextmanager
    def span(self, *a, **kw):
        yield

    def events(self) -> List[dict]:
        return []

    def to_chrome_trace(self) -> dict:
        return {"traceEvents": [], "displayTimeUnit": "ms"}

    def export(self, path: str) -> None:
        raise RuntimeError("cannot export a NullTracer (tracing is off)")

    def close(self) -> None:
        pass


NULL_TRACER = NullTracer()


def validate_chrome_trace(obj: dict) -> List[str]:
    """Schema check for an exported trace: returns a list of problems
    (empty = valid).  Used by the trace-export tests and the CI smoke so a
    regression can never silently produce a file Perfetto rejects.

    Beyond the per-event field checks, two track-level rules:

    * every non-metadata event's tid must be introduced by a
      ``thread_name`` metadata event (Perfetto renders unnamed tids as
      anonymous tracks — always a tracer bug here, since ``Tracer``
      emits the M record at first use of a track);
    * spans on a ``device*`` track must not overlap: the device executes
      one bracketed dispatch at a time (a device synchronization
      on both sides of each program), so overlap means broken attribution.  Host tracks nest
      spans (step ⊃ phase) and are exempt.  A 1 µs slack absorbs the
      microsecond rounding + min-duration clamp of ``to_chrome_trace``.
    """
    problems: List[str] = []
    if not isinstance(obj, dict) or "traceEvents" not in obj:
        return ["top level must be a dict with 'traceEvents'"]
    events = obj["traceEvents"]
    if not isinstance(events, list):
        return ["'traceEvents' must be a list"]
    track_by_tid: Dict[int, str] = {}
    device_spans: Dict[int, List[Tuple[float, float, int]]] = {}
    for i, ev in enumerate(events):
        if not isinstance(ev, dict):
            problems.append(f"event {i}: not a dict")
            continue
        ph = ev.get("ph")
        if ph not in ("X", "i", "M", "B", "E"):
            problems.append(f"event {i}: bad ph {ph!r}")
            continue
        for key in ("name", "pid", "tid"):
            if key not in ev:
                problems.append(f"event {i}: missing {key!r}")
        if ph == "M":
            if ev.get("name") == "thread_name":
                track = (ev.get("args") or {}).get("name")
                if isinstance(track, str) and "tid" in ev:
                    track_by_tid[ev["tid"]] = track
            continue
        tid = ev.get("tid")
        if tid is not None and tid not in track_by_tid:
            problems.append(
                f"event {i}: tid {tid} has no thread_name metadata"
            )
        ts = ev.get("ts")
        if not isinstance(ts, (int, float)) or ts < 0:
            problems.append(f"event {i}: bad ts {ts!r}")
            continue
        dur = ev.get("dur")
        if ph == "X" and not isinstance(dur, (int, float)):
            problems.append(f"event {i}: complete event missing dur")
        elif ph == "X" and str(track_by_tid.get(tid, "")).startswith("device"):
            device_spans.setdefault(tid, []).append((ts, ts + dur, i))
    for tid, spans in device_spans.items():
        spans.sort()
        for (_, prev_end, prev_i), (ts, _, i) in zip(spans, spans[1:]):
            if prev_end > ts + 1:  # 1 us slack for rounding/min-dur clamp
                problems.append(
                    f"device track tid {tid}: span at event {prev_i} "
                    f"overlaps span at event {i} "
                    f"(end {prev_end} > start {ts})"
                )
    return problems

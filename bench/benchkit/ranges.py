"""The program's own ranges in a traced segment's profiler trace, and the
device operations each launched.

While a torch profiler records, the engine opens ``record_function``
ranges at its boundaries under fixed names (``repro_torch.serving.tracing``):
``engine.prefill.target`` / ``engine.prefill.draft`` (one request's
prefill into one pool), ``host.copy.verify`` / ``host.copy.draft`` (a
device-to-host copy), ``host.accept`` and ``host.tables``.  A zero-length
range named ``args.<range> k=v ...`` just inside a range carries its
numbers (a prefill's ``rows`` and ``rid``).

A device operation (kernel, copy, set) belongs to the range in which the
runtime call that launched it sits: the trace's ``correlation`` ids join
the two.  Only ranges that start inside ``bench.window`` count.  A
program that opens no such ranges leaves every list here empty.
"""
from __future__ import annotations

import bisect
import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

from benchkit.trace import DEVICE_CATS, LAUNCH_APIS, _union

PREFILLS = ("engine.prefill.target", "engine.prefill.draft")
COPY_VERIFY = "host.copy.verify"
ARGS_PREFIX = "args."
RUNTIME_CATS = ("cuda_runtime", "cuda_driver")


@dataclasses.dataclass
class Range:
    name: str
    t0: float  # us, the trace's clock
    t1: float
    args: Dict[str, int] = dataclasses.field(default_factory=dict)
    launches: int = 0
    ops: List[Tuple[float, float, str]] = dataclasses.field(default_factory=list)  # (ts, end, cat)

    @property
    def end(self) -> float:
        """The later of the range's end and the end of the last device
        operation it launched."""
        return max([self.t1] + [b for _, b, _ in self.ops])


def parse_args(name: str) -> Tuple[str, Dict[str, int]]:
    """``args.<range> k=v ...`` -> (range, {k: v})."""
    head, *pairs = name[len(ARGS_PREFIX):].split(" ")
    out = {}
    for p in pairs:
        k, _, v = p.partition("=")
        out[k] = int(v)
    return head, out


def _window(events: Sequence[dict]) -> Tuple[float, float]:
    for e in events:
        if e.get("name") == "bench.window" and e.get("cat") == "user_annotation":
            return float(e["ts"]), float(e["ts"]) + float(e["dur"])
    raise RuntimeError("the trace has no bench.window span")


def find(trace: dict, names: Sequence[str]) -> List[Range]:
    """The ranges named ``names`` that start inside ``bench.window``, in
    order, each with its arguments, launch calls and device operations.
    Ranges of these names must not overlap one another."""
    events = [e for e in trace.get("traceEvents", []) if e.get("ph") == "X"]
    w0, w1 = _window(events)
    rs = sorted((Range(e["name"], float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0.0)))
                 for e in events if e.get("cat") == "user_annotation" and e.get("name") in names
                 and w0 <= float(e["ts"]) <= w1), key=lambda r: r.t0)
    if not rs:
        return []
    starts = [r.t0 for r in rs]

    def at(t: float, name: Optional[str] = None) -> Optional[Range]:
        i = bisect.bisect_right(starts, t) - 1
        if i >= 0 and t <= rs[i].t1 and name in (None, rs[i].name):
            return rs[i]
        return None

    launched: Dict[int, Range] = {}
    for e in events:
        cat, name = e.get("cat", ""), e.get("name", "")
        if cat == "user_annotation" and name.startswith(ARGS_PREFIX):
            head, args = parse_args(name)
            r = at(float(e["ts"]), head)
            if r is not None:
                r.args.update(args)
        elif cat in RUNTIME_CATS:
            r = at(float(e["ts"]))
            if r is None:
                continue
            if name in LAUNCH_APIS:
                r.launches += 1
            corr = (e.get("args") or {}).get("correlation")
            if corr is not None:
                launched[corr] = r
    for e in events:
        if e.get("cat") in DEVICE_CATS:
            r = launched.get((e.get("args") or {}).get("correlation"))
            if r is not None:
                ts = float(e["ts"])
                r.ops.append((ts, ts + float(e.get("dur", 0.0)), e["cat"]))
    return rs


def busy_us(rs: Sequence[Range]) -> float:
    """The union of the device operations the ranges launched."""
    return _union([(a, b) for r in rs for a, b, _ in r.ops])


def has_device_records(trace: dict) -> bool:
    """Whether the trace holds runtime calls (a trace of a CUDA run)."""
    return any(e.get("cat") in RUNTIME_CATS for e in trace.get("traceEvents", []))


def prefill_rows(rs: Sequence[Range]) -> int:
    """The prompt rows of the target's prefill ranges."""
    return sum(r.args.get("rows", 0) for r in rs if r.name == PREFILLS[0])


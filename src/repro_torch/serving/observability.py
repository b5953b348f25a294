"""Zero-dependency metrics registry: counters, gauges, histograms, and a
Prometheus-text exposition — the single source of truth for every number
the serving stack reports.

The paper's headline claims are all *rates* (14.08–135.69 token/s,
4.46–7.17x over vanilla SD, acceptance-driven adaptive windows), so the
serving stack needs one instrumentation layer that the engine, the async
front-end, the HTTP server, and the benchmarks all read from — instead of
the ad-hoc per-module dicts they used to carry.  ``MetricsRegistry`` is
that layer:

* **Counter** — monotone accumulator (``inc`` rejects negative deltas);
* **Gauge** — last-write-wins level (queue depth, pool residency);
* **Histogram** — fixed cumulative buckets + sum/count (TTFT, ITL,
  round wall time, per-round acceptance fraction).  Buckets are fixed at
  registration so ``observe`` is O(buckets) with no allocation.

Families are label-aware (``family.labels(pool="target")``) with children
created on first use; re-registering a name returns the existing family
(idempotent) and raises on a type mismatch.  All mutation goes through one
registry lock — the engine worker thread observes while the HTTP loop
thread scrapes, and increments are read-modify-write, so lock-free "+="
would lose updates.  The instrumented paths run at *round* granularity
(not per token, never inside a traced computation), so the lock is never
contended on the hot path.

Off-by-default-cheap: a registry built with ``enabled=False`` hands every
caller a shared no-op child — ``inc``/``set``/``observe`` return
immediately, values stay zero, and ``render()`` emits only headers.  The
Engine's default registry is enabled (the cost is a handful of guarded
float adds per round); the *tracer* (serving/tracing.py), which allocates
per event, is the component that defaults off.

Exposition: ``registry.render()`` returns the Prometheus text format
(``text/plain; version=0.0.4``) the server's ``GET /metrics`` serves;
``registry.snapshot()`` returns the same data JSON-safe for benchmark
files.  Nothing here imports jax — the module is pure host bookkeeping
and can never perturb bit-identity.
"""
from __future__ import annotations

import math
import threading
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

__all__ = [
    "Counter",
    "Gauge",
    "Histogram",
    "MetricsRegistry",
    "LATENCY_BUCKETS",
    "RATIO_BUCKETS",
]

# Default buckets for second-valued latencies (TTFT / ITL / round wall):
# sub-ms through tens of seconds, the span CPU smoke and real TPU serving
# both land in.
LATENCY_BUCKETS: Tuple[float, ...] = (
    0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1,
    0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0,
)
# Buckets for [0, 1]-valued fractions (per-round acceptance rate).
RATIO_BUCKETS: Tuple[float, ...] = (
    0.0, 0.125, 0.25, 0.375, 0.5, 0.625, 0.75, 0.875, 1.0,
)


def _fmt(v: float) -> str:
    """Prometheus sample value: integers render bare, floats via repr."""
    if v == math.inf:
        return "+Inf"
    if float(v).is_integer() and abs(v) < 1e15:
        return str(int(v))
    return repr(float(v))


def _escape(v: str) -> str:
    return v.replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")


def _label_str(names: Sequence[str], values: Sequence[str]) -> str:
    if not names:
        return ""
    inner = ",".join(
        f'{n}="{_escape(str(v))}"' for n, v in zip(names, values)
    )
    return "{" + inner + "}"


class _Child:
    """One labeled series.  Mutators must run under the registry lock
    (the family wrappers take it); reads of a single float are atomic."""

    __slots__ = ("value",)

    def __init__(self):
        self.value = 0.0


class _HistChild:
    __slots__ = ("counts", "sum", "count")

    def __init__(self, n_buckets: int):
        self.counts = [0] * n_buckets  # cumulative at render time, raw here
        self.sum = 0.0
        self.count = 0


class _NoopChild:
    """Shared sink for disabled registries: every mutator is a no-op."""

    __slots__ = ()
    value = 0.0
    sum = 0.0
    count = 0

    def inc(self, v: float = 1.0) -> None:
        pass

    def dec(self, v: float = 1.0) -> None:
        pass

    def set(self, v: float) -> None:
        pass

    def observe(self, v: float) -> None:
        pass


_NOOP = _NoopChild()


class _Family:
    """Base: a named metric with optional labels and per-label children."""

    kind = "untyped"

    def __init__(self, registry: "MetricsRegistry", name: str, help: str,
                 labelnames: Sequence[str]):
        self._registry = registry
        self.name = name
        self.help = help
        self.labelnames = tuple(labelnames)
        self._children: Dict[Tuple[str, ...], object] = {}

    def _new_child(self):
        raise NotImplementedError

    def labels(self, **kv):
        """The child series for this label assignment (created on first
        use).  A label-less family IS its own single child."""
        if self._registry.enabled is False:
            return _NOOP
        if set(kv) != set(self.labelnames):
            raise ValueError(
                f"{self.name}: expected labels {self.labelnames}, got "
                f"{tuple(kv)}"
            )
        key = tuple(str(kv[n]) for n in self.labelnames)
        with self._registry._lock:
            child = self._children.get(key)
            if child is None:
                child = self._new_child()
                self._children[key] = child
        return _Bound(self._registry, child)

    def _default(self):
        if self.labelnames:
            raise ValueError(
                f"{self.name} has labels {self.labelnames}; use .labels()"
            )
        return self.labels()

    # -- convenience for label-less families --------------------------------

    def inc(self, v: float = 1.0) -> None:
        self._default().inc(v)

    def dec(self, v: float = 1.0) -> None:
        self._default().dec(v)

    def set(self, v: float) -> None:
        self._default().set(v)

    def observe(self, v: float) -> None:
        self._default().observe(v)

    # -- reads ---------------------------------------------------------------

    def value(self, **kv) -> float:
        """Current value of one series (0.0 if never touched)."""
        key = tuple(str(kv.get(n, "")) for n in self.labelnames)
        child = self._children.get(key)
        return 0.0 if child is None else float(child.value)

    def series(self) -> Dict[Tuple[str, ...], float]:
        """{label-values: value} over every child (histograms: count)."""
        out = {}
        for key, child in self._children.items():
            out[key] = float(getattr(child, "value", getattr(child, "count", 0.0)))
        return out

    def total(self) -> float:
        return sum(self.series().values())


class _Bound:
    """A child bound to its registry lock: the mutator surface handed out
    by ``labels()``."""

    __slots__ = ("_registry", "_child")

    def __init__(self, registry: "MetricsRegistry", child):
        self._registry = registry
        self._child = child

    @property
    def value(self) -> float:
        return float(getattr(self._child, "value", 0.0))

    def inc(self, v: float = 1.0) -> None:
        if v < 0:
            raise ValueError(f"counters are monotone; inc({v}) is negative")
        with self._registry._lock:
            self._child.value += v

    def _inc_any(self, v: float) -> None:
        with self._registry._lock:
            self._child.value += v

    def dec(self, v: float = 1.0) -> None:
        self._inc_any(-v)

    def set(self, v: float) -> None:
        with self._registry._lock:
            self._child.value = float(v)

    def observe(self, v: float) -> None:
        child = self._child
        with self._registry._lock:
            child.sum += v
            child.count += 1
            for i, ub in enumerate(self._registry._buckets_of(child)):
                if v <= ub:
                    child.counts[i] += 1
                    break


class Counter(_Family):
    kind = "counter"

    def _new_child(self):
        return _Child()

    def dec(self, v: float = 1.0) -> None:  # pragma: no cover - guard
        raise ValueError("counters are monotone; use a Gauge")


class Gauge(_Family):
    kind = "gauge"

    def _new_child(self):
        return _Child()

    def inc(self, v: float = 1.0) -> None:
        # gauges may move both ways; route around the monotone guard
        if self._registry.enabled is False:
            return
        self._default()._inc_any(v)


class Histogram(_Family):
    kind = "histogram"

    def __init__(self, registry, name, help, labelnames,
                 buckets: Sequence[float]):
        super().__init__(registry, name, help, labelnames)
        bs = tuple(sorted(float(b) for b in buckets))
        if not bs:
            raise ValueError("histogram needs at least one bucket")
        if bs[-1] != math.inf:
            bs = bs + (math.inf,)
        self.buckets = bs

    def _new_child(self):
        child = _HistChild(len(self.buckets))
        self._registry._hist_buckets[id(child)] = self.buckets
        return child

    def value(self, **kv) -> float:
        """For histograms: the observation COUNT of one series."""
        key = tuple(str(kv.get(n, "")) for n in self.labelnames)
        child = self._children.get(key)
        return 0.0 if child is None else float(child.count)

    def sum_value(self, **kv) -> float:
        key = tuple(str(kv.get(n, "")) for n in self.labelnames)
        child = self._children.get(key)
        return 0.0 if child is None else float(child.sum)


class MetricsRegistry:
    """Named metric families + Prometheus-text / JSON exposition.

    Thread-safe: one lock guards child creation, every mutation, and the
    render snapshot.  Registration is idempotent by name (same kind —
    and, for histograms, same buckets — returns the existing family)."""

    def __init__(self, enabled: bool = True, namespace: str = "serving"):
        self.enabled = enabled
        self.namespace = namespace
        self._lock = threading.Lock()
        self._families: Dict[str, _Family] = {}
        # child -> buckets lookup for Histogram._Bound.observe
        self._hist_buckets: Dict[int, Tuple[float, ...]] = {}

    def _buckets_of(self, child) -> Tuple[float, ...]:
        return self._hist_buckets[id(child)]

    def _full(self, name: str) -> str:
        return f"{self.namespace}_{name}" if self.namespace else name

    def _register(self, cls, name: str, help: str, labelnames, **kw):
        full = self._full(name)
        with self._lock:
            fam = self._families.get(full)
            if fam is not None:
                if not isinstance(fam, cls):
                    raise ValueError(
                        f"{full} already registered as {fam.kind}"
                    )
                if cls is Histogram and kw.get("buckets") is not None:
                    bs = tuple(sorted(float(b) for b in kw["buckets"]))
                    if bs[-1] != math.inf:
                        bs = bs + (math.inf,)
                    if bs != fam.buckets:
                        raise ValueError(f"{full}: bucket mismatch")
                return fam
            fam = cls(self, full, help, labelnames, **kw)
            self._families[full] = fam
        return fam

    def counter(self, name: str, help: str = "",
                labelnames: Sequence[str] = ()) -> Counter:
        return self._register(Counter, name, help, labelnames)

    def gauge(self, name: str, help: str = "",
              labelnames: Sequence[str] = ()) -> Gauge:
        return self._register(Gauge, name, help, labelnames)

    def histogram(self, name: str, help: str = "",
                  labelnames: Sequence[str] = (),
                  buckets: Sequence[float] = LATENCY_BUCKETS) -> Histogram:
        return self._register(Histogram, name, help, labelnames,
                              buckets=buckets)

    def get(self, name: str) -> Optional[_Family]:
        return self._families.get(self._full(name))

    def value(self, name: str, **labels) -> float:
        fam = self.get(name)
        return 0.0 if fam is None else fam.value(**labels)

    # -- exposition ----------------------------------------------------------

    def render(self) -> str:
        """Prometheus text format (``text/plain; version=0.0.4``)."""
        lines: List[str] = []
        with self._lock:
            families = list(self._families.values())
            for fam in families:
                lines.append(f"# HELP {fam.name} {fam.help}")
                lines.append(f"# TYPE {fam.name} {fam.kind}")
                children = sorted(fam._children.items())
                for key, child in children:
                    if isinstance(fam, Histogram):
                        cum = 0
                        for i, ub in enumerate(fam.buckets):
                            cum += child.counts[i]
                            ls = _label_str(
                                fam.labelnames + ("le",), key + (_fmt(ub),)
                            )
                            lines.append(f"{fam.name}_bucket{ls} {cum}")
                        ls = _label_str(fam.labelnames, key)
                        lines.append(f"{fam.name}_sum{ls} {_fmt(child.sum)}")
                        lines.append(f"{fam.name}_count{ls} {child.count}")
                    else:
                        ls = _label_str(fam.labelnames, key)
                        lines.append(f"{fam.name}{ls} {_fmt(child.value)}")
        return "\n".join(lines) + "\n"

    def snapshot(self) -> dict:
        """JSON-safe dump: {family: {"type", "help", "series": {label-repr:
        value-or-histogram}}} — what the benchmarks merge into their
        trajectory files so they report the same numbers ``/metrics``
        serves."""
        out: dict = {}
        with self._lock:
            for fam in self._families.values():
                series = {}
                for key, child in sorted(fam._children.items()):
                    label = ",".join(
                        f"{n}={v}" for n, v in zip(fam.labelnames, key)
                    )
                    if isinstance(fam, Histogram):
                        series[label] = {
                            "count": child.count,
                            "sum": child.sum,
                            "buckets": {
                                _fmt(ub): c
                                for ub, c in zip(fam.buckets, child.counts)
                            },
                        }
                    else:
                        series[label] = child.value
                out[fam.name] = {
                    "type": fam.kind, "help": fam.help, "series": series,
                }
        return out

    def series_names(self) -> Iterable[str]:
        """Every family name currently registered (for smoke assertions)."""
        return list(self._families)

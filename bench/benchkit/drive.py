"""Drives the Engine in-process through ``add_request`` and ``step``, as an
offline or batched user does, and records what a user sees.

The load is open: requests arrive on the mix's seeded schedule at
``rate_per_s`` whatever the engine's state, each added between steps once
it is due.  The window starts in the state the mix's ``start`` names:
``running`` requests admitted (prefilled) during set-up, their outputs
cut so that they finish spread over the window's first part, and
``queued`` more waiting.  A mix whose rate is above what the card
sustains keeps the queue from running dry, so every round carries a full
batch; the run reports the fewest requests waiting at any step of the
window.

Every time is the host's ``time.perf_counter()`` taken after ``step()``
returns; a step ends in a device-to-host copy of the verify logits, so
the tokens it returns are on the host by then.  Records:

* ``emits``: (request, time, tokens) for every output a step streamed;
* per request: submit and first-token times, finished, its finish reason;
* ``rounds``: (start, end, rows) of every step that had an active row.

The window opens at a step boundary and closes at the end of the first
step that ends at or after ``seconds``: its length is the measured span,
and every output streamed inside it counts.
"""
from __future__ import annotations

import collections
import dataclasses
import sys
import time
from typing import Dict, List, Optional, Tuple

import numpy as np

from benchkit.traffic import Traffic

DRAIN_S = 60.0  # how long past the window the comparison may wait for finished requests


@dataclasses.dataclass
class Req:
    k: int
    rid: int
    prompt_len: int
    max_tokens: int
    submit: float
    first: Optional[float] = None
    last: Optional[float] = None
    finished: Optional[float] = None
    reason: Optional[str] = None
    n_out: int = 0


@dataclasses.dataclass
class Record:
    t0: float = 0.0
    t1: float = 0.0
    emits: List[Tuple[int, float, int]] = dataclasses.field(default_factory=list)
    reqs: Dict[int, Req] = dataclasses.field(default_factory=dict)
    rounds: List[Tuple[float, float, int]] = dataclasses.field(default_factory=list)
    counters0: Dict[str, float] = dataclasses.field(default_factory=dict)
    counters1: Dict[str, float] = dataclasses.field(default_factory=dict)
    min_waiting: Optional[int] = None  # fewest requests waiting after a step of the window

    @property
    def window_s(self) -> float:
        return self.t1 - self.t0


COUNTERS = ("tokens_drafted_total", "tokens_accepted_total", "tokens_emitted_total",
            "steps_total")


def counters(eng) -> Dict[str, float]:
    return {name: float(eng.metrics.get(name).value()) for name in COUNTERS}


class Proposals:
    """The draft's proposals of every chain round, by request: the greedy
    accept rule sees a row's proposals, the commit that follows it names
    the row's request and how many outputs it had committed before."""

    def __init__(self):
        self.by_rid: Dict[int, List[Tuple[int, np.ndarray]]] = collections.defaultdict(list)
        self._last: Optional[np.ndarray] = None
        self._saved: List[tuple] = []

    def install(self) -> None:
        from repro_torch.serving import engine as E
        accept, commit, rec = E.speculative_accept_greedy_host, E.Engine._commit, self

        def _accept(drafts, p_logits, dl):
            rec._last = np.array(drafts[:dl], dtype=np.int64)
            return accept(drafts, p_logits, dl)

        def _commit(self_, slot, req, new, n_acc, dl, drafted, work):
            if rec._last is not None:
                rec.by_rid[req.rid].append((len(req.out), rec._last))
                rec._last = None
            return commit(self_, slot, req, new, n_acc, dl, drafted, work)
        self._saved = [(E, "speculative_accept_greedy_host", accept), (E.Engine, "_commit", commit)]
        E.speculative_accept_greedy_host = _accept
        E.Engine._commit = _commit

    def uninstall(self) -> None:
        for obj, name, old in reversed(self._saved):
            setattr(obj, name, old)
        self._saved = []


class LoadLoop:
    def __init__(self, eng, traffic: Traffic):
        from repro_torch.serving.api import SamplingParams
        self.eng, self.traffic = eng, traffic
        self._sp = SamplingParams
        self.next_k = 0
        self.by_rid: Dict[int, Req] = {}
        self.rec = Record()
        self.proposals = Proposals()
        self.proposals.install()

    # -- requests ------------------------------------------------------------

    def submit(self, now: float, cut: Optional[int] = None) -> Req:
        k = self.next_k
        self.next_k += 1
        prompt, max_tokens = self.traffic.request(k, cut)
        rid = self.eng.add_request(prompt, self._sp(max_tokens=max_tokens))
        r = Req(k=k, rid=rid, prompt_len=len(prompt), max_tokens=max_tokens, submit=now)
        self.by_rid[rid] = r
        return r

    def step(self) -> List:
        t_a = time.perf_counter()
        outs = self.eng.step()
        t = time.perf_counter()
        if outs:
            self.rec.rounds.append((t_a, t, len(outs)))
        for o in outs:
            r = self.by_rid[o.request_id]
            n = len(o.new_token_ids)
            if n:
                self.rec.emits.append((o.request_id, t, n))
                r.n_out += n
                if r.first is None:
                    r.first = t
                r.last = t
            if o.finished:
                r.finished = t
                r.reason = o.outputs[0].finish_reason
        return outs

    # -- the loop ------------------------------------------------------------

    def run(self, seconds: float, tail_s: float = 0.0, hooks=None) -> None:
        """The start state, then the window: arrivals added as they fall
        due, one step after another.  The start's step prefills prompts
        across the mix's lengths and runs a round at the full batch, so
        every kernel the window runs is built and has run before it opens
        (the port's kernels are built ahead, none per shape).  After the
        window ``tail_s`` more seconds run under ``hooks`` (the traced
        segment of a ``--trace 1`` run)."""
        start = self.traffic.mix["start"]
        now = time.perf_counter()
        for i in range(int(start["running"])):
            self.submit(now, cut=i)
        for _ in range(int(start["queued"])):
            self.submit(now)
        self.step()
        rec = self.rec
        rate = float(self.traffic.mix["rate_per_s"])
        n = int((seconds + tail_s + 30.0) * rate) + 16
        offsets = self.traffic.arrivals(n)
        rec.counters0 = counters(self.eng)
        rec.t0 = time.perf_counter()
        end, i = rec.t0 + seconds, 0
        while True:
            t = time.perf_counter()
            while i < n and rec.t0 + offsets[i] <= t:
                self.submit(t)
                i += 1
            self.step()
            t = time.perf_counter()
            if not rec.t1:
                waiting = sum(1 for r in self.by_rid.values() if r.first is None)
                rec.min_waiting = waiting if rec.min_waiting is None else min(rec.min_waiting,
                                                                              waiting)
                if t >= end:
                    self._close(t, hooks)
            if rec.t1 and t >= self._tail_from + tail_s:
                break
        if hooks is not None:
            hooks.stop()
        self.rec.reqs = dict(self.by_rid)

    def _close(self, t: float, hooks) -> None:
        """Close the window at ``t``; start the traced segment, whose
        ``tail_s`` run from when the profiler is up."""
        self.rec.t1 = t
        self.rec.counters1 = counters(self.eng)
        if hooks is not None:
            hooks.start()
        self._tail_from = time.perf_counter()

    def drain_finished(self, want: int, limit_s: float = DRAIN_S) -> None:
        """Step on, with no new requests, until ``want`` requests have
        finished (the comparison needs finished ones)."""
        deadline = time.perf_counter() + limit_s
        while sum(r.finished is not None for r in self.by_rid.values()) < want \
                and self.eng.has_unfinished() and time.perf_counter() < deadline:
            self.step()
        self.rec.reqs = dict(self.by_rid)

    def close(self) -> None:
        self.proposals.uninstall()


def report_steps(rec: Record) -> None:
    """Step times inside the window, apart for the steps that admitted a
    request (its first token came out of that step) and the others, and
    the fewest requests waiting after a step."""
    firsts = {r.first for r in rec.reqs.values() if r.first is not None}
    inside = [(b - a, b in firsts) for a, b, _ in rec.rounds if a >= rec.t0 and b <= rec.t1]
    for label, want in (("with admissions", True), ("without", False)):
        ms = np.asarray([d for d, f in inside if f == want]) * 1e3
        if len(ms):
            print(f"steps {label}: {len(ms)}, total {ms.sum():.1f} ms, median {np.median(ms):.2f} ms, "
                  f"p10 {np.percentile(ms, 10):.2f} ms, p90 {np.percentile(ms, 90):.2f} ms",
                  file=sys.stderr)
    done = sum(1 for r in rec.reqs.values() if r.finished is not None and rec.t0 < r.finished <= rec.t1)
    print(f"queue: at least {rec.min_waiting} requests waiting after every step of the window; "
          f"{done} requests finished in it", file=sys.stderr)

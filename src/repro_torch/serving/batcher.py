"""Continuous-batching scheduler over the paged KV pools (torch counterpart
of repro/serving/batcher.py, without the prefix cache and the fused-PAR
slot telemetry, which are not ported yet).

A QUEUED request is admitted into a free batch slot only when BOTH pools
(target + draft) can reserve its worst-case page count (prompt +
max_new_tokens + a full draft/verify window), so an admitted request can
never run out of pages mid-flight; a FINISHED request releases its pages
at once.  Admission is head-of-line FIFO, and every (slot, request)
binding is stable from admission to retirement.  Each round also prices
the dispatched work with the WDOS discrete-event model
(core/scheduler.py), as the reference does.
"""
from __future__ import annotations

import dataclasses
from collections import deque
from typing import Deque, Dict, List, Optional, Sequence, Tuple

from repro_torch.core import scheduler as sch
from repro_torch.core.scheduler import Queue
from repro_torch.serving.observability import MetricsRegistry
from repro_torch.serving.paged_cache import PagedKVPool
from repro_torch.serving.request import DraftController, Request, RequestState

__all__ = ["ContinuousBatcher", "WDOSModelStats"]


@dataclasses.dataclass
class WDOSModelStats:
    """Accumulated discrete-event model of the dispatched rounds."""

    wdos_makespan: float = 0.0
    inorder_makespan: float = 0.0
    busy: Dict[Queue, float] = dataclasses.field(
        default_factory=lambda: {q: 0.0 for q in Queue}
    )

    @property
    def modeled_speedup(self) -> float:
        return self.inorder_makespan / self.wdos_makespan if self.wdos_makespan else 1.0

    def utilization(self, q: Queue) -> float:
        return self.busy[q] / self.wdos_makespan if self.wdos_makespan else 0.0


class ContinuousBatcher:
    """Slot/queue bookkeeping + page-budget admission + WDOS round model."""

    def __init__(
        self,
        cfg,  # api.EngineConfig
        t_pool: PagedKVPool,
        d_pool: PagedKVPool,
        t_layers: int,
        d_layers: int,
        t_costs: Tuple[float, float],  # (per-layer load, per-layer compute)
        d_costs: Tuple[float, float],
        metrics: Optional[MetricsRegistry] = None,
    ):
        self.cfg = cfg
        self.t_pool = t_pool
        self.d_pool = d_pool
        self.t_layers = t_layers
        self.d_layers = d_layers
        self.t_costs = t_costs
        self.d_costs = d_costs
        self.queue: Deque[Request] = deque()
        self.slots: List[Optional[Request]] = [None] * cfg.max_batch
        self.step_count = 0
        self.rounds = 0
        self.admitted = 0
        self.finished_count = 0
        self.finished_emitted = 0
        self.finished_drafted = 0
        self.finished_accepted = 0
        self.wdos = WDOSModelStats()
        self.metrics = MetricsRegistry() if metrics is None else metrics
        self._m_rounds = self.metrics.counter("rounds_total", "Decode rounds dispatched")
        self._m_finished = self.metrics.counter(
            "requests_finished_total", "Requests retired, by finish reason", ("reason",),
        )

    # -- lifecycle ----------------------------------------------------------

    def submit(self, req: Request) -> None:
        req.controller = DraftController(self.cfg.draft_len, self.cfg.draft_len)
        self.queue.append(req)

    def admit(self) -> List[Tuple[int, Request]]:
        """Fill free slots FIFO while both pools can take the worst case.
        Returns the newly admitted (slot, request) pairs (they need prefill)."""
        out: List[Tuple[int, Request]] = []
        for slot in range(self.cfg.max_batch):
            if self.slots[slot] is not None or not self.queue:
                continue
            req = self.queue[0]
            peak = req.peak_cache_len(self.cfg.spec_window)
            t_seq = self.t_pool.allocate_sequence(peak)
            if t_seq is None:
                break  # head-of-line: keep FIFO order, wait for pages
            d_seq = self.d_pool.allocate_sequence(peak)
            if d_seq is None:
                t_seq.release()
                break
            self.queue.popleft()
            req.t_seq, req.d_seq = t_seq, d_seq
            req.state = RequestState.PREFILL
            self.slots[slot] = req
            self.admitted += 1
            out.append((slot, req))
        return out

    def active(self) -> List[Tuple[int, Request]]:
        return [
            (i, r)
            for i, r in enumerate(self.slots)
            if r is not None and r.state is RequestState.DECODE
        ]

    def _tally_finished(self, req: Request) -> None:
        self.finished_count += 1
        self.finished_emitted += len(req.out)
        self.finished_drafted += req.drafted
        self.finished_accepted += req.accepted
        self._m_finished.labels(reason=req.finish_reason or "length").inc()

    def retire(self, slot: int, reason: str = "length") -> None:
        req = self.slots[slot]
        assert req is not None
        req.finish(reason=reason)
        self._tally_finished(req)
        self.slots[slot] = None

    def cancel_queued(self, rid: int) -> Optional[Request]:
        """Drop a not-yet-admitted request from the queue (Engine.abort)."""
        for req in list(self.queue):
            if req.rid == rid:
                self.queue.remove(req)
                req.finish(reason="abort")
                self._tally_finished(req)
                return req
        return None

    def slot_of(self, rid: int) -> Optional[int]:
        for i, r in enumerate(self.slots):
            if r is not None and r.rid == rid:
                return i
        return None

    def all_done(self) -> bool:
        return not self.queue and all(r is None for r in self.slots)

    # -- WDOS discrete-event model of one dispatched round ------------------

    def model_round(self, work: Sequence[Tuple[Request, int]]) -> None:
        """Price the round just executed: per request, `dl` chained DLM
        draft pipelines (RERAM loads) then one TLM verify pipeline (EMAC
        loads) depending on the request's final draft compute."""
        self.rounds += 1
        self._m_rounds.inc()
        if not work:
            return
        b = sch.new_builder()
        d_load, d_comp = self.d_costs
        t_load, t_comp = self.t_costs
        for req, dl in work:
            prev: Tuple[int, ...] = ()
            for j in range(dl):
                _, last = sch.layer_pipeline_instrs(
                    b, self.d_layers, Queue.RERAM, d_load, d_comp,
                    entry_deps=prev, tag=f"r{req.rid}.draft{j}",
                )
                prev = (last,)
            sch.layer_pipeline_instrs(
                b, self.t_layers, Queue.EMAC, t_load, t_comp * (dl + 1),
                entry_deps=prev, tag=f"r{req.rid}.verify",
            )
        s = sch.wdos_schedule(b.instrs)
        base = sch.inorder_schedule(b.instrs)
        self.wdos.wdos_makespan += s.makespan
        self.wdos.inorder_makespan += base.makespan
        for q in Queue:
            self.wdos.busy[q] += s.busy[q]

    # -- reporting ----------------------------------------------------------

    def summary(self) -> Dict[str, object]:
        return {
            "requests": self.finished_count,
            "rounds": self.rounds,
            "steps": self.step_count,
            "emitted": self.finished_emitted,
            "acceptance_rate": self.finished_accepted / max(self.finished_drafted, 1),
            "target_pool": self.t_pool.stats(),
            "draft_pool": self.d_pool.stats(),
            "wdos_modeled_speedup": self.wdos.modeled_speedup,
            "wdos_utilization": {q.name: self.wdos.utilization(q) for q in Queue},
        }

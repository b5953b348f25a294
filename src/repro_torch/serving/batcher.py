"""Continuous-batching scheduler over the paged KV pools (torch counterpart
of repro/serving/batcher.py).

A QUEUED request is admitted into a free batch slot only when BOTH pools
(target + draft) can reserve its worst-case page count (prompt +
max_new_tokens + a full draft/verify window), so an admitted request can
never run out of pages mid-flight; a FINISHED request releases its pages
at once.  Admission is head-of-line FIFO, and every (slot, request)
binding is stable from admission to retirement.  With a prefix cache
(serving/prefix_cache.py) the head's longest cached prefix maps shared
pages that its reservation does not pay for, and under pool pressure
admission evicts cached blocks, least recently used first, before it
stalls.  Each round also prices
the dispatched work with the WDOS discrete-event model
(core/scheduler.py), as the reference does, and under ``par_mode="wdos"``
each fused slot is counted by kind and priced on its own
(``record_fused_slot``; ``fused_summary`` reports it); ``model_wdos=False``
skips the pricing.  ``BatchConfig`` holds the knobs of the deprecated
``serve_batch`` wrapper (serving/engine.py).
"""
from __future__ import annotations

import dataclasses
from collections import deque
from typing import Deque, Dict, List, Optional, Sequence, Tuple

from repro_torch.core import scheduler as sch
from repro_torch.core.scheduler import MixedSlotPlan, Queue
from repro_torch.serving.observability import MetricsRegistry
from repro_torch.serving.paged_cache import PagedKVPool
from repro_torch.serving.prefix_cache import PrefixCache, PrefixMatch
from repro_torch.serving.request import DraftController, Request, RequestState

__all__ = ["BatchConfig", "ContinuousBatcher", "WDOSModelStats"]


@dataclasses.dataclass(frozen=True)
class BatchConfig:
    """Knobs of the deprecated ``serve_batch`` wrapper (new code drives
    ``Engine`` with ``EngineConfig`` and per-request ``SamplingParams``)."""

    max_batch: int = 8  # concurrent decode slots
    page_size: int = 16  # tokens per KV page
    max_tokens: int = 64  # per-request generation budget
    draft_len: int = 3  # fixed draft window (adaptive=False)
    adaptive: bool = False  # per-request APSD draft-length adaptation
    short_dl: int = 2
    long_dl: int = 6
    temperature: float = 0.0  # the wrapper serves greedy decoding only
    num_pages: Optional[int] = None  # page budget per pool (None: fit max_batch)
    model_wdos: bool = True  # price each round with the WDOS model (stats)
    # "paged": device-resident pools; "host": the legacy host-gather loop
    # (serving/host_gather.py), the benchmark baseline
    kv_path: str = "paged"

    @property
    def max_dl(self) -> int:
        return self.long_dl if self.adaptive else self.draft_len


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
        prefix_cache: Optional[PrefixCache] = None,
    ):
        self.cfg = cfg
        self.prefix_cache = prefix_cache
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
        self._m_fused_slots = self.metrics.counter(
            "fused_slots_total",
            "Fused slots dispatched: kind=fused has cross-request draft+verify "
            "co-residency, verify_only / draft_only do not", ("kind",),
        )
        self._m_fused_rows = self.metrics.counter(
            "fused_rows_total", "Batch rows occupied across fused slots, by role", ("role",),
        )
        self._m_fused_wall = self.metrics.counter(
            "fused_wall_seconds_total",
            "Host wall seconds by dispatched program: program=verify is any slot with a "
            "verify pass (fused or not), draft_only the draft step alone", ("program",),
        )
        self._m_wdos_modeled = self.metrics.counter(
            "wdos_modeled_seconds_total",
            "Discrete-event makespan of the executed slots under each schedule "
            "(wdos 4-queue vs in-order issue)", ("schedule",),
        )

    # -- lifecycle ----------------------------------------------------------

    def submit(self, req: Request) -> None:
        if self.cfg.adaptive:
            req.controller = DraftController(self.cfg.short_dl, self.cfg.long_dl)
        else:
            req.controller = DraftController(self.cfg.draft_len, self.cfg.draft_len)
        self.queue.append(req)

    def _allocate_pair(self, peak: int, match: Optional[PrefixMatch]):
        """One attempt at both pools' worst-case reservations, the match's
        fully shared pages not charged; (None, None) on failure, with
        nothing leaked."""
        def alloc(pool, role):
            if match is None:
                return pool.allocate_sequence(peak)
            return pool.allocate_sequence(peak, shared_pages=match.shared_pages(role),
                                          shared_tokens=match.tokens_matched)

        t_seq = alloc(self.t_pool, "target")
        if t_seq is None:
            return None, None
        d_seq = alloc(self.d_pool, "draft")
        if d_seq is None:
            t_seq.release()
            return None, None
        return t_seq, d_seq

    def admit(self) -> List[Tuple[int, Request]]:
        """Fill free slots FIFO while both pools can take the worst case.
        Returns the newly admitted (slot, request) pairs (they need prefill).

        With a prefix cache the head's longest cached prefix discounts its
        reservation, and under pool pressure cached blocks are evicted one
        at a time (LRU, zero-ref leaves) until the reservation fits or
        nothing evictable is left (then the head waits, as without it)."""
        out: List[Tuple[int, Request]] = []
        pc = self.prefix_cache
        for slot in range(self.cfg.max_batch):
            if self.slots[slot] is not None or not self.queue:
                continue
            req = self.queue[0]
            # spec_window == max_dl for chain speculation; the legacy host
            # loop's BatchConfig has only max_dl
            peak = req.peak_cache_len(getattr(self.cfg, "spec_window", self.cfg.max_dl))
            match = pc.match(req.prompt, req.kv_kind) if pc is not None else None
            while True:
                t_seq, d_seq = self._allocate_pair(peak, match)
                if t_seq is not None or pc is None or pc.evict_one() == 0:
                    break
                # the eviction may have freed a node of the matched path
                # (its node refs are zero until acquire): match again
                match = pc.match(req.prompt, req.kv_kind)
            if t_seq is None:
                break  # head-of-line: keep FIFO order, wait for pages
            if match is not None:
                pc.acquire(match)
                req.prefix_match = match
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
        # unpin the radix path only after the sequences dropped their page
        # references (in finish): the pool's per-page refcount then frees
        # no page that another row still maps
        if req.prefix_match is not None:
            self.prefix_cache.release(req.prefix_match)
            req.prefix_match = None
        self._tally_finished(req)
        self.slots[slot] = None

    def cancel_queued(self, rid: int) -> Optional[Request]:
        """Drop a not-yet-admitted request from the queue (Engine.abort).
        A queued request holds no prefix match (matches are acquired at
        admission), so there is no radix path to unpin."""
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
        if not self.cfg.model_wdos or not work:
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

    # -- fused slot telemetry (par_mode="wdos") ------------------------------

    def record_fused_slot(self, plan: MixedSlotPlan, wall_s: float, verify_width: int,
                          draft_width: int = 1) -> None:
        """Account one executed fused slot: its kind and rows, the host wall
        seconds of its program, and the discrete-event pricing of exactly
        this plan (so the model and the measurement describe one schedule)."""
        kind = "fused" if plan.fused else "verify_only" if plan.verify_rows else "draft_only"
        self._m_fused_slots.labels(kind=kind).inc()
        if plan.draft_rows:
            self._m_fused_rows.labels(role="draft").inc(len(plan.draft_rows))
        if plan.verify_rows:
            self._m_fused_rows.labels(role="verify").inc(len(plan.verify_rows))
        program = "verify" if plan.verify_rows else "draft_only"
        self._m_fused_wall.labels(program=program).inc(wall_s)
        if not self.cfg.model_wdos:
            return
        b = sch.new_builder()
        sch.mixed_slot_instrs(b, plan, self.t_layers, self.d_layers, self.t_costs,
                              self.d_costs, verify_width, draft_width=draft_width)
        if not b.instrs:
            return
        s = sch.wdos_schedule(b.instrs)
        base = sch.inorder_schedule(b.instrs)
        self._m_wdos_modeled.labels(schedule="wdos").inc(s.makespan)
        self._m_wdos_modeled.labels(schedule="inorder").inc(base.makespan)

    # -- reporting ----------------------------------------------------------

    def fused_summary(self) -> Optional[Dict[str, float]]:
        """The fused-slot report, derived from the registry counters (None
        until a fused slot has run); the reference's key set."""
        slots = self._m_fused_slots.total()
        if not slots:
            return None
        fused = self._m_fused_slots.value(kind="fused")
        d_rows = self._m_fused_rows.value(role="draft")
        v_rows = self._m_fused_rows.value(role="verify")
        modeled_wdos = self._m_wdos_modeled.value(schedule="wdos")
        modeled_inorder = self._m_wdos_modeled.value(schedule="inorder")
        return {
            "slots": int(slots),
            "fused_slots": int(fused),
            "occupancy": fused / slots,
            "draft_row_slots": int(d_rows),
            "verify_row_slots": int(v_rows),
            "mean_rows_per_slot": (d_rows + v_rows) / slots,
            "draft_only_wall_s": self._m_fused_wall.value(program="draft_only"),
            "verify_wall_s": self._m_fused_wall.value(program="verify"),
            "modeled_overlap_speedup": modeled_inorder / modeled_wdos if modeled_wdos else 1.0,
        }

    def summary(self) -> Dict[str, object]:
        out = {
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
        fused = self.fused_summary()
        if fused is not None:
            out["fused"] = fused
        return out

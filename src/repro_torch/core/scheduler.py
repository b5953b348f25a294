"""WDOS — Workload-Decoupled Out-of-order Scheduler (paper Fig. 31.1.5).

The chip decouples APSD work into 4 parallel instruction queues — inter-chip
transceiver (XCVR), compute (COMPUTE), ReRAM load (RERAM) and external memory
access (EMAC).  Each queue issues ITS OWN instructions in order, but the
queues run concurrently; an instruction issues only when all its parents
(possibly in other queues) have completed — the "synchronous counter matrix"
of intra-queue decoders + inter-queue synchronizers.  The result is
out-of-order execution *across* queues with dependency-aware synchronization,
which is what lets DLM drafting (RERAM + COMPUTE) overlap TLM verification
(EMAC + COMPUTE) inside one chip.

This module is a discrete-event simulator of that scheduler.  It is used by
core/perfmodel.py to price SD / PEARL / APSD rounds and reproduces the
paper's utilization claims; the same DAG-building helpers drive the
benchmarks (benchmarks/bench_apsd.py).

On the TPU re-host the WDOS *idea* becomes: draft and verify dispatched in a
single XLA program on disjoint mesh slices so their compute/collectives
overlap (launch/serve.py); the simulator stays as the faithful model of the
silicon behaviour.

Since the fused PAR serving mode (``EngineConfig(par_mode="wdos")``,
serving/engine.py) the scheduler is no longer just a pricing model: the
*mixed phase plan* emitter below (``RowPhase`` / ``MixedSlotPlan`` /
``plan_mixed_slot``) decides, per fused dispatch slot, which batch rows run
a DLM draft micro-step and which run their TLM verify window — out of order
across requests, by per-row readiness.  The engine executes one plan as ONE
fused XLA dispatch (draft and verify subgraphs in the same program, the
TPU analogue of issuing to decoupled RERAM/EMAC queues), and
``mixed_slot_instrs`` prices exactly that slot so the modeled overlap can
be validated against the engine's measured fused-round telemetry
(benchmarks/bench_serving.py).
"""
from __future__ import annotations

import dataclasses
import enum
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

__all__ = [
    "Queue",
    "Instr",
    "Schedule",
    "wdos_schedule",
    "inorder_schedule",
    "layer_pipeline_instrs",
    "RowPhase",
    "MixedSlotPlan",
    "plan_mixed_slot",
    "mixed_slot_instrs",
]


class Queue(enum.IntEnum):
    XCVR = 0  # inter-chip transceiver
    COMPUTE = 1  # TFTE / NLPU / LRU
    RERAM = 2  # ReRAM load interface (DLM codebooks)
    EMAC = 3  # external memory access controller (TLM weights)


@dataclasses.dataclass(frozen=True)
class Instr:
    uid: int
    queue: Queue
    duration: float
    deps: Tuple[int, ...] = ()
    tag: str = ""


@dataclasses.dataclass
class Schedule:
    makespan: float
    start: Dict[int, float]
    finish: Dict[int, float]
    busy: Dict[Queue, float]

    def utilization(self, q: Queue) -> float:
        return self.busy.get(q, 0.0) / self.makespan if self.makespan > 0 else 0.0


def wdos_schedule(instrs: Sequence[Instr]) -> Schedule:
    """Simulate the 4-queue dependency-aware scheduler.

    Per-queue FIFO issue; cross-queue out-of-order; an instruction starts at
    max(queue free time, parents' finish).  Raises on dependency deadlock
    (cyclic or cross-queue head-of-line cycles)."""
    by_queue: Dict[Queue, List[Instr]] = {q: [] for q in Queue}
    for ins in instrs:
        by_queue[ins.queue].append(ins)
    heads = {q: 0 for q in Queue}
    qfree = {q: 0.0 for q in Queue}
    start: Dict[int, float] = {}
    finish: Dict[int, float] = {}
    busy = {q: 0.0 for q in Queue}
    remaining = len(instrs)
    while remaining > 0:
        progressed = False
        for q in Queue:
            lst = by_queue[q]
            while heads[q] < len(lst):
                ins = lst[heads[q]]
                if not all(d in finish for d in ins.deps):
                    break
                s = max(qfree[q], max((finish[d] for d in ins.deps), default=0.0))
                start[ins.uid] = s
                finish[ins.uid] = s + ins.duration
                qfree[q] = finish[ins.uid]
                busy[q] += ins.duration
                heads[q] += 1
                remaining -= 1
                progressed = True
        if not progressed:
            raise RuntimeError("WDOS deadlock: unsatisfiable dependency order")
    makespan = max(finish.values(), default=0.0)
    return Schedule(makespan=makespan, start=start, finish=finish, busy=busy)


def inorder_schedule(instrs: Sequence[Instr]) -> Schedule:
    """Baseline: one in-order queue (no workload decoupling) — every
    instruction serializes.  This is the no-WDOS reference."""
    t = 0.0
    start: Dict[int, float] = {}
    finish: Dict[int, float] = {}
    busy = {q: 0.0 for q in Queue}
    for ins in instrs:
        start[ins.uid] = t
        t += ins.duration
        finish[ins.uid] = t
        busy[ins.queue] += ins.duration
    return Schedule(makespan=t, start=start, finish=finish, busy=busy)


class _Builder:
    """Monotonic uid allocator for DAG construction."""

    def __init__(self) -> None:
        self._uid = 0
        self.instrs: List[Instr] = []

    def add(
        self,
        queue: Queue,
        duration: float,
        deps: Iterable[int] = (),
        tag: str = "",
    ) -> int:
        uid = self._uid
        self._uid += 1
        self.instrs.append(
            Instr(uid=uid, queue=queue, duration=duration, deps=tuple(deps), tag=tag)
        )
        return uid


def layer_pipeline_instrs(
    builder: _Builder,
    n_layers: int,
    load_queue: Queue,
    load_time: float,
    compute_time: float,
    entry_deps: Iterable[int] = (),
    tag: str = "",
) -> Tuple[List[int], int]:
    """Per-layer load->compute pipeline: compute_i depends on load_i and
    compute_{i-1}; loads prefetch ahead (FIFO within the load queue).

    Returns (all uids, final compute uid)."""
    uids: List[int] = []
    prev_compute: Optional[int] = None
    entry = tuple(entry_deps)
    for i in range(n_layers):
        ld = builder.add(load_queue, load_time, entry if i == 0 else (), f"{tag}.load{i}")
        deps = [ld] + ([prev_compute] if prev_compute is not None else list(entry))
        cp = builder.add(Queue.COMPUTE, compute_time, deps, f"{tag}.comp{i}")
        uids.extend([ld, cp])
        prev_compute = cp
    assert prev_compute is not None
    return uids, prev_compute


def new_builder() -> _Builder:
    return _Builder()


# ---------------------------------------------------------------------------
# Mixed phase plans: cross-request PAR (fused draft+verify) scheduling
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class RowPhase:
    """One batch row's position inside its current draft/verify cycle.

    ``window`` is the draft length its APSD controller chose for the
    in-flight window; ``drafted`` counts proposals made so far.  A row is
    ready to VERIFY exactly when the window is full — until then its next
    unit of work is one more DLM draft micro-step."""

    slot: int
    window: int
    drafted: int

    @property
    def verify_ready(self) -> bool:
        return self.drafted >= self.window


@dataclasses.dataclass(frozen=True)
class MixedSlotPlan:
    """Role assignment for ONE fused dispatch slot.

    ``draft_rows`` propose their next draft token (DLM, RERAM-fed);
    ``verify_rows`` score their full window (TLM, EMAC-fed) while their
    DLM side feeds the window's final straggler token — so a verify row
    occupies BOTH queues, which is what makes the slot a true PAR round.
    The two sets are disjoint; rows in neither set are idle this slot."""

    draft_rows: Tuple[int, ...]
    verify_rows: Tuple[int, ...]

    @property
    def fused(self) -> bool:
        """True when DIFFERENT requests' draft and verify work co-reside in
        the dispatch — the cross-request PAR overlap the paper's WDOS buys.
        (A verify row's own straggler also keeps the draft queue busy, but
        that is intra-request overlap; it is not counted here.)"""
        return bool(self.verify_rows) and bool(self.draft_rows)

    @property
    def rows(self) -> Tuple[int, ...]:
        return tuple(self.draft_rows) + tuple(self.verify_rows)


def plan_mixed_slot(rows: Sequence[RowPhase]) -> MixedSlotPlan:
    """Emit the next slot's mixed phase plan, out of order by readiness.

    Every window-full row verifies NOW (verification never benefits from
    waiting: the TLM pass is batched, so co-scheduling all ready rows costs
    one EMAC pipeline) and every other row advances its draft window by one
    token — request A verifies while request B drafts, the paper's
    Fig. 31.1.5 overlap lifted to cross-request granularity.  The plan is a
    pure function of row readiness, so the engine's execution and the
    discrete-event pricing (``mixed_slot_instrs``) see the same schedule."""
    verify = tuple(sorted(r.slot for r in rows if r.verify_ready))
    draft = tuple(sorted(r.slot for r in rows if not r.verify_ready))
    return MixedSlotPlan(draft_rows=draft, verify_rows=verify)


def mixed_slot_instrs(
    builder: _Builder,
    plan: MixedSlotPlan,
    t_layers: int,
    d_layers: int,
    t_costs: Tuple[float, float],  # (per-layer EMAC load, per-layer compute)
    d_costs: Tuple[float, float],  # (per-layer RERAM load, per-layer compute)
    verify_width: int,
    draft_width: int = 1,
) -> None:
    """Price ONE fused slot: a RERAM-fed DLM pipeline per drafting row
    (plus the straggler pipeline each verifying row's DLM side runs) and an
    EMAC-fed TLM pipeline per verifying row, all sharing no edges — the DAG
    the 4-queue WDOS overlaps and the in-order baseline serializes.

    ``draft_width`` scales the DLM compute per layer: chain speculation
    drafts one token per micro-step (width 1), tree speculation re-feeds
    the whole fixed-width draft window each micro-step so every DLM
    pipeline computes ``tree_budget + 1`` tokens wide."""
    d_load, d_comp = d_costs
    t_load, t_comp = t_costs
    for slot in plan.draft_rows:
        layer_pipeline_instrs(
            builder, d_layers, Queue.RERAM, d_load, d_comp * draft_width,
            tag=f"s{slot}.draft",
        )
    for slot in plan.verify_rows:
        layer_pipeline_instrs(
            builder, d_layers, Queue.RERAM, d_load, d_comp * draft_width,
            tag=f"s{slot}.straggler",
        )
        layer_pipeline_instrs(
            builder, t_layers, Queue.EMAC, t_load, t_comp * verify_width,
            tag=f"s{slot}.verify",
        )

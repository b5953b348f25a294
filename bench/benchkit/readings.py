"""What a run hands its metric readers, and the arithmetic they share.

``Run`` carries the window's record (``drive.Record``), the cell's config
and mix, the set-up seconds and, in a ``--trace 1`` run, the traced
segment's hooks and trace summary.  A reader
(``metrics/<name>.py: read(run)``) returns a number, or None when the run
has nothing for it to read.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Sequence

from benchkit.spec import ConfigFile
from roofline import counts


def nearest_rank(values: Sequence[float], p: float) -> float:
    """The p-th percentile by nearest rank (p in (0, 100]); inf sorts last."""
    if not values:
        raise ValueError("no samples")
    v = sorted(values)
    return v[max(0, math.ceil(p / 100.0 * len(v)) - 1)]


@dataclasses.dataclass
class Run:
    cfg: ConfigFile
    mix: dict
    rec: object  # drive.Record
    setup_s: float
    hooks: object = None  # trace.Hooks of the traced segment
    summary: Optional[Dict] = None  # trace.summarize of it

    # -- the window (host clock) ---------------------------------------------

    def window_emits(self) -> List[tuple]:
        return [e for e in self.rec.emits if self.rec.t0 < e[1] <= self.rec.t1]

    def window_rounds(self) -> List[tuple]:
        return [r for r in self.rec.rounds if r[0] >= self.rec.t0 and r[1] <= self.rec.t1]

    def itl_samples(self) -> List[float]:
        """Per streamed output after a request's first, k samples of g / k
        (k tokens after a gap g since the request's previous output),
        for outputs inside the window."""
        last: Dict[int, float] = {}
        out: List[float] = []
        for rid, t, k in self.rec.emits:
            prev = last.get(rid)
            last[rid] = t
            if prev is not None and self.rec.t0 < t <= self.rec.t1:
                out.extend([(t - prev) / k] * k)
        return out

    def counter_delta(self, name: str) -> float:
        return self.rec.counters1[name] - self.rec.counters0[name]

    # -- the traced segment --------------------------------------------------

    @property
    def traced(self) -> bool:
        return self.summary is not None

    def traced_rounds(self) -> int:
        h = self.hooks
        return sum(1 for a, b, _ in self.rec.rounds if a >= h.t_start and b <= h.t_stop)



def attn_calls(run: Run, int8: bool):
    """(new lengths, call record) of each paged-attention call of one body."""
    for call in run.hooks.attn:
        b, s, h, kvh, hd, q_es, kv_es, q8, tree, mp, group = call
        if q8 == int8:
            yield [n + s for n in run.hooks.lengths(group)], call


def attn_bound_s(run: Run, int8: bool) -> float:
    total = 0.0
    for lens, (b, s, h, kvh, hd, q_es, kv_es, q8, tree, mp, group) in attn_calls(run, int8):
        total += counts.lower_bound_s(counts.attn_ops(lens, s, h, hd),
                                      counts.attn_bytes(lens, s, h, kvh, hd, q_es, kv_es, q8, mp),
                                      counts.PEAKS["bf16_flops"])
    return total


def share(bound_s: float, device_s: float) -> Optional[float]:
    """100 x the least time over the device time; None with nothing timed."""
    if bound_s <= 0.0 or device_s <= 0.0:
        return None
    return 100.0 * bound_s / device_s


def traced_model_flops(run: Run) -> float:
    """Model FLOPs of the work the traced segment did: every paged forward
    (draft steps, verifies) over its active rows, every prefill, counted
    by the configuration's family (``forward_flops``)."""
    fam, m = run.cfg.family, run.cfg.model
    total = 0.0
    for g_i, g in enumerate(run.hooks.groups):
        role = fam.role_of_forward(m, g["calls"])
        if role is None:
            continue
        s = g["s"]
        lens = [n for n in run.hooks.lengths(g_i) if n > 0]
        keys = sum(s * (n + s) - s * (s - 1) // 2 for n in lens)
        total += fam.forward_flops(m, role, s * len(lens), keys)
    for role, rows, matched in run.hooks.prefills:
        total += fam.forward_flops(m, role, rows, rows * matched + rows * (rows + 1) // 2)
    return total

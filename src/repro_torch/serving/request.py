"""Request lifecycle for the continuous-batching runtime (torch counterpart
of repro/serving/request.py, greedy requests).

A request moves QUEUED -> PREFILL -> DECODE -> FINISHED.  While in DECODE it
owns one PagedSequence per model (target + draft) and a ``DraftController``
that gives its draft length per round.  The reference's per-request PRNG
key streams (sampled requests), stop strings, streaming sinks, latency
timestamps and the fused-PAR / tree phase state are not ported yet; the
engine refuses requests that need them.
"""
from __future__ import annotations

import dataclasses
import enum
from typing import List, Optional

import numpy as np

from repro_torch.core.apsd import NONPAR, PAR, APSDPolicy
from repro_torch.serving.api import SamplingParams
from repro_torch.serving.paged_cache import PagedSequence

__all__ = ["RequestState", "DraftController", "Request"]


class RequestState(enum.Enum):
    QUEUED = "queued"
    PREFILL = "prefill"
    DECODE = "decode"
    FINISHED = "finished"


@dataclasses.dataclass
class DraftController:
    """Per-request draft length (the APSD mode state machine).  The port's
    engine builds it with short_dl == long_dl: a fixed draft length."""

    short_dl: int
    long_dl: int
    mode: int = NONPAR

    def draft_len(self) -> int:
        return self.long_dl if self.mode == PAR else self.short_dl

    def observe(self, n_accepted: int, window: int) -> None:
        self.mode = APSDPolicy.next_mode(self.mode, n_accepted == window, True)


@dataclasses.dataclass
class Request:
    rid: int
    prompt: np.ndarray  # (S,) int32, S >= 2
    max_new_tokens: int
    sampling: Optional[SamplingParams] = None  # None => greedy defaults

    state: RequestState = RequestState.QUEUED
    out: List[int] = dataclasses.field(default_factory=list)
    last_tok: int = 0  # tip of the committed sequence (re-fed each round)
    t_seq: Optional[PagedSequence] = None
    d_seq: Optional[PagedSequence] = None
    controller: Optional[DraftController] = None
    finish_reason: Optional[str] = None

    drafted: int = 0
    accepted: int = 0
    _delta_mark: int = 0

    def __post_init__(self):
        self.prompt = np.asarray(self.prompt, np.int32).reshape(-1)
        if self.prompt.shape[0] < 2:
            raise ValueError("prompt must have >= 2 tokens (SD invariant)")
        self.last_tok = int(self.prompt[-1])
        if self.sampling is None:
            self.sampling = SamplingParams(max_tokens=self.max_new_tokens)

    @property
    def done(self) -> bool:
        return len(self.out) >= self.max_new_tokens

    def peak_cache_len(self, max_dl: int) -> int:
        """Worst-case cache length: committed-1 positions plus a full
        draft/verify window (+1 for the verify bonus / draft straggler)."""
        return self.prompt.shape[0] + self.max_new_tokens + max_dl

    def commit(self, tokens: List[int]) -> None:
        """Append verified tokens and update the tip.  A round may overshoot
        max_new_tokens; the overshoot is kept for cache bookkeeping and
        trimmed at finish."""
        self.out.extend(tokens)
        if tokens:
            self.last_tok = int(tokens[-1])

    def emittable_len(self) -> int:
        return min(len(self.out), self.max_new_tokens)

    def take_delta(self) -> List[int]:
        """Newly deliverable tokens since the last call."""
        hi = self.emittable_len()
        lo = min(self._delta_mark, hi)
        self._delta_mark = hi
        return [int(t) for t in self.out[lo:hi]]

    def finish(self, reason: str = "length") -> None:
        self.state = RequestState.FINISHED
        if self.finish_reason is None:
            self.finish_reason = reason
        self.out = self.out[: self.max_new_tokens]
        for seq in (self.t_seq, self.d_seq):
            if seq is not None and not seq.released:
                seq.release()
        self.t_seq = self.d_seq = None

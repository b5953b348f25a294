"""Request lifecycle for the continuous-batching runtime (torch counterpart
of repro/serving/request.py).

A request moves QUEUED -> PREFILL -> DECODE -> FINISHED.  While in DECODE it
owns one PagedSequence per model (target + draft) and a ``DraftController``
that gives its draft length per round (fixed, or the APSD short/long
choice under ``adaptive``); under ``par_mode="wdos"`` it carries its open
draft window across engine steps, and under ``spec_mode="tree"`` its draft
tree.  ``history`` logs (mode, drafted, accepted, emitted) per committed
round.  Tokens stream to an optional sink as soon as they are safe to
deliver.

A sampled request (``temperature > 0``) draws all its randomness from its
own key streams: keys derive from its seed and are indexed by (stream,
round, position), never drawn from a shared counter, so its tokens do not
depend on the batch it is scheduled into.  ``rounds`` increments only when
a round commits, so fused and two-phase rounds index the same keys.

``SamplingParams.stop`` is enforced at commit: each committed token's text
extends the request's generated text, the text is scanned for the earliest
new stop match, and on a hit the output is cut at the token boundary before
the match (the stop string itself is excluded) with
``finish_reason="stop"``.  The cache bookkeeping is untouched, so a stopped
request retires and frees its pages as a length-finished one does.  A
token whose text could still begin a match is held back from delivery
until later text proves it safe, so a delivered token is never retracted.

The reference's latency timestamps are not ported yet (nothing in the port
reads them).
"""
from __future__ import annotations

import bisect
import dataclasses
import enum
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np

from repro_torch.core import prng
from repro_torch.core.apsd import NONPAR, PAR, APSDPolicy
from repro_torch.serving.api import SamplingParams, default_detokenize
from repro_torch.serving.paged_cache import PagedSequence

__all__ = ["RequestState", "DraftController", "Request"]

# per-request PRNG stream ids (folded into the seed key first)
_DRAFT_STREAM = 0  # draft-token sampling, indexed by (round, position)
_ACCEPT_STREAM = 1  # rejection-sampling accept/residual, indexed by round


class RequestState(enum.Enum):
    QUEUED = "queued"
    PREFILL = "prefill"
    DECODE = "decode"
    FINISHED = "finished"


@dataclasses.dataclass
class DraftController:
    """Per-request draft length (the APSD mode state machine): long_dl in
    PAR mode, short_dl in NONPAR.  A fixed draft length is short_dl ==
    long_dl."""

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
    sink: Optional[Callable[[int], None]] = None  # streaming token callback
    sampling: Optional[SamplingParams] = None  # None => greedy defaults
    # token -> text for sampling.stop matching (the engine injects its
    # detokenizer at add_request; None: api.default_detokenize)
    detokenize: Optional[Callable[[int], str]] = None
    # resolved KV storage kind ("none" | "int8"), stamped by the engine at
    # add_request: which device store the request's pages live in
    kv_kind: str = "none"

    state: RequestState = RequestState.QUEUED
    out: List[int] = dataclasses.field(default_factory=list)
    last_tok: int = 0  # tip of the committed sequence (re-fed each round)
    t_seq: Optional[PagedSequence] = None
    d_seq: Optional[PagedSequence] = None
    controller: Optional[DraftController] = None
    finish_reason: Optional[str] = None
    # the prefix-cache hit this request was admitted with (PrefixMatch),
    # held until retirement so the batcher can unpin its radix-tree path;
    # None when the cache is off or the lookup missed
    prefix_match: Optional[Any] = None

    rounds: int = 0  # committed rounds: the key streams' round index
    drafted: int = 0
    accepted: int = 0
    # (controller mode, drafted, accepted, emitted) per committed round
    history: List[Tuple[int, int, int, int]] = dataclasses.field(default_factory=list)

    # -- fused window state (par_mode="wdos"): pending_dl is the open
    # window's length (None between windows); pending holds the proposals so
    # far (their draft KV sits at d_seq.length + [0, len(pending))), and
    # pending_q the draft logits rows a sampled request's accept rule needs.
    # Carried across engine steps.
    pending_dl: Optional[int] = None
    pending: List[int] = dataclasses.field(default_factory=list)
    pending_q: List[np.ndarray] = dataclasses.field(default_factory=list)

    # -- tree phase state (spec_mode="tree"): tree_dl is the round's target
    # depth (None between rounds); tree_nodes[i] / tree_parents[i] are the
    # drafted token and parent NODE index (-1 = root) of window slot 1+i in
    # drafting (BFS) order; tree_depth is the deepest fully grown level;
    # tree_draws counts this round's sampled child draws (the draft_key
    # position index); tree_q maps a window slot to the draft logits row its
    # children were sampled from (sampled requests: the tree rejection rule
    # needs q at every branch point).
    tree_dl: Optional[int] = None
    tree_nodes: List[int] = dataclasses.field(default_factory=list)
    tree_parents: List[int] = dataclasses.field(default_factory=list)
    tree_depth: int = 0
    tree_draws: int = 0
    tree_q: Dict[int, np.ndarray] = dataclasses.field(default_factory=dict)

    # -- stop-string state (sampling.stop non-empty): the generated text and
    # each output token's cumulative text end, so a match maps back to a
    # token boundary; _stream_mark is the sink's delivery watermark and
    # _delta_mark take_delta's
    stop_hit: bool = False
    _gen_text: str = ""
    _text_ends: List[int] = dataclasses.field(default_factory=list)
    _stream_mark: int = 0
    _delta_mark: int = 0

    def __post_init__(self):
        self.prompt = np.asarray(self.prompt, np.int32).reshape(-1)
        if self.prompt.shape[0] < 2:
            raise ValueError("prompt must have >= 2 tokens (SD invariant)")
        self.last_tok = int(self.prompt[-1])
        if self.sampling is None:
            self.sampling = SamplingParams(max_tokens=self.max_new_tokens)
        self._base_key: Optional[np.ndarray] = None  # greedy requests never build one

    # -- sampling key streams ------------------------------------------------

    def _key(self) -> np.ndarray:
        if self._base_key is None:
            self._base_key = prng.PRNGKey(self.sampling.seed)
        return self._base_key

    def draft_key(self, position: int) -> np.ndarray:
        """Key for the draft token at ``position`` of the current round."""
        k = prng.fold_in(self._key(), _DRAFT_STREAM)
        return prng.fold_in(prng.fold_in(k, self.rounds), position)

    def accept_key(self) -> np.ndarray:
        """Key for the current round's rejection-sampling accept/residual."""
        return prng.fold_in(prng.fold_in(self._key(), _ACCEPT_STREAM), self.rounds)

    @property
    def done(self) -> bool:
        return self.stop_hit or len(self.out) >= self.max_new_tokens

    def peak_cache_len(self, max_dl: int) -> int:
        """Worst-case cache length: committed-1 positions plus a full
        draft/verify window (+1 for the verify bonus / draft straggler)."""
        return self.prompt.shape[0] + self.max_new_tokens + max_dl

    def begin_window(self, dl: int) -> None:
        """Open a fresh draft window of ``dl`` proposals (fused rounds)."""
        if dl < 1:
            raise ValueError(f"draft window must be >= 1, got {dl}")
        self.clear_window()
        self.pending_dl = dl

    def clear_window(self) -> None:
        self.pending_dl = None
        self.pending = []
        self.pending_q = []

    @property
    def window_full(self) -> bool:
        """Ready to verify: every proposal of the open window is drafted."""
        return self.pending_dl is not None and len(self.pending) >= self.pending_dl

    @property
    def draft_tip(self) -> int:
        """The token the next draft step feeds: the window's last proposal,
        or the committed tip while the window is empty."""
        return int(self.pending[-1]) if self.pending else self.last_tok

    def begin_tree(self, dl: int) -> None:
        """Open a fresh draft tree targeting depth `dl`."""
        if dl < 1:
            raise ValueError(f"tree depth must be >= 1, got {dl}")
        self.clear_tree()
        self.tree_dl = dl

    def clear_tree(self) -> None:
        self.tree_dl = None
        self.tree_nodes = []
        self.tree_parents = []
        self.tree_depth = 0
        self.tree_draws = 0
        self.tree_q = {}

    @property
    def tree_full(self) -> bool:
        """Ready to verify: the tree reached its target depth (or spent its
        node budget, in which case the grower stamps tree_depth forward)."""
        return self.tree_dl is not None and self.tree_depth >= self.tree_dl

    def commit(self, tokens: List[int]) -> None:
        """Append verified tokens, stream them (up to the budget) and update
        the tip.  A round may overshoot max_new_tokens; the overshoot is kept
        for cache bookkeeping and trimmed at finish.  With stop strings the
        text stream is scanned as well (``_commit_with_stop``)."""
        if self.sampling.stop:
            self._commit_with_stop(tokens)
            return
        keep = max(0, self.max_new_tokens - len(self.out))
        if self.sink is not None:
            for t in tokens[:keep]:
                self.sink(int(t))
        self.out.extend(tokens)
        if tokens:
            self.last_tok = int(tokens[-1])

    def _commit_with_stop(self, tokens: List[int]) -> None:
        detok = self.detokenize if self.detokenize is not None else default_detokenize
        stops = self.sampling.stop
        if tokens:
            # the committed window's tip, before any cut: the engine's cache
            # bookkeeping sees the tip it always does
            self.last_tok = int(tokens[-1])
        for t in tokens:
            if self.stop_hit:
                break
            if len(self.out) >= self.max_new_tokens:
                # overshoot past the budget: kept for cache bookkeeping only
                # (trimmed at finish), never part of the text a stop can match
                self.out.append(int(t))
                continue
            tail_start = len(self._gen_text)
            self.out.append(int(t))
            self._gen_text += detok(int(t))
            self._text_ends.append(len(self._gen_text))
            # a NEW match ends inside this token's text: scan from
            # tail_start - (len(stop) - 1) to cover matches begun earlier
            start = None
            for s in stops:
                m = self._gen_text.find(s, max(0, tail_start - len(s) + 1))
                if m >= 0 and (start is None or m < start):
                    start = m
            if start is not None:
                # keep the tokens whose text ends at or before the match
                self.out = self.out[: bisect.bisect_right(self._text_ends, start)]
                self.stop_hit = True
                self.finish_reason = "stop"
        # stream only what is safe: survived the cut, fits the budget, and
        # cannot still become part of a later match
        if self.sink is not None:
            hi = self.emittable_len()
            for t in self.out[self._stream_mark: hi]:
                self.sink(int(t))
            self._stream_mark = max(self._stream_mark, hi)

    def _held_tail_chars(self) -> int:
        """Chars at the end of the generated text that are a proper prefix
        of some stop string: they could still begin a match (the holdback
        window)."""
        best = 0
        text = self._gen_text
        for s in self.sampling.stop:
            for n in range(min(len(s) - 1, len(text)), best, -1):
                if text.endswith(s[:n]):
                    best = n
                    break
        return best

    def emittable_len(self) -> int:
        """Output tokens safe to deliver now: everything committed up to the
        budget, minus, while stop matching is live, the held tail whose text
        could yet become part of a match.  Once the request resolves (stop
        hit, or budget reached) the holdback flushes."""
        n = min(len(self.out), self.max_new_tokens)
        if not self.sampling.stop or self.stop_hit or n >= self.max_new_tokens:
            return n
        held = self._held_tail_chars()
        if not held:
            return n
        return min(n, bisect.bisect_right(self._text_ends, len(self._gen_text) - held))

    def take_delta(self) -> List[int]:
        """Newly deliverable tokens since the last call: held-back tokens are
        delivered late, never retracted, so the deltas concatenate to the
        final output."""
        hi = self.emittable_len()
        lo = min(self._delta_mark, hi)
        self._delta_mark = hi
        return [int(t) for t in self.out[lo:hi]]

    def record_round(self, mode: int, drafted: int, accepted: int, emitted: int) -> None:
        self.history.append((mode, drafted, accepted, emitted))

    def finish(self, reason: str = "length") -> None:
        self.state = RequestState.FINISHED
        if self.finish_reason is None:
            self.finish_reason = reason
        self.out = self.out[: self.max_new_tokens]
        self.clear_window()
        self.clear_tree()
        self._gen_text = ""  # the stop-matching buffers are dead weight now
        self._text_ends = []
        for seq in (self.t_seq, self.d_seq):
            if seq is not None and not seq.released:
                seq.release()
        self.t_seq = self.d_seq = None

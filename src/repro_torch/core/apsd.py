"""APSD, adaptive parallel speculative decoding (torch counterpart of
repro/core/apsd.py): the paper's mode-switch rule and the single-request
generator ``apsd_generate``.

NONPAR drafts a short window and verifies it; PAR verifies the pending
window while drafting the next long one, and stays in PAR only while the
target accepts the whole pending window and its bonus token equals the
first token of the concurrent draft.  Functionally the generator drafts
first, then verifies (the overlap itself is the scheduler's business)."""
from __future__ import annotations

import dataclasses
from typing import Any, List, NamedTuple, Optional, Tuple

import torch

from repro_torch.core import prng
from repro_torch.core.speculative import (
    LMInterface,
    _probs,
    categorical,
    speculative_accept_greedy,
    speculative_sample,
)

__all__ = ["NONPAR", "PAR", "APSDConfig", "APSDPolicy", "RoundRecord", "APSDStats",
           "apsd_generate"]

NONPAR = 0
PAR = 1


@dataclasses.dataclass(frozen=True)
class APSDConfig:
    short_dl: int = 2  # non-parallel draft length
    long_dl: int = 6  # parallel draft length
    temperature: float = 0.0
    max_tokens: int = 64


class APSDPolicy:
    """The paper's mode-switch rule, isolated for reuse."""

    @staticmethod
    def next_mode(mode: int, all_accepted: bool, first_match: bool) -> int:
        if mode == NONPAR:
            # a fully-accepted short window is evidence drafting is easy
            return PAR if all_accepted else NONPAR
        return PAR if (all_accepted and first_match) else NONPAR


class RoundRecord(NamedTuple):
    mode: int  # NONPAR / PAR
    drafted: int  # tokens proposed by the draft this round (incl. discarded)
    accepted: int  # draft tokens committed
    emitted: int  # accepted + 1 (bonus/correction)
    discarded: int  # concurrent-draft tokens thrown away


class APSDStats(NamedTuple):
    emitted: int
    rounds: int
    drafted: int
    accepted: int
    discarded: int
    par_rounds: int
    records: Tuple[RoundRecord, ...]

    @property
    def rejected_ratio(self) -> float:
        return 1.0 - self.accepted / max(self.drafted, 1)

    @property
    def tokens_per_round(self) -> float:
        return self.emitted / max(self.rounds, 1)


def _draft_tokens(key, draft: LMInterface, draft_params: Any, d_cache: Any,
                  start_tok: torch.Tensor, n: int, temperature: float):
    """The draft proposes n tokens autoregressively from start_tok."""
    toks, qrows = [], []
    cur = start_tok
    for _ in range(n):
        lg, d_cache = draft.extend(draft_params, cur.reshape(1, 1), d_cache)
        if temperature <= 0.0:
            nxt = torch.argmax(lg[0, -1])
        else:
            key, sub = prng.split(key)
            nxt = categorical(sub, lg[0, -1].float() / temperature)
            qrows.append(_probs(lg[0, -1], temperature))
        toks.append(nxt.to(torch.int32))
        cur = toks[-1]
    return torch.stack(toks), (torch.stack(qrows) if qrows else None), d_cache, key


def _verify(key, target: LMInterface, target_params: Any, t_cache: Any,
            prev_tok: torch.Tensor, draft_toks: torch.Tensor,
            q_rows: Optional[torch.Tensor], temperature: float):
    """The target scores [prev_tok, drafts] in one pass; accept and roll
    back."""
    l = int(draft_toks.shape[0])
    window = torch.cat([prev_tok.reshape(1), draft_toks]).reshape(1, -1)
    vg, t_cache = target.extend(target_params, window, t_cache)
    p_logits = vg[0]
    if temperature <= 0.0:
        toks, n_out, n_acc = speculative_accept_greedy(draft_toks, p_logits)
    else:
        key, sub = prng.split(key)
        toks, n_out, n_acc = speculative_sample(sub, draft_toks, _probs(p_logits, temperature),
                                                q_rows)
    # the target cache holds l+1 new positions; the bonus token is re-fed
    # next round, so keep n_acc of the l drafts + the prev_tok position
    if l - n_acc > 0:
        t_cache = target.rewind(t_cache, l - n_acc)
    return toks, n_out, n_acc, t_cache, key


def apsd_generate(
    key,
    target: LMInterface,
    target_params: Any,
    draft: LMInterface,
    draft_params: Any,
    prompt: torch.Tensor,  # (1, S) int32 on the models' device
    cfg: APSDConfig,
) -> Tuple[torch.Tensor, APSDStats]:
    """Single-request APSD generator (host loop, batch 1), greedy or sampled
    (``key``: a ``prng`` key).  Lossless: the policy only changes which
    drafts are proposed or discarded, never acceptance.  Returns (tokens
    (T,) int32 on the host, stats)."""
    assert prompt.shape[1] >= 2
    assert cfg.long_dl >= 2, "PAR mode needs long_dl >= 2"
    _, t_cache = target.prefill(target_params, prompt[:, :-1])
    _, d_cache = draft.prefill(draft_params, prompt[:, :-1])
    last_tok = prompt[0, -1].to(torch.int32)
    temp = cfg.temperature

    out: List[int] = []
    records: List[RoundRecord] = []
    mode = NONPAR
    # the concurrent draft of the previous PAR round, not yet verified
    pending: Optional[Tuple[torch.Tensor, Optional[torch.Tensor]]] = None

    while len(out) < cfg.max_tokens:
        discarded = 0
        if mode == NONPAR:
            # ---- sequential: draft a short window, then verify it
            d_toks, q_rows, d_cache, key = _draft_tokens(
                key, draft, draft_params, d_cache, last_tok, cfg.short_dl, temp)
            toks, n_out, n_acc, t_cache, key = _verify(
                key, target, target_params, t_cache, last_tok, d_toks, q_rows, temp)
            drafted = cfg.short_dl
            # the draft cache holds [last_tok, d_0..d_{s-2}]; restore
            # cache == committed[:-1] (see speculative.sd_generate)
            if n_acc == cfg.short_dl:
                _, d_cache = draft.extend(draft_params, d_toks[-1].reshape(1, 1), d_cache)
            elif (cfg.short_dl - 1) - n_acc > 0:
                d_cache = draft.rewind(d_cache, (cfg.short_dl - 1) - n_acc)
            all_acc = n_acc == cfg.short_dl
            first_match = True  # no concurrent draft to contradict
            pending = None
        else:
            # ---- parallel: draft the next window (the draft cache already
            # sits at the tip of `pending`), then verify `pending`
            assert pending is not None
            p_toks, p_qrows = pending
            c_toks, c_qrows, d_cache, key = _draft_tokens(
                key, draft, draft_params, d_cache, p_toks[-1], cfg.long_dl, temp)
            toks, n_out, n_acc, t_cache, key = _verify(
                key, target, target_params, t_cache, last_tok, p_toks, p_qrows, temp)
            drafted = cfg.long_dl  # the concurrent window proposed this round
            l_pending = int(p_toks.shape[0])
            all_acc = n_acc == l_pending
            first_match = bool(all_acc and int(toks[n_acc]) == int(c_toks[0]))
            if first_match:
                # c_toks[0] is already committed (== the bonus); c_toks[1:]
                # await verification next round; the draft cache is in place
                pending = (c_toks[1:], None if c_qrows is None else c_qrows[1:])
            else:
                # drop the concurrent window and the rejected pending drafts:
                # the draft cache holds committed + p[0..Lp-1] + c[0..L-2]
                discarded = cfg.long_dl
                rewind_n = (l_pending - n_acc) + (cfg.long_dl - 1)
                if rewind_n > 0:
                    d_cache = draft.rewind(d_cache, rewind_n)
                pending = None

        new = [int(t) for t in toks[:n_out].tolist()]
        out.extend(new)
        last_tok = torch.tensor(new[-1], dtype=torch.int32, device=prompt.device)
        # a matched first-token guess is itself an accepted draft token
        acc_stat = n_acc + (1 if (mode == PAR and first_match) else 0)
        records.append(RoundRecord(mode=mode, drafted=drafted, accepted=acc_stat,
                                   emitted=n_out, discarded=discarded))
        new_mode = APSDPolicy.next_mode(mode, bool(all_acc), first_match)
        if new_mode == PAR and pending is None:
            # entering PAR from NONPAR: seed the first pending window
            d_toks, q_rows, d_cache, key = _draft_tokens(
                key, draft, draft_params, d_cache, last_tok, cfg.long_dl, temp)
            pending = (d_toks, q_rows)
        mode = new_mode
        if mode == NONPAR:
            pending = None

    stats = APSDStats(
        emitted=sum(r.emitted for r in records),
        rounds=len(records),
        drafted=sum(r.drafted for r in records),
        accepted=sum(r.accepted for r in records),
        discarded=sum(r.discarded for r in records),
        par_rounds=sum(1 for r in records if r.mode == PAR),
        records=tuple(records),
    )
    return torch.tensor(out[: cfg.max_tokens], dtype=torch.int32), stats

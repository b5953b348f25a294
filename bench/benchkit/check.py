"""The comparison that decides ``correct``.

Once the window has closed, a sample of the requests the run finished is
drawn from the seed, the longest among them always in it.  Two numbers
are read over it, both widest gaps by which a token the program chose
lies below the reference's best logit at its position (all tokens are
greedy):

* ``max_logit_gap``: the target's served tokens, against the family's
  float32 target reference run once over each prompt with its served
  tokens;
* ``draft_max_logit_gap``: the draft's proposals (``drive.Proposals``),
  against the family's float32 draft reference: the first proposal of
  every round of a sampled request over one pass of its prompt and
  served tokens, and every proposal of up to ``DRAFT_ROUNDS`` rounds
  drawn from the seed over its own branch (the committed tokens and the
  proposals before it).  At acceptance near 0 no draft token is served,
  so only the draft's numbers see its forward and its kernels.  Over the
  same proposals also ``draft_mean_logit_gap`` (the mean gap) and
  ``draft_flip_share`` (the share of proposals that are not the
  reference's first choice), which a near-tie moves less than the
  widest gap.

The control (``control=True``: the same references one precision step
lower) takes the program's place: at the same positions the gap of the
token the lower precision puts first (``control_gap``, and
``draft_control_max_logit_gap`` with its mean and flip share).  Its readings set a limit's upper end; the
program's over a dozen seeds set its lower end (``PERF.md`` gives both and
the limit, which the configuration file states under ``check``).
"""
from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from benchkit.spec import ConfigFile

_SAMPLE_STREAM, _ROUND_STREAM = 29, 31
DRAFT_ROUNDS = 4  # rounds per sampled request whose every proposal is checked


def sample(reqs: Dict, seed: int, n: int) -> List[int]:
    """Request ids to compare: the finished request with the most served
    tokens, then others drawn from the seed."""
    done = sorted((r for r in reqs.values() if r.finished is not None and r.n_out > 0),
                  key=lambda r: r.k)
    if not done:
        return []
    longest = max(done, key=lambda r: (r.n_out, -r.k))
    rest = [r for r in done if r is not longest]
    rng = np.random.default_rng([int(seed) % (1 << 64), _SAMPLE_STREAM])
    picks = [rest[i] for i in rng.permutation(len(rest))[: max(0, n - 1)]]
    return [longest.rid] + [r.rid for r in picks]


def _gaps(ref: torch.Tensor, toks) -> np.ndarray:
    """The gap of each of ``toks`` (one per row) below its row's best."""
    t = torch.as_tensor(np.asarray(toks, np.int64), device=ref.device)
    return (ref.max(dim=-1).values - ref.gather(1, t[:, None])[:, 0]).cpu().numpy()


def _gap(ref: torch.Tensor, toks) -> float:
    return float(_gaps(ref, toks).max())


def _control_gap(ref: torch.Tensor, ctl: torch.Tensor) -> float:
    return _gap(ref, ctl.argmax(dim=-1).cpu().numpy())


def target_gaps(cfg: ConfigFile, seed: int, seqs: Sequence[Tuple[np.ndarray, np.ndarray]], device,
                control: bool = False) -> Dict[str, float]:
    fam, m = cfg.family, cfg.model
    full = [np.concatenate([p, o]).astype(np.int64) for p, o in seqs]
    starts = [len(p) for p, _ in seqs]
    ref = fam.target_logits(m, seed, full, starts, device)
    out = {"max_logit_gap": max(_gap(lg, o) for lg, (_, o) in zip(ref, seqs)),
           "served_tokens": float(sum(len(o) for _, o in seqs))}
    if control:
        ctl = fam.target_logits(m, seed, full, starts, device, precision="control")
        out["control_gap"] = max(_control_gap(r, c) for r, c in zip(ref, ctl))
    return out


def draft_gaps(cfg: ConfigFile, seed: int, kept, seqs: Sequence[Tuple[np.ndarray, np.ndarray]],
               props: Sequence[List[Tuple[int, np.ndarray]]], device,
               control: bool = False) -> Dict[str, float]:
    """``props[i]``: request i's rounds as (outputs committed before the
    round, its proposals)."""
    fam, m = cfg.family, cfg.model
    gaps = {"program": [], "control": []}

    def read(seq, rows, toks):
        ref = fam.draft_logits(m, seed, kept, seq, rows, device)
        gaps["program"].append(_gaps(ref, toks))
        if control:
            ctl = fam.draft_logits(m, seed, kept, seq, rows, device, precision="control")
            gaps["control"].append(_gaps(ref, ctl.argmax(dim=-1).cpu().numpy()))

    rng = np.random.default_rng([int(seed) % (1 << 64), _ROUND_STREAM])
    for (p, o), rounds in zip(seqs, props):
        rounds = [(c, d) for c, d in rounds if 1 <= c <= len(o) and len(d)]
        if not rounds:
            continue
        seq = np.concatenate([p, o]).astype(np.int64)
        read(seq, [len(p) + c - 1 for c, _ in rounds], [int(d[0]) for _, d in rounds])
        for i in sorted(rng.permutation(len(rounds))[:DRAFT_ROUNDS]):
            c, d = rounds[i]
            if len(d) > 1:  # the later proposals, each over the ones before it
                branch = np.concatenate([p, o[:c], d[:-1]]).astype(np.int64)
                read(branch, list(range(len(p) + c, len(p) + c - 1 + len(d))), list(d[1:]))
    out = {}
    for who, prefix in (("program", "draft_"), ("control", "draft_control_")):
        if gaps[who]:
            g = np.concatenate(gaps[who])
            out.update({prefix + "max_logit_gap": float(g.max()),
                        prefix + "mean_logit_gap": float(g.mean()),
                        prefix + "flip_share": float((g > 0).mean())})
    out["draft_proposals"] = float(sum(len(g) for g in gaps["program"]))
    out.update(fam.draft_readings(m, seed, kept, device))
    return out

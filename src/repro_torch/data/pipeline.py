"""Deterministic synthetic LM data pipeline with host-sharded loading (the
port's own copy of repro/data/pipeline.py, pure numpy: its batches are
bitwise the reference's).

Production framing: each host materializes ONLY its shard of the global
batch (`host_slice`), generation is a pure function of (seed, step) so any
host can reproduce any step — which is what makes checkpoint-restart and
elastic re-sharding trivial (no data-loader state to save beyond the step
counter, and a resized fleet re-slices the same global stream).

The token stream is a seeded Zipf-ish unigram mixture with short-range
bigram structure — enough signal for the training loss to fall, which the
end-to-end example asserts.
"""
from __future__ import annotations

import dataclasses
from typing import Iterator, Optional, Tuple

import numpy as np

__all__ = ["DataConfig", "SyntheticLMDataset", "make_batch_iterator"]


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab: int
    seq_len: int
    global_batch: int
    seed: int = 0
    zipf_a: float = 1.3  # unigram skew
    bigram_strength: float = 0.7  # P(next token from the bigram chain)


class SyntheticLMDataset:
    """Pure-function batches: batch(step) -> (global_batch, seq_len+1)."""

    def __init__(self, cfg: DataConfig):
        self.cfg = cfg
        rng = np.random.default_rng(cfg.seed)
        # fixed unigram distribution (Zipf over a shuffled vocab)
        ranks = np.arange(1, cfg.vocab + 1, dtype=np.float64)
        probs = ranks ** (-cfg.zipf_a)
        probs /= probs.sum()
        self._unigram = probs[rng.permutation(cfg.vocab)]
        # deterministic bigram successor table (a permutation => cycles)
        self._succ = rng.permutation(cfg.vocab)

    def batch(self, step: int) -> np.ndarray:
        """Full global batch for a step (any host can compute any slice)."""
        cfg = self.cfg
        rng = np.random.default_rng((cfg.seed, step))
        b, s = cfg.global_batch, cfg.seq_len + 1
        out = np.empty((b, s), dtype=np.int32)
        cur = rng.choice(cfg.vocab, size=b, p=self._unigram)
        out[:, 0] = cur
        for t in range(1, s):
            follow = rng.random(b) < cfg.bigram_strength
            fresh = rng.choice(cfg.vocab, size=b, p=self._unigram)
            cur = np.where(follow, self._succ[cur], fresh)
            out[:, t] = cur
        return out

    def host_slice(self, step: int, host_id: int, n_hosts: int) -> np.ndarray:
        """This host's contiguous rows of the global batch."""
        assert self.cfg.global_batch % n_hosts == 0
        per = self.cfg.global_batch // n_hosts
        return self.batch(step)[host_id * per : (host_id + 1) * per]


def make_batch_iterator(
    cfg: DataConfig,
    start_step: int = 0,
    host_id: int = 0,
    n_hosts: int = 1,
) -> Iterator[Tuple[int, np.ndarray]]:
    """(step, batch) iterator resumable from any step (checkpoint-restart)."""
    ds = SyntheticLMDataset(cfg)
    step = start_step
    while True:
        yield step, ds.host_slice(step, host_id, n_hosts)
        step += 1

"""The one load generator: every traffic mix is a data file it reads.

A mix file (``traffic/<mix>.json``) states:

* ``source``: the public trace or paper its numbers come from;
* ``rate_per_s``: the arrival rate, with exponential gaps (Poisson);
* ``start``: ``running`` requests admitted before the window, their
  outputs cut to a length drawn uniformly below their own (quantile
  (c + 0.5) / running of it, c in a shuffled order), so that they finish
  spread out; ``queued`` more waiting;
* ``prompt_tokens`` / ``output_tokens``: log-normal lengths, ``median``
  and ``sigma`` of the log, clipped to [``min``, ``max``];
* ``grid``: lengths and gaps are the distribution's quantiles at
  (i + 0.5) / grid, dealt out in a shuffled order, a fresh order every
  ``grid`` requests.  The order is fixed, the same for every seed: the
  engine admits in arrival order and never waits for an arrival, so
  every seed's window does the same work, and the seed draws only the
  token ids (and the weights);
* ``engine``: the engine settings the mix is served with;
* ``check_requests``: how many finished requests the comparison samples;
* ``trace_seconds``: the length of a ``--trace 1`` run's traced segment.

Token ids are uniform over the vocabulary, drawn per request from the
seed.  Pure numpy.
"""
from __future__ import annotations

import math
import statistics
from typing import List, Optional, Tuple

import numpy as np

_NORMAL = statistics.NormalDist()
_TOKENS, _PROMPT_ORDER, _OUTPUT_ORDER, _FIRST_ORDER, _GAP_ORDER = 7, 11, 13, 17, 19


def lognormal_grid(spec: dict, n: int) -> np.ndarray:
    q = [_NORMAL.inv_cdf((i + 0.5) / n) for i in range(n)]
    x = np.round(float(spec["median"]) * np.exp(float(spec["sigma"]) * np.asarray(q)))
    return np.clip(x, int(spec["min"]), int(spec["max"])).astype(np.int64)


class Traffic:
    def __init__(self, mix: dict, seed: int, vocab: int):
        self.mix = mix
        self.seed = int(seed) % (1 << 64)
        self.vocab = int(vocab)
        self.grid = int(mix.get("grid", 64))
        self._prompts = lognormal_grid(mix["prompt_tokens"], self.grid)
        self._outputs = lognormal_grid(mix["output_tokens"], self.grid)

    def _rng(self, *key) -> np.random.Generator:
        return np.random.default_rng([self.seed, *key])

    @staticmethod
    def _dealt(values: np.ndarray, stream: int, k: int):
        cycle, i = divmod(k, len(values))
        return values[np.random.default_rng([stream, cycle]).permutation(len(values))[i]]

    def sizes(self, k: int) -> Tuple[int, int]:
        """(prompt length, output length) of request k."""
        return (int(self._dealt(self._prompts, _PROMPT_ORDER, k)),
                int(self._dealt(self._outputs, _OUTPUT_ORDER, k)))

    def request(self, k: int, cut: Optional[int] = None) -> Tuple[np.ndarray, int]:
        """(prompt token ids, max output tokens) of request k; ``cut``: the
        index of a start request, whose output is cut."""
        plen, out = self.sizes(k)
        if cut is not None:
            running = int(self.mix["start"]["running"])
            c = int(np.random.default_rng(_FIRST_ORDER).permutation(running)[cut])
            out = max(1, math.ceil(out * (c + 0.5) / running))
        prompt = self._rng(_TOKENS, k).integers(0, self.vocab, size=plen, dtype=np.int64)
        return prompt.astype(np.int32), out

    def arrivals(self, n: int) -> np.ndarray:
        """Offsets (s) from the window's opening of the first n arrivals."""
        rate = float(self.mix["rate_per_s"])
        gaps = np.asarray([-math.log(1.0 - (i + 0.5) / self.grid) / rate
                           for i in range(self.grid)])
        return np.cumsum([self._dealt(gaps, _GAP_ORDER, k) for k in range(n)])

    def max_model_len(self, window: int, page_size: int) -> int:
        """The longest cache a request can need, in whole pages."""
        need = int(self.mix["prompt_tokens"]["max"]) + int(self.mix["output_tokens"]["max"]) + window
        return -(-need // page_size) * page_size

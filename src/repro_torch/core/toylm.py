"""First-order Markov toy LMs (torch counterpart of repro/core/toylm.py):
exact, cheap oracles for the speculative decoding stack.

A table LM's next-token distribution depends only on the last fed token,
so greedy decoding from it has a closed form (``markov_greedy_decode``)
and ``core/speculative.sd_generate`` / ``core/apsd.apsd_generate`` can be
held to it exactly.  The cache is a device token buffer and a length, with
the rewind semantics of a real KV cache."""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import prng
from repro_torch.core.speculative import LMInterface

__all__ = ["make_markov_lm", "markov_greedy_decode", "random_transition_logits"]


def random_transition_logits(key, vocab: int, sharpness: float = 2.0) -> np.ndarray:
    """(V, V) float32 logits table, row t the distribution of the token
    after t: ``sharpness`` times standard normal draws from the ``prng``
    key (the reference's ``jax.random.normal`` draws bit for bit).  Numpy
    on the host; the caller moves it to its device."""
    return np.float32(sharpness) * prng.normal(key, (vocab, vocab))


def make_markov_lm(max_len: int = 4096, device="cuda") -> LMInterface:
    """LMInterface over params = a (V, V) transition-logits tensor on
    ``device``.  cache = (buffer (1, max_len) int32 on ``device``, length);
    the logits at step i are ``table[fed_token_i]``."""
    device = torch.device(device)

    def _feed(params, tokens, buf, start):
        b, l = tokens.shape
        if b != 1:
            raise ValueError(f"the Markov LM takes one row, got {b}")
        buf[:, start:start + l] = tokens.to(torch.int32)
        return params[tokens[0].long()][None]  # (1, L, V)

    def prefill(params, tokens):
        buf = torch.zeros((1, max_len), dtype=torch.int32, device=device)
        logits = _feed(params, tokens, buf, 0)
        return logits, (buf, tokens.shape[1])

    def extend(params, tokens, cache):
        buf, length = cache
        logits = _feed(params, tokens, buf, length)
        return logits, (buf, length + tokens.shape[1])

    def rewind(cache, n):
        buf, length = cache
        return (buf, length - n)

    return LMInterface(prefill=prefill, extend=extend, rewind=rewind)


def markov_greedy_decode(params, start: int, n: int) -> torch.Tensor:
    """Ground-truth greedy decode of the table LM from token ``start``:
    (n,) int32 on the host."""
    table = torch.as_tensor(params).cpu()
    toks, cur = [], int(start)
    for _ in range(n):
        cur = int(torch.argmax(table[cur]))
        toks.append(cur)
    return torch.tensor(toks, dtype=torch.int32)

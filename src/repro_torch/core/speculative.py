"""Speculative decoding primitives the serving engine uses (the greedy part
of repro/core/speculative.py): the model handle and the host-side greedy
accept rule."""
from __future__ import annotations

from typing import Any, Callable, List, NamedTuple, Tuple

import numpy as np

__all__ = ["LMInterface", "speculative_accept_greedy_host"]


class LMInterface(NamedTuple):
    """Functional LM handle over a dense cache (the reference's also carries
    ``rewind``, which nothing in the port calls).

    prefill(params, tokens (B,S))            -> (logits (B,S,V), cache)
    extend(params, tokens (B,L), cache)      -> (logits (B,L,V), cache)
    """

    prefill: Callable[..., Tuple[Any, Any]]
    extend: Callable[..., Tuple[Any, Any]]


def speculative_accept_greedy_host(drafts, p_logits: np.ndarray, dl: int) -> Tuple[List[int], int]:
    """Greedy verify for one request's round: accept while draft ==
    argmax(target), then emit the bonus/correction token.

    drafts: (>= dl,) int draft tokens; p_logits: (>= dl+1, V) target logits.
    np.argmax takes the first maximum, like jnp.argmax and torch.argmax."""
    tlm_tok = np.argmax(p_logits, axis=-1)
    n_acc = 0
    while n_acc < dl and tlm_tok[n_acc] == drafts[n_acc]:
        n_acc += 1
    return [int(t) for t in drafts[:n_acc]] + [int(tlm_tok[n_acc])], n_acc

"""Speculative decoding primitives the serving engine uses (the greedy part
of repro/core/speculative.py): the model handle, the host-side greedy
accept rules for chains and trees, and the tree-window layout helpers."""
from __future__ import annotations

from typing import Any, Callable, List, NamedTuple, Optional, Tuple

import numpy as np

__all__ = [
    "LMInterface",
    "speculative_accept_greedy_host",
    "tree_children",
    "tree_ancestor_mask",
    "tree_depths",
    "topk_tokens_host",
    "speculative_tree_accept_greedy_host",
]


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


# -- speculation trees ---------------------------------------------------------
# A round's tree lives in one fixed-width window: slot 0 re-feeds the
# committed tip (last_tok), node i (drafting/BFS order) sits at slot 1+i, and
# parents[i] is the parent NODE index, -1 when the parent is the root.
# Window-indexed logits follow the same convention: row 0 is the
# distribution after last_tok, row 1+i after node i.


def tree_children(parents) -> List[List[int]]:
    """children[w] = node indices whose parent occupies window slot w, in
    drafting order (node i sits at window slot 1+i; root at slot 0)."""
    kids: List[List[int]] = [[] for _ in range(len(parents) + 1)]
    for i, par in enumerate(parents):
        kids[0 if par < 0 else 1 + par].append(i)
    return kids


def tree_ancestor_mask(parents, width: Optional[int] = None) -> np.ndarray:
    """(W, W) float32 ancestor mask for one request's tree window: row w
    sees column j iff slot j is slot w itself or an ancestor of it (slot 0
    is an ancestor of every node).  ``width`` pads with self-only rows."""
    t = len(parents)
    w = t + 1 if width is None else width
    assert w >= t + 1, (w, t)
    m = np.eye(w, dtype=np.float32)
    for i in range(t):
        m[1 + i, 0] = 1.0
        par = parents[i]
        if par >= 0:
            m[1 + i] = np.maximum(m[1 + i], m[1 + par])
    return m


def tree_depths(parents, width: Optional[int] = None) -> np.ndarray:
    """(W,) int32 window-relative depth of each slot (the RoPE position
    offsets of the window): slot 0 is depth 0, node i is depth(parent) + 1;
    padded slots repeat depth 0."""
    t = len(parents)
    w = t + 1 if width is None else width
    d = np.zeros((w,), np.int32)
    for i in range(t):
        d[1 + i] = (d[1 + parents[i]] if parents[i] >= 0 else d[0]) + 1
    return d


def topk_tokens_host(logits: np.ndarray, k: int) -> List[int]:
    """Top-k token ids, highest logit first, first maximum first on ties
    (stable argsort), so element 0 is exactly ``np.argmax(logits)``."""
    order = np.argsort(-np.asarray(logits, np.float32), kind="stable")
    return [int(t) for t in order[:k]]


def speculative_tree_accept_greedy_host(
    nodes, parents, p_logits: np.ndarray
) -> Tuple[List[int], List[int], int]:
    """Greedy tree verify: descend to the first child that matches the
    target argmax at each position, emit the argmax when no child does.
    Every committed token is the target argmax at its position, so greedy
    tree and greedy chain emit the same sequence.  Returns (committed
    tokens, accepted node indices in path order, n_accepted)."""
    kids = tree_children(parents)
    committed: List[int] = []
    path: List[int] = []
    slot = 0
    while True:
        top = int(np.argmax(p_logits[slot]))
        match = next((c for c in kids[slot] if int(nodes[c]) == top), None)
        committed.append(top)
        if match is None:
            return committed, path, len(path)
        path.append(match)
        slot = 1 + match

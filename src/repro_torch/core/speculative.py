"""Speculative decoding (torch counterpart of repro/core/speculative.py):
the model handle, the host-side accept rules the serving engine applies
per row (greedy and lossless rejection sampling, for chains and trees),
the tree-window layout helpers, and the single-request generator
``sd_generate`` with its device-side rules.

All randomness comes from ``core/prng.py`` keys, bit for bit the
reference's ``jax.random`` keys, with the reference's order of ``split``
and ``fold_in`` calls; only ``log`` (numpy's, or torch's on the device,
against XLA's) may differ in its last bits, which can move a categorical
draw or an accept test only at an ulp-level tie."""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from repro_torch.core import prng

__all__ = [
    "SDConfig",
    "SDStats",
    "LMInterface",
    "speculative_sample",
    "speculative_accept_greedy",
    "speculative_accept_greedy_host",
    "speculative_sample_host",
    "sample_token_host",
    "sd_generate",
    "tree_children",
    "tree_ancestor_mask",
    "tree_depths",
    "topk_tokens_host",
    "speculative_tree_sample_host",
    "speculative_tree_accept_greedy_host",
]


@dataclasses.dataclass(frozen=True)
class SDConfig:
    draft_len: int = 4
    temperature: float = 1.0  # 0 => greedy (deterministic accept rule)
    max_tokens: int = 64


class LMInterface(NamedTuple):
    """Functional LM handle over a dense cache.

    prefill(params, tokens (B,S))            -> (logits (B,S,V), cache)
    extend(params, tokens (B,L), cache)      -> (logits (B,L,V), cache)
    rewind(cache, n)                         -> cache with n tokens dropped
    """

    prefill: Callable[..., Tuple[Any, Any]]
    extend: Callable[..., Tuple[Any, Any]]
    rewind: Callable[[Any, int], Any]


class SDStats(NamedTuple):
    emitted: int  # total tokens emitted
    rounds: int  # number of draft/verify rounds
    drafted: int  # total draft tokens proposed
    accepted: int  # total draft tokens accepted

    @property
    def acceptance_rate(self) -> float:
        return self.accepted / max(self.drafted, 1)

    @property
    def rejection_rate(self) -> float:
        return 1.0 - self.acceptance_rate

    @property
    def tokens_per_round(self) -> float:
        return self.emitted / max(self.rounds, 1)


# -- device rules (single-request generators) ---------------------------------


def _probs(logits: torch.Tensor, temperature: float) -> torch.Tensor:
    return torch.softmax(logits.float() / max(temperature, 1e-6), dim=-1)


def categorical(key, logits: torch.Tensor) -> torch.Tensor:
    """One draw from the softmax of a 1-D logits row on its device: the
    first maximum of ``logits + gumbel``, the Gumbel noise drawn on the host
    from ``key`` (``prng.gumbel``) in float32 (the reference draws it in the
    logits' dtype: the same draws on float32 models).  Returns a 0-d int64
    tensor."""
    noise = torch.as_tensor(prng.gumbel(key, tuple(logits.shape)), device=logits.device)
    return torch.argmax(noise + logits.float())


def _first_reject(accept: torch.Tensor) -> torch.Tensor:
    """Length of the all-accepted prefix of a boolean vector."""
    return torch.cumprod(accept.long(), dim=0).sum()


def speculative_sample(
    key,
    draft_tokens: torch.Tensor,  # (L,) int, sampled from q
    p_probs: torch.Tensor,  # (L+1, V) target distribution at each position
    q_probs: torch.Tensor,  # (L, V) draft distribution at each position
) -> Tuple[torch.Tensor, int, int]:
    """Lossless speculative rejection sampling for one draft window on the
    model's device.  Returns (out_tokens (L+1,) padded with -1, n_out in
    [1, L+1], n_accepted in [0, L])."""
    l = q_probs.shape[0]
    dev = p_probs.device
    k_u, k_res = prng.split(key)
    idx = torch.arange(l, device=dev)
    d = draft_tokens.long()
    p_i, q_i = p_probs[idx, d], q_probs[idx, d]
    u = torch.as_tensor(prng.uniform(k_u, (l,)), device=dev)
    n_acc = int(_first_reject(u * q_i < p_i))  # u < p/q without the divide
    # residual distribution at the first rejected position (or bonus at L)
    p_next = p_probs[n_acc]
    q_next = q_probs[min(n_acc, l - 1)] if n_acc < l else torch.zeros_like(p_next)
    residual = torch.clamp(p_next - q_next, min=0.0)
    res_sum = residual.sum()
    dist = torch.where(res_sum > 1e-9, residual / torch.clamp(res_sum, min=1e-9), p_next)
    next_tok = categorical(k_res, torch.log(dist + 1e-20))
    out = torch.full((l + 1,), -1, dtype=draft_tokens.dtype, device=dev)
    out[:n_acc] = draft_tokens[:n_acc]
    out[n_acc] = next_tok.to(draft_tokens.dtype)
    return out, n_acc + 1, n_acc


def speculative_accept_greedy(
    draft_tokens: torch.Tensor,  # (L,)
    p_logits: torch.Tensor,  # (L+1, V)
) -> Tuple[torch.Tensor, int, int]:
    """Greedy (temperature-0) verify: accept while draft == argmax(target)."""
    l = draft_tokens.shape[0]
    tlm_tok = torch.argmax(p_logits, dim=-1).to(draft_tokens.dtype)  # (L+1,)
    n_acc = int(_first_reject(tlm_tok[:l] == draft_tokens))
    out = torch.full((l + 1,), -1, dtype=draft_tokens.dtype, device=draft_tokens.device)
    out[:n_acc] = draft_tokens[:n_acc]
    out[n_acc] = tlm_tok[n_acc]
    return out, n_acc + 1, n_acc


# -- host rules (the batched engine's per-row mirrors) -------------------------


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



def _top_k_filter_host(logits: np.ndarray, top_k: int) -> np.ndarray:
    """Keep the top-k logits (ties at the threshold all survive), set the
    rest to -inf."""
    if top_k <= 0 or top_k >= logits.shape[-1]:
        return logits
    thresh = np.partition(logits, -top_k, axis=-1)[..., -top_k, None]
    return np.where(logits < thresh, -np.inf, logits)


def _top_p_filter_host(logits: np.ndarray, top_p: float) -> np.ndarray:
    """Nucleus filter on temperature-scaled logits: keep the minimal set of
    tokens whose probability mass reaches ``top_p`` (ties broken by token
    id through a stable sort; the top token always survives), set the rest
    to -inf.  ``top_p >= 1`` is the identity."""
    if top_p >= 1.0:
        return logits
    probs = _softmax_host(np.asarray(logits, np.float32))
    order = np.argsort(-probs, axis=-1, kind="stable")  # desc, low id first
    sorted_p = np.take_along_axis(probs, order, axis=-1)
    cum = np.cumsum(sorted_p, axis=-1)
    keep_sorted = (cum - sorted_p) < top_p  # the mass BEFORE a token is < top_p
    keep = np.zeros(probs.shape, bool)
    np.put_along_axis(keep, order, keep_sorted, axis=-1)
    return np.where(keep, logits, -np.inf)


def _softmax_host(logits: np.ndarray) -> np.ndarray:
    x = logits - np.max(logits, axis=-1, keepdims=True)
    e = np.exp(x)
    return e / np.sum(e, axis=-1, keepdims=True)


def _filtered_logits_host(logits: np.ndarray, temperature: float, top_k: int,
                          top_p: float) -> np.ndarray:
    """The logits drafting draws from: top-k, then temperature, then top-p
    (the same filters on both sides of the rejection rule keep it
    lossless)."""
    lg = _top_k_filter_host(np.asarray(logits, np.float32), top_k) / max(temperature, 1e-6)
    return _top_p_filter_host(lg, top_p)


def sample_token_host(key, logits: np.ndarray, temperature: float, top_k: int = 0,
                      top_p: float = 1.0) -> int:
    """Sample one token from (temperature/top-k/top-p filtered) logits with
    an explicit key: the per-request draft step of the batched engine.
    Deterministic in (key, logits, params) only, so a request's draw never
    depends on its batch composition."""
    return prng.categorical(key, _filtered_logits_host(logits, temperature, top_k, top_p))


def _log_host(dist: np.ndarray) -> np.ndarray:
    """The categorical logits of a distribution, ``log(dist + 1e-20)`` in f32."""
    return np.log(np.asarray(dist, np.float32) + np.float32(1e-20))


def speculative_sample_host(
    key,
    drafts,  # (>= dl,) int draft tokens sampled via sample_token_host
    p_logits: np.ndarray,  # (>= dl+1, V) target logits over the window
    q_logits: np.ndarray,  # (>= dl, V) draft logits at each draft position
    dl: int,
    temperature: float,
    top_k: int = 0,
    top_p: float = 1.0,
) -> Tuple[List[int], int]:
    """Lossless rejection sampling for one request's round: filter both
    distributions as drafting did (which keeps the rule lossless under
    top-k/top-p), accept the ``u * q < p`` prefix, and draw the residual
    (or bonus) token, all from ``key``.  Returns (committed tokens [n_acc
    accepted drafts + 1 residual/bonus], n_acc)."""
    p = _softmax_host(_filtered_logits_host(p_logits[: dl + 1], temperature, top_k, top_p))
    q = _softmax_host(_filtered_logits_host(q_logits[:dl], temperature, top_k, top_p))
    k_u, k_res = prng.split(key)
    u = prng.uniform(k_u, (max(dl, 1),))
    idx = np.arange(dl)
    d = np.asarray(drafts[:dl], np.int64)
    accept = u[:dl] * q[idx, d] < p[idx, d]  # u < p/q without the divide
    n_acc = int(np.cumprod(accept.astype(np.int64)).sum()) if dl else 0
    p_next = p[n_acc]
    q_next = q[min(n_acc, dl - 1)] if n_acc < dl else np.zeros_like(p_next)
    residual = np.maximum(p_next - q_next, 0.0)
    res_sum = float(residual.sum())
    dist = residual / res_sum if res_sum > 1e-9 else p_next
    return [int(t) for t in d[:n_acc]] + [prng.categorical(k_res, _log_host(dist))], n_acc

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



def speculative_tree_sample_host(
    key,
    nodes,  # (T,) int drafted token per node, BFS order
    parents,  # (T,) int parent node index per node (-1 = root)
    p_logits: np.ndarray,  # (>= T+1, V) target logits, window-indexed
    q_logits: np.ndarray,  # (>= T+1, V) draft logits, window-indexed
    temperature: float,
    top_k: int = 0,
    top_p: float = 1.0,
) -> Tuple[List[int], List[int], int]:
    """Lossless tree rejection sampling (multi-branch verify) for one
    request's round.  From the root, the residual starts as the filtered
    target distribution; each child (drawn i.i.d. from the filtered draft
    distribution, with replacement) is accepted with probability
    ``min(1, r(x) / q(x))``, and on rejection the residual becomes
    ``norm(max(r - q, 0))``.  When every child is rejected the final token
    is drawn from the residual; at fan-out 1 this is
    ``speculative_sample_host`` decision for decision.  Decision i (accept
    tests and the final draw, in walk order) takes ``fold_in(key, i)``.
    Returns (committed tokens [path + 1 residual/bonus], accepted node
    indices in path order, n_accepted)."""
    kids = tree_children(parents)
    committed: List[int] = []
    path: List[int] = []
    slot = 0  # current window slot (context position)
    decision = 0
    while True:
        p_w = _softmax_host(_filtered_logits_host(p_logits[slot], temperature, top_k, top_p))
        q_w = _softmax_host(_filtered_logits_host(q_logits[slot], temperature, top_k, top_p))
        r = p_w
        accepted = None
        for c in kids[slot]:
            tok = int(nodes[c])
            u = float(prng.uniform(prng.fold_in(key, decision)))
            decision += 1
            if u * q_w[tok] < r[tok]:  # u < r/q without the divide
                accepted = c
                break
            residual = np.maximum(r - q_w, 0.0)
            res_sum = float(residual.sum())
            r = residual / res_sum if res_sum > 1e-9 else r
        if accepted is not None:
            committed.append(int(nodes[accepted]))
            path.append(accepted)
            slot = 1 + accepted
            continue
        committed.append(prng.categorical(prng.fold_in(key, decision), _log_host(r)))
        return committed, path, len(path)

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


def sd_generate(
    key,
    target: LMInterface,
    target_params: Any,
    draft: LMInterface,
    draft_params: Any,
    prompt: torch.Tensor,  # (1, S) int32 on the models' device
    cfg: SDConfig,
) -> Tuple[torch.Tensor, SDStats]:
    """Single-request SD generator (host loop over the device forwards), greedy
    or sampled.  ``key`` is a ``prng`` key, split as the reference splits
    its ``jax.random`` key.  Returns (tokens (T,) int32 on the host,
    stats)."""
    l = cfg.draft_len
    # prefill all but the last prompt token: it is re-fed as the head of
    # every verify window / draft step, so the caches never hold a position
    # twice
    assert prompt.shape[1] >= 2, "prompt must have >= 2 tokens"
    _, t_cache = target.prefill(target_params, prompt[:, :-1])
    _, d_cache = draft.prefill(draft_params, prompt[:, :-1])
    out: List[int] = []
    emitted = drafted = accepted = rounds = 0
    last_tok = prompt[0, -1]
    sampled = cfg.temperature > 0.0

    while len(out) < cfg.max_tokens:
        # --- draft phase: the draft proposes l tokens autoregressively
        d_toks, q_rows = [], []
        cur = last_tok
        for _ in range(l):
            lg, d_cache = draft.extend(draft_params, cur.reshape(1, 1), d_cache)
            if sampled:
                key, sub = prng.split(key)
                nxt = categorical(sub, lg[0, -1].float() / cfg.temperature)
                q_rows.append(_probs(lg[0, -1], cfg.temperature))
            else:
                nxt = torch.argmax(lg[0, -1])
            d_toks.append(nxt.to(torch.int32))
            cur = d_toks[-1]
        draft_tokens = torch.stack(d_toks)
        # --- verify phase: the target scores [last_tok, drafts...] at once
        verify_in = torch.cat([last_tok.reshape(1), draft_tokens]).reshape(1, -1)
        vg, t_cache = target.extend(target_params, verify_in, t_cache)
        p_logits = vg[0]  # (l+1, V): position i predicts the token after draft i-1
        if sampled:
            key, sub = prng.split(key)
            toks, n_out, n_acc = speculative_sample(
                sub, draft_tokens, _probs(p_logits, cfg.temperature), torch.stack(q_rows))
        else:
            toks, n_out, n_acc = speculative_accept_greedy(draft_tokens, p_logits)
        new = [int(t) for t in toks[:n_out].tolist()]
        out.extend(new)
        rounds += 1
        drafted += l
        accepted += n_acc
        emitted += n_out
        # --- cache upkeep.  Between rounds each cache holds the committed
        # sequence minus its last token.  The target consumed l+1 positions:
        # keep n_acc drafts + the last_tok position.
        if l - n_acc > 0:
            t_cache = target.rewind(t_cache, l - n_acc)
        # the draft consumed [last_tok, d_0..d_{l-2}] (d_{l-1} was sampled,
        # never fed): keep n_acc drafts; when all were accepted, feed the
        # straggler d_{l-1} to complete the cache
        if n_acc == l:
            _, d_cache = draft.extend(draft_params, draft_tokens[-1].reshape(1, 1), d_cache)
        elif (l - 1) - n_acc > 0:
            d_cache = draft.rewind(d_cache, (l - 1) - n_acc)
        last_tok = torch.tensor(new[-1], dtype=torch.int32, device=prompt.device)

    stats = SDStats(emitted=emitted, rounds=rounds, drafted=drafted, accepted=accepted)
    return torch.tensor(out[: cfg.max_tokens], dtype=torch.int32), stats

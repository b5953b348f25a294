"""Copy-on-write prefix cache: a refcounted radix tree over prompt tokens
(torch counterpart of repro/serving/prefix_cache.py).

Many requests open with the same system prompt, so their prefills
recompute the same KV.  This module caches prompt prefixes at PAGE-BLOCK
granularity, one radix-tree node per ``page_size``-token block, and maps
a hit into the new request's page tables as READ-ONLY SHARED PAGES
(``PagedSequence`` shared-prefix support in ``paged_cache.py``), so the
shared span's prefill is skipped.

Contracts, as in the reference:

* **One tree per KV storage kind.**  Under ``kv_quant="mixed"`` an int8
  request's pages hold garbage in the fp store (and the reverse), so pages
  are shared only between requests of one kind.
* **A node is one full block**, keyed by the block's token ids.  It pins
  one page per pool role (``target`` / ``draft``) with a pool reference
  the tree holds until eviction, and keeps a host mirror of the block's
  dense (unquantized) KV per role.  The engine seeds a dense cache with the
  mirrored prefix and runs the tail prefill as an ``extend``, which gives
  the KV a full prefill would have (the page bytes, int8 or not, were made
  from the same dense rows).  The mirrors are CPU torch tensors in the
  model dtype (numpy has no bfloat16), page-locked for an engine on the
  card so that a hit's seed reaches the device at the link's full rate.
* **Partial matches** (the prompt diverges mid-block, or the cached block
  covers more than ``plen - 1`` tokens) map the last page partially; the
  holder copies it on write before its first scatter
  (``PagedSequence.cow_last_shared``), so the shared page is never
  written.
* **Refcounts at two levels.**  ``_Node.ref`` counts live requests matched
  through the node (``acquire`` / ``release`` from the batcher);
  ``PagedKVPool`` counts the page references (the tree's pin and every
  mapping sequence).  Donors hold no node reference: evicting a node whose
  donor still runs only drops the tree's page reference.
* **Eviction is LRU over zero-ref leaves** whose pages would free (pool
  refcount 1, only the tree holds them), driven by the batcher's admission
  retry under pool pressure.

Everything here is host bookkeeping: dict walks per admission, nothing on
the per-token path.
"""
from __future__ import annotations

import dataclasses
import itertools
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.serving.paged_cache import PagedKVPool

__all__ = ["PrefixCache", "PrefixMatch"]

Mirror = Tuple[torch.Tensor, torch.Tensor]  # (k, v), each (L, page_size, kvh, hd)


@dataclasses.dataclass
class _Node:
    """One full prompt block: its tokens, one pinned page per pool role,
    and a host mirror of the block's dense KV per role."""

    key: bytes
    tokens: np.ndarray  # int32 (page_size,)
    pages: Dict[str, int]
    mirrors: Dict[str, Mirror]
    parent: Optional["_Node"]
    children: Dict[bytes, "_Node"] = dataclasses.field(default_factory=dict)
    ref: int = 0  # live requests matched through this node
    tick: int = 0  # LRU clock (a counter, not wall time)


class PrefixMatch:
    """The longest cached prefix of one prompt: the node path, the tokens
    it covers (at most ``plen - 1``), the pages to map and the dense KV
    that seeds the tail prefill."""

    def __init__(self, kind: str, nodes: List[_Node], tokens_matched: int):
        self.kind = kind
        self.nodes = nodes
        self.tokens_matched = tokens_matched

    @property
    def partial(self) -> bool:
        """True when the last page is only partly covered: the mapping
        sequence copies it on write before its first write."""
        return self.tokens_matched % len(self.nodes[0].tokens) != 0

    def shared_pages(self, role: str) -> List[int]:
        return [n.pages[role] for n in self.nodes]

    def blocks(self, role: str) -> List[Mirror]:
        """Each matched node's mirrored (k, v) block, (L, page_size, kvh,
        hd) each; the last may be only partly matched."""
        return [n.mirrors[role] for n in self.nodes]

    def prefix_kv(self, role: str) -> Mirror:
        """Dense (k, v) of the matched prefix, each (L, m, kvh, hd) on the
        host: the seed for running the unshared tail as an ``extend``."""
        m = self.tokens_matched
        k = torch.cat([n.mirrors[role][0] for n in self.nodes], dim=1)
        v = torch.cat([n.mirrors[role][1] for n in self.nodes], dim=1)
        return k[:, :m], v[:, :m]


def _lcp(a: np.ndarray, b: np.ndarray) -> int:
    """Length of the longest common prefix of two int token arrays."""
    n = min(len(a), len(b))
    if n == 0:
        return 0
    neq = np.nonzero(a[:n] != b[:n])[0]
    return int(neq[0]) if len(neq) else n


class PrefixCache:
    """Radix tree of prompt blocks -> shared pages, one tree per KV kind.

    ``pools`` maps the pool roles (``"target"`` / ``"draft"``) to the
    ``PagedKVPool`` whose pages that role's nodes pin; every node carries
    one page per role, so a hit saves both pools' prefills.
    ``pin_memory`` keeps the mirrors page-locked (an engine on the card)."""

    def __init__(self, pools: Dict[str, PagedKVPool], page_size: int, pin_memory: bool = False):
        self.pools = dict(pools)
        self.page_size = page_size
        self.pin_memory = pin_memory
        self._roots: Dict[str, _Node] = {}
        self._clock = itertools.count(1)
        self.lookups = 0
        self.hits = 0
        self.tokens_saved = 0
        self.node_count = 0
        self.evictions = 0
        self.cow_copies = 0

    # -- lookup ---------------------------------------------------------------

    def _root(self, kind: str) -> _Node:
        root = self._roots.get(kind)
        if root is None:
            root = _Node(key=b"", tokens=np.zeros(0, np.int32), pages={}, mirrors={},
                         parent=None)
            self._roots[kind] = root
        return root

    def match(self, prompt, kind: str) -> Optional[PrefixMatch]:
        """Longest cached prefix of ``prompt`` in ``kind``'s tree, or None.
        Capped at ``len(prompt) - 1`` tokens: the last prompt token is
        re-fed for the first decode logits, so its KV row stays private."""
        self.lookups += 1
        prompt = np.asarray(prompt, np.int32)
        ps = self.page_size
        limit = len(prompt) - 1
        if limit < 1:
            return None
        node, nodes, m = self._root(kind), [], 0
        while m + ps <= limit:
            child = node.children.get(prompt[m: m + ps].tobytes())
            if child is None:
                break
            nodes.append(child)
            node = child
            m += ps
        # the divergence (or the cap) lies mid-block: take the child with
        # the longest common prefix of the remaining tokens; its page maps
        # partially and its holder copies it on write
        want = prompt[m:limit]
        best, best_r = None, 0
        for child in node.children.values():
            r = _lcp(child.tokens, want)
            if r > best_r:
                best, best_r = child, r
        if best is not None:
            nodes.append(best)
            m += best_r
        if m == 0:
            return None
        self.hits += 1
        return PrefixMatch(kind, nodes, m)

    # -- request refs ---------------------------------------------------------

    def acquire(self, match: PrefixMatch) -> None:
        """A matched request was admitted: pin its node path against
        eviction for its lifetime.  ``tokens_saved`` counts here, at
        admission, not at lookup: a stalled head may be matched again."""
        tick = next(self._clock)
        for node in match.nodes:
            node.ref += 1
            node.tick = tick
        self.tokens_saved += match.tokens_matched

    def release(self, match: PrefixMatch) -> None:
        """The matched request retired (finish or abort): unpin its path.
        Its page references are dropped by ``PagedSequence.release``; the
        tree's own pins stay until eviction."""
        tick = next(self._clock)
        for node in match.nodes:
            if node.ref <= 0:
                raise RuntimeError("prefix-cache release without acquire")
            node.ref -= 1
            node.tick = tick

    # -- insertion ------------------------------------------------------------

    def insert(self, prompt, kind: str, page_lists: Dict[str, List[int]],
               kv: Dict[str, Mirror], upto: int) -> int:
        """Donate a freshly prefilled request's full blocks to the tree.

        ``page_lists[role]`` is the donor's page table, ``kv[role]`` its
        dense (k, v) on the host covering at least ``upto`` rows, and
        ``upto`` its prefilled rows (``plen - 1``).  Only FULL blocks go in:
        the donor's own decode writes a partial tail block.  Blocks already
        present are skipped; a new node pins the donor's pages with a pool
        reference (the donor keeps its own; the last reference frees).
        Returns the nodes inserted."""
        prompt = np.asarray(prompt, np.int32)
        ps = self.page_size
        node, inserted = self._root(kind), 0
        tick = next(self._clock)
        for i in range(upto // ps):
            block = prompt[i * ps: (i + 1) * ps]
            key = block.tobytes()
            child = node.children.get(key)
            if child is None:
                pages = {role: page_lists[role][i] for role in self.pools}
                for role, page in pages.items():
                    self.pools[role].incref_page(page)
                mirrors = {role: tuple(self._host(a[:, i * ps: (i + 1) * ps]) for a in kv[role])
                           for role in self.pools}
                child = _Node(key=key, tokens=block.copy(), pages=pages, mirrors=mirrors,
                              parent=node)
                node.children[key] = child
                self.node_count += 1
                inserted += 1
            child.tick = tick
            node = child
        return inserted

    def _host(self, rows: torch.Tensor) -> torch.Tensor:
        """A host copy of ``rows`` that no later write to the source reaches."""
        out = torch.empty(rows.shape, dtype=rows.dtype, pin_memory=self.pin_memory)
        return out.copy_(rows)

    # -- eviction -------------------------------------------------------------

    def evict_one(self) -> int:
        """Free the least recently used evictable leaf; returns the pages
        freed (0 when nothing is evictable).  Evictable: no children, no
        live request refs, and every page's pool refcount 1 (only the tree
        holds it; evicting anything else frees no memory)."""
        best: Optional[_Node] = None
        stack = [child for root in self._roots.values() for child in root.children.values()]
        while stack:
            node = stack.pop()
            stack.extend(node.children.values())
            if node.children or node.ref > 0:
                continue
            if any(self.pools[role].page_ref(page) != 1 for role, page in node.pages.items()):
                continue
            if best is None or node.tick < best.tick:
                best = node
        if best is None:
            return 0
        for role, page in best.pages.items():
            self.pools[role]._give_page(page, back_to_reservation=False)
        del best.parent.children[best.key]
        self.node_count -= 1
        self.evictions += 1
        return len(best.pages)

    def evict_pages(self, want: int) -> int:
        """Evict until ``want`` pages were freed or nothing evictable is
        left; returns the pages freed."""
        freed = 0
        while freed < want:
            got = self.evict_one()
            if got == 0:
                break
            freed += got
        return freed

    # -- introspection --------------------------------------------------------

    @property
    def hit_rate(self) -> float:
        return self.hits / self.lookups if self.lookups else 0.0

    def pinned_pages(self) -> Dict[str, Dict[str, List[int]]]:
        """{kind: {role: page ids}} of every node of every tree: the pages
        no holder may write."""
        out: Dict[str, Dict[str, List[int]]] = {}
        for kind, root in self._roots.items():
            pages: Dict[str, List[int]] = {role: [] for role in self.pools}
            stack = list(root.children.values())
            while stack:
                node = stack.pop()
                stack.extend(node.children.values())
                for role, page in node.pages.items():
                    pages[role].append(page)
            out[kind] = pages
        return out

    def cached_pages(self) -> int:
        """Pages the tree pins (summed over roles)."""
        return self.node_count * len(self.pools)

    def stats(self) -> Dict[str, float]:
        return {
            "lookups": self.lookups,
            "hits": self.hits,
            "hit_rate": self.hit_rate,
            "tokens_saved": self.tokens_saved,
            "nodes": self.node_count,
            "evictions": self.evictions,
            "cow_copies": self.cow_copies,
        }

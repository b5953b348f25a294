"""Serving engine: the stepwise continuous-batching speculative-decoding
runtime (torch counterpart of repro/serving/engine.py: two-phase or fused
WDOS rounds, chain or tree, greedy or sampled, fixed or adaptive drafts).

``Engine`` admits requests at any time (``add_request``); each ``step()``
admits what fits, prefills it into both paged pools, and runs one round
over every active request.  ``abort`` frees a request's pages at once.

Two schedules (``EngineConfig.par_mode``, tokens the same in both):

* ``"off"``: two-phase rounds.  A chain round: the draft model proposes
  ``round_dl`` tokens per row in lockstep micro-steps (plus one straggler
  step), then ONE batched target pass verifies every row's window, and the
  host applies the accept rule and commits per row.  A tree round
  (``spec_mode="tree"``): each draft dispatch grows every row's tree by one
  level over a fixed window of ``tree_budget + 1`` slots, one
  ancestor-masked target pass verifies the trees, the multi-branch accept
  rule commits a root path per row, and the KV of an accepted non-leftmost
  path is copied into chain order.
* ``"wdos"``: each step runs a horizon of fused slots planned by
  core/scheduler.plan_mixed_slot.  In a slot the rows whose window (or
  tree) is full VERIFY on the target, with a fixed window of ``max_dl +
  1`` (chain) or ``tree_budget + 1`` (tree), while every other row DRAFTS
  one more token (or tree level); the target pass and the draft step run
  one after the other on the current stream, each with a per-row role mask
  that diverts the rows it does not serve to the pool's scratch page
  (models/layers.forward_cache_ctx).  A row's open window carries across
  steps (serving/request.py), so a short-window row commits several
  windows while a long-window neighbour drafts.

Draft lengths: fixed (``draft_len``), or under ``adaptive`` each request's
APSD controller picks ``short_dl`` or ``long_dl`` per window from its own
acceptance; admission reserves the longest (``max_dl``).

Sampled requests (``temperature > 0``) follow the reference: the draft
proposals of a chain round or slot in which any drafting row samples hop
through the host, where each sampled row draws from its own filtered
distribution with its own key stream (greedy rows take the argmax of the
same host row, so their tokens are those of an all-greedy batch), and the
host applies the lossless rejection rule (chain) or the multi-branch tree
rule with the draft rows kept per branch point.  All-greedy drafting keeps
the next-token argmax on the device.  Keys are indexed by committed rounds,
so neither the batch nor the schedule changes a request's tokens.  Stop
strings are matched at commit (serving/request.py); a stopped request
retires in the same round (on the WDOS paths, in the same slot).

KV storage (``kv_quant``): "none" keeps the model dtype, "int8" stores
int8 pages with one f32 scale per (slot, kv head), "mixed" allocates both
stores and each request picks its own (``SamplingParams.kv_quant``).  One
allocator serves both kinds, so a row's pages carry the same ids in both
stores; each dispatch runs once per store and the logits merge row-wise.

KV lives in device-resident paged pools (the allocator of
serving/paged_cache.py plus torch tensors): prefill scatters straight into
pool pages, each batched step writes its new tokens in place and attends
through per-row page tables, and accept/rewind is a per-row length update.
The reference donates its pools to XLA and rebinds them each step; here
the pools are updated in place and never copied.

Invariants carried over from the reference: a request's pages are reserved
and backed at admission, so its page-table row is stable for its lifetime;
a round writes at most ``max_dl + 1`` positions past the committed prefix
(a tree round its whole window) and rewinds to ``committed - 1``; inactive
and masked rows point every table slot at the pool's scratch page, and no
caller reads their logits.  Greedy tokens are per-row deterministic, so
batch composition never changes a request's output.

Not ported yet (refused with NotImplementedError): the prefix cache and
device-time profiling; the tracer and the flight recorder are absent.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core import scheduler as sch
from repro_torch.core.speculative import (
    LMInterface,
    sample_token_host,
    speculative_accept_greedy_host,
    speculative_sample_host,
    speculative_tree_accept_greedy_host,
    speculative_tree_sample_host,
    topk_tokens_host,
    tree_ancestor_mask,
    tree_depths,
)
from repro_torch.models import layers as L
from repro_torch.models import lm
from repro_torch.models.common import ModelConfig
from repro_torch.serving import quantized_lm as qlm
from repro_torch.serving.api import (
    CompletionOutput,
    EngineConfig,
    RequestOutput,
    SamplingParams,
    default_detokenize,
)
from repro_torch.serving.batcher import ContinuousBatcher
from repro_torch.serving.observability import MetricsRegistry
from repro_torch.serving.paged_cache import PagedKVPool, device_pool_store, pages_for
from repro_torch.serving.request import Request, RequestState

__all__ = [
    "Engine",
    "EngineConfig",
    "SamplingParams",
    "RequestOutput",
    "CompletionOutput",
    "ServingModel",
    "make_interface",
]


@dataclasses.dataclass
class ServingModel:
    cfg: ModelConfig
    params: Any
    mode: str = "w4a8"  # w4a8 (target) | bvq (draft)
    s_max: int = 512
    device: Any = "cuda"

    def __post_init__(self):
        if self.mode not in ("w4a8", "bvq"):
            raise NotImplementedError(
                f"serving mode {self.mode!r}: the port serves the w4a8 target and the bvq draft"
            )
        self.device = torch.device(self.device)

    def _apply(self, params, tokens, cache):
        fwd = qlm.apply_quantized_lm if self.mode == "w4a8" else qlm.apply_bvq_lm
        return fwd(params, self.cfg, tokens, cache=cache)


def make_interface(model: ServingModel) -> LMInterface:
    """Dense-cache prefill / extend / rewind over one model.  Rewinding
    moves the cache's length back; the rows past it are overwritten by the
    next extend and masked until then."""

    def prefill(params, tokens):
        cache = lm.init_cache(model.cfg, tokens.shape[0], model.s_max, model.device)
        return model._apply(params, tokens, cache)

    def extend(params, tokens, cache):
        return model._apply(params, tokens, cache)

    def rewind(cache, n):
        if n < 0:
            raise ValueError(f"rewind expects n >= 0, got {n}")
        if cache["length"] - n < 0:
            raise ValueError(f"over-rewind: cache length {cache['length']} < rewind {n}")
        return dict(cache, length=cache["length"] - n)

    return LMInterface(prefill=prefill, extend=extend, rewind=rewind)


def _wdos_costs(mcfg: ModelConfig) -> Tuple[float, float]:
    load = 12.0 * mcfg.d_model * mcfg.d_model * 1e-6  # ~per-layer weight bytes
    return load, 0.25 * load


def _pool_for(model: ServingModel, cfg: EngineConfig, peaks: Sequence[int]) -> PagedKVPool:
    """Page allocator sized to hold `max_batch` worst-case requests (or the
    explicit cfg.num_pages budget); the KV bytes live in device tensors."""
    mcfg = model.cfg
    if cfg.num_pages is not None:
        num_pages = cfg.num_pages
    else:
        worst = sorted((pages_for(p, cfg.page_size) for p in peaks), reverse=True)
        num_pages = sum(worst[: cfg.max_batch])
    return PagedKVPool(
        n_layers=mcfg.n_layers,
        kv_heads=L.kv_store_heads(mcfg),
        head_dim=mcfg.hd,
        num_pages=num_pages,
        page_size=cfg.page_size,
        dtype=mcfg.tdtype,
        alloc_storage=False,
        kv_quant=cfg.kv_quant,
    )


def _make_paged_step(model: ServingModel):
    """One batched paged forward: every batch slot is a row with its OWN
    page-table row and length.  New tokens (and, in an int8 store, their
    scales) are written into the store tensors in place; returns the
    logits.  A tree window passes ``win_pos`` (B, W) slot depths and
    ``tree_mask`` (B, W, W) ancestor masks (the reference's
    ``_make_tree_step``).  ``role_mask`` (B,) bool leaves only the rows it
    selects writing their own pages: a fused WDOS slot runs the target's
    step with the verifying rows' mask, then the draft's with the drafting
    rows' (the reference's fused and masked draft steps)."""

    def step(params, tokens, store, page_table, lengths, win_pos=None, tree_mask=None,
             role_mask=None):
        cache = {"lengths": lengths, "page_table": page_table, "attn": store}
        if tree_mask is not None:
            cache["win_pos"], cache["tree_mask"] = win_pos, tree_mask
        if role_mask is not None:
            cache["role_mask"] = role_mask
        logits, _ = model._apply(params, tokens, cache)
        return logits

    return step


def _scatter_prefill(store: Dict[str, torch.Tensor], k_dense: torch.Tensor,
                     v_dense: torch.Tensor, pages: torch.Tensor, n: int) -> None:
    """Write a freshly prefilled request's dense cache rows [0, n) into its
    pool pages, device to device, in place.  k_dense/v_dense: (L, s_max,
    kvh, hd); pages: (mp,) physical page ids of the request's table row.
    For an int8 store the rows quantize here (the rule the decode steps
    apply) and values and scales land together.  The reference scatters a
    fixed-width span and routes the slots outside [0, n) to the scratch
    page so it compiles once; eager torch writes the valid rows only."""
    nl, p1, ps, kvh, _ = store["k"].shape
    pos = torch.arange(n, device=pages.device)
    flat = pages.long()[pos // ps] * ps + pos % ps
    k_rows, v_rows = k_dense[:, :n], v_dense[:, :n]
    if "k_scale" in store:
        (kq, ks), (vq, vs) = L.kv_quantize(k_rows), L.kv_quantize(v_rows)
        writes = {"k": kq, "v": vq, "k_scale": ks, "v_scale": vs}
    else:
        writes = {"k": k_rows, "v": v_rows}
    for name, src in writes.items():
        pool = store[name]
        pool.view(nl, p1 * ps, kvh, pool.shape[-1])[:, flat] = src.to(pool.dtype)


def _compact_slots(store: Dict[str, torch.Tensor], src: torch.Tensor,
                   dst: torch.Tensor) -> None:
    """Copy flat pool slots ``src`` to ``dst`` in every tensor of a store
    (values and, for int8, scales), in place: the tree-verify compaction
    that moves an accepted non-leftmost path's KV from its BFS window slots
    to the chain positions the committed sequence expects.  ``flat[:, src]``
    is a gather into a new tensor, made before the write, so overlapping
    src/dst spans are safe."""
    for a in store.values():
        nl, p1, ps = a.shape[:3]
        flat = a.view(nl, p1 * ps, *a.shape[3:])
        flat[:, dst] = flat[:, src]


def _sample_tree_level(req: Request, cfg: EngineConfig, logits: np.ndarray) -> None:
    """Grow one request's draft tree by ONE level from its window logits
    (W, V): row 0 is the distribution after the committed tip, row 1+i
    after drafted node i.  Each frontier node (the deepest grown level)
    fans out to ``spec_branches`` children when the draft's top-1
    probability is below ``branch_threshold`` and the node budget covers
    the fan-out, else one child.  Greedy requests take the top-k tokens
    (child 0 is the argmax, so the chain is always a subtree); sampled
    requests draw i.i.d. children from their draft key stream indexed by
    ``tree_draws`` and keep the row in ``tree_q`` for the accept rule.
    When the budget runs out before any child lands, ``tree_depth`` jumps
    to ``tree_dl`` so the tree reads as full."""
    parents = req.tree_parents
    depths = tree_depths(parents, len(parents) + 1)
    d = req.tree_depth
    frontier = [0] if d == 0 else [1 + i for i in range(len(parents)) if depths[1 + i] == d]
    sp = req.sampling
    grew = False
    for slot in frontier:
        budget = cfg.tree_budget - len(req.tree_nodes)
        if budget <= 0:
            break
        row = logits[slot]
        # the draft's top-1 probability, in float64 on the host row as the
        # reference computes it, so branching decisions agree at a crossing
        conf = 1.0 / float(np.exp(row.astype(np.float64) - float(row.max())).sum())
        k = cfg.spec_branches if conf < cfg.branch_threshold and budget >= cfg.spec_branches else 1
        if sp.greedy:
            toks = topk_tokens_host(row, k)
        else:
            toks = [sample_token_host(req.draft_key(req.tree_draws + i), row, sp.temperature,
                                      sp.top_k, sp.top_p) for i in range(k)]
            req.tree_draws += k
            req.tree_q[slot] = row.copy()
        for t in toks:
            req.tree_parents.append(slot - 1)
            req.tree_nodes.append(int(t))
        grew = True
    req.tree_depth = d + 1 if grew else req.tree_dl


def _tree_window_rows(req: Request, width: int):
    """(tokens, depths, ancestor mask) window rows of one request's tree:
    slot 0 re-feeds the committed tip at depth 0, slot 1+i holds drafted
    node i at its depth; padded slots see only themselves."""
    toks = np.zeros((width,), np.int32)
    toks[0] = req.last_tok
    toks[1: 1 + len(req.tree_nodes)] = req.tree_nodes
    return toks, tree_depths(req.tree_parents, width), tree_ancestor_mask(req.tree_parents, width)


class _TableSet:
    """Host mirror of one pool's per-slot page tables / lengths.

    Page tables change only at admission/retirement (pages are backed
    eagerly), lengths every round; both are small int32 uploads.  The
    table width is sized by the engine's max_model_len."""

    def __init__(self, max_batch: int, pool: PagedKVPool, cap_tokens: int, device):
        self.device = device
        self.max_pages = pages_for(cap_tokens, pool.page_size)
        self.scratch = pool.num_pages  # device tensors have one extra page
        self.table = np.full((max_batch, self.max_pages), self.scratch, np.int32)
        self.lengths = np.zeros((max_batch,), np.int32)
        self._table_dev: Optional[torch.Tensor] = None

    def set_row(self, slot: int, seq) -> None:
        row = self.table[slot]
        row[:] = self.scratch
        row[: len(seq.pages)] = seq.pages
        self._table_dev = None

    def clear_row(self, slot: int) -> None:
        self.table[slot] = self.scratch
        self._table_dev = None

    def load(self, rows) -> Tuple[torch.Tensor, torch.Tensor]:
        """rows: iterable of (slot, PagedSequence) -> (table, lengths) on
        the device; inactive slots get length 0."""
        self.lengths[:] = 0
        for slot, seq in rows:
            self.lengths[slot] = seq.length
        return self.table_dev(), torch.as_tensor(self.lengths, device=self.device)

    def table_dev(self) -> torch.Tensor:
        if self._table_dev is None:
            self._table_dev = torch.as_tensor(self.table, device=self.device)
        return self._table_dev


class Engine:
    """Continuous-batching speculative-decoding engine over device-resident
    paged KV pools.

    Lifecycle::

        eng = Engine(target, draft, EngineConfig(max_batch=4), device="cuda")
        rid = eng.add_request(prompt, SamplingParams(max_tokens=32))
        while eng.has_unfinished():
            for out in eng.step():      # one batched SD round
                stream(out.new_token_ids)
        tokens = eng.output_tokens(rid)

    ``detokenize`` renders a token as text for stop-string matching
    (default: ``api.default_detokenize``).
    """

    def __init__(
        self,
        target: ServingModel,
        draft: ServingModel,
        config: Optional[EngineConfig] = None,
        device="cuda",
        detokenize: Optional[Callable[[int], str]] = None,
    ):
        cfg = config if config is not None else EngineConfig()
        unported = cfg.unported()
        if unported:
            raise NotImplementedError(f"EngineConfig settings not ported yet: {unported}")
        self.device = torch.device(device)
        for model in (target, draft):
            if model.device != self.device:
                raise ValueError(
                    f"{model.cfg.name} lives on {model.device}, the engine on {self.device}"
                )
        self.cfg = cfg
        self.target = target
        self.draft = draft
        self.max_model_len = (
            cfg.max_model_len
            if cfg.max_model_len is not None
            else min(target.s_max, draft.s_max)
        )
        for model in (target, draft):
            if self.max_model_len > model.s_max:
                raise ValueError(
                    f"max_model_len {self.max_model_len} exceeds "
                    f"s_max={model.s_max} of {model.cfg.name}"
                )
        worst = [self.max_model_len] * cfg.max_batch
        self._t_pool = _pool_for(target, cfg, worst)
        self._d_pool = _pool_for(draft, cfg, worst)
        # one store per storage kind over one allocator: under "mixed" a
        # request reads and writes only the store of its kind, and the other
        # store's copy of its pages holds unread garbage
        self._kinds = cfg.kv_kinds
        self._t_stores = {k: device_pool_store(self._t_pool, self.device, k) for k in self._kinds}
        self._d_stores = {k: device_pool_store(self._d_pool, self.device, k) for k in self._kinds}

        self.metrics = m = MetricsRegistry()
        self._m_table_upload = m.counter(
            "table_upload_seconds_total", "Host seconds uploading page tables / lengths",
        )
        self._m_tree_nodes = m.counter(
            "tree_nodes_total", "Draft-tree nodes proposed for verification (tree rounds)",
        )
        self._m_tree_branches = m.counter(
            "tree_branches_total",
            "Extra branches forked beyond a chain: fan-out minus one, summed over nodes",
        )
        self._m_tree_depth = m.histogram(
            "tree_accept_depth",
            "Depth of the accepted root path per tree round (the bonus token not counted)",
            buckets=(0.0, 1.0, 2.0, 3.0, 4.0, 6.0, 8.0, 12.0),
        )
        self._m_tree_compactions = m.counter(
            "tree_compactions_total",
            "Compaction calls moving an accepted non-leftmost path's KV into chain order",
        )
        self._m_host_copies = m.counter(
            "host_copies_total",
            "Device-to-host copies of logits or draft tokens in rounds (each waits for the device)",
        )
        for fam in (self._m_tree_nodes, self._m_tree_branches, self._m_tree_compactions,
                    self._m_host_copies):
            fam.inc(0)

        self._batcher = ContinuousBatcher(
            cfg, self._t_pool, self._d_pool,
            t_layers=target.cfg.n_layers, d_layers=draft.cfg.n_layers,
            t_costs=_wdos_costs(target.cfg), d_costs=_wdos_costs(draft.cfg),
            metrics=self.metrics,
        )
        self._t_iface, self._d_iface = make_interface(target), make_interface(draft)
        self._t_step, self._d_step = _make_paged_step(target), _make_paged_step(draft)
        # a tree round's fixed window: the committed tip + tree_budget nodes
        self._tree_width = cfg.tree_budget + 1
        self._t_tables = _TableSet(cfg.max_batch, self._t_pool, self.max_model_len, self.device)
        self._d_tables = _TableSet(cfg.max_batch, self._d_pool, self.max_model_len, self.device)
        self._requests: Dict[int, Request] = {}
        self._next_id = 0
        self._detokenize = detokenize if detokenize is not None else default_detokenize

    # -- request lifecycle ---------------------------------------------------

    def add_request(
        self,
        prompt,
        sampling_params: Optional[SamplingParams] = None,
        sink: Optional[Callable[[int], None]] = None,
    ) -> int:
        """Submit a prompt; returns its request id.  The batcher prefills it
        on the next ``step()`` once a slot and pages are free.  ``sink``
        receives each token as it becomes deliverable."""
        sp = sampling_params if sampling_params is not None else SamplingParams()
        req = Request(
            rid=self._next_id,
            prompt=np.asarray(prompt).reshape(-1),
            max_new_tokens=sp.max_tokens,
            sink=sink,
            sampling=sp,
            detokenize=self._detokenize,
            # ValueError when the request pins a kind this engine did not allocate
            kv_kind=self.cfg.resolve_kv_quant(sp.kv_quant),
        )
        peak = req.peak_cache_len(self.cfg.spec_window)
        if peak > self.max_model_len:
            raise ValueError(
                f"request peak cache length {peak} (prompt {req.prompt.shape[0]} "
                f"+ max_tokens {sp.max_tokens} + speculation window "
                f"{self.cfg.spec_window}) exceeds max_model_len={self.max_model_len}"
            )
        self._next_id += 1
        self._requests[req.rid] = req
        self._batcher.submit(req)
        return req.rid

    def abort(self, request_id: int) -> bool:
        """Cancel a request: a queued one is dropped, an active one retires
        at once and its pool pages return to the free list.  False if the id
        is unknown or already finished."""
        req = self._requests.get(request_id)
        if req is None or req.state is RequestState.FINISHED:
            return False
        if req.state is RequestState.QUEUED:
            return self._batcher.cancel_queued(request_id) is not None
        slot = self._batcher.slot_of(request_id)
        assert slot is not None, "active request without a slot"
        self._retire(slot, reason="abort")
        return True

    def has_unfinished(self) -> bool:
        return not self._batcher.all_done()

    def queue_depth(self) -> int:
        return len(self._batcher.queue)

    def num_active(self) -> int:
        return sum(1 for r in self._batcher.slots if r is not None)

    def request(self, request_id: int) -> Request:
        return self._requests[request_id]

    def output_tokens(self, request_id: int) -> torch.Tensor:
        req = self._requests[request_id]
        return torch.tensor(req.out[: req.max_new_tokens], dtype=torch.int32)

    def pool_stats(self):
        """(target PoolStats, draft PoolStats) — page residency right now."""
        return self._t_pool.stats(), self._d_pool.stats()

    def stats_snapshot(self) -> dict:
        """One JSON-safe stats view: queue and slots, rounds, acceptance,
        the KV storage mode and each pool's residency (bytes per kind)."""
        t_stats, d_stats = self.pool_stats()
        b = self._batcher
        return {
            "queued": self.queue_depth(),
            "active": self.num_active(),
            "max_batch": self.cfg.max_batch,
            "par_mode": self.cfg.par_mode,
            "spec_mode": self.cfg.spec_mode,
            "kv_quant": self.cfg.kv_quant,
            "steps": b.step_count,
            "rounds": b.rounds,
            "finished_requests": b.finished_count,
            "emitted_tokens": b.finished_emitted,
            "acceptance_rate": b.finished_accepted / max(b.finished_drafted, 1),
            "target_pool": dataclasses.asdict(t_stats),
            "draft_pool": dataclasses.asdict(d_stats),
        }

    # -- the stepwise round --------------------------------------------------

    def _prefill_into(self, req: Request, model: ServingModel, iface: LMInterface,
                      seq, store, tables: _TableSet, slot: int) -> None:
        """Prefill one request into one pool: back all its pages, run the
        dense-cache prefill over prompt[:-1] (the tip is re-fed by the first
        round), and scatter the cache rows into the request's pages."""
        plen = req.prompt.shape[0]
        seq.ensure_backed(seq.capacity_pages * seq.pool.page_size)
        tables.set_row(slot, seq)
        tokens = torch.as_tensor(req.prompt[None, :-1], device=self.device)
        _, cache = iface.prefill(model.params, tokens)
        _scatter_prefill(
            store, cache["attn"]["k"][:, 0], cache["attn"]["v"][:, 0],
            torch.as_tensor(tables.table[slot], device=self.device), plen - 1,
        )
        seq.advance(plen - 1)

    def _admit(self) -> None:
        """Admit whatever fits and prefill it into both pools (the store of
        the request's kind in each)."""
        for slot, req in self._batcher.admit():
            self._prefill_into(req, self.target, self._t_iface, req.t_seq,
                               self._t_stores[req.kv_kind], self._t_tables, slot)
            self._prefill_into(req, self.draft, self._d_iface, req.d_seq,
                               self._d_stores[req.kv_kind], self._d_tables, slot)
            req.state = RequestState.DECODE

    def _kvq_mask(self, active) -> Optional[torch.Tensor]:
        """(B,) bool device mask, True where the row's KV is int8, or None
        on a single-kind engine (one dispatch, no merge)."""
        if len(self._kinds) == 1:
            return None
        m = np.zeros((self.cfg.max_batch,), bool)
        for slot, req in active:
            m[slot] = req.kv_kind == "int8"
        return torch.as_tensor(m, device=self.device)

    def _dispatch(self, run: Callable[[str], Any], kvq):
        """One logical batched forward over every storage kind: ``run(kind)``
        calls the step on that kind's store(s) and returns its logits.  A single-kind engine calls it once; a mixed engine
        once per store, the logits merged row-wise by kind.  A row writes
        only its own pages of each store and reads only the store of its
        kind, so the other call leaves unread garbage, never corruption."""
        if kvq is None:
            return run(self._kinds[0])
        outs = {k: run(k) for k in self._kinds}
        return torch.where(kvq[:, None, None], outs["int8"], outs["none"])

    def _dev(self, a: np.ndarray) -> torch.Tensor:
        return torch.as_tensor(a, device=self.device)

    def _to_host(self, t: torch.Tensor) -> np.ndarray:
        """A round's device-to-host copy, counted in ``host_copies_total``."""
        self._m_host_copies.inc()
        return t.cpu().numpy()

    def _load_tables(self, active):
        t0 = time.perf_counter()
        d_table, d_len0 = self._d_tables.load((s, r.d_seq) for s, r in active)
        t_table, t_len0 = self._t_tables.load((s, r.t_seq) for s, r in active)
        self._m_table_upload.inc(time.perf_counter() - t0)
        return d_table, d_len0, t_table, t_len0

    def _table_devs(self):
        """(target, draft) page tables on the device for a WDOS step: one
        upload serves every slot (the rows retired mid-step are masked)."""
        t0 = time.perf_counter()
        tables = self._t_tables.table_dev(), self._d_tables.table_dev()
        self._m_table_upload.inc(time.perf_counter() - t0)
        return tables

    def _retire(self, slot: int, reason: str = "length") -> None:
        self._t_tables.clear_row(slot)
        self._d_tables.clear_row(slot)
        self._batcher.retire(slot, reason=reason)

    def step(self) -> List[RequestOutput]:
        """Admit what fits, then run ONE round over every active request: a
        two-phase chain or tree round, or under ``par_mode="wdos"`` a horizon
        of fused slots (which may commit several windows per request).
        Returns a ``RequestOutput`` per request active at the round's
        start."""
        self._admit()
        active = self._batcher.active()
        if active:
            tree = self.cfg.spec_mode == "tree"
            if self.cfg.par_mode == "wdos":
                (self._fused_tree_round if tree else self._fused_round)(active)
            else:
                (self._tree_round if tree else self._chain_round)(active)
                for slot, req in active:
                    if req.done:
                        self._retire(slot)
        self._batcher.step_count += 1
        return [self._output_for(req) for _, req in active]

    def _commit(self, req: Request, new: List[int], n_acc: int, dl: int, drafted: int,
                work: List[Tuple[Request, int]]) -> None:
        """Commit one verified window of ``dl`` (``drafted`` proposals; a
        tree's node count), record the round and step the request's APSD
        controller."""
        req.commit(new)
        req.record_round(req.controller.mode, dl, n_acc, len(new))
        req.rounds += 1
        req.drafted += drafted
        req.accepted += n_acc
        req.controller.observe(n_acc, dl)
        work.append((req, dl))

    def _chain_round(self, active) -> None:
        cfg = self.cfg
        dls = {slot: req.controller.draft_len() for slot, req in active}
        round_dl = max(dls.values())
        any_sampled = any(not req.sampling.greedy for _, req in active)
        kvq = self._kvq_mask(active)
        d_table, d_len0, t_table, t_len0 = self._load_tables(active)

        # ---- draft phase: round_dl proposal steps + 1 straggler step, all
        # batched.  An all-greedy batch keeps the next-token argmax on the
        # device; once any row samples, each proposal hops through the host,
        # where sampled rows draw from their own keys and greedy rows take
        # the argmax of the same f32 row (the first-max rule of both).
        cur = np.zeros((cfg.max_batch,), np.int32)
        for slot, req in active:
            cur[slot] = req.last_tok
        cur_dev = self._dev(cur)
        draft_cols: List[Any] = []
        q_cols: List[np.ndarray] = []  # per-position draft logits (sampled rounds)
        for j in range(round_dl + 1):
            logits = self._dispatch(lambda k: self._d_step(
                self.draft.params, cur_dev[:, None], self._d_stores[k], d_table, d_len0 + j), kvq)
            if j < round_dl:
                if any_sampled:
                    last = self._to_host(logits[:, -1, :].float())
                    q_cols.append(last)
                    nxt = np.argmax(last, axis=-1).astype(np.int32)
                    for slot, req in active:
                        sp = req.sampling
                        if not sp.greedy:
                            nxt[slot] = sample_token_host(req.draft_key(j), last[slot],
                                                          sp.temperature, sp.top_k, sp.top_p)
                    draft_cols.append(nxt)
                    cur_dev = self._dev(nxt)
                else:
                    cur_dev = torch.argmax(logits[:, -1, :], dim=-1).to(torch.int32)
                    draft_cols.append(cur_dev)
            # else: straggler — feeds d_{round_dl-1}, completing the cache for
            # fully-accepted rows; over-written rows rewind it away below.
        if any_sampled:
            drafts = np.stack(draft_cols, axis=1)
        else:
            drafts = self._to_host(torch.stack(draft_cols, dim=1))

        # ---- verify phase: one batched pass scoring [last_tok, drafts...]
        window = np.zeros((cfg.max_batch, round_dl + 1), np.int32)
        window[:, 0] = cur
        window[:, 1:] = drafts
        window_dev = self._dev(window)
        v_logits = self._dispatch(lambda k: self._t_step(
            self.target.params, window_dev, self._t_stores[k], t_table, t_len0), kvq)
        p_logits = self._to_host(v_logits.float())  # (B, round_dl+1, V)

        # ---- per-request accept / commit: a pure length update per row
        work: List[Tuple[Request, int]] = []
        for slot, req in active:
            dl = dls[slot]
            sp = req.sampling
            if sp.greedy:
                new, n_acc = speculative_accept_greedy_host(drafts[slot], p_logits[slot], dl)
            else:
                q_logits = np.stack([q_cols[j][slot] for j in range(dl)])
                new, n_acc = speculative_sample_host(
                    req.accept_key(), drafts[slot], p_logits[slot], q_logits, dl,
                    sp.temperature, sp.top_k, sp.top_p,
                )
            self._commit(req, new, n_acc, dl, dl, work)
            # both models wrote round_dl+1 positions; keep n_acc + 1
            # (draft invariant: cache == committed[:-1], incl. straggler)
            for seq in (req.t_seq, req.d_seq):
                seq.advance(round_dl + 1)
                seq.rewind(round_dl - n_acc, release_pages=False)
        self._batcher.model_round(work)

    # -- fused WDOS rounds (par_mode="wdos") ---------------------------------

    def _fused_round(self, active) -> None:
        """One chain round as a horizon of ``max_dl + 2`` fused slots (the
        dispatch budget of a two-phase round of the longest window).  Each
        slot the planner sends window-full rows to VERIFY (a target window
        of the fixed width ``max_dl + 1``, causally padded, while the draft
        side feeds the window's straggler) and every other row to DRAFT one
        proposal.  A row's open window carries across steps; a row that
        finishes retires in the slot that finished it."""
        cfg = self.cfg
        b, wv = cfg.max_batch, cfg.max_dl + 1
        # the kinds of the step's first actives cover every later slot (the
        # active set only shrinks inside a step)
        kvq = self._kvq_mask(active)
        t_table, d_table = self._table_devs()
        work: List[Tuple[Request, int]] = []
        for _ in range(cfg.max_dl + 2):
            active = self._batcher.active()
            if not active:
                break
            by_slot = dict(active)
            for _, req in active:
                if req.pending_dl is None:
                    req.begin_window(req.controller.draft_len())
            plan = sch.plan_mixed_slot([sch.RowPhase(slot=s, window=r.pending_dl,
                                                     drafted=len(r.pending)) for s, r in active])
            # every active row runs the draft step: a drafting row its next
            # proposal, a verifying row its window's straggler
            d_tok = np.zeros((b, 1), np.int32)
            d_len = np.zeros((b,), np.int32)
            d_mask = np.zeros((b,), bool)
            for slot, req in active:
                d_tok[slot, 0] = req.draft_tip
                d_len[slot] = req.d_seq.length + len(req.pending)
                d_mask[slot] = True
            d_tok, d_len, d_mask = self._dev(d_tok), self._dev(d_len), self._dev(d_mask)

            # a fused slot: the target's verify window over the verifying
            # rows, then the draft step over every active row, one after the
            # other on the current stream; each side's masked rows write only
            # its pool's scratch page
            t0 = time.perf_counter()
            v_logits = v_np = None
            if plan.verify_rows:
                v_tok = np.zeros((b, wv), np.int32)
                t_len = np.zeros((b,), np.int32)
                v_mask = np.zeros((b,), bool)
                for slot in plan.verify_rows:
                    req = by_slot[slot]
                    v_tok[slot, 0] = req.last_tok
                    v_tok[slot, 1: 1 + req.pending_dl] = req.pending
                    t_len[slot] = req.t_seq.length
                    v_mask[slot] = True
                v_tok, t_len, v_mask = self._dev(v_tok), self._dev(t_len), self._dev(v_mask)
                v_logits = self._dispatch(lambda k: self._t_step(
                    self.target.params, v_tok, self._t_stores[k], t_table, t_len,
                    role_mask=v_mask), kvq)
            d_logits = self._dispatch(lambda k: self._d_step(
                self.draft.params, d_tok, self._d_stores[k], d_table, d_len,
                role_mask=d_mask), kvq)
            if v_logits is not None:
                v_np = self._to_host(v_logits.float())  # (B, max_dl + 1, V)
            # only drafting rows read the draft logits: the argmax on the
            # device when none of them samples, else the f32 rows
            if plan.draft_rows:
                last = d_logits[:, -1, :]
                if all(by_slot[s].sampling.greedy for s in plan.draft_rows):
                    q_np, nxt = None, self._to_host(torch.argmax(last, dim=-1).to(torch.int32))
                else:
                    q_np = self._to_host(last.float())
                    nxt = np.argmax(q_np, axis=-1)
            self._batcher.record_fused_slot(plan, time.perf_counter() - t0, wv)

            # drafting rows: append the next proposal (the two-phase rule and
            # the same (round, position) keys, so tokens match across modes)
            for slot in plan.draft_rows:
                req = by_slot[slot]
                sp = req.sampling
                if sp.greedy:
                    req.pending.append(int(nxt[slot]))
                else:
                    req.pending.append(int(sample_token_host(
                        req.draft_key(len(req.pending)), q_np[slot],
                        sp.temperature, sp.top_k, sp.top_p)))
                    req.pending_q.append(q_np[slot].copy())

            # verifying rows: accept / commit, then back to committed - 1
            for slot in plan.verify_rows:
                req = by_slot[slot]
                dl, sp = req.pending_dl, req.sampling
                drafts = np.asarray(req.pending, np.int64)
                if sp.greedy:
                    new, n_acc = speculative_accept_greedy_host(drafts, v_np[slot], dl)
                else:
                    new, n_acc = speculative_sample_host(
                        req.accept_key(), drafts, v_np[slot], np.stack(req.pending_q), dl,
                        sp.temperature, sp.top_k, sp.top_p,
                    )
                self._commit(req, new, n_acc, dl, dl, work)
                # the target wrote wv positions, the draft dl + 1 (with the
                # straggler); both keep n_acc + 1
                req.t_seq.advance(wv)
                req.t_seq.rewind(wv - 1 - n_acc, release_pages=False)
                req.d_seq.advance(dl + 1)
                req.d_seq.rewind(dl - n_acc, release_pages=False)
                req.clear_window()
                if req.done:
                    self._retire(slot)
        self._batcher.model_round(work)

    def _fused_tree_round(self, active) -> None:
        """One tree round as a horizon of ``min(max_dl, tree_budget) + 2``
        fused slots: tree-full rows VERIFY (the ancestor-masked target
        window) while every active row re-feeds its tree on the draft side
        (for a verifying row the straggler that lands the leaf KV; for the
        others one more level).  Accepted non-leftmost paths are compacted
        before the next slot, since a committed row's next window overlaps
        its old slots."""
        cfg = self.cfg
        b, w = cfg.max_batch, self._tree_width
        kvq = self._kvq_mask(active)
        t_table, d_table = self._table_devs()
        work: List[Tuple[Request, int]] = []
        for _ in range(min(cfg.max_dl, cfg.tree_budget) + 2):
            active = self._batcher.active()
            if not active:
                break
            by_slot = dict(active)
            for _, req in active:
                if req.tree_dl is None:
                    req.begin_tree(min(req.controller.draft_len(), cfg.tree_budget))
            plan = sch.plan_mixed_slot([sch.RowPhase(slot=s, window=r.tree_dl,
                                                     drafted=r.tree_depth) for s, r in active])
            d_len = np.zeros((b,), np.int32)
            d_mask = np.zeros((b,), bool)
            for slot, req in active:
                d_len[slot] = req.d_seq.length
                d_mask[slot] = True
            d_win, d_len, d_mask = self._tree_inputs(active), self._dev(d_len), self._dev(d_mask)

            # a fused slot as in the chain round, over tree windows
            t0 = time.perf_counter()
            v_logits = v_np = d_np = None
            if plan.verify_rows:
                t_len = np.zeros((b,), np.int32)
                v_mask = np.zeros((b,), bool)
                for slot in plan.verify_rows:
                    t_len[slot] = by_slot[slot].t_seq.length
                    v_mask[slot] = True
                v_win = self._tree_inputs([(s, by_slot[s]) for s in plan.verify_rows])
                t_len, v_mask = self._dev(t_len), self._dev(v_mask)
                v_logits = self._dispatch(lambda k: self._t_step(
                    self.target.params, v_win[0], self._t_stores[k], t_table, t_len, *v_win[1:],
                    role_mask=v_mask), kvq)
            d_logits = self._dispatch(lambda k: self._d_step(
                self.draft.params, d_win[0], self._d_stores[k], d_table, d_len, *d_win[1:],
                role_mask=d_mask), kvq)
            if v_logits is not None:
                v_np = self._to_host(v_logits.float())  # (B, W, V)
            if plan.draft_rows:  # tree growth reads every frontier row
                d_np = self._to_host(d_logits.float())
            self._batcher.record_fused_slot(plan, time.perf_counter() - t0, w, draft_width=w)

            for slot in plan.draft_rows:
                _sample_tree_level(by_slot[slot], cfg, d_np[slot])
            moves_t = {k: ([], []) for k in self._kinds}
            moves_d = {k: ([], []) for k in self._kinds}
            for slot in plan.verify_rows:
                req = by_slot[slot]
                self._tree_verify_commit(req, v_np[slot], req.tree_dl, moves_t, moves_d, work)
                if req.done:
                    self._retire(slot)
            self._compact_pools(moves_t, moves_d)
        self._batcher.model_round(work)

    # -- tree speculation (spec_mode="tree") ---------------------------------

    def _tree_inputs(self, rows):
        """(tokens, depths, ancestor masks) on the device, (B, W[, W]), for
        the tree windows of the (slot, request) ``rows``; every other row
        sees only itself, so its softmax stays finite."""
        b, w = self.cfg.max_batch, self._tree_width
        tok = np.zeros((b, w), np.int32)
        pos = np.zeros((b, w), np.int32)
        tm = np.zeros((b, w, w), np.float32)
        tm[:, np.arange(w), np.arange(w)] = 1.0
        for slot, req in rows:
            tok[slot], pos[slot], tm[slot] = _tree_window_rows(req, w)
        return self._dev(tok), self._dev(pos), self._dev(tm)

    def _tree_round(self, active) -> None:
        """One tree round: grow every active row's draft tree one LEVEL per
        draft dispatch (the whole fixed window re-fed at the same base
        length, so each level's frontier attends its ancestors through the
        tree mask), plus one straggler dispatch that lands the leaf KV; then
        verify every tree in ONE tree-masked target dispatch, walk the
        multi-branch accept rule per row, and compact accepted non-leftmost
        paths into chain order."""
        cfg = self.cfg
        dls = {slot: min(req.controller.draft_len(), cfg.tree_budget) for slot, req in active}
        round_depth = max(dls.values())
        kvq = self._kvq_mask(active)
        d_table, d_len0, t_table, t_len0 = self._load_tables(active)
        for slot, req in active:
            req.begin_tree(dls[slot])

        for j in range(round_depth + 1):
            win = self._tree_inputs(active)
            logits = self._dispatch(lambda k: self._d_step(
                self.draft.params, win[0], self._d_stores[k], d_table, d_len0, *win[1:]), kvq)
            if j < round_depth:
                l_np = self._to_host(logits.float())
                for slot, req in active:
                    if not req.tree_full:
                        _sample_tree_level(req, cfg, l_np[slot])
        win = self._tree_inputs(active)
        v_logits = self._dispatch(lambda k: self._t_step(
            self.target.params, win[0], self._t_stores[k], t_table, t_len0, *win[1:]), kvq)
        p_logits = self._to_host(v_logits.float())  # (B, W, V)

        work: List[Tuple[Request, int]] = []
        moves_t = {k: ([], []) for k in self._kinds}
        moves_d = {k: ([], []) for k in self._kinds}
        for slot, req in active:
            self._tree_verify_commit(req, p_logits[slot], dls[slot], moves_t, moves_d, work)
        self._compact_pools(moves_t, moves_d)
        self._batcher.model_round(work)

    def _tree_verify_commit(self, req: Request, p_win: np.ndarray, dl: int,
                            moves_t, moves_d, work) -> None:
        """Accept / commit one verified tree row: the multi-branch accept
        rule over the window logits (W, V), greedy or lossless sampling (the
        draft rows of the branch points in a zero-padded (W, V) q window),
        commits the accepted root path plus the target's next token; queue
        the compaction moves that relocate the path's BFS slots to the chain
        positions; advance both sequences by the window and rewind back to
        committed - 1."""
        w = self._tree_width
        sp = req.sampling
        nodes, parents = req.tree_nodes, req.tree_parents
        if sp.greedy:
            new, path, n_acc = speculative_tree_accept_greedy_host(nodes, parents, p_win)
        else:
            q_win = np.zeros((w, p_win.shape[-1]), np.float32)
            for qslot, row in req.tree_q.items():
                q_win[qslot] = row
            new, path, n_acc = speculative_tree_sample_host(
                req.accept_key(), nodes, parents, p_win, q_win,
                sp.temperature, sp.top_k, sp.top_p,
            )
        self._commit(req, new, n_acc, dl, len(nodes), work)
        self._m_tree_nodes.inc(len(nodes))
        # a chain of n nodes has n distinct parents; each repeat is a fork
        self._m_tree_branches.inc(len(nodes) - len(set(parents)))
        self._m_tree_depth.observe(n_acc)
        # the accepted path sits at window slots base+1+path[i]; the chain
        # needs it at base+1+i.  RoPE agrees by construction: path[i] is a
        # depth-(i+1) node, encoded at position base+1+i, its destination.
        if path != list(range(n_acc)):
            for seq, mv in ((req.t_seq, moves_t[req.kv_kind]), (req.d_seq, moves_d[req.kv_kind])):
                base = seq.length
                mv[0].extend(seq.flat_slots(base + 1 + np.asarray(path, np.int64)).tolist())
                mv[1].extend(seq.flat_slots(base + 1 + np.arange(n_acc, dtype=np.int64)).tolist())
        # both models wrote the whole W-wide window; keep n_acc + 1
        # (draft invariant: cache == committed[:-1], incl. the straggler)
        for seq in (req.t_seq, req.d_seq):
            seq.advance(w)
            seq.rewind(w - 1 - n_acc, release_pages=False)
        req.clear_tree()

    def _compact_pools(self, moves_t, moves_d) -> None:
        """Run the queued compaction moves: one ``_compact_slots`` call per
        (pool, kind) that has any, each counted in
        ``tree_compactions_total``."""
        for moves, stores in ((moves_t, self._t_stores), (moves_d, self._d_stores)):
            for kind, (src, dst) in moves.items():
                if src:
                    _compact_slots(stores[kind], torch.as_tensor(src, device=self.device),
                                   torch.as_tensor(dst, device=self.device))
                    self._m_tree_compactions.inc()

    def _output_for(self, req: Request) -> RequestOutput:
        """One streaming RequestOutput: the tokens delivered this step plus
        the cumulative completion."""
        return RequestOutput(
            request_id=req.rid,
            prompt_token_ids=[int(t) for t in req.prompt],
            new_token_ids=req.take_delta(),
            finished=req.state is RequestState.FINISHED,
            outputs=[CompletionOutput(
                index=0,
                token_ids=[int(t) for t in req.out[: req.emittable_len()]],
                finish_reason=req.finish_reason,
            )],
        )

    def run(
        self,
        prompts: Optional[Sequence[Any]] = None,
        sampling_params=None,
    ) -> Tuple[List[torch.Tensor], dict]:
        """Drain loop: optionally add `prompts` (one shared or per-prompt
        ``SamplingParams``), then ``step()`` until nothing is queued or
        active.  Returns (outputs for the added prompts — or every request
        this engine has seen — in submission order, summary)."""
        rids = None
        if prompts is not None:
            n = len(prompts)
            if sampling_params is None or isinstance(sampling_params, SamplingParams):
                sps = [sampling_params] * n
            else:
                sps = list(sampling_params)
                if len(sps) != n:
                    raise ValueError(f"{len(sps)} sampling_params for {n} prompts")
            rids = [self.add_request(p, sps[i]) for i, p in enumerate(prompts)]
        while self.has_unfinished():
            self.step()
        ids = rids if rids is not None else sorted(self._requests)
        return [self.output_tokens(r) for r in ids], self.summary()

    def summary(self) -> dict:
        s = self._batcher.summary()
        s["kv_path"] = "paged"
        s["par_mode"] = self.cfg.par_mode
        s["kv_quant"] = self.cfg.kv_quant
        s["spec_mode"] = self.cfg.spec_mode
        s["kv_bytes_per_token"] = {
            "target": self._t_pool.bytes_per_token_by_kind(),
            "draft": self._d_pool.bytes_per_token_by_kind(),
        }
        s["tree"] = {
            "nodes": self._m_tree_nodes.value(),
            "branches": self._m_tree_branches.value(),
            "compactions": self._m_tree_compactions.value(),
        }
        s["table_upload_s"] = self._m_table_upload.value()
        s["host_copies"] = self._m_host_copies.value()
        return s

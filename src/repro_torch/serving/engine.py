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

Prefix cache (``EngineConfig.prefix_cache``): admission maps the longest
cached prefix of a prompt as read-only shared pages in both pools
(serving/prefix_cache.py, serving/batcher.py), and the prefill runs only
the unshared tail, over a dense cache seeded with the tree's host mirrors
of the prefix, after copying a partially shared last page on write
(``_prefill_into``); a full hit runs no forward.  Each new full block of a
prefilled prompt is donated to the tree.

Observability (the reference's): the engine's metric families in a
``MetricsRegistry`` shared with the batcher and the HTTP server; spans and
instants on a ``Tracer`` (``trace=``, off by default); a ``FlightRecorder``
of per-round records (``EngineConfig.flight_ring``); and, every
``profile_every_n``-th round, each dispatched program bracketed by device
synchronizations and timed on the engine's clock (``_profiled``,
``profile_summary``).  None of it changes a token.

The deprecated run-to-drain wrappers ``serve_sd``, ``serve_apsd`` and
``serve_batch`` survive as thin wrappers over ``Engine`` (each warns once);
``serve_batch(kv_path="host")`` and ``serve_batch_host`` run the frozen
legacy host-gather loop (serving/host_gather.py), the benchmark baseline.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core import scheduler as sch
from repro_torch.core.costs import compaction_cost, prefill_cost, window_cost
from repro_torch.core.apsd import PAR, APSDConfig, APSDStats, RoundRecord
from repro_torch.core.speculative import (
    LMInterface,
    SDConfig,
    SDStats,
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
    resolve_paged_attn_impl,
    warn_deprecated_once,
)
from repro_torch.serving.batcher import BatchConfig, ContinuousBatcher
from repro_torch.serving.flight_recorder import FlightRecorder
from repro_torch.serving.observability import LATENCY_BUCKETS, RATIO_BUCKETS, MetricsRegistry
from repro_torch.serving.paged_cache import (
    PagedKVPool,
    device_pool_store,
    num_pages_for_bytes,
    pages_for,
)
from repro_torch.serving.prefix_cache import PrefixCache
from repro_torch.serving.request import Request, RequestState
from repro_torch.serving.tracing import NULL_TRACER, Tracer

__all__ = [
    "Engine",
    "EngineConfig",
    "SamplingParams",
    "RequestOutput",
    "CompletionOutput",
    "ServingModel",
    "make_interface",
    "serve_sd",
    "serve_apsd",
    "serve_batch",
    "serve_batch_host",
    "BatchConfig",
]


# the forward of each serving mode: the W4A8 target, the BVQ draft (dense
# SwiGLU blocks, qk-norm included), and a model served in its own dtype, of
# any attention family (dense, VLM, MoE: launch/serve.build_arch_pair and
# build_pair with quantize=False)
_FORWARDS = {"w4a8": qlm.apply_quantized_lm, "bvq": qlm.apply_bvq_lm, "bf16": lm.apply_lm}


def resolve_device(device) -> torch.device:
    """``device`` with its index made explicit: an index-less "cuda" is the
    current CUDA device of the calling thread.  The current device is per
    thread in torch, so a thread that drives the engine (the async front
    end's worker) makes this index current first."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return device


@dataclasses.dataclass
class ServingModel:
    cfg: ModelConfig
    params: Any
    mode: str = "bf16"  # bf16 (dense, VLM or MoE) | w4a8 (target) | bvq (draft)
    s_max: int = 512
    device: Any = "cuda"

    def __post_init__(self):
        if self.mode not in _FORWARDS:
            raise ValueError(f"serving mode {self.mode!r} is not one of {sorted(_FORWARDS)}")
        self.device = resolve_device(self.device)

    def _apply(self, params, tokens, cache):
        return _FORWARDS[self.mode](params, self.cfg, tokens, cache=cache)


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
    # the reference's model of a layer's weight bytes (12 d^2, MHA SwiGLU),
    # kept as it is for every family so the modelled WDOS overlap matches it
    load = 12.0 * mcfg.d_model * mcfg.d_model * 1e-6  # ~per-layer weight bytes
    return load, 0.25 * load


def _pool_for(model: ServingModel, cfg, peaks: Sequence[int],
              alloc_storage: bool = False) -> PagedKVPool:
    """Page pool sized to hold `max_batch` worst-case requests, or the
    explicit cfg.num_pages budget, or the pages cfg.pool_bytes buys in the
    bytes of the pool's storage kinds (an int8 page with its scales is
    ~3.5x smaller than an f32 one).  ``cfg`` is an ``EngineConfig`` or the
    legacy host loop's ``BatchConfig`` (no byte budget, dense pages).  The
    KV bytes live in device tensors, or with ``alloc_storage`` in the
    pool's own host storage (serving/host_gather.py)."""
    mcfg = model.cfg
    kv_quant = getattr(cfg, "kv_quant", "none")
    if getattr(cfg, "pool_bytes", None) is not None:
        num_pages = num_pages_for_bytes(
            cfg.pool_bytes, n_layers=mcfg.n_layers, kv_heads=L.kv_store_heads(mcfg),
            head_dim=mcfg.hd, page_size=cfg.page_size, dtype=mcfg.tdtype,
            kv_quant=kv_quant,
        )
    elif cfg.num_pages is not None:
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
        alloc_storage=alloc_storage,
        kv_quant=kv_quant,
    )


# the legacy host loop (serving/host_gather.py) calls the accept rule by
# this name, as the reference's does
_greedy_accept_host = speculative_accept_greedy_host


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
                     v_dense: torch.Tensor, pages: torch.Tensor, n: int, start: int = 0) -> None:
    """Write a freshly prefilled request's dense cache rows [start, n) into
    its pool pages, device to device, in place.  k_dense/v_dense: (L,
    s_max, kvh, hd); pages: (mp,) physical page ids of the request's table
    row.  A prefix-cache hit passes start = tokens matched, so the shared
    prefix pages (whose rows are resident already, and which the donor, the
    tree and other rows read) are never written.  For an int8 store the
    rows quantize here (the rule the decode steps apply) and values and
    scales land together.  The reference scatters a fixed-width span and
    routes the slots outside [start, n) to the scratch page so it compiles
    once; eager torch writes the valid rows only."""
    nl, p1, ps, kvh, _ = store["k"].shape
    pos = torch.arange(start, n, device=pages.device)
    flat = pages.long()[pos // ps] * ps + pos % ps
    k_rows, v_rows = k_dense[:, start:n], v_dense[:, start:n]
    if "k_scale" in store:
        (kq, ks), (vq, vs) = L.kv_quantize(k_rows), L.kv_quantize(v_rows)
        writes = {"k": kq, "v": vq, "k_scale": ks, "v_scale": vs}
    else:
        writes = {"k": k_rows, "v": v_rows}
    for name, src in writes.items():
        pool = store[name]
        pool.view(nl, p1 * ps, kvh, pool.shape[-1])[:, flat] = src.to(pool.dtype)


def _copy_page(store: Dict[str, torch.Tensor], src: int, dst: int) -> None:
    """Copy one physical page in every tensor of a store (values and, for
    int8, scales), in place: the copy-on-write that privatizes a partially
    shared prefix page before its holder's first write."""
    for a in store.values():
        a[:, dst] = a[:, src]


def _pull_mirror(k_dense: torch.Tensor, v_dense: torch.Tensor, n: int):
    """A donor's dense rows [0, n) of one model, (L, n, kvh, hd) each,
    copied to the host for the prefix cache's mirrors."""
    return k_dense[:, :n].cpu(), v_dense[:, :n].cpu()


def _push_mirror(match, role: str, k_dst: torch.Tensor, v_dst: torch.Tensor) -> None:
    """Copy the matched prefix's mirrored rows [0, m) into k_dst / v_dst
    (L, >= m, kvh, hd) on the device, one copy per block (asynchronous
    from page-locked mirrors; the host allocator keeps a mirror alive
    until its copy is done)."""
    m = match.tokens_matched
    for j, (kb, vb) in enumerate(match.blocks(role)):
        lo = j * kb.shape[1]
        n = min(kb.shape[1], m - lo)
        k_dst[:, lo:lo + n].copy_(kb[:, :n], non_blocking=True)
        v_dst[:, lo:lo + n].copy_(vb[:, :n], non_blocking=True)


def _seeded_cache(model: "ServingModel", match, role: str, device) -> Dict[str, Any]:
    """A one-row dense cache holding the matched prefix's mirrored rows at
    length m: the start of a hit's tail extend."""
    cache = lm.init_cache(model.cfg, 1, model.s_max, device)
    _push_mirror(match, role, cache["attn"]["k"][:, 0], cache["attn"]["v"][:, 0])
    cache["length"] = match.tokens_matched
    return cache


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
    (default: ``api.default_detokenize``).  ``metrics`` shares a registry
    (the batcher's and the server's families live in the same one);
    ``trace`` records spans and instants, on whose clock the engine then
    runs.
    """

    def __init__(
        self,
        target: ServingModel,
        draft: ServingModel,
        config: Optional[EngineConfig] = None,
        device="cuda",
        detokenize: Optional[Callable[[int], str]] = None,
        metrics: Optional[MetricsRegistry] = None,
        trace: Optional[Tracer] = None,
    ):
        cfg = config if config is not None else EngineConfig()
        if cfg.paged_attn_impl is not None:
            resolve_paged_attn_impl(cfg.paged_attn_impl)  # the reference's check
        self.device = resolve_device(device)
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
        # copy-on-write prefix cache: a refcounted radix tree over prompt
        # blocks whose hits map read-only shared pages in both pools
        # (serving/prefix_cache.py; admission in the batcher, the hit-path
        # prefill in _prefill_into)
        self._prefix: Optional[PrefixCache] = None
        if cfg.prefix_cache:
            self._prefix = PrefixCache({"target": self._t_pool, "draft": self._d_pool},
                                       cfg.page_size, pin_memory=self.device.type == "cuda")

        # observability: one registry for the engine, the batcher and the
        # server; the tracer's clock, when it is on, is the engine's, so
        # request times and spans share a timebase
        self.metrics = metrics if metrics is not None else MetricsRegistry()
        self.tracer = trace if trace is not None else NULL_TRACER
        if self.tracer.enabled:
            self._now = self.tracer.now
        else:
            _t0 = time.perf_counter()
            self._now = lambda: time.perf_counter() - _t0
        self._init_metrics()
        # sampled device-time profiling (_profiled): per program name the
        # one-time cost stamp, the summed wall seconds and the call count
        self._profile_every = cfg.profile_every_n
        self._profile_round = False
        self._round_idx = 0
        self._prog_flops: Dict[str, float] = {}
        self._prog_bytes: Dict[str, float] = {}
        self._prog_wall: Dict[str, float] = {}
        self._prog_calls: Dict[str, int] = {}
        # a ring of per-round records fed at every round's end, empty
        # rounds included (serving/flight_recorder.py)
        self.flight = FlightRecorder(cfg.flight_ring, metrics=self.metrics, tracer=self.tracer,
                                     dump_dir=cfg.flight_dump_dir)

        self._batcher = ContinuousBatcher(
            cfg, self._t_pool, self._d_pool,
            t_layers=target.cfg.n_layers, d_layers=draft.cfg.n_layers,
            t_costs=_wdos_costs(target.cfg), d_costs=_wdos_costs(draft.cfg),
            metrics=self.metrics, prefix_cache=self._prefix,
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

    # -- observability -------------------------------------------------------

    def _init_metrics(self) -> None:
        """Register the engine's metric families, the reference's (its
        docs/OBSERVABILITY.md is the catalog) plus ``host_copies_total``.
        Registration is idempotent, so engines may share a registry."""
        m = self.metrics
        self._m_submitted = m.counter("requests_submitted_total", "Requests accepted by add_request")
        self._m_steps = m.counter("steps_total", "Engine steps executed")
        self._m_emitted = m.counter("tokens_emitted_total", "Tokens delivered to consumers")
        self._m_drafted = m.counter("tokens_drafted_total", "Draft tokens proposed")
        self._m_accepted = m.counter("tokens_accepted_total", "Draft tokens accepted by verification")
        self._m_table_upload = m.counter(
            "table_upload_seconds_total", "Host seconds uploading page tables / lengths",
        )
        self._m_accept_rate = m.gauge("acceptance_rate", "Cumulative accepted/drafted fraction")
        self._m_queue_depth = m.gauge("queue_depth", "Requests waiting for admission (QUEUED)")
        self._m_active = m.gauge("active_requests", "Requests holding a decode slot")
        self._m_pool_pages = m.gauge("pool_pages", "Paged-KV pool residency", ("pool", "state"))
        self._m_kv_bytes = m.gauge(
            "kv_bytes_total",
            "Bytes resident in allocated paged-KV pages (per storage dtype; int8 includes "
            "its f32 per-slot scales)", ("pool", "dtype"),
        )
        self._m_kv_bytes_per_token = m.gauge(
            "kv_bytes_per_token", "K+V bytes one cached token occupies (per storage dtype)",
            ("pool", "dtype"),
        )
        self._m_ttft = m.histogram("ttft_seconds", "Submit -> first delivered token",
                                   buckets=LATENCY_BUCKETS)
        self._m_itl = m.histogram(
            "itl_seconds",
            "Gap between successive token deliveries of one request (one observation per "
            "non-empty delta)", buckets=LATENCY_BUCKETS,
        )
        self._m_round_wall = m.histogram("round_wall_seconds", "Wall time of one engine step",
                                         buckets=LATENCY_BUCKETS)
        self._m_admission_wait = m.histogram(
            "admission_wait_seconds", "Submit -> admission into a decode slot",
            buckets=LATENCY_BUCKETS,
        )
        self._m_round_accept = m.histogram("round_acceptance", "Per-round accepted/drafted fraction",
                                           buckets=RATIO_BUCKETS)
        # tree families, registered and materialized at zero on every engine
        # so the catalog and the scrape are stable
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
        for fam in (self._m_tree_nodes, self._m_tree_branches, self._m_tree_compactions):
            fam.inc(0)
        # prefix-cache families, registered whether or not the cache is on
        self._m_prefix_hit_rate = m.gauge(
            "prefix_hit_rate", "Prefix-cache hit fraction over admission lookups",
        )
        self._m_shared_pages = m.gauge(
            "shared_pages",
            "Prefix-cache page residency: state='shared' counts pool pages mapped by more "
            "than one holder, state='cached' the pages the radix tree pins",
            ("pool", "state"),
        )
        self._m_tokens_saved = m.counter(
            "prefill_tokens_saved_total", "Prompt rows whose prefill was skipped via shared pages",
        )
        self._m_prefix_cow = m.counter(
            "prefix_cow_total", "Copy-on-write privatizations of a partially shared prefix page",
        )
        # the port's own: every round's device-to-host copy waits for the device
        self._m_host_copies = m.counter(
            "host_copies_total",
            "Device-to-host copies of logits or draft tokens in rounds (each waits for the device)",
        )
        self._m_host_copies.inc(0)

    def _refresh_gauges(self) -> None:
        """Republish the level-style series (queue depth, active slots, pool
        residency, cumulative acceptance, the prefix cache's) at step
        boundaries and before a stats snapshot."""
        self._m_queue_depth.set(self.queue_depth())
        self._m_active.set(self.num_active())
        for name, pool in (("target", self._t_pool), ("draft", self._d_pool)):
            st = pool.stats()
            g = self._m_pool_pages
            g.labels(pool=name, state="used").set(st.used_pages)
            g.labels(pool=name, state="reserved").set(st.reserved_pages)
            g.labels(pool=name, state="free").set(st.free_pages)
            used_tokens = st.used_pages * pool.page_size
            for dt, bpt in pool.bytes_per_token_by_kind().items():
                self._m_kv_bytes_per_token.labels(pool=name, dtype=dt).set(bpt)
                self._m_kv_bytes.labels(pool=name, dtype=dt).set(bpt * used_tokens)
        drafted = self._m_drafted.value()
        if drafted:
            self._m_accept_rate.set(self._m_accepted.value() / drafted)
        if self._prefix is not None:
            self._m_prefix_hit_rate.set(self._prefix.hit_rate)
            for name, pool in (("target", self._t_pool), ("draft", self._d_pool)):
                self._m_shared_pages.labels(pool=name, state="shared").set(pool.shared_page_count)
                self._m_shared_pages.labels(pool=name, state="cached").set(self._prefix.node_count)

    def stats_snapshot(self) -> dict:
        """One JSON-safe stats view, built in one pass on the calling thread
        (the async front end's worker publishes it after each step): queue
        and slots, rounds, acceptance, the KV storage mode, each pool's
        residency, the fused-slot report and, with the prefix cache on, its
        stats."""
        self._refresh_gauges()
        t_stats, d_stats = self.pool_stats()
        b = self._batcher
        snap = {
            "queued": self.queue_depth(),
            "active": self.num_active(),
            "max_batch": self.cfg.max_batch,
            "par_mode": self.cfg.par_mode,
            "kv_quant": self.cfg.kv_quant,
            "steps": b.step_count,
            "rounds": b.rounds,
            "finished_requests": b.finished_count,
            "emitted_tokens": b.finished_emitted,
            "acceptance_rate": b.finished_accepted / max(b.finished_drafted, 1),
            "target_pool": dataclasses.asdict(t_stats),
            "draft_pool": dataclasses.asdict(d_stats),
        }
        fused = b.fused_summary()
        if fused is not None:
            snap["fused"] = fused
        if self._prefix is not None:
            snap["prefix_cache"] = self._prefix.stats()
        return snap

    # -- request lifecycle ---------------------------------------------------

    def add_request(
        self,
        prompt,
        sampling_params: Optional[SamplingParams] = None,
        sink: Optional[Callable[[int], None]] = None,
    ) -> int:
        """Submit a prompt; returns its request id.  The batcher prefills it
        on the next ``step()`` once a slot and pages are free.  ``sink``
        receives each token as it becomes deliverable.  Host work only: the
        async front end calls it from its event-loop thread."""
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
        req.submit_ts = self._now()
        self._m_submitted.inc()
        self.tracer.instant("engine", "submit", cat="lifecycle", rid=req.rid)
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

    def release_request(self, request_id: int) -> bool:
        """Drop a finished request's bookkeeping (its ``Request`` and output
        buffer); a long-lived server calls it for every retired request.
        False if the id is unknown or not finished."""
        req = self._requests.get(request_id)
        if req is None or req.state is not RequestState.FINISHED:
            return False
        del self._requests[request_id]
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

    # -- sampled device-time profiling ---------------------------------------

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _profiled(self, program: str, fn, *args, cost: Callable[[], dict]):
        """Run one dispatch.  On a profiled round (every
        ``profile_every_n``-th step) synchronize the device on both sides of
        it and read the engine's clock: the wall of the program alone, as
        the reference's ``block_until_ready`` bracket gives it, on the
        tracer's timebase.  The wall, the call and the call's own count
        (``cost()``, a ``core/costs`` dict taken before the bracket) add to
        ``profile_summary()``, and a span carrying that count goes on the
        tracer's "device" track.  Off-round cost: one bool check, no
        synchronization."""
        if not self._profile_round:
            return fn(*args)
        stamp = cost()
        self._sync()
        t0 = self._now()
        out = fn(*args)
        self._sync()
        t1 = self._now()
        self._prog_wall[program] = self._prog_wall.get(program, 0.0) + (t1 - t0)
        self._prog_calls[program] = self._prog_calls.get(program, 0) + 1
        self._prog_flops[program] = self._prog_flops.get(program, 0.0) + stamp["flops"]
        self._prog_bytes[program] = self._prog_bytes.get(program, 0.0) + stamp["bytes"]
        self.tracer.rec("device", program, t0, t1, cat="device", **stamp)
        return out

    def profile_summary(self) -> Dict[str, dict]:
        """Measured device-time attribution: per dispatched program the
        bracketed call count, the summed wall seconds, and the FLOPs and
        bytes of one call (the mean over the calls timed, each counted on
        its own inputs: the target's and the draft's prefills share the
        name ``prefill``), so ``bytes * calls / wall_s`` is the achieved
        rate.  Empty unless ``profile_every_n > 0`` sampled at least one
        round."""
        return {prog: {"calls": calls,
                       "wall_s": self._prog_wall[prog],
                       "flops": self._prog_flops[prog] / calls,
                       "bytes": self._prog_bytes[prog] / calls}
                for prog, calls in self._prog_calls.items()}

    # -- flight-recorder feed ------------------------------------------------

    def _flight_base(self) -> Tuple[float, float, int]:
        """Counter values at a round's start, so its record carries the
        round's deltas."""
        return self._m_drafted.value(), self._m_accepted.value(), self._batcher.admitted

    def _flight_round(self, base, t_step: float, t_end: float, rows: int, mode: str) -> None:
        """Append one round record to the flight recorder (empty rounds
        too: pool exhaustion and admission stalls show as rounds with
        queued work and no rows)."""
        if not self.flight.enabled:
            return
        d0, a0, adm0 = base
        self.flight.record({
            "round": self._batcher.step_count,
            "mode": mode,
            "rows": rows,
            "wall_s": t_end - t_step,
            "drafted": self._m_drafted.value() - d0,
            "accepted": self._m_accepted.value() - a0,
            "admitted": self._batcher.admitted - adm0,
            "queued": self.queue_depth(),
            "active": self.num_active(),
            "free_pages": {"target": self._t_pool.free_pages, "draft": self._d_pool.free_pages},
            "t": t_end,
        })

    def flight_snapshot(self, dump: bool = False) -> dict:
        """The flight recorder's JSON-safe view (``GET /debug/flight``);
        ``dump=True`` also captures the trace tail and writes a postmortem
        file when a dump directory is configured."""
        return self.flight.dump() if dump else self.flight.snapshot()

    # -- the stepwise round --------------------------------------------------

    def _prefill_into(self, req: Request, model: ServingModel, iface: LMInterface,
                      seq, store, tables: _TableSet, slot: int, role: str):
        """Prefill one request into one pool: back all its pages, run the
        dense-cache prefill over prompt[:-1] (the tip is re-fed by the first
        round), and scatter the cache rows into the request's pages.

        A prefix-cache hit (``req.prefix_match`` covers m tokens) has its
        shared pages in the table already, holding the rows a full prefill
        would write.  A partially shared last page is copied on write first
        (in the store of the request's kind), so the shared page is never
        written.  A full hit (m = plen - 1) runs no forward: the first
        round re-feeds the tip at plen - 1, in the private copy.  Otherwise
        the tail [m, plen - 1) runs as an ``extend`` over a dense cache
        seeded with the mirrored prefix rows and scatters with start = m.
        Rewind never goes below the committed prefix, so no later write
        reaches a shared page either.

        Returns the dense rows [0, plen - 1) on the host for the prefix
        cache to mirror when the prompt has a full block the tree lacks,
        else None."""
        plen = req.prompt.shape[0]
        match = req.prefix_match
        m = match.tokens_matched if match is not None else 0
        seq.ensure_backed(seq.capacity_pages * seq.pool.page_size)
        if seq.needs_cow:
            _copy_page(store, *seq.cow_last_shared())
            self._prefix.cow_copies += 1
            self._m_prefix_cow.inc()
        tables.set_row(slot, seq)
        if m >= plen - 1:
            return None
        if m > 0:
            tail = torch.as_tensor(req.prompt[None, m:-1], device=self.device)
            _, cache = iface.extend(model.params, tail, _seeded_cache(model, match, role,
                                                                      self.device))
        else:
            tokens = torch.as_tensor(req.prompt[None, :-1], device=self.device)
            _, cache = iface.prefill(model.params, tokens)
        k, v = cache["attn"]["k"][:, 0], cache["attn"]["v"][:, 0]
        _scatter_prefill(store, k, v, torch.as_tensor(tables.table[slot], device=self.device),
                         plen - 1, m)
        seq.advance(plen - 1 - m)
        ps = seq.pool.page_size
        # the matched path covers blocks [0, m // ps); pull the rows only
        # when the prompt has a full block beyond it (a steady-state hit
        # ran a sub-page tail and donates nothing)
        if self._prefix is not None and m // ps < (plen - 1) // ps:
            return _pull_mirror(k, v, plen - 1)
        return None

    def _admit(self) -> None:
        """Admit whatever fits and prefill it into both pools (the store of
        the request's kind in each); donate the new full blocks to the
        prefix cache."""
        for slot, req in self._batcher.admit():
            t_adm = self._now()
            req.admit_ts = t_adm
            if req.submit_ts is not None:
                self._m_admission_wait.observe(t_adm - req.submit_ts)
            self.tracer.instant(f"row{slot}", "admit", cat="lifecycle", rid=req.rid)
            kind = req.kv_kind
            matched = req.prefix_match.tokens_matched if req.prefix_match is not None else 0
            kv = {}
            for role, model, iface, seq, stores, tables in (
                ("target", self.target, self._t_iface, req.t_seq, self._t_stores, self._t_tables),
                ("draft", self.draft, self._d_iface, req.d_seq, self._d_stores, self._d_tables),
            ):
                kv[role] = self._profiled(
                    "prefill", self._prefill_into, req, model, iface, seq, stores[kind],
                    tables, slot, role,
                    cost=lambda model=model, stores=stores: prefill_cost(
                        model, stores[kind], req.prompt.shape[0], matched))
            if self._prefix is not None:
                if req.prefix_match is not None:
                    self._m_tokens_saved.inc(req.prefix_match.tokens_matched)
                if kv["target"] is not None:
                    self._prefix.insert(req.prompt, kind,
                                        {"target": req.t_seq.pages, "draft": req.d_seq.pages},
                                        kv, upto=req.prompt.shape[0] - 1)
            req.state = RequestState.DECODE
            self.tracer.rec(f"row{slot}", "prefill", t_adm, self._now(), cat="prefill",
                            rid=req.rid)

    def _kvq_mask(self, active) -> Optional[torch.Tensor]:
        """(B,) bool device mask, True where the row's KV is int8, or None
        on a single-kind engine (one dispatch, no merge)."""
        if len(self._kinds) == 1:
            return None
        m = np.zeros((self.cfg.max_batch,), bool)
        for slot, req in active:
            m[slot] = req.kv_kind == "int8"
        return torch.as_tensor(m, device=self.device)

    def _dispatch(self, program: str, run: Callable[[str], Any], kvq,
                  cost: Callable[[str], dict]) -> torch.Tensor:
        """One logical batched dispatch over every storage kind, named
        ``program`` for the profiler: ``run(kind)`` calls the step on that
        kind's store and returns its logits, ``cost(kind)`` counts its
        work.  A single-kind engine calls it once; a mixed engine once per
        store, each call profiled under the same name, the logits merged
        row-wise by kind (``_merge``).  A row writes only its own pages of
        each store and reads only the store of its kind, so the other call
        leaves unread garbage, never corruption."""
        return self._merge({k: self._profiled(program, run, k, cost=lambda k=k: cost(k))
                            for k in self._kinds}, kvq)

    def _merge(self, outs: Dict[str, torch.Tensor], kvq) -> torch.Tensor:
        """Per-kind logits merged row-wise: each row takes its own kind's."""
        if kvq is None:
            return outs[self._kinds[0]]
        return torch.where(kvq[:, None, None], outs["int8"], outs["none"])

    def _fused_dispatch(self, program: str, verify: Callable[[str], Any],
                        draft: Callable[[str], Any], kvq, cost: Callable[[str], dict]):
        """A fused WDOS slot: per store, the target's verify then the draft
        step as one profiled ``program`` call (the reference's one fused
        program per store); (verify logits, draft logits), each merged by
        kind."""
        outs = {k: self._profiled(program, lambda k: (verify(k), draft(k)), k,
                                  cost=lambda k=k: cost(k)) for k in self._kinds}
        return tuple(self._merge({k: o[i] for k, o in outs.items()}, kvq) for i in (0, 1))

    def _dev(self, a: np.ndarray) -> torch.Tensor:
        return torch.as_tensor(a, device=self.device)

    def _to_host(self, t: torch.Tensor) -> np.ndarray:
        """A round's device-to-host copy, counted in ``host_copies_total``."""
        self._m_host_copies.inc()
        return t.cpu().numpy()

    def _load_tables(self, active):
        t0 = self._now()
        d_table, d_len0 = self._d_tables.load((s, r.d_seq) for s, r in active)
        t_table, t_len0 = self._t_tables.load((s, r.t_seq) for s, r in active)
        self._m_table_upload.inc(self._now() - t0)
        return d_table, d_len0, t_table, t_len0

    def _table_devs(self):
        """(target, draft) page tables on the device for a WDOS step: one
        upload serves every slot (the rows retired mid-step are masked)."""
        t0 = self._now()
        tables = self._t_tables.table_dev(), self._d_tables.table_dev()
        self._m_table_upload.inc(self._now() - t0)
        return tables

    def _retire(self, slot: int, reason: Optional[str] = None) -> None:
        """Free a slot: ``reason=None`` retires a finished request (a
        ``finish`` instant on its row's track), ``"abort"`` cancels one."""
        self._t_tables.clear_row(slot)
        self._d_tables.clear_row(slot)
        if reason is None:
            req = self._batcher.slots[slot]
            if self.tracer.enabled:
                self.tracer.instant(f"row{slot}", "finish", cat="lifecycle", rid=req.rid,
                                    reason=req.finish_reason or "length")
            reason = "length"
        self._batcher.retire(slot, reason=reason)

    def step(self) -> List[RequestOutput]:
        """Admit what fits, then run ONE round over every active request: a
        two-phase chain or tree round, or under ``par_mode="wdos"`` a horizon
        of fused slots (which may commit several windows per request).
        Returns a ``RequestOutput`` per request active at the round's
        start.  Every round, empty ones included, feeds the step counter,
        the gauges and the flight recorder; a round that ran also feeds the
        round-wall histogram and the tracer's ``step#k`` span."""
        cfg = self.cfg
        self._round_idx += 1
        self._profile_round = self._profile_every > 0 and self._round_idx % self._profile_every == 0
        tree = cfg.spec_mode == "tree"
        mode = ("fused" if cfg.par_mode == "wdos" else "two_phase") + ("_tree" if tree else "")
        t_step = self._now()
        fb = self._flight_base()
        self._admit()
        active = self._batcher.active()
        if not active:
            self._batcher.step_count += 1
            self._m_steps.inc()
            self._refresh_gauges()
            self._flight_round(fb, t_step, self._now(), 0, mode)
            return []
        if cfg.par_mode == "wdos":
            (self._fused_tree_round if tree else self._fused_round)(active)
        else:
            (self._tree_round if tree else self._chain_round)(active)
            for slot, req in active:
                if req.done:
                    self._retire(slot)
        self._batcher.step_count += 1
        self._m_steps.inc()
        t_end = self._now()
        self._m_round_wall.observe(t_end - t_step)
        self.tracer.rec("engine", f"step#{self._batcher.step_count}", t_step, t_end, cat="step",
                        par_mode=cfg.par_mode, rows=len(active))
        self._refresh_gauges()
        self._flight_round(fb, t_step, t_end, len(active), mode)
        return [self._output_for(req, t_end) for _, req in active]

    def _commit(self, slot: int, req: Request, new: List[int], n_acc: int, dl: int,
                drafted: int, work: List[Tuple[Request, int]]) -> None:
        """Commit one verified window of ``dl`` (``drafted`` proposals; a
        tree's node count), record the round, step the request's APSD
        controller and count it (drafted / accepted, round acceptance, a
        ``commit`` instant on the row's track)."""
        req.commit(new)
        req.record_round(req.controller.mode, dl, n_acc, len(new))
        req.rounds += 1
        req.drafted += drafted
        req.accepted += n_acc
        req.controller.observe(n_acc, dl)
        self._m_drafted.inc(drafted)
        self._m_accepted.inc(n_acc)
        self._m_round_accept.observe(n_acc / dl if dl else 0.0)
        if self.tracer.enabled:
            self.tracer.instant(f"row{slot}", "commit", cat="commit", rid=req.rid,
                                drafted=drafted, accepted=n_acc)
        work.append((req, dl))

    def _chain_round(self, active) -> None:
        cfg = self.cfg
        dls = {slot: req.controller.draft_len() for slot, req in active}
        round_dl = max(dls.values())
        any_sampled = any(not req.sampling.greedy for _, req in active)
        kvq = self._kvq_mask(active)
        d_table, d_len0, t_table, t_len0 = self._load_tables(active)
        t_draft0 = self._now()

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
            logits = self._dispatch("draft", lambda k: self._d_step(
                self.draft.params, cur_dev[:, None], self._d_stores[k], d_table, d_len0 + j), kvq,
                cost=lambda k: window_cost(self.draft, self._d_stores[k],
                                           self._d_tables.lengths + j, 1))
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
        t_verify0 = self._now()
        self.tracer.rec("engine", "draft_phase", t_draft0, t_verify0, cat="phase",
                        rows=len(active), dl=round_dl)

        # ---- verify phase: one batched pass scoring [last_tok, drafts...]
        window = np.zeros((cfg.max_batch, round_dl + 1), np.int32)
        window[:, 0] = cur
        window[:, 1:] = drafts
        window_dev = self._dev(window)
        v_logits = self._dispatch("verify", lambda k: self._t_step(
            self.target.params, window_dev, self._t_stores[k], t_table, t_len0), kvq,
            cost=lambda k: window_cost(self.target, self._t_stores[k], self._t_tables.lengths,
                                       round_dl + 1))
        p_logits = self._to_host(v_logits.float())  # (B, round_dl+1, V)
        self.tracer.rec("engine", "verify_phase", t_verify0, self._now(), cat="phase",
                        rows=len(active))

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
            self._commit(slot, req, new, n_acc, dl, dl, work)
            # both models wrote round_dl+1 positions; keep n_acc + 1
            # (draft invariant: cache == committed[:-1], incl. straggler)
            for seq in (req.t_seq, req.d_seq):
                seq.advance(round_dl + 1)
                seq.rewind(round_dl - n_acc, release_pages=False)
        self._batcher.model_round(work)

    # -- fused WDOS rounds (par_mode="wdos") ---------------------------------

    def _trace_slot(self, plan, by_slot, t0: float, t1: float, tree: bool) -> None:
        """One ``fused_slot`` span on the engine track plus a span on every
        participating row's track: the WDOS schedule made visible."""
        kind = "fused" if plan.fused else "verify_only" if plan.verify_rows else "draft_only"
        extra = {"spec": "tree"} if tree else {}
        self.tracer.rec("engine", "fused_slot", t0, t1, cat="fused", kind=kind,
                        draft_rows=len(plan.draft_rows), verify_rows=len(plan.verify_rows),
                        **extra)
        for slot in plan.draft_rows:
            req = by_slot[slot]
            if tree:
                self.tracer.rec(f"row{slot}", "tree_draft", t0, t1, cat="draft", rid=req.rid,
                                depth=req.tree_depth)
            else:
                self.tracer.rec(f"row{slot}", "draft", t0, t1, cat="draft", rid=req.rid)
        for slot in plan.verify_rows:
            self.tracer.rec(f"row{slot}", "tree_verify" if tree else "verify", t0, t1,
                            cat="verify", rid=by_slot[slot].rid)

    def _fused_round(self, active) -> None:
        """One chain round as a horizon of ``max_dl + 2`` fused slots (the
        dispatch budget of a two-phase round of the longest window).  Each
        slot the planner sends window-full rows to VERIFY (a target window
        of the fixed width ``max_dl + 1``, causally padded, while the draft
        side feeds the window's straggler) and every other row to DRAFT one
        proposal.  A slot with verifying rows is one ``fused_wdos`` program
        (the target's verify, then the draft step), a slot without one
        ``draft_slot``.  A row's open window carries across steps; a row
        that finishes retires in the slot that finished it."""
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
            d_len_np = np.zeros((b,), np.int32)
            d_mask = np.zeros((b,), bool)
            for slot, req in active:
                d_tok[slot, 0] = req.draft_tip
                d_len_np[slot] = req.d_seq.length + len(req.pending)
                d_mask[slot] = True
            d_tok, d_len, d_mask = self._dev(d_tok), self._dev(d_len_np), self._dev(d_mask)

            def draft_step(k):
                return self._d_step(self.draft.params, d_tok, self._d_stores[k], d_table, d_len,
                                    role_mask=d_mask)

            def draft_cost(k):
                return window_cost(self.draft, self._d_stores[k], d_len_np, 1)

            # a fused slot: the target's verify window over the verifying
            # rows, then the draft step over every active row, one after the
            # other on the current stream; each side's masked rows write only
            # its pool's scratch page
            slot_t0 = self._now()
            v_np = None
            if plan.verify_rows:
                v_tok = np.zeros((b, wv), np.int32)
                t_len_np = np.zeros((b,), np.int32)
                v_mask = np.zeros((b,), bool)
                for slot in plan.verify_rows:
                    req = by_slot[slot]
                    v_tok[slot, 0] = req.last_tok
                    v_tok[slot, 1: 1 + req.pending_dl] = req.pending
                    t_len_np[slot] = req.t_seq.length
                    v_mask[slot] = True
                v_tok, t_len, v_mask = self._dev(v_tok), self._dev(t_len_np), self._dev(v_mask)

                def verify(k):
                    return self._t_step(self.target.params, v_tok, self._t_stores[k], t_table,
                                        t_len, role_mask=v_mask)

                def fused_cost(k):
                    t = window_cost(self.target, self._t_stores[k], t_len_np, wv)
                    d = draft_cost(k)
                    return {key: t[key] + d[key] for key in t}

                v_logits, d_logits = self._fused_dispatch("fused_wdos", verify, draft_step, kvq,
                                                          cost=fused_cost)
                v_np = self._to_host(v_logits.float())  # (B, max_dl + 1, V)
            else:
                d_logits = self._dispatch("draft_slot", draft_step, kvq, cost=draft_cost)
            # only drafting rows read the draft logits: the argmax on the
            # device when none of them samples, else the f32 rows
            if plan.draft_rows:
                last = d_logits[:, -1, :]
                if all(by_slot[s].sampling.greedy for s in plan.draft_rows):
                    q_np, nxt = None, self._to_host(torch.argmax(last, dim=-1).to(torch.int32))
                else:
                    q_np = self._to_host(last.float())
                    nxt = np.argmax(q_np, axis=-1)
            slot_t1 = self._now()
            self._batcher.record_fused_slot(plan, slot_t1 - slot_t0, wv)
            if self.tracer.enabled:
                self._trace_slot(plan, by_slot, slot_t0, slot_t1, tree=False)

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
                self._commit(slot, req, new, n_acc, dl, dl, work)
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
        others one more level): one ``fused_tree`` program, or
        ``tree_draft_slot`` when no row verifies.  Accepted non-leftmost
        paths are compacted before the next slot, since a committed row's
        next window overlaps its old slots."""
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
            d_len_np = np.zeros((b,), np.int32)
            d_mask = np.zeros((b,), bool)
            for slot, req in active:
                d_len_np[slot] = req.d_seq.length
                d_mask[slot] = True
            d_win, d_len, d_mask = self._tree_inputs(active), self._dev(d_len_np), self._dev(d_mask)

            def draft_step(k):
                return self._d_step(self.draft.params, d_win[0], self._d_stores[k], d_table,
                                    d_len, *d_win[1:], role_mask=d_mask)

            def draft_cost(k):
                return window_cost(self.draft, self._d_stores[k], d_len_np, w)

            # a fused slot as in the chain round, over tree windows
            slot_t0 = self._now()
            v_np = d_np = None
            if plan.verify_rows:
                t_len_np = np.zeros((b,), np.int32)
                v_mask = np.zeros((b,), bool)
                for slot in plan.verify_rows:
                    t_len_np[slot] = by_slot[slot].t_seq.length
                    v_mask[slot] = True
                v_win = self._tree_inputs([(s, by_slot[s]) for s in plan.verify_rows])
                t_len, v_mask = self._dev(t_len_np), self._dev(v_mask)

                def verify(k):
                    return self._t_step(self.target.params, v_win[0], self._t_stores[k], t_table,
                                        t_len, *v_win[1:], role_mask=v_mask)

                def fused_cost(k):
                    t = window_cost(self.target, self._t_stores[k], t_len_np, w)
                    d = draft_cost(k)
                    return {key: t[key] + d[key] for key in t}

                v_logits, d_logits = self._fused_dispatch("fused_tree", verify, draft_step, kvq,
                                                          cost=fused_cost)
                v_np = self._to_host(v_logits.float())  # (B, W, V)
            else:
                d_logits = self._dispatch("tree_draft_slot", draft_step, kvq, cost=draft_cost)
            if plan.draft_rows:  # tree growth reads every frontier row
                d_np = self._to_host(d_logits.float())
            slot_t1 = self._now()
            self._batcher.record_fused_slot(plan, slot_t1 - slot_t0, w, draft_width=w)
            if self.tracer.enabled:
                self._trace_slot(plan, by_slot, slot_t0, slot_t1, tree=True)

            for slot in plan.draft_rows:
                _sample_tree_level(by_slot[slot], cfg, d_np[slot])
            moves_t = {k: ([], []) for k in self._kinds}
            moves_d = {k: ([], []) for k in self._kinds}
            for slot in plan.verify_rows:
                req = by_slot[slot]
                self._tree_verify_commit(slot, req, v_np[slot], req.tree_dl, moves_t, moves_d, work)
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
        w = self._tree_width
        dls = {slot: min(req.controller.draft_len(), cfg.tree_budget) for slot, req in active}
        round_depth = max(dls.values())
        kvq = self._kvq_mask(active)
        d_table, d_len0, t_table, t_len0 = self._load_tables(active)
        t_draft0 = self._now()
        for slot, req in active:
            req.begin_tree(dls[slot])

        for j in range(round_depth + 1):
            win = self._tree_inputs(active)
            logits = self._dispatch("tree_draft", lambda k: self._d_step(
                self.draft.params, win[0], self._d_stores[k], d_table, d_len0, *win[1:]), kvq,
                cost=lambda k: window_cost(self.draft, self._d_stores[k], self._d_tables.lengths,
                                           w))
            if j < round_depth:
                l_np = self._to_host(logits.float())
                for slot, req in active:
                    if not req.tree_full:
                        _sample_tree_level(req, cfg, l_np[slot])
        t_verify0 = self._now()
        self.tracer.rec("engine", "tree_draft", t_draft0, t_verify0, cat="phase",
                        rows=len(active), depth=round_depth, spec="tree")
        win = self._tree_inputs(active)
        v_logits = self._dispatch("tree_verify", lambda k: self._t_step(
            self.target.params, win[0], self._t_stores[k], t_table, t_len0, *win[1:]), kvq,
            cost=lambda k: window_cost(self.target, self._t_stores[k], self._t_tables.lengths,
                                       w))
        p_logits = self._to_host(v_logits.float())  # (B, W, V)
        self.tracer.rec("engine", "tree_verify", t_verify0, self._now(), cat="phase",
                        rows=len(active), spec="tree")

        work: List[Tuple[Request, int]] = []
        moves_t = {k: ([], []) for k in self._kinds}
        moves_d = {k: ([], []) for k in self._kinds}
        for slot, req in active:
            self._tree_verify_commit(slot, req, p_logits[slot], dls[slot], moves_t, moves_d, work)
        self._compact_pools(moves_t, moves_d)
        self._batcher.model_round(work)

    def _tree_verify_commit(self, slot: int, req: Request, p_win: np.ndarray, dl: int,
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
        self._commit(slot, req, new, n_acc, dl, len(nodes), work)
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
        (pool, kind) that has any (the ``compaction`` program), each counted
        in ``tree_compactions_total``; the flush spans the engine track."""
        if not any(src for mv in (moves_t, moves_d) for (src, _) in mv.values()):
            return
        t0 = self._now()
        n_dispatched = 0
        for moves, stores, model in ((moves_t, self._t_stores, self.target),
                                     (moves_d, self._d_stores, self.draft)):
            for kind, (src, dst) in moves.items():
                if src:
                    store = stores[kind]
                    self._profiled(
                        "compaction", _compact_slots, store,
                        torch.as_tensor(src, device=self.device),
                        torch.as_tensor(dst, device=self.device),
                        cost=lambda store=store, n=len(src), model=model: compaction_cost(
                            model, store, n))
                    self._m_tree_compactions.inc()
                    n_dispatched += 1
        if self.tracer.enabled:
            self.tracer.rec("engine", "compaction", t0, self._now(), cat="phase",
                            dispatches=n_dispatched)

    def _output_for(self, req: Request, now: Optional[float] = None) -> RequestOutput:
        """One streaming RequestOutput: the tokens delivered this step plus
        the cumulative completion.  This is the delivery point, so TTFT and
        ITL are counted here: a non-empty delta is one delivery, the first
        observes TTFT (submit to first token), each later one the gap since
        the previous delivery."""
        delta = req.take_delta()
        if delta:
            t = self._now() if now is None else now
            self._m_emitted.inc(len(delta))
            if req.first_emit_ts is None:
                req.first_emit_ts = t
                if req.submit_ts is not None:
                    self._m_ttft.observe(t - req.submit_ts)
            elif req.last_emit_ts is not None:
                self._m_itl.observe(t - req.last_emit_ts)
            req.last_emit_ts = t
        return RequestOutput(
            request_id=req.rid,
            prompt_token_ids=[int(t) for t in req.prompt],
            new_token_ids=delta,
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
        sinks: Optional[Sequence[Optional[Callable[[int], None]]]] = None,
    ) -> Tuple[List[torch.Tensor], dict]:
        """Drain loop: optionally add `prompts` (one shared or per-prompt
        ``SamplingParams``, and per-prompt ``sinks``), then ``step()`` until
        nothing is queued or active.  Returns (outputs for the added prompts
        — or every request this engine has seen — in submission order,
        summary)."""
        rids = None
        if prompts is not None:
            n = len(prompts)
            if sampling_params is None or isinstance(sampling_params, SamplingParams):
                sps = [sampling_params] * n
            else:
                sps = list(sampling_params)
                if len(sps) != n:
                    raise ValueError(f"{len(sps)} sampling_params for {n} prompts")
            rids = [self.add_request(p, sps[i], sink=sinks[i] if sinks else None)
                    for i, p in enumerate(prompts)]
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
            "target": float(self._t_pool.bytes_per_token()),
            "draft": float(self._d_pool.bytes_per_token()),
        }
        s["kv_copy_s"] = 0.0  # no host K/V copies exist on this path
        s["tree"] = {
            "nodes": self._m_tree_nodes.value(),
            "branches": self._m_tree_branches.value(),
            "compactions": self._m_tree_compactions.value(),
        }
        s["table_upload_s"] = self._m_table_upload.value()
        s["host_copies"] = self._m_host_copies.value()
        if self._prefix is not None:
            s["prefix_cache"] = self._prefix.stats()
        return s


# ---------------------------------------------------------------------------
# Deprecated run-to-drain wrappers (greedy outputs equal to Engine.run's)
# ---------------------------------------------------------------------------


def _seed_from_key(key) -> int:
    """Fold a PRNG key (``core/prng.PRNGKey``: its key data is
    ``jax.random``'s bit for bit) into a per-request integer seed, the
    reference's bridge from key threading to per-request key streams."""
    return int(np.asarray(key).ravel()[-1])


def _empty_summary(cfg) -> dict:
    return {
        "requests": 0, "rounds": 0, "steps": 0, "emitted": 0,
        "acceptance_rate": 0.0, "target_pool": None, "draft_pool": None,
        "wdos_modeled_speedup": 1.0,
        "wdos_utilization": {},
        "par_mode": getattr(cfg, "par_mode", "off"),
        "kv_path": getattr(cfg, "kv_path", "paged"),
        "kv_copy_s": 0.0,
        "table_upload_s": 0.0,
    }


def serve_sd(key, target: ServingModel, draft: ServingModel, prompt, cfg: SDConfig):
    """DEPRECATED: single-request speculative decoding through the Engine.
    Greedy outputs equal ``sd_generate``'s; a sampled request draws from
    the engine's key stream seeded from ``key``."""
    warn_deprecated_once("serve_sd", "Engine.add_request(...) + Engine.step()")
    prompt_np = np.asarray(prompt).reshape(-1)
    ecfg = EngineConfig(
        max_batch=1,
        draft_len=cfg.draft_len,
        model_wdos=False,
        max_model_len=prompt_np.shape[0] + cfg.max_tokens + cfg.draft_len,
    )
    eng = Engine(target, draft, ecfg, device=target.device)
    sp = SamplingParams(temperature=max(cfg.temperature, 0.0), max_tokens=cfg.max_tokens,
                        seed=_seed_from_key(key))
    outs, _ = eng.run([prompt_np], sp)
    req = eng.request(0)
    stats = SDStats(emitted=req.emitted_total, rounds=req.rounds, drafted=req.drafted,
                    accepted=req.accepted)
    return outs[0], stats


def serve_apsd(key, target: ServingModel, draft: ServingModel, prompt, cfg: APSDConfig):
    """DEPRECATED: single-request APSD through the Engine's adaptive mode
    (each request's controller drives the APSD mode machine, so greedy
    outputs stay lossless); the round stats are rebuilt from the request's
    round log."""
    warn_deprecated_once("serve_apsd", "Engine with EngineConfig(adaptive=True)")
    prompt_np = np.asarray(prompt).reshape(-1)
    ecfg = EngineConfig(
        max_batch=1,
        adaptive=True,
        short_dl=cfg.short_dl,
        long_dl=cfg.long_dl,
        model_wdos=False,
        max_model_len=prompt_np.shape[0] + cfg.max_tokens + cfg.long_dl,
    )
    eng = Engine(target, draft, ecfg, device=target.device)
    sp = SamplingParams(temperature=max(cfg.temperature, 0.0), max_tokens=cfg.max_tokens,
                        seed=_seed_from_key(key))
    outs, _ = eng.run([prompt_np], sp)
    req = eng.request(0)
    records = tuple(
        RoundRecord(mode=m, drafted=d, accepted=a, emitted=e, discarded=0)
        for m, d, a, e in req.history
    )
    stats = APSDStats(
        emitted=sum(r.emitted for r in records),
        rounds=len(records),
        drafted=sum(r.drafted for r in records),
        accepted=sum(r.accepted for r in records),
        discarded=0,
        par_rounds=sum(1 for r in records if r.mode == PAR),
        records=records,
    )
    return outs[0], stats


def serve_batch(
    key,
    target: ServingModel,
    draft: ServingModel,
    prompts: Sequence[Any],  # each (S,) or (1, S) int32, S >= 2
    cfg: BatchConfig,
    sinks: Optional[Sequence[Optional[Callable[[int], None]]]] = None,
) -> Tuple[List[torch.Tensor], dict]:
    """DEPRECATED: run-to-drain greedy batch decoding; use ``Engine``.
    Builds an Engine sized like the reference's closed-batch runtime (the
    pool fits the ``max_batch`` largest requests, the table width the
    batch's worst-case peak), adds every prompt and drains.
    ``kv_path="host"`` selects the frozen legacy host-gather loop
    (serving/host_gather.py), kept as the benchmark baseline."""
    warn_deprecated_once("serve_batch", "Engine.run(...)")
    if cfg.kv_path == "host":
        from repro_torch.serving.host_gather import serve_batch_host as _host_impl

        return _host_impl(key, target, draft, prompts, cfg, sinks=sinks)
    if cfg.kv_path != "paged":
        raise ValueError(f"kv_path must be 'paged' or 'host', got {cfg.kv_path!r}")
    if cfg.temperature != 0.0:
        raise NotImplementedError(
            "the deprecated serve_batch wrapper serves greedy decoding only; pass "
            "SamplingParams(temperature=...) to Engine.add_request for sampled decoding"
        )
    del key  # greedy decoding is deterministic; kept for the signature
    if not len(prompts):
        return [], _empty_summary(cfg)
    prompts_np = [np.asarray(p).reshape(-1) for p in prompts]
    peaks = [p.shape[0] + cfg.max_tokens + cfg.max_dl for p in prompts_np]
    for model in (target, draft):
        if max(peaks) > model.s_max:
            raise ValueError(
                f"peak cache length {max(peaks)} exceeds s_max={model.s_max} of {model.cfg.name}"
            )
    if cfg.num_pages is not None:
        num_pages = cfg.num_pages
    else:
        worst = sorted((pages_for(p, cfg.page_size) for p in peaks), reverse=True)
        num_pages = sum(worst[: cfg.max_batch])
    ecfg = EngineConfig(
        max_batch=cfg.max_batch,
        page_size=cfg.page_size,
        draft_len=cfg.draft_len,
        adaptive=cfg.adaptive,
        short_dl=cfg.short_dl,
        long_dl=cfg.long_dl,
        num_pages=num_pages,
        max_model_len=max(peaks),
        model_wdos=cfg.model_wdos,
    )
    eng = Engine(target, draft, ecfg, device=target.device)
    return eng.run(prompts_np, SamplingParams(max_tokens=cfg.max_tokens), sinks=sinks)


def serve_batch_host(
    key,
    target: ServingModel,
    draft: ServingModel,
    prompts: Sequence[Any],
    cfg: BatchConfig,
    sinks: Optional[Sequence[Optional[Callable[[int], None]]]] = None,
) -> Tuple[List[torch.Tensor], dict]:
    """DEPRECATED: the legacy host-gather loop, kept only as the benchmark
    baseline (serving/host_gather.py)."""
    warn_deprecated_once("serve_batch_host", "Engine.run(...) (device-resident paged KV)")
    from repro_torch.serving.host_gather import serve_batch_host as _host_impl

    return _host_impl(key, target, draft, prompts, cfg, sinks=sinks)

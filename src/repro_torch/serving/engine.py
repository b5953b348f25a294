"""Serving engine: the stepwise continuous-batching speculative-decoding
runtime (torch counterpart of repro/serving/engine.py, greedy chain rounds).

``Engine`` admits requests at any time (``add_request``); each ``step()``
admits what fits, prefills it into both paged pools, and runs one
two-phase round over every active request: the draft model proposes
``draft_len`` tokens per row in lockstep micro-steps (plus one straggler
step), then ONE batched target pass verifies every row's window, and the
host applies the greedy accept rule and commits per row.  ``abort`` frees
a request's pages at once.

KV lives in device-resident paged pools (the allocator of
serving/paged_cache.py plus torch tensors): prefill scatters straight into
pool pages, each batched step writes its new tokens in place and attends
through per-row page tables, and accept/rewind is a per-row length update.
The reference donates its pools to XLA and rebinds them each step; here
the pools are updated in place and never copied.

Invariants carried over from the reference: a request's pages are reserved
and backed at admission, so its page-table row is stable for its lifetime;
a round writes at most ``draft_len + 1`` positions past the committed
prefix and rewinds to ``committed - 1``; inactive batch rows point every
table slot at the pool's scratch page.  Greedy tokens are per-row
deterministic, so batch composition never changes a request's output.

Not ported yet (refused with NotImplementedError): sampled requests, stop
strings, tree speculation, fused WDOS rounds, int8 pools, the prefix
cache, adaptive draft lengths, device-time profiling, the tracer and the
flight recorder.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.speculative import LMInterface, speculative_accept_greedy_host
from repro_torch.models import layers as L
from repro_torch.models import lm
from repro_torch.models.common import ModelConfig
from repro_torch.serving import quantized_lm as qlm
from repro_torch.serving.api import (
    CompletionOutput,
    EngineConfig,
    RequestOutput,
    SamplingParams,
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
    """Dense-cache prefill / extend over one model."""

    def prefill(params, tokens):
        cache = lm.init_cache(model.cfg, tokens.shape[0], model.s_max, model.device)
        return model._apply(params, tokens, cache)

    def extend(params, tokens, cache):
        return model._apply(params, tokens, cache)

    return LMInterface(prefill=prefill, extend=extend)


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
    )


def _make_paged_step(model: ServingModel):
    """One batched paged forward: every batch slot is a row with its OWN
    page-table row and length.  New tokens are written into the pool
    tensors in place; returns the logits."""

    def step(params, tokens, store, page_table, lengths):
        cache = {"lengths": lengths, "page_table": page_table, "attn": store}
        logits, _ = model._apply(params, tokens, cache)
        return logits

    return step


def _scatter_prefill(store: Dict[str, torch.Tensor], k_dense: torch.Tensor,
                     v_dense: torch.Tensor, pages: torch.Tensor, n: int) -> None:
    """Write a freshly prefilled request's dense cache rows [0, n) into its
    pool pages, device to device, in place.  k_dense/v_dense: (L, s_max,
    kvh, hd); pages: (mp,) physical page ids of the request's table row.
    The reference scatters a fixed-width span and routes the slots outside
    [0, n) to the scratch page so it compiles once; eager torch writes the
    valid rows only."""
    nl, p1, ps, kvh, hd = store["k"].shape
    pos = torch.arange(n, device=pages.device)
    flat = pages.long()[pos // ps] * ps + pos % ps
    for name, src in (("k", k_dense), ("v", v_dense)):
        pool = store[name]
        pool.view(nl, p1 * ps, kvh, hd)[:, flat] = src[:, :n].to(pool.dtype)


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
    """

    def __init__(
        self,
        target: ServingModel,
        draft: ServingModel,
        config: Optional[EngineConfig] = None,
        device="cuda",
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
        self._t_store = device_pool_store(self._t_pool, self.device)
        self._d_store = device_pool_store(self._d_pool, self.device)

        self.metrics = MetricsRegistry()
        self._m_table_upload = self.metrics.counter(
            "table_upload_seconds_total", "Host seconds uploading page tables / lengths",
        )

        self._batcher = ContinuousBatcher(
            cfg, self._t_pool, self._d_pool,
            t_layers=target.cfg.n_layers, d_layers=draft.cfg.n_layers,
            t_costs=_wdos_costs(target.cfg), d_costs=_wdos_costs(draft.cfg),
            metrics=self.metrics,
        )
        self._t_iface, self._d_iface = make_interface(target), make_interface(draft)
        self._t_step, self._d_step = _make_paged_step(target), _make_paged_step(draft)
        self._t_tables = _TableSet(cfg.max_batch, self._t_pool, self.max_model_len, self.device)
        self._d_tables = _TableSet(cfg.max_batch, self._d_pool, self.max_model_len, self.device)
        self._requests: Dict[int, Request] = {}
        self._next_id = 0

    # -- request lifecycle ---------------------------------------------------

    def add_request(
        self,
        prompt,
        sampling_params: Optional[SamplingParams] = None,
    ) -> int:
        """Submit a prompt; returns its request id.  The batcher prefills it
        on the next ``step()`` once a slot and pages are free."""
        sp = sampling_params if sampling_params is not None else SamplingParams()
        if not sp.greedy:
            raise NotImplementedError(
                "sampled requests (temperature > 0) need the reference's key streams; "
                "the port serves greedy requests"
            )
        if sp.stop:
            raise NotImplementedError("stop strings are not ported yet")
        if sp.kv_quant not in (None, "none"):
            raise ValueError(
                f"request kv_quant={sp.kv_quant!r} is incompatible with engine kv_quant='none'"
            )
        req = Request(
            rid=self._next_id,
            prompt=np.asarray(prompt).reshape(-1),
            max_new_tokens=sp.max_tokens,
            sampling=sp,
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
        self._t_tables.clear_row(slot)
        self._d_tables.clear_row(slot)
        self._batcher.retire(slot, reason="abort")
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
        """Admit whatever fits and prefill it into both pools."""
        for slot, req in self._batcher.admit():
            self._prefill_into(req, self.target, self._t_iface, req.t_seq,
                               self._t_store, self._t_tables, slot)
            self._prefill_into(req, self.draft, self._d_iface, req.d_seq,
                               self._d_store, self._d_tables, slot)
            req.state = RequestState.DECODE

    def step(self) -> List[RequestOutput]:
        """Admit what fits, then run ONE two-phase round over every active
        request.  Returns a ``RequestOutput`` per request that progressed."""
        cfg = self.cfg
        self._admit()
        active = self._batcher.active()
        if not active:
            self._batcher.step_count += 1
            return []

        dls = {slot: req.controller.draft_len() for slot, req in active}
        round_dl = max(dls.values())

        t0 = time.perf_counter()
        d_table, d_len0 = self._d_tables.load((s, r.d_seq) for s, r in active)
        t_table, t_len0 = self._t_tables.load((s, r.t_seq) for s, r in active)
        self._m_table_upload.inc(time.perf_counter() - t0)

        # ---- draft phase: round_dl proposal steps + 1 straggler step, all
        # batched; the next-token argmax stays on the device
        cur = np.zeros((cfg.max_batch,), np.int32)
        for slot, req in active:
            cur[slot] = req.last_tok
        cur_dev = torch.as_tensor(cur, device=self.device)
        draft_cols: List[torch.Tensor] = []
        for j in range(round_dl + 1):
            logits = self._d_step(
                self.draft.params, cur_dev[:, None], self._d_store, d_table, d_len0 + j
            )
            if j < round_dl:
                cur_dev = torch.argmax(logits[:, -1, :], dim=-1).to(torch.int32)
                draft_cols.append(cur_dev)
            # else: straggler — feeds d_{round_dl-1}, completing the cache for
            # fully-accepted rows; over-written rows rewind it away below.
        drafts = torch.stack(draft_cols, dim=1).cpu().numpy()

        # ---- verify phase: one batched pass scoring [last_tok, drafts...]
        window = np.zeros((cfg.max_batch, round_dl + 1), np.int32)
        window[:, 0] = cur
        window[:, 1:] = drafts
        v_logits = self._t_step(
            self.target.params, torch.as_tensor(window, device=self.device),
            self._t_store, t_table, t_len0,
        )
        p_logits = v_logits.float().cpu().numpy()  # (B, round_dl+1, V)

        # ---- per-request accept / commit: a pure length update per row
        work = []
        progressed: List[Request] = []
        for slot, req in active:
            dl = dls[slot]
            new, n_acc = speculative_accept_greedy_host(drafts[slot], p_logits[slot], dl)
            req.commit(new)
            req.drafted += dl
            req.accepted += n_acc
            req.controller.observe(n_acc, dl)
            work.append((req, dl))
            progressed.append(req)
            # both models wrote round_dl+1 positions; keep n_acc + 1
            # (draft invariant: cache == committed[:-1], incl. straggler)
            for seq in (req.t_seq, req.d_seq):
                seq.advance(round_dl + 1)
                seq.rewind(round_dl - n_acc, release_pages=False)
        self._batcher.model_round(work)
        for slot, req in active:
            if req.done:
                self._t_tables.clear_row(slot)
                self._d_tables.clear_row(slot)
                self._batcher.retire(slot)
        self._batcher.step_count += 1
        return [self._output_for(req) for req in progressed]

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
        s["kv_bytes_per_token"] = {
            "target": float(self._t_pool.bytes_per_token()),
            "draft": float(self._d_pool.bytes_per_token()),
        }
        s["table_upload_s"] = self._m_table_upload.value()
        return s

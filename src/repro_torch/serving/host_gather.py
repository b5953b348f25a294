"""LEGACY host-gather serving loop (torch counterpart of
repro/serving/host_gather.py): the benchmark baseline that the
device-resident paged ``Engine`` replaced.

The paged pools live in host memory (``PagedKVPool(alloc_storage=True)``).
Every round, each active request's whole dense K/V view is gathered from
its pages into reused host buffers (page-locked when the models run on
the card) and the whole ``(n_layers, max_batch, s_max, kv_heads,
head_dim)`` buffers of each model are uploaded to the device; after the
verify both models' buffers come back whole and the spans the round wrote
are appended to the pools.  That per-round O(S_max x B) host traffic is
the data-movement tax this loop exists to measure (``kv_copy_s`` counts
the wall time of those copies, as the reference does); K/V never stays on
the device between rounds.

One batched forward runs per draft step and one per verify, every batch
slot a row with its own length, as the reference's ``jit(vmap)`` step
does.  The uploaded buffers are read as a paged pool with one page of
``s_max`` positions per slot (page table row i = [i]), so the forward is
the engine's paged route (the paged-attention kernel on the card).  Peaks
are checked against ``s_max``, so no write passes a row's page.

Greedy tokens equal the paged ``Engine``'s, and the reference loop's on
the same weights.  The loop is frozen as the reference keeps it: run to
drain, greedy only, no Engine features; it shares only the engine's leaf
helpers (pool sizing, accept rule, summary shape).
"""
from __future__ import annotations

import time
from typing import Any, Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.serving.batcher import BatchConfig, ContinuousBatcher
from repro_torch.serving.paged_cache import PagedKVPool
from repro_torch.serving.request import Request, RequestState

__all__ = ["serve_batch_host"]


class _PoolGather:
    """Reused host buffers for one model's pool -> dense batched views, and
    the device buffers they are uploaded into, read by the forward as a
    pool of one page per slot."""

    def __init__(self, max_batch: int, pool: PagedKVPool, s_max: int, device: torch.device):
        shape = (pool.n_layers, max_batch, s_max, pool.kv_heads, pool.head_dim)
        pin = device.type == "cuda"
        self.k = torch.zeros(shape, dtype=pool.dtype, pin_memory=pin)
        self.v = torch.zeros(shape, dtype=pool.dtype, pin_memory=pin)
        self.store = {"k": torch.empty(shape, dtype=pool.dtype, device=device),
                      "v": torch.empty(shape, dtype=pool.dtype, device=device)}
        self.table = torch.arange(max_batch, dtype=torch.int32, device=device)[:, None]
        self.lengths = np.zeros((max_batch,), np.int32)
        self.device = device

    def load(self, rows) -> Tuple[np.ndarray, torch.Tensor]:
        """Gather rows (iterable of (slot, PagedSequence)) into the host
        buffers, upload both buffers whole (blocking); returns the lengths
        on the host and on the device."""
        self.lengths[:] = 0
        for i, seq in rows:
            seq.gather_into(self.k[:, i], self.v[:, i])
            self.lengths[i] = seq.length
        self.store["k"].copy_(self.k)
        self.store["v"].copy_(self.v)
        return self.lengths.copy(), torch.as_tensor(self.lengths, device=self.device)

    def pull(self) -> None:
        """Copy both device buffers back whole into the host buffers."""
        self.k.copy_(self.store["k"])
        self.v.copy_(self.store["v"])


def serve_batch_host(
    key,
    target,
    draft,
    prompts: Sequence[Any],
    cfg: BatchConfig,
    sinks: Optional[Sequence[Optional[Callable[[int], None]]]] = None,
) -> Tuple[List[torch.Tensor], dict]:
    """The legacy host-gather loop (see the module docstring), greedy and
    run to drain.  Called through ``engine.serve_batch(..., cfg)`` with
    ``cfg.kv_path == "host"``.  Returns (outputs, summary) with
    ``kv_path="host"`` and ``kv_copy_s`` the seconds spent in K/V copies."""
    from repro_torch.serving import engine as E

    del key  # greedy decoding is deterministic; kept for the signature
    if cfg.temperature != 0.0:
        raise NotImplementedError("serve_batch currently supports temperature=0.0")
    requests = [
        Request(rid=i, prompt=np.asarray(p).reshape(-1), max_new_tokens=cfg.max_tokens,
                sink=sinks[i] if sinks else None)
        for i, p in enumerate(prompts)
    ]
    if not requests:
        return [], E._empty_summary(cfg)
    peaks = [r.peak_cache_len(cfg.max_dl) for r in requests]
    for model in (target, draft):
        if max(peaks) > model.s_max:
            raise ValueError(
                f"peak cache length {max(peaks)} exceeds s_max={model.s_max} of {model.cfg.name}"
            )
    device = target.device
    t_pool = E._pool_for(target, cfg, peaks, alloc_storage=True)
    d_pool = E._pool_for(draft, cfg, peaks, alloc_storage=True)
    batcher = ContinuousBatcher(
        cfg, t_pool, d_pool, t_layers=target.cfg.n_layers, d_layers=draft.cfg.n_layers,
        t_costs=E._wdos_costs(target.cfg), d_costs=E._wdos_costs(draft.cfg),
    )
    for r in requests:
        batcher.submit(r)

    t_iface, d_iface = E.make_interface(target), E.make_interface(draft)
    t_step, d_step = E._make_paged_step(target), E._make_paged_step(draft)
    t_gather = _PoolGather(cfg.max_batch, t_pool, target.s_max, device)
    d_gather = _PoolGather(cfg.max_batch, d_pool, draft.s_max, device)
    kv_copy_s = 0.0  # cumulative host<->device K/V copy time (the tax)

    def _prefill_into(req: Request, iface, params, seq):
        nonlocal kv_copy_s
        plen = req.prompt.shape[0]
        tokens = torch.as_tensor(req.prompt[None, :-1], device=device)
        _, cache = iface.prefill(params, tokens)
        t0 = time.perf_counter()
        k = cache["attn"]["k"][:, 0].cpu()  # (n_layers, s_max, kvh, hd)
        v = cache["attn"]["v"][:, 0].cpu()
        seq.append(k[:, : plen - 1], v[:, : plen - 1])
        kv_copy_s += time.perf_counter() - t0

    while not batcher.all_done():
        for _, req in batcher.admit():
            _prefill_into(req, t_iface, target.params, req.t_seq)
            _prefill_into(req, d_iface, draft.params, req.d_seq)
            req.state = RequestState.DECODE
        active = batcher.active()
        if not active:
            batcher.step_count += 1
            continue

        dls = {slot: req.controller.draft_len() for slot, req in active}
        round_dl = max(dls.values())

        # ---- draft phase: round_dl greedy steps + 1 straggler step, all
        # batched; the uploaded draft buffers stay on the device for the loop
        t0 = time.perf_counter()
        d_len0, d_len0_dev = d_gather.load((s, r.d_seq) for s, r in active)
        kv_copy_s += time.perf_counter() - t0
        cur = np.zeros((cfg.max_batch,), np.int32)
        for slot, req in active:
            cur[slot] = req.last_tok
        cur_dev = torch.as_tensor(cur, device=device)
        draft_cols = []
        for j in range(round_dl + 1):
            logits = d_step(draft.params, cur_dev[:, None], d_gather.store, d_gather.table,
                            d_len0_dev + j)
            if j < round_dl:
                cur_dev = torch.argmax(logits[:, -1, :], dim=-1).to(torch.int32)
                draft_cols.append(cur_dev)
            # else: straggler — feeds d_{round_dl-1}, completing the cache for
            # fully-accepted rows; over-written rows rewind it away below.
        drafts = torch.stack(draft_cols, dim=1).cpu().numpy()  # (B, round_dl)

        # ---- verify phase: one batched pass scoring [last_tok, drafts...]
        t0 = time.perf_counter()
        t_len0, t_len0_dev = t_gather.load((s, r.t_seq) for s, r in active)
        kv_copy_s += time.perf_counter() - t0
        window = np.zeros((cfg.max_batch, round_dl + 1), np.int32)
        window[:, 0] = cur
        window[:, 1:] = drafts
        v_logits = t_step(target.params, torch.as_tensor(window, device=device),
                          t_gather.store, t_gather.table, t_len0_dev)
        p_logits = v_logits.float().cpu().numpy()  # (B, round_dl+1, V)
        t0 = time.perf_counter()
        d_gather.pull()
        t_gather.pull()
        kv_copy_s += time.perf_counter() - t0

        # ---- per-request accept / commit / page maintenance
        work = []
        for slot, req in active:
            dl = dls[slot]
            new, n_acc = E._greedy_accept_host(drafts[slot], p_logits[slot], dl)
            req.commit(new)
            req.rounds += 1
            req.drafted += dl
            req.accepted += n_acc
            req.controller.observe(n_acc, dl)
            work.append((req, dl))
            # both models wrote round_dl+1 positions at their lengths (the
            # draft's include the straggler); keep n_acc + 1 of them
            t0 = time.perf_counter()
            for seq, gather, pos in ((req.t_seq, t_gather, int(t_len0[slot])),
                                     (req.d_seq, d_gather, int(d_len0[slot]))):
                seq.append(gather.k[:, slot, pos:pos + round_dl + 1],
                           gather.v[:, slot, pos:pos + round_dl + 1])
                seq.rewind(round_dl - n_acc)
            kv_copy_s += time.perf_counter() - t0
        batcher.model_round(work)
        for slot, req in active:
            if req.done:
                batcher.retire(slot)
        batcher.step_count += 1

    outputs = [torch.tensor(r.out[: r.max_new_tokens], dtype=torch.int32) for r in requests]
    summary = batcher.summary()
    summary["kv_path"] = "host"
    summary["kv_copy_s"] = kv_copy_s
    summary["table_upload_s"] = 0.0  # same schema as the paged path
    return outputs, summary

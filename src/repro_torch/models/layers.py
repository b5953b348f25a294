"""Layer library of the main path (torch counterpart of the parts of
repro/models/layers.py the dense serving forward reaches): norms, rotary,
prefill attention over a dense cache, and the paged KV cache.

Paged attention runs ``kernels.paged_attn.paged_attention``: the CUDA
kernel on the card, its plain version on the CPU.  Prefill attention is
plain torch, as it is plain jnp in the reference."""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.kernels.paged_attn import paged_attention
from repro_torch.models.common import ModelConfig

__all__ = [
    "rmsnorm",
    "rope",
    "kv_store_heads",
    "flash_attention",
    "PagedCache",
    "paged_attention_update",
    "forward_cache_ctx",
]


def rmsnorm(params: dict, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * params["g"].float()).to(x.dtype)


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x: (B, S, H, hd); positions: (B, S) int."""
    hd = x.shape[-1]
    half = hd // 2
    freqs = torch.exp(
        -math.log(theta) * torch.arange(half, dtype=torch.float32, device=x.device) / half
    )
    ang = positions[..., None].float() * freqs
    cos = torch.cos(ang)[..., None, :]
    sin = torch.sin(ang)[..., None, :]
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def silu_mul(g: torch.Tensor, u: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """silu(g) in float32, cast to the model dtype, times u."""
    return F.silu(g.float()).to(dtype) * u


def kv_store_heads(cfg: ModelConfig) -> int:
    """KV heads the cache stores.  The reference replicates kv heads only
    under tensor parallelism (its ``_repeat_kv``); on the port's single
    device it stores exactly ``n_kv`` and the repeat is the identity."""
    return cfg.n_kv


def flash_attention(
    q: torch.Tensor,  # (B, Sq, H, hd)
    k: torch.Tensor,  # (B, Skv, Hkv, hd)
    v: torch.Tensor,
    causal: bool,
    q_offset: int = 0,
    kv_chunk: int = 1024,
) -> torch.Tensor:
    """Streaming-softmax attention over KV chunks (prefill).  Dots take
    model-dtype operands with float32 accumulation; softmax statistics and
    the accumulator stay float32, as in the reference."""
    b, sq, h, hd = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    g = h // hkv
    scale = 1.0 / math.sqrt(hd)
    dot_dt = q.dtype
    qf = (q.reshape(b, sq, hkv, g, hd).float() * scale).to(dot_dt).float()
    n_chunks = max(skv // kv_chunk, 1)
    while skv % n_chunks:
        n_chunks -= 1
    ck = skv // n_chunks
    q_pos = torch.arange(sq, device=q.device)[None, :] + q_offset
    m = torch.full((b, hkv, g, sq), -math.inf, device=q.device)
    l = torch.zeros((b, hkv, g, sq), device=q.device)
    acc = torch.zeros((b, hkv, g, sq, hd), device=q.device)
    for c in range(n_chunks):
        kb = k[:, c * ck:(c + 1) * ck].to(dot_dt).float()
        vb = v[:, c * ck:(c + 1) * ck].to(dot_dt).float()
        scores = torch.einsum("bqkgh,bckh->bkgqc", qf, kb)
        if causal:
            kv_pos = c * ck + torch.arange(ck, device=q.device)
            mask = q_pos[:, :, None] >= kv_pos[None, None, :]
            scores = torch.where(mask[:, None, None], scores, torch.full_like(scores, -1e30))
        m_new = torch.maximum(m, scores.amax(dim=-1))
        p = torch.exp(scores - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(dim=-1)
        pv = torch.einsum("bkgqc,bckh->bkgqh", p.to(dot_dt).float(), vb)
        acc = acc * corr[..., None] + pv
        m = m_new
    out = acc / torch.clamp(l[..., None], min=1e-30)
    out = out.permute(0, 3, 1, 2, 4).reshape(b, sq, h, hd)
    return out.to(q.dtype)


def decode_attention(
    q: torch.Tensor,  # (B, 1, H, hd)
    cache_k: torch.Tensor,  # (B, S_max, hkv, hd)
    cache_v: torch.Tensor,
    length: int,  # valid prefix INCLUDING the new token
) -> torch.Tensor:
    """One token's attention over a dense cache (the reference's
    ``_decode_attention`` for fp caches)."""
    b, sq, h, hd = q.shape
    s_max, hkv = cache_k.shape[1], cache_k.shape[2]
    g = h // hkv
    scale = 1.0 / math.sqrt(hd)
    dot_dt = torch.bfloat16 if cache_k.dtype == torch.bfloat16 else torch.float32
    qf = (q.reshape(b, sq, hkv, g, hd).float() * scale).to(dot_dt).float()
    scores = torch.einsum("bqkgh,bskh->bkgqs", qf, cache_k.to(dot_dt).float())
    valid = torch.arange(s_max, device=q.device) < length
    scores = torch.where(valid, scores, torch.full_like(scores, -1e30))
    p = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgqs,bskh->bkgqh", p.to(dot_dt).float(), cache_v.to(dot_dt).float())
    out = out.permute(0, 3, 1, 2, 4).reshape(b, sq, h, hd)
    return out.to(q.dtype)


@dataclasses.dataclass
class PagedCache:
    """One layer's view of the device-resident paged KV pool, shared by the
    whole batch: each row owns the pages its ``page_table`` row names and
    ``length`` is per row.  ``k``/``v`` are views into the engine's pool
    tensors, so writes through them land in the pool."""

    k: torch.Tensor  # (P + scratch, page_size, kvh, hd)
    v: torch.Tensor
    page_table: torch.Tensor  # (B, max_pages) int32
    length: torch.Tensor  # (B,) int32 — tokens already written per request


_UNPORTED_CACHE_KEYS = ("role_mask", "win_pos", "tree_mask")


def forward_cache_ctx(cache: Optional[dict], b: int, s: int):
    """Shared forward preamble: ``(offset, positions (B, S), page_table)``.

    A cache carrying ``page_table`` is the paged pool (``{"lengths" (B,),
    "page_table" (B, mp), "attn": {"k": (L, P, ps, kvh, hd), "v": ...}}``):
    offset is the per-row length tensor.  A dense cache (``{"length": int,
    "attn": {"k": (L, B, S_max, kvh, hd), ...}}``) or None yields an int
    offset and ``page_table=None``."""
    if cache is not None and "page_table" in cache:
        unported = [k for k in _UNPORTED_CACHE_KEYS if k in cache]
        if unported:
            raise NotImplementedError(f"paged cache keys not ported yet: {unported}")
        offset = cache["lengths"]
        positions = offset[:, None].long() + torch.arange(s, device=offset.device)[None, :]
        return offset, positions, cache["page_table"]
    offset = int(cache["length"]) if cache is not None else 0
    device = cache["attn"]["k"].device if cache is not None else None
    positions = (offset + torch.arange(s, device=device))[None, :].expand(b, s)
    return offset, positions, None


def paged_attention_update(
    q: torch.Tensor,  # (B, S, H, hd) — post-rope queries
    k_new: torch.Tensor,  # (B, S, kvh, hd) — post-rope
    v_new: torch.Tensor,
    pc: PagedCache,
) -> torch.Tensor:
    """Scatter the S new tokens into their pool pages, then attend over the
    valid per-row prefix (+ the causally masked window when S > 1).

    The reference returns updated pool arrays (its pools are donated to
    XLA); here the pools are written in place with ``index_copy_``.  Rows
    write disjoint pages; inactive rows all target the scratch page, where
    duplicate writes are harmless.  Returns ``out (B, S, H, hd)``."""
    b, s, h, hd = q.shape
    n_pages, ps, kvh, _ = pc.k.shape
    mp = pc.page_table.shape[1]
    pos = pc.length[:, None].long() + torch.arange(s, device=q.device)[None, :]
    page = torch.gather(pc.page_table.long(), 1, torch.clamp(pos // ps, max=mp - 1))
    # positions past the table span divert to the scratch page (the pool's
    # last) rather than overwrite the row's own committed KV
    page = torch.where(pos >= mp * ps, torch.full_like(page, n_pages - 1), page)
    flat = (page * ps + pos % ps).reshape(-1)
    for pool, span in ((pc.k, k_new), (pc.v, v_new)):
        pool.view(n_pages * ps, kvh, hd).index_copy_(
            0, flat, span.to(pool.dtype).reshape(b * s, kvh, hd)
        )
    new_len = pc.length + s
    q5 = q.reshape(b, s, kvh, h // kvh, hd)
    out = paged_attention(q5, pc.k, pc.v, pc.page_table, new_len)
    return out.reshape(b, s, h, hd).to(q.dtype)

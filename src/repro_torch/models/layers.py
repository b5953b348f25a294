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
    "kv_quantize",
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
    ``length`` is per row.  ``k``/``v`` (and the scales) are views into the
    engine's pool tensors, so writes through them land in the pool.

    With ``k_scale``/``v_scale`` the pool is int8: new tokens quantize on
    the write (values and scales in the same call) and the attention kernel
    dequantizes each page, so pages stay int8 at rest.  ``tree_mask`` (B,
    S, S) replaces the causal window with a speculation tree's ancestor
    relation; None keeps the causal window."""

    k: torch.Tensor  # (P + scratch, page_size, kvh, hd)
    v: torch.Tensor
    page_table: torch.Tensor  # (B, max_pages) int32
    length: torch.Tensor  # (B,) int32 — tokens already written per request
    k_scale: Optional[torch.Tensor] = None  # (P + scratch, page_size, kvh, 1) f32
    v_scale: Optional[torch.Tensor] = None
    tree_mask: Optional[torch.Tensor] = None  # (B, S, S) f32 window visibility


def forward_cache_ctx(cache: Optional[dict], b: int, s: int):
    """Shared forward preamble: ``(offset, positions (B, S), paged)``.

    A cache carrying ``page_table`` is the paged pool (``{"lengths" (B,),
    "page_table" (B, mp), "attn": {"k": (L, P, ps, kvh, hd), "v": ...[,
    "k_scale", "v_scale"]}}``): offset is the per-row length tensor and
    ``paged`` the ``(page_table, tree_mask)`` pair the layers need.  The
    speculation-tree keys are optional: ``win_pos`` (B, S) gives each
    window slot its depth, so positions = offset + win_pos (slot order is
    BFS, RoPE follows depth), and ``tree_mask`` (B, S, S) its ancestor
    relation.  A dense cache (``{"length": int, "attn": {"k": (L, B, S_max,
    kvh, hd), ...}}``) or None yields an int offset and ``paged=None``.

    Role mask (fused slots): an optional ``"role_mask"`` (B,) bool selects
    the rows that take part in this forward.  A masked row's length becomes
    0 and its whole page-table row the pool's scratch page (its last), so
    its writes land where no request reads; several masked rows may write
    the same scratch slots, so their outputs are garbage no caller reads."""
    if cache is not None and "page_table" in cache:
        offset = cache["lengths"]
        table = cache["page_table"]
        mask = cache.get("role_mask")
        if mask is not None:
            scratch = cache["attn"]["k"].shape[1] - 1
            offset = torch.where(mask, offset, torch.zeros_like(offset))
            table = torch.where(mask[:, None], table, torch.full_like(table, scratch))
        win_pos = cache.get("win_pos")
        if win_pos is None:
            win_pos = torch.arange(s, device=offset.device)[None, :]
        positions = offset[:, None].long() + win_pos.long()
        return offset, positions.expand(b, s), (table, cache.get("tree_mask"))
    offset = int(cache["length"]) if cache is not None else 0
    device = cache["attn"]["k"].device if cache is not None else None
    positions = (offset + torch.arange(s, device=device))[None, :].expand(b, s)
    return offset, positions, None


def kv_quantize(x: torch.Tensor):
    """Symmetric int8 quantization per (token, head) over the last axis
    (the reference's ``_kv_quantize``): (..., hd) -> (int8 values, float32
    scales (..., 1)).  Computed in float32; torch.round rounds half to
    even, as jnp.round does."""
    xf = x.float()
    scale = torch.clamp(xf.abs().amax(dim=-1, keepdim=True), min=1e-8) / 127.0
    q = torch.clamp(torch.round(xf / scale), -127, 127).to(torch.int8)
    return q, scale


def paged_attention_update(
    q: torch.Tensor,  # (B, S, H, hd) — post-rope queries
    k_new: torch.Tensor,  # (B, S, kvh, hd) — post-rope
    v_new: torch.Tensor,
    pc: PagedCache,
) -> torch.Tensor:
    """Scatter the S new tokens into their pool pages, then attend over the
    valid per-row prefix (+ the window, causal or tree-masked, when S > 1).

    The reference returns updated pool arrays (its pools are donated to
    XLA); here the pools are written in place with ``index_copy_``.  Rows
    write disjoint pages; inactive rows all target the scratch page, where
    duplicate writes are harmless.  An int8 pool gets the span quantized,
    values and scales written in the same call.  Returns ``out (B, S, H,
    hd)``."""
    b, s, h, hd = q.shape
    n_pages, ps, kvh, _ = pc.k.shape
    mp = pc.page_table.shape[1]
    pos = pc.length[:, None].long() + torch.arange(s, device=q.device)[None, :]
    page = torch.gather(pc.page_table.long(), 1, torch.clamp(pos // ps, max=mp - 1))
    # positions past the table span divert to the scratch page (the pool's
    # last) rather than overwrite the row's own committed KV
    page = torch.where(pos >= mp * ps, torch.full_like(page, n_pages - 1), page)
    flat = (page * ps + pos % ps).reshape(-1)
    if pc.k_scale is not None:
        kq, ks = kv_quantize(k_new)
        vq, vs = kv_quantize(v_new)
        writes = ((pc.k, kq), (pc.v, vq), (pc.k_scale, ks), (pc.v_scale, vs))
    else:
        writes = ((pc.k, k_new), (pc.v, v_new))
    for pool, span in writes:
        width = pool.shape[-1]
        pool.view(n_pages * ps, kvh, width).index_copy_(
            0, flat, span.to(pool.dtype).reshape(b * s, kvh, width)
        )
    new_len = pc.length + s
    q5 = q.reshape(b, s, kvh, h // kvh, hd)
    out = paged_attention(q5, pc.k, pc.v, pc.page_table, new_len,
                          k_scale=pc.k_scale, v_scale=pc.v_scale, tree_mask=pc.tree_mask)
    return out.reshape(b, s, h, hd).to(q.dtype)

"""Plain-torch versions of every ported kernel (torch counterpart of
repro/kernels/ref.py): the correctness ground truth.

Each function mirrors its kernel's contract exactly.  The kernel wrappers
run these for CPU tensors; on the card they serve only as the yardstick
the kernels are held against (tests and chip_smoke.py)."""
from __future__ import annotations

import math
from typing import Optional

import torch

from repro_torch.core.bvq import reconstruct_dense
from repro_torch.core.quantization import unpack_int4
from repro_torch.core.rotation import (RotationPlan, _apply_blocks, local_rotate,
                                      local_rotate_transpose)

__all__ = [
    "block_rotate_ref",
    "rotate_plan_ref",
    "w4a8_matmul_ref2",
    "w4a8_matmul_int32_ref",
    "bvq_matmul_ref2",
    "gather_pages_ref",
    "paged_attn_ref",
    "decode_attn_int8_ref",
]


def block_rotate_ref(x: torch.Tensor, m: int, k: int, transpose: bool = False) -> torch.Tensor:
    """Plain version of kernels.fwht.block_rotate."""
    return _apply_blocks(x, m, k, transpose=transpose)


def rotate_plan_ref(x: torch.Tensor, plan: RotationPlan, transpose: bool = False) -> torch.Tensor:
    """Plain version of kernels.fwht.rotate_plan: the LRU's stages composed
    with rolls / concatenations, each stage rounded to x.dtype."""
    return local_rotate_transpose(x, plan) if transpose else local_rotate(x, plan)


def w4a8_matmul_ref2(xq, wp, sx, sw) -> torch.Tensor:
    """Plain version of kernels.w4a8_matmul.w4a8_matmul (packed input).

    The integer product runs in float64, which holds every partial sum
    exactly (|acc| <= 127 * 8 * K << 2**53) on CPU and GPU alike; the
    epilogue is (float32(acc) * sx) * sw, as in the reference."""
    w = unpack_int4(wp, axis=0).to(torch.float64)
    acc = xq.to(torch.float64) @ w
    return acc.to(torch.float32) * sx * sw


def w4a8_matmul_int32_ref(xq, wp) -> torch.Tensor:
    """Plain version of kernels.w4a8_matmul.w4a8_matmul_int32: the exact
    integer product (float64 holds it) as int32."""
    return (xq.to(torch.float64) @ unpack_int4(wp, axis=0).to(torch.float64)).to(torch.int32)


def bvq_matmul_ref2(x: torch.Tensor, cb: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Plain version of kernels.bvq_matmul.bvq_matmul: x @ W with W rebuilt
    from the dequantized codebooks ``cb`` (nb, C, v) and ``idx`` (nb, K/v,
    bc), rounded to x.dtype as the reference kernel does (a no-op for
    float32), f32 accumulation and output."""
    w = reconstruct_dense(cb, idx).to(x.dtype)
    return x.float() @ w.float()


def gather_pages_ref(pool: torch.Tensor, page_table: torch.Tensor) -> torch.Tensor:
    """(P, ps, KVS, hd) pool + (B, max_pages) table -> (B, max_pages*ps, KVS,
    hd) contiguous per-request K/V (the dense view of a paged cache)."""
    b, mp = page_table.shape
    _, ps, kvs, hd = pool.shape
    return pool[page_table.long()].reshape(b, mp * ps, kvs, hd)


def paged_attn_ref(
    q: torch.Tensor,  # (B, KVS, G, hd), or (B, W, KVS, G, hd) for a window
    k_pool: torch.Tensor,  # (P, page_size, KVS, hd)
    v_pool: torch.Tensor,
    page_table: torch.Tensor,  # (B, max_pages) int32 (unused slots: any valid id)
    lengths: torch.Tensor,  # (B,) int32 valid tokens (incl. the window when 5-D)
    k_scale: Optional[torch.Tensor] = None,  # (P, page_size, KVS, 1) f32 (int8 pools)
    v_scale: Optional[torch.Tensor] = None,
    tree_mask: Optional[torch.Tensor] = None,  # (B, W, W) window visibility
) -> torch.Tensor:
    """Plain version of kernels.paged_attn.paged_attention: gather the pages
    into a dense cache (dequantized to f32 with the scales when the pools
    are int8), then masked softmax attention per row.  A 5-D q is a
    W-token window whose last query sits at absolute position
    ``lengths - 1``: causal (query w sees positions <= lengths - W + w), or
    with ``tree_mask`` a speculation tree — every query sees the committed
    prefix (positions < lengths - W) and window slot j iff
    ``tree_mask[b, w, j]``."""
    windowed = q.dim() == 5
    if not windowed:
        q = q[:, None]
    b, w, kvs, g, hd = q.shape
    k = gather_pages_ref(k_pool, page_table).float()
    v = gather_pages_ref(v_pool, page_table).float()
    if k_scale is not None:
        k = k * gather_pages_ref(k_scale, page_table).float()
        v = v * gather_pages_ref(v_scale, page_table).float()
    s = k.shape[1]
    dev = q.device
    scale = 1.0 / math.sqrt(hd)
    scores = torch.einsum("bwkgh,bskh->bwkgs", q.float() * scale, k)
    if tree_mask is None:
        horizon = lengths.long()[:, None] - w + torch.arange(w, device=dev)[None, :]
        valid = torch.arange(s, device=dev)[None, None] <= horizon[..., None]  # (B, W, S)
    else:
        rel = torch.arange(s, device=dev)[None, :] - (lengths.long()[:, None] - w)  # (B, S)
        in_window = (rel >= 0) & (rel < w)
        idx = torch.clamp(rel, 0, w - 1)[:, None, :].expand(b, w, s)
        win_vis = torch.gather(tree_mask.bool(), 2, idx)
        prefix = torch.arange(s, device=dev)[None, None, :] < (lengths.long()[:, None, None] - w)
        valid = prefix | (in_window[:, None, :] & win_vis)
    scores = torch.where(valid[:, :, None, None], scores, torch.full_like(scores, -1e30))
    p = torch.softmax(scores, dim=-1)
    out = torch.einsum("bwkgs,bskh->bwkgh", p, v)
    if not windowed:
        out = out[:, 0]
    return out.float()


def decode_attn_int8_ref(
    q: torch.Tensor,  # (B, KVS, G, hd)
    k_cache: torch.Tensor,  # (B, S, KVS, hd) int8
    k_scale: torch.Tensor,  # (B, S, KVS) f32
    v_cache: torch.Tensor,
    v_scale: torch.Tensor,
    length: torch.Tensor,  # () int32 valid prefix
) -> torch.Tensor:
    """Plain version of kernels.decode_attn.decode_attention_int8: one
    token's attention over a dense int8 cache.  As in the reference kernel,
    the K scale folds into the scores and the V scale into the softmax
    weights (the cache is never dequantized); positions >= length are
    masked with -1e30.  Returns (B, KVS, G, hd) f32."""
    hd = q.shape[-1]
    s = k_cache.shape[1]
    scale = 1.0 / math.sqrt(hd)
    scores = torch.einsum("bkgh,bskh->bkgs", q.float() * scale, k_cache.float())
    scores = scores * k_scale.float().permute(0, 2, 1)[:, :, None, :]
    valid = torch.arange(s, device=q.device) < length.long()
    scores = torch.where(valid, scores, torch.full_like(scores, -1e30))
    p = torch.softmax(scores, dim=-1) * v_scale.float().permute(0, 2, 1)[:, :, None, :]
    return torch.einsum("bkgs,bskh->bkgh", p, v_cache.float())

"""Plain-torch versions of every ported kernel (torch counterpart of
repro/kernels/ref.py): the correctness ground truth.

Each function mirrors its kernel's contract exactly.  The kernel wrappers
run these for CPU tensors; on the card they serve only as the yardstick
the kernels are held against (tests and chip_smoke.py)."""
from __future__ import annotations

import math

import torch

from repro_torch.core.bvq import reconstruct_dense
from repro_torch.core.quantization import unpack_int4
from repro_torch.core.rotation import _apply_blocks

__all__ = [
    "block_rotate_ref",
    "w4a8_matmul_ref2",
    "bvq_matmul_ref2",
    "gather_pages_ref",
    "paged_attn_ref",
]


def block_rotate_ref(x: torch.Tensor, m: int, k: int, transpose: bool = False) -> torch.Tensor:
    """Plain version of kernels.fwht.block_rotate."""
    return _apply_blocks(x, m, k, transpose=transpose)


def w4a8_matmul_ref2(xq, wp, sx, sw) -> torch.Tensor:
    """Plain version of kernels.w4a8_matmul.w4a8_matmul (packed input).

    The integer product runs in float64, which holds every partial sum
    exactly (|acc| <= 127 * 8 * K << 2**53) on CPU and GPU alike; the
    epilogue is (float32(acc) * sx) * sw, as in the reference."""
    w = unpack_int4(wp, axis=0).to(torch.float64)
    acc = xq.to(torch.float64) @ w
    return acc.to(torch.float32) * sx * sw


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
) -> torch.Tensor:
    """Plain version of kernels.paged_attn.paged_attention: gather the pages
    into a dense cache, then masked softmax attention per row.  A 5-D q is
    a W-token causally masked window whose last query sits at absolute
    position ``lengths - 1``."""
    windowed = q.dim() == 5
    if not windowed:
        q = q[:, None]
    b, w, kvs, g, hd = q.shape
    k = gather_pages_ref(k_pool, page_table).float()
    v = gather_pages_ref(v_pool, page_table).float()
    s = k.shape[1]
    scale = 1.0 / math.sqrt(hd)
    scores = torch.einsum("bwkgh,bskh->bwkgs", q.float() * scale, k)
    horizon = lengths.long()[:, None] - w + torch.arange(w, device=q.device)[None, :]
    valid = torch.arange(s, device=q.device)[None, None] <= horizon[..., None]  # (B, W, S)
    scores = torch.where(valid[:, :, None, None], scores, torch.full_like(scores, -1e30))
    p = torch.softmax(scores, dim=-1)
    out = torch.einsum("bwkgs,bskh->bwkgh", p, v)
    if not windowed:
        out = out[:, 0]
    return out.float()

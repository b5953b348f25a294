"""Paged-attention wrapper: ``csrc/paged_attn.cu`` on the card, the plain
version (kernels/ref.py) on the CPU.

Replaces the Pallas kernel
``repro/kernels/paged_attn.py:paged_decode_attention_pallas`` with all four
of its bodies: fp pools, int8 pools with per-(slot, head) scales, and each
of those under a speculation-tree window mask.  The contract is the
reference's (its docstring, lines 43-62): unused table slots hold any
in-range page id and the length mask decides validity; a row of length 0
gives finite output; padded window queries never change earlier rows.

Launches count under the body that ran: ``paged_attention`` (fp, causal),
``paged_attention_int8``, ``paged_attention_tree`` and
``paged_attention_int8_tree``.  The kernel reads q in its own dtype (bf16 or
f32; others are widened to f32 first) and writes f32.  It takes head dims
that are multiples of 8 in [16, 128] and windows of any width (each block
keeps its rows' window masks, ceil(W / 32) words a row, in shared memory).
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import _lib
from repro_torch.kernels.ref import paged_attn_ref

__all__ = ["paged_attention"]


def paged_attention(
    q: torch.Tensor,  # (B, KVS, G, hd) or (B, W, KVS, G, hd), any float dtype
    k_pool: torch.Tensor,  # (P, page_size, KVS, hd): float32, bfloat16, or int8 with scales
    v_pool: torch.Tensor,
    page_table: torch.Tensor,  # (B, max_pages) int32
    lengths: torch.Tensor,  # (B,) int32 valid tokens incl. the window
    k_scale: Optional[torch.Tensor] = None,  # (P, page_size, KVS, 1) float32
    v_scale: Optional[torch.Tensor] = None,
    tree_mask: Optional[torch.Tensor] = None,  # (B, W, W), 5-D q only
) -> torch.Tensor:
    """Attention through the page table (no dense cache copy), f32 out in
    q's shape.  A 5-D q scores a W-token window: causally (query w sees
    positions <= lengths - W + w), or with ``tree_mask`` as a speculation
    tree (every query sees the committed prefix, positions < lengths - W,
    and window slot j iff ``tree_mask[b, w, j]``).  With the scales the
    pools are int8 and each page is dequantized (``int8 * scale``) before
    it meets q."""
    quantized = k_scale is not None
    if quantized != (v_scale is not None):
        raise ValueError("paged_attention: pass both k_scale and v_scale, or neither")
    if tree_mask is not None and q.dim() != 5:
        raise ValueError("paged_attention: tree_mask needs a 5-D window q")
    if q.device.type == "cpu":
        return paged_attn_ref(q, k_pool, v_pool, page_table, lengths,
                              k_scale=k_scale, v_scale=v_scale, tree_mask=tree_mask)
    q5 = q if q.dim() == 5 else q[:, None]
    if q5.dtype not in (torch.float32, torch.bfloat16):
        q5 = q5.float()
    q5 = q5.contiguous()
    extra = [t for t in (k_scale, v_scale, tree_mask) if t is not None]
    dev = _lib.require_cuda("paged_attention", q5, k_pool, v_pool, page_table, lengths, *extra)
    b, w, kvs, g, hd = q5.shape
    _, ps, pool_kvs, pool_hd = k_pool.shape
    if (pool_kvs, pool_hd) != (kvs, hd) or v_pool.shape != k_pool.shape:
        raise ValueError(f"paged_attention: pools {k_pool.shape} do not match q {q.shape}")
    if page_table.dtype != torch.int32 or lengths.dtype != torch.int32:
        raise TypeError("paged_attention: page_table and lengths must be int32")
    if page_table.shape[0] != b or lengths.shape != (b,):
        raise ValueError("paged_attention: page_table/lengths batch mismatch")
    if v_pool.dtype != k_pool.dtype:
        raise TypeError("paged_attention: k and v pools must share a dtype")
    if quantized != (k_pool.dtype == torch.int8):
        raise TypeError("paged_attention: int8 pools need scales, and only int8 pools take them")
    if quantized:
        for sc in (k_scale, v_scale):
            if sc.dtype != torch.float32 or sc.shape != k_pool.shape[:-1] + (1,):
                raise ValueError(f"paged_attention: scales must be float32 "
                                 f"{tuple(k_pool.shape[:-1]) + (1,)}, got {sc.dtype} {sc.shape}")
    if tree_mask is not None:
        if tree_mask.dtype != torch.float32 or tree_mask.shape != (b, w, w):
            raise ValueError(f"paged_attention: tree_mask must be float32 {(b, w, w)}, "
                             f"got {tree_mask.dtype} {tuple(tree_mask.shape)}")
    if hd % 8 or not 16 <= hd <= 128:
        raise ValueError(f"paged_attention: the kernel takes hd a multiple of 8 in [16, 128], "
                         f"got hd={hd}")
    if any(t.data_ptr() % 16 for t in (q5, k_pool, v_pool)):
        raise ValueError("paged_attention: q and the pools must be 16-byte aligned")
    mp = page_table.shape[1]
    splits = _lib.attn_splits(_lib.sm_count(dev), b * kvs, mp * ps)
    ws, cnt = _lib.attn_scratch(dev, splits, b * kvs, w * g, hd)
    out = torch.empty(q5.shape, dtype=torch.float32, device=dev)

    def ptr(t):
        return None if t is None else t.data_ptr()

    err = _lib.lib().repro_paged_attn(
        q5.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(), ptr(k_scale), ptr(v_scale),
        ptr(tree_mask), page_table.data_ptr(), lengths.data_ptr(), out.data_ptr(), ptr(ws),
        ptr(cnt), b, w, kvs, g, hd, ps, mp, _lib.dtype_code(k_pool.dtype),
        _lib.dtype_code(q5.dtype), splits, _lib.stream_ptr(dev),
    )
    _lib.check(err, "paged_attention")
    body = ("_int8" if quantized else "") + ("_tree" if tree_mask is not None else "")
    _lib.launches["paged_attention" + body] += 1
    return out if q.dim() == 5 else out[:, 0]

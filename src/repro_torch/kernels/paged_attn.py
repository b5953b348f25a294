"""Paged-attention wrapper (fp pools): ``csrc/paged_attn.cu`` on the card,
the plain version (kernels/ref.py) on the CPU.

Replaces the fp-pool body of the Pallas kernel
``repro/kernels/paged_attn.py:paged_decode_attention_pallas``.  The
contract is the reference's (its docstring, lines 43-62): unused table
slots hold any in-range page id and the length mask decides validity; a
row of length 0 gives finite output; padded window queries never change
earlier rows.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _lib
from repro_torch.kernels.ref import paged_attn_ref

__all__ = ["paged_attention"]


def paged_attention(
    q: torch.Tensor,  # (B, KVS, G, hd) or (B, W, KVS, G, hd), any float dtype
    k_pool: torch.Tensor,  # (P, page_size, KVS, hd), float32 or bfloat16
    v_pool: torch.Tensor,
    page_table: torch.Tensor,  # (B, max_pages) int32
    lengths: torch.Tensor,  # (B,) int32 valid tokens incl. the window
) -> torch.Tensor:
    """Attention through the page table (no dense cache copy), f32 out in
    q's shape.  A 5-D q scores a W-token window causally: query w sees
    positions <= lengths - W + w."""
    if q.device.type == "cpu":
        return paged_attn_ref(q, k_pool, v_pool, page_table, lengths)
    q5 = q if q.dim() == 5 else q[:, None]
    q5 = q5.float().contiguous()
    dev = _lib.require_cuda("paged_attention", q5, k_pool, v_pool, page_table, lengths)
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
    code = _lib.dtype_code(k_pool.dtype)
    out = torch.empty_like(q5)
    err = _lib.lib().repro_paged_attn(
        q5.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(), page_table.data_ptr(),
        lengths.data_ptr(), out.data_ptr(), b, w, kvs, g, hd, ps, page_table.shape[1],
        code, _lib.stream_ptr(dev),
    )
    _lib.check(err, "paged_attention")
    _lib.launches["paged_attention"] += 1
    return out if q.dim() == 5 else out[:, 0]

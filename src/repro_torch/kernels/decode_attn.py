"""Dense int8 decode-attention wrapper: ``csrc/decode_attn.cu`` on the
card, the plain version (kernels/ref.py) on the CPU.

Replaces the Pallas kernel
``repro/kernels/decode_attn.py:decode_attention_int8_pallas``: one decoded
token's attention over a contiguous int8 KV cache with per-(token, head)
f32 scales, the K scale folded into the scores and the V scale into the
softmax weights.  No serving path of the reference calls it, nor of the
port; chip_smoke.py and the card tests hold it against its plain version.
Launches count as ``decode_attention_int8``.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _lib
from repro_torch.kernels.ref import decode_attn_int8_ref

__all__ = ["decode_attention_int8"]


def decode_attention_int8(
    q: torch.Tensor,  # (B, KVS, G, hd), any float dtype
    k_cache: torch.Tensor,  # (B, S, KVS, hd) int8
    k_scale: torch.Tensor,  # (B, S, KVS) float32
    v_cache: torch.Tensor,
    v_scale: torch.Tensor,
    length: torch.Tensor,  # () int32 valid prefix, incl. the new token
    block_s: int = 512,
) -> torch.Tensor:
    """out (B, KVS, G, hd) f32.  ``block_s`` is the reference's TPU tile
    length; it is validated as there (it divides S once clipped to S) and
    does not change the result.  The kernel reads q in its own dtype (bf16
    or f32; others are widened to f32 first) and takes head dims that are
    multiples of 8 in [16, 128]."""
    b, kvs, g, hd = q.shape
    s = k_cache.shape[1]
    if s % min(block_s, s):
        raise ValueError(f"decode_attention_int8: block_s {block_s} does not tile S={s}")
    if q.device.type == "cpu":
        return decode_attn_int8_ref(q, k_cache, k_scale, v_cache, v_scale, length)
    qf = (q if q.dtype in (torch.float32, torch.bfloat16) else q.float()).contiguous()
    dev = _lib.require_cuda("decode_attention_int8", qf, k_cache, k_scale, v_cache, v_scale,
                            length)
    if k_cache.dtype != torch.int8 or v_cache.dtype != torch.int8:
        raise TypeError("decode_attention_int8: caches must be int8")
    if k_cache.shape != (b, s, kvs, hd) or v_cache.shape != k_cache.shape:
        raise ValueError(f"decode_attention_int8: caches {k_cache.shape} do not match q {q.shape}")
    for sc in (k_scale, v_scale):
        if sc.dtype != torch.float32 or sc.shape != (b, s, kvs):
            raise ValueError(f"decode_attention_int8: scales must be float32 {(b, s, kvs)}")
    if length.dtype != torch.int32 or length.numel() != 1:
        raise TypeError("decode_attention_int8: length must be one int32")
    if hd % 8 or not 16 <= hd <= 128:
        raise ValueError(f"decode_attention_int8: the kernel takes hd a multiple of 8 in "
                         f"[16, 128], got {hd}")
    if any(t.data_ptr() % 16 for t in (qf, k_cache, v_cache)):
        raise ValueError("decode_attention_int8: q and the caches must be 16-byte aligned")
    splits = _lib.attn_splits(_lib.sm_count(dev), b * kvs, s)
    ws, cnt = _lib.attn_scratch(dev, splits, b * kvs, g, hd)
    out = torch.empty(qf.shape, dtype=torch.float32, device=dev)
    err = _lib.lib().repro_decode_attn_int8(
        qf.data_ptr(), k_cache.data_ptr(), k_scale.data_ptr(), v_cache.data_ptr(),
        v_scale.data_ptr(), length.data_ptr(), out.data_ptr(),
        None if ws is None else ws.data_ptr(), None if cnt is None else cnt.data_ptr(),
        b, s, kvs, g, hd, _lib.dtype_code(qf.dtype), splits, _lib.stream_ptr(dev),
    )
    _lib.check(err, "decode_attention_int8")
    _lib.launches["decode_attention_int8"] += 1
    return out

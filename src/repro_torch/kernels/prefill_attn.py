"""Prefill flash-attention wrapper (K8): ``csrc/prefill_attn.cu`` on the
card.

Replaces no TPU kernel: the reference computes prefill attention in plain
jnp, and so does the port's plain version, ``models/layers.flash_attention``
(its ``_flash_block`` loop), which stays the route for CPU and meta tensors,
float32 models and calls autograd records through.  ``flash_attention``
hands this wrapper every other call: bf16 or fp16 CUDA tensors, one launch
per call, the same function at the same precision (only the order of the
sums differs).  Launches count as ``prefill_attention``.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _lib

__all__ = ["HEAD_DIMS", "prefill_attention"]

HEAD_DIMS = (16, 32, 64, 112, 128)  # the kernel's template instances


def prefill_attention(
    q: torch.Tensor,  # (B, Sq, H, hd)
    k: torch.Tensor,  # (B, Skv, Hkv, hd), any strides with the last axis contiguous
    v: torch.Tensor,
    causal: bool,
    q_offset: int = 0,
) -> torch.Tensor:
    """Out (B, Sq, H, hd) in q's dtype.  Causal: row i sits at position
    ``q_offset + i`` and sees the keys at positions up to its own; keys
    at ``q_offset + Sq`` and past are never read.  Otherwise every row sees
    all Skv keys.  K / V are read in place: a dense cache's layer view needs
    no copy."""
    b, sq, h, hd = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    dev = q.device
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device != dev or t.device.type != "cuda":
            raise ValueError(f"prefill_attention: {name} must be on q's CUDA device, "
                             f"got {t.device}")
        if t.dtype != q.dtype:
            raise TypeError(f"prefill_attention: {name} is {t.dtype}, q is {q.dtype}")
        if t.stride(-1) != 1 or any(s % 8 for s in t.stride()[:-1]) or t.data_ptr() % 16:
            raise ValueError(f"prefill_attention: {name} needs a contiguous last axis and "
                             "16-byte aligned rows")
    if q.dtype not in (torch.bfloat16, torch.float16):
        raise TypeError(f"prefill_attention: bf16 or fp16 only, got {q.dtype}")
    if k.shape != (b, skv, hkv, hd) or v.shape != k.shape:
        raise ValueError(f"prefill_attention: k {tuple(k.shape)} / v {tuple(v.shape)} do not "
                         f"match q {tuple(q.shape)}")
    if hd not in HEAD_DIMS:
        raise ValueError(f"prefill_attention: head dim {hd} not in {HEAD_DIMS}")
    if h % hkv:
        raise ValueError(f"prefill_attention: {h} q heads over {hkv} kv heads")
    if q_offset < 0:
        raise ValueError(f"prefill_attention: q_offset {q_offset} < 0")
    out = torch.empty((b, sq, h, hd), dtype=q.dtype, device=dev)
    err = _lib.lib().repro_prefill_attn(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
        b, sq, skv, h, hkv, hd, int(q_offset), int(bool(causal)),
        int(q.dtype == torch.float16), _lib.stream_ptr(dev),
    )
    _lib.check(err, "prefill_attention")
    _lib.launches["prefill_attention"] += 1
    return out

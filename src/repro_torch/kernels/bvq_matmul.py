"""BVQ matmul wrapper: ``csrc/bvq_matmul.cu`` on the card, the plain
version (kernels/ref.py) on the CPU.

Replaces the Pallas kernel ``repro/kernels/bvq_matmul.py:bvq_matmul_pallas``.
The codebooks arrive already dequantized (``core.bvq.dequant_codebooks``,
done once at load time instead of inside every call).
"""
from __future__ import annotations

import functools

import torch

from repro_torch.kernels import _lib
from repro_torch.kernels.ref import bvq_matmul_ref2

__all__ = ["bvq_matmul", "plan"]

_K_STAGE = 32  # K values per pipeline stage of the kernel
_CHANNELS_PER_CTA = 64


@functools.lru_cache(maxsize=None)
def plan(m: int, k: int, n: int, sms: int) -> _lib.Plan:
    """The launch plan: 64-channel tiles, K split until the grid has at
    least one CTA per SM (every split a whole number of stages)."""
    mt, passes = _lib.token_tiles(m)
    k_stages = -(-k // _K_STAGE)
    ctas = -(-n // _CHANNELS_PER_CTA)
    want = -(-sms // (ctas * passes))
    sps = max(1, k_stages // want)
    return _lib.Plan(mt, passes, ctas, -(-k_stages // sps), sps, k_stages)


def bvq_matmul(x: torch.Tensor, cb: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """y = x @ W, W[row*v + t, j*bc + col] = cb[j, idx[j, row, col], t].

    x (M, K) float32 or bfloat16; cb (nb, C, v) f32; idx (nb, K/v, bc)
    int32 -> (M, nb*bc) f32.  On the card v must divide 32 (and be a
    multiple of 4) and bc must be a multiple of 16."""
    if x.device.type == "cpu":
        return bvq_matmul_ref2(x, cb, idx)
    dev = _lib.require_cuda("bvq_matmul", x, cb, idx)
    m, k = x.shape
    nb, c, v = cb.shape
    nb2, rows, bc = idx.shape
    if cb.dtype != torch.float32 or idx.dtype != torch.int32:
        raise TypeError("bvq_matmul: cb must be float32 and idx int32")
    if nb2 != nb or rows * v != k:
        raise ValueError(f"bvq_matmul: shapes x {x.shape} cb {cb.shape} idx {idx.shape}")
    if v % 4 or _K_STAGE % v or bc % 16:
        raise ValueError(f"bvq_matmul: the kernel needs v in (4, 8, 16, 32) and bc % 16 == 0, "
                         f"got v={v} bc={bc}")
    code = _lib.dtype_code(x.dtype)
    n = nb * bc
    p = plan(m, k, n, _lib.sm_count(dev))
    out = torch.empty((m, n), dtype=torch.float32, device=dev)
    ws = cnt = None
    if p.ksplit > 1:
        ws = _lib.scratch(dev, "bvq_ws", _lib.split_k_elems(p), torch.float32)
        cnt = _lib.scratch(dev, "bvq_cnt", p.passes * p.ctas, torch.int32)
    err = _lib.lib().repro_bvq_matmul(
        x.data_ptr(), cb.data_ptr(), idx.data_ptr(), out.data_ptr(),
        ws.data_ptr() if ws is not None else None, cnt.data_ptr() if cnt is not None else None,
        m, k, nb, c, v, bc, code, p.mt, p.ksplit, p.stages_per_split, _lib.stream_ptr(dev),
    )
    _lib.check(err, "bvq_matmul")
    _lib.launches["bvq_matmul"] += 1
    return out

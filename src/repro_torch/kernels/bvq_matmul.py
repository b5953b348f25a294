"""BVQ matmul wrapper: ``csrc/bvq_matmul.cu`` on the card, the plain
version (kernels/ref.py) on the CPU.

Replaces the Pallas kernel ``repro/kernels/bvq_matmul.py:bvq_matmul_pallas``.
The codebooks arrive already dequantized (``core.bvq.dequant_codebooks``,
done once at load time instead of inside every call).
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _lib
from repro_torch.kernels.ref import bvq_matmul_ref2

__all__ = ["bvq_matmul"]


def bvq_matmul(x: torch.Tensor, cb: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """y = x @ W, W[row*v + t, j*bc + col] = cb[j, idx[j, row, col], t].

    x (M, K) float32 or bfloat16; cb (nb, C, v) f32; idx (nb, K/v, bc)
    int32 -> (M, nb*bc) f32."""
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
    code = _lib.dtype_code(x.dtype)
    out = torch.empty((m, nb * bc), dtype=torch.float32, device=dev)
    err = _lib.lib().repro_bvq_matmul(
        x.data_ptr(), cb.data_ptr(), idx.data_ptr(), out.data_ptr(),
        m, k, nb, c, v, bc, code, _lib.stream_ptr(dev),
    )
    _lib.check(err, "bvq_matmul")
    _lib.launches["bvq_matmul"] += 1
    return out

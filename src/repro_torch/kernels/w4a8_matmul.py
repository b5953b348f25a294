"""W4A8 GEMM wrapper: ``csrc/w4a8_matmul.cu`` on the card, the plain
version (kernels/ref.py) on the CPU.

Replaces the Pallas kernel ``repro/kernels/w4a8_matmul.py:w4a8_matmul_pallas``.
"""
from __future__ import annotations

import functools

import torch

from repro_torch.kernels import _lib
from repro_torch.kernels.ref import w4a8_matmul_ref2

__all__ = ["w4a8_matmul"]

_MIN_K_PER_SPLIT = 64  # K values one split of the K loop covers at least
_BLOCKS_PER_SM = 8  # resident blocks wanted per SM to hide load latency


@functools.lru_cache(maxsize=None)
def _sm_count(dev: torch.device) -> int:
    return torch.cuda.get_device_properties(dev).multi_processor_count


def _ksplit(dev: torch.device, m: int, k: int, n: int) -> int:
    """Split K over the grid when the (N, M) tiles alone leave SMs short
    of resident warps (decode shapes): the loop is bound by load latency,
    so aim at _BLOCKS_PER_SM blocks per SM."""
    lib = _lib.lib()
    tiles = -(-n // lib.repro_w4a8_cols_per_block()) * -(-m // lib.repro_w4a8_rows_per_block())
    want = -(-_BLOCKS_PER_SM * _sm_count(dev) // tiles)
    return max(1, min(want, k // _MIN_K_PER_SPLIT))


def w4a8_matmul(xq: torch.Tensor, wp: torch.Tensor, sx: torch.Tensor,
                sw: torch.Tensor) -> torch.Tensor:
    """y = (xq @ unpack_int4(wp)) * sx * sw with int32 accumulation.

    xq (M, K) int8; wp (K/2, N) int8 nibble-packed along K (low nibble =
    element 2i); sx (M, 1) f32; sw (1, N) f32 -> (M, N) f32."""
    if xq.device.type == "cpu":
        return w4a8_matmul_ref2(xq, wp, sx, sw)
    dev = _lib.require_cuda("w4a8_matmul", xq, wp, sx, sw)
    m, k = xq.shape
    k2, n = wp.shape
    if xq.dtype != torch.int8 or wp.dtype != torch.int8:
        raise TypeError("w4a8_matmul: xq and wp must be int8")
    if sx.dtype != torch.float32 or sw.dtype != torch.float32:
        raise TypeError("w4a8_matmul: scales must be float32")
    if k != 2 * k2 or sx.shape != (m, 1) or sw.shape != (1, n):
        raise ValueError(f"w4a8_matmul: shapes {xq.shape} {wp.shape} {sx.shape} {sw.shape}")
    if k % 4 or n % 4 or xq.data_ptr() % 4 or wp.data_ptr() % 4:
        raise ValueError("w4a8_matmul: needs K % 4 == 0, N % 4 == 0 and 4-byte aligned inputs")
    ksplit = _ksplit(dev, m, k, n)
    out = torch.empty((m, n), dtype=torch.float32, device=dev)
    ws = torch.zeros((m, n), dtype=torch.int32, device=dev) if ksplit > 1 else None
    err = _lib.lib().repro_w4a8_matmul(
        xq.data_ptr(), wp.data_ptr(), sx.data_ptr(), sw.data_ptr(), out.data_ptr(),
        ws.data_ptr() if ws is not None else None, m, k, n, ksplit, _lib.stream_ptr(dev),
    )
    _lib.check(err, "w4a8_matmul")
    _lib.launches["w4a8_matmul"] += 1
    return out

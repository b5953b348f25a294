"""LRU block-rotation wrapper: ``csrc/fwht.cu`` on the card, the plain
version (kernels/ref.py) on the CPU.

Replaces the Pallas kernel ``repro/kernels/fwht.py:block_rotate_pallas``.
Two-stage (tiled / two-block) plans compose from this single-stage kernel
in ``kernels/ops.lru_rotate``.
"""
from __future__ import annotations

import functools

import torch

from repro_torch.core import hadamard
from repro_torch.kernels import _lib
from repro_torch.kernels.ref import block_rotate_ref

__all__ = ["block_rotate"]


@functools.lru_cache(maxsize=None)
def _hm(m: int, dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    """The +-1 H_m factor in x's dtype on x's device, as the reference
    passes it to its kernel."""
    return torch.as_tensor(hadamard.hadamard_matrix(m), dtype=dtype, device=device)


def block_rotate(x: torch.Tensor, m: int, k: int, transpose: bool = False) -> torch.Tensor:
    """y = x @ kron(I_{n/B}, H_B / sqrt(B)) over the last axis, B = m * 2**k.

    x: (..., n) with n % B == 0; leading dims flatten into tokens."""
    if x.device.type == "cpu":
        return block_rotate_ref(x, m, k, transpose=transpose)
    b = m << k
    n = x.shape[-1]
    if n % b:
        raise ValueError(f"block_rotate: n={n} is not a multiple of B={b}")
    lead = x.shape[:-1]
    x2 = x.reshape(-1, n).contiguous()
    dev = _lib.require_cuda("block_rotate", x2)
    code = _lib.dtype_code(x.dtype)
    hm = _hm(m, x.dtype, dev)
    out = torch.empty_like(x2)
    err = _lib.lib().repro_block_rotate(
        x2.data_ptr(), hm.data_ptr(), out.data_ptr(), x2.shape[0], n, m, k,
        int(transpose), code, _lib.stream_ptr(dev),
    )
    _lib.check(err, "block_rotate")
    _lib.launches["block_rotate"] += 1
    return out.reshape(*lead, n)

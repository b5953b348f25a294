"""The entry points the model layers call (torch counterpart of
repro/kernels/ops.py): the LRU rotation of a whole plan, dynamic activation
quantization, and the linear wrappers.

The device decides the path: each kernel wrapper launches its CUDA kernel
for a CUDA tensor (or raises) and runs its plain version for a CPU tensor.
There is no other switch and no fallback."""
from __future__ import annotations

import torch

from repro_torch.core import quantization as q
from repro_torch.core import rotation as rot
from repro_torch.kernels.bvq_matmul import bvq_matmul
from repro_torch.kernels.fwht import rotate_plan
from repro_torch.kernels.w4a8_matmul import w4a8_matmul

__all__ = ["lru_rotate", "lru_rotate_transpose", "w4a8_linear", "bvq_linear"]


def lru_rotate(x: torch.Tensor, plan: rot.RotationPlan) -> torch.Tensor:
    """y = x @ R for any RotationPlan: one kernel launch on the card."""
    return rotate_plan(x, plan)


def lru_rotate_transpose(x: torch.Tensor, plan: rot.RotationPlan) -> torch.Tensor:
    """y = x @ R^T."""
    return rotate_plan(x, plan, transpose=True)


def w4a8_linear(x: torch.Tensor, packed_w: torch.Tensor, sw: torch.Tensor) -> torch.Tensor:
    """Dynamic-A8 linear over packed W4 weights: y = Q8(x) @ W4 * sx * sw,
    returned in x's dtype."""
    lead = x.shape[:-1]
    x2 = x.reshape(-1, x.shape[-1])
    xq, sx = q.quantize_act_int8(x2)
    y = w4a8_matmul(xq, packed_w, sx, sw)
    return y.reshape(*lead, -1).to(x.dtype)


def bvq_linear(x: torch.Tensor, cb: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """y = x @ reconstruct(cb, idx) with on-the-fly codebook decode,
    returned in x's dtype."""
    lead = x.shape[:-1]
    x2 = x.reshape(-1, x.shape[-1]).contiguous()
    y = bvq_matmul(x2, cb, idx)
    return y.reshape(*lead, -1).to(x.dtype)

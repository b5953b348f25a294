"""The entry points the model layers call (torch counterpart of
repro/kernels/ops.py): plan composition for multi-stage rotations, dynamic
activation quantization, and the linear wrappers.

The device decides the path: each kernel wrapper launches its CUDA kernel
for a CUDA tensor (or raises) and runs its plain version for a CPU tensor.
There is no other switch and no fallback."""
from __future__ import annotations

import torch

from repro_torch.core import quantization as q
from repro_torch.core import rotation as rot
from repro_torch.kernels.bvq_matmul import bvq_matmul
from repro_torch.kernels.fwht import block_rotate
from repro_torch.kernels.w4a8_matmul import w4a8_matmul

__all__ = ["lru_rotate", "lru_rotate_transpose", "w4a8_linear", "bvq_linear"]


def lru_rotate(x: torch.Tensor, plan: rot.RotationPlan) -> torch.Tensor:
    """y = x @ R for any RotationPlan, one block_rotate launch per stage."""
    n, b = plan.n, plan.block
    assert x.shape[-1] == n
    if plan.kind == "exact":
        return block_rotate(x, plan.m, plan.k)
    if plan.kind == "tiled":
        y = block_rotate(x, plan.m, plan.k)
        shift = b // 2
        y = torch.roll(y, -shift, dims=-1)
        y = block_rotate(y, plan.m, plan.k)
        return torch.roll(y, shift, dims=-1)
    upper = block_rotate(x[..., :b], plan.m, plan.k)
    x = torch.cat([upper, x[..., b:]], dim=-1)
    lower = block_rotate(x[..., n - b:], plan.m, plan.k)
    return torch.cat([x[..., : n - b], lower], dim=-1)


def lru_rotate_transpose(x: torch.Tensor, plan: rot.RotationPlan) -> torch.Tensor:
    """y = x @ R^T."""
    n, b = plan.n, plan.block
    assert x.shape[-1] == n
    if plan.kind == "exact":
        return block_rotate(x, plan.m, plan.k, transpose=True)
    if plan.kind == "tiled":
        shift = b // 2
        y = torch.roll(x, -shift, dims=-1)
        y = block_rotate(y, plan.m, plan.k, transpose=True)
        y = torch.roll(y, shift, dims=-1)
        return block_rotate(y, plan.m, plan.k, transpose=True)
    lower = block_rotate(x[..., n - b:], plan.m, plan.k, transpose=True)
    x = torch.cat([x[..., : n - b], lower], dim=-1)
    upper = block_rotate(x[..., :b], plan.m, plan.k, transpose=True)
    return torch.cat([upper, x[..., b:]], dim=-1)


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

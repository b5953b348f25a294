"""W4A8 quantization substrate (torch counterpart of repro/core/quantization.py).

INT4 per-output-channel symmetric weights, INT8 dynamic per-token
activations, nibble packing, and the straight-through fake quantizers of
QAT.  ``torch.round`` rounds half to even like
``jnp.round``, and the scale is applied by true division ``x / s`` (a
reciprocal multiply would flip roundings at .5 boundaries), so the integer
outputs are bit-identical to the reference on identical inputs."""
from __future__ import annotations

from typing import Tuple, Union

import torch

__all__ = [
    "quantize_act_int8",
    "quantize_weight_int",
    "fake_quant_act",
    "fake_quant_weight",
    "pack_int4",
    "unpack_int4",
    "sqnr_db",
]

INT8_QMAX = 127
INT4_QMAX = 7

Axis = Union[int, Tuple[int, ...]]


def _absmax_scale(x: torch.Tensor, axis: Axis, qmax: int) -> torch.Tensor:
    s = torch.amax(torch.abs(x), dim=axis, keepdim=True) / qmax
    return torch.clamp(s, min=1e-8)


def quantize_act_int8(x: torch.Tensor, axis: int = -1) -> Tuple[torch.Tensor, torch.Tensor]:
    """Dynamic per-token symmetric INT8: returns (q int8, scale f32)."""
    xf = x.float()
    s = _absmax_scale(xf, axis, INT8_QMAX)
    q = torch.clamp(torch.round(xf / s), -INT8_QMAX, INT8_QMAX)
    return q.to(torch.int8), s


def quantize_weight_int(
    w: torch.Tensor, bits: int = 4, axis: Axis = 0
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-output-channel symmetric INT<bits>; ``axis`` is the reduced
    (input) dim.  Returns (q int8-storage, scale f32)."""
    qmax = (1 << (bits - 1)) - 1
    wf = w.float()
    s = _absmax_scale(wf, axis, qmax)
    q = torch.clamp(torch.round(wf / s), -qmax, qmax)
    return q.to(torch.int8), s


def fake_quant_act(x: torch.Tensor, axis: Axis = -1) -> torch.Tensor:
    """Straight-through INT8 fake-quant (QAT): the forward value is the
    quantized ``x``, the gradient passes through as identity."""
    s = _absmax_scale(x.detach(), axis, INT8_QMAX)
    q = torch.clamp(torch.round(x / s), -INT8_QMAX, INT8_QMAX) * s
    return x + (q - x).detach()


def fake_quant_weight(w: torch.Tensor, bits: int = 4, axis: Axis = 0) -> torch.Tensor:
    """Straight-through INT<bits> fake-quant (QAT), scale per reduced
    ``axis`` taken from the detached ``w``."""
    qmax = (1 << (bits - 1)) - 1
    s = _absmax_scale(w.detach(), axis, qmax)
    q = torch.clamp(torch.round(w / s), -qmax, qmax) * s
    return w + (q - w).detach()


def pack_int4(q: torch.Tensor, axis: int = 0) -> torch.Tensor:
    """Pack int4 values (int8 storage) pairwise along ``axis``: element 2i ->
    low nibble, 2i+1 -> high nibble."""
    assert q.shape[axis] % 2 == 0
    idx = torch.arange(0, q.shape[axis], 2, device=q.device)
    lo = torch.index_select(q, axis, idx).to(torch.int32)
    hi = torch.index_select(q, axis, idx + 1).to(torch.int32)
    return ((hi << 4) | (lo & 0xF)).to(torch.int8)


def unpack_int4(packed: torch.Tensor, axis: int = 0) -> torch.Tensor:
    """Inverse of pack_int4 (sign-extends nibbles)."""
    p = packed.to(torch.int32)
    lo = (p << 28) >> 28
    hi = p >> 4
    ax = axis % packed.dim()
    stacked = torch.stack([lo, hi], dim=ax + 1)
    shape = list(packed.shape)
    shape[ax] *= 2
    return stacked.reshape(shape).to(torch.int8)


def sqnr_db(ref: torch.Tensor, approx: torch.Tensor) -> float:
    """Signal-to-quantization-noise ratio in dB."""
    r = ref.float()
    num = torch.sum(r * r)
    den = torch.sum((r - approx.float()) ** 2) + 1e-12
    return float(10.0 * torch.log10(num / den))

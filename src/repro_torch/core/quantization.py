"""W4A8 quantization substrate (torch counterpart of repro/core/quantization.py).

INT4 per-output-channel symmetric weights, INT8 dynamic per-token
activations, nibble packing, and the straight-through fake quantizers of
QAT.  ``torch.round`` rounds half to even like
``jnp.round``, and the scale is applied by true division ``x / s`` (a
reciprocal multiply would flip roundings at .5 boundaries), so the integer
outputs are bit-identical to the reference on identical inputs.
``QuantizedLinear`` with ``quantized_linear_apply`` is the offline-quantized
layer: the W4A8 kernel on the card, ``w4a8_matmul_ref`` on the CPU."""
from __future__ import annotations

import dataclasses
import functools
from typing import Optional, Tuple, Union

import numpy as np
import torch

__all__ = [
    "quantize_act_int8",
    "quantize_weight_int",
    "fake_quant_act",
    "fake_quant_weight",
    "pack_int4",
    "unpack_int4",
    "div_scalar",
    "w4a8_matmul_ref",
    "QuantizedLinear",
    "quantize_linear_weights",
    "quantized_linear_apply",
    "sqnr_db",
]

INT8_QMAX = 127
INT4_QMAX = 7

Axis = Union[int, Tuple[int, ...]]


@functools.lru_cache(maxsize=None)
def _divisor(value: float, dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    return torch.full((), value, dtype=dtype, device=device)


def div_scalar(x: torch.Tensor, value: float) -> torch.Tensor:
    """x / value, correctly rounded on every device.  torch's CUDA division
    by a Python scalar multiplies by the scalar's reciprocal, which puts
    some quotients an ulp off the true one, and a quantizer's scale that
    far off can flip a code at a .5 boundary; a 0-dim divisor tensor on
    x's device keeps true division."""
    return x / _divisor(float(value), x.dtype, x.device)


def _absmax_scale(x: torch.Tensor, axis: Axis, qmax: int) -> torch.Tensor:
    s = div_scalar(torch.amax(torch.abs(x), dim=axis, keepdim=True), qmax)
    return torch.clamp(s, min=1e-8)


def quantize_act_int8(x: torch.Tensor, axis: int = -1, amax: Optional[torch.Tensor] = None
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Dynamic per-token symmetric INT8: returns (q int8, scale f32).
    ``amax`` (keepdim, float32) replaces x's own absolute maximum: a
    row-parallel shard quantizes with the maximum over the whole row."""
    xf = x.float()
    if amax is None:
        s = _absmax_scale(xf, axis, INT8_QMAX)
    else:
        s = torch.clamp(div_scalar(amax, INT8_QMAX), min=1e-8)
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


def w4a8_matmul_ref(xq: torch.Tensor, sx: torch.Tensor, wq: torch.Tensor,
                    sw: torch.Tensor) -> torch.Tensor:
    """Plain W4A8 GEMM: y = (xq int8 @ wq int4) * sx * sw.

    xq (..., K) int8, sx (..., 1) f32, wq (K, N) int8 storage of int4
    values, sw (1, N) f32 -> f32 (..., N).  The integer product runs in
    float64, which holds every partial sum exactly (|acc| <= 127 * 7 * K <<
    2**53), so it equals the reference's int32 accumulation on any device."""
    acc = xq.to(torch.float64) @ wq.to(torch.float64)
    return acc.to(torch.float32) * sx * sw.reshape(1, -1)


@dataclasses.dataclass
class QuantizedLinear:
    """Offline-quantized linear layer (the target's W4A8 serving path).

    ``wq`` stores int4 values in int8; ``packed`` holds the same weight
    nibble-packed along K and reordered for the W4A8 kernel
    (``kernels/w4a8_matmul.prepack``), the layout ``quantized_linear_apply``
    hands the kernel on the card."""

    wq: torch.Tensor  # (K, N) int8 storage of int4
    sw: torch.Tensor  # (1, N) f32
    bits: int = 4
    packed: Optional[torch.Tensor] = None  # (ceil(N/16), 2*ceil(K/128), 512) int8

    @classmethod
    def from_reference(cls, ql, device="cuda") -> "QuantizedLinear":
        """Carry a reference ``QuantizedLinear`` (or anything with numpy-
        readable ``wq`` / ``sw`` and ``bits``) onto ``device``, packing the
        kernel's layout from ``wq``."""
        wq = torch.from_numpy(np.asarray(ql.wq, np.int8).copy()).to(device)
        sw = torch.from_numpy(np.asarray(ql.sw, np.float32).reshape(1, -1).copy()).to(device)
        return cls(wq=wq, sw=sw, bits=int(ql.bits), packed=_kernel_pack(wq, int(ql.bits)))


def _kernel_pack(wq: torch.Tensor, bits: int) -> Optional[torch.Tensor]:
    """The W4A8 kernel's layout of an int4 weight (None for other widths
    or an odd K, which only the plain version takes)."""
    if bits != 4 or wq.shape[0] % 2:
        return None
    from repro_torch.kernels.w4a8_matmul import prepack  # the kernel imports this module

    return prepack(pack_int4(wq, axis=0))


def quantize_linear_weights(w: torch.Tensor, bits: int = 4) -> QuantizedLinear:
    """Per-output-channel symmetric INT<bits> quantization of a (K, N)
    weight, with the kernel's packed layout for 4 bits."""
    wq, sw = quantize_weight_int(w, bits=bits, axis=0)
    return QuantizedLinear(wq=wq, sw=sw.reshape(1, -1), bits=bits,
                           packed=_kernel_pack(wq, bits))


def quantized_linear_apply(x: torch.Tensor, ql: QuantizedLinear) -> torch.Tensor:
    """Dynamic-A8 x static-W4 linear in x's dtype: quantize x per token,
    integer GEMM, dequantize.  A CUDA tensor runs the W4A8 kernel over
    ``ql.packed`` (``kernels/ops.w4a8_linear``); a CPU tensor runs the plain
    ``w4a8_matmul_ref`` over ``ql.wq``."""
    if x.device.type != "cpu":
        if ql.packed is None:
            raise ValueError(f"quantized_linear_apply: the W4A8 kernel takes 4-bit weights "
                             f"with an even K, got bits={ql.bits}, K={ql.wq.shape[0]}")
        from repro_torch.kernels import ops  # ops imports this module

        return ops.w4a8_linear(x, ql.packed, ql.sw)
    lead = x.shape[:-1]
    x2 = x.reshape(-1, x.shape[-1])
    xq, sx = quantize_act_int8(x2)
    y = w4a8_matmul_ref(xq, sx, ql.wq, ql.sw)
    return y.reshape(*lead, -1).to(x.dtype)


def sqnr_db(ref: torch.Tensor, approx: torch.Tensor) -> float:
    """Signal-to-quantization-noise ratio in dB."""
    r = ref.float()
    num = torch.sum(r * r)
    den = torch.sum((r - approx.float()) ** 2) + 1e-12
    return float(10.0 * torch.log10(num / den))

"""W4A8 GEMM wrapper: ``csrc/w4a8_matmul.cu`` on the card, the plain
version (kernels/ref.py) on the CPU.

Replaces the Pallas kernel ``repro/kernels/w4a8_matmul.py:w4a8_matmul_pallas``.

The kernel reads the packed int4 weight in a fragment-ordered layout made
once, at load time, by ``prepack`` (the same K*N/2 bytes, for K a multiple
of 128 and N of 16; smaller or ragged weights are zero-padded to that).
``w4a8_matmul`` takes either layout: a 2-D (K/2, N) weight packed as the
reference packs it (``core.quantization.pack_int4``), reordered on the fly,
or the 3-D prepacked one.  The model's weights are prepacked, so the
serving path reorders nothing.

``w4a8_matmul_int32`` is the same kernel with its unscaled epilogue: the
int32 accumulators xq @ unpack_int4(wp), which a row-parallel shard's
ranks sum exactly before one scaling (``serving/quantized_lm._qlinear_rows``).
Its launches are counted as "w4a8_matmul_int32".
"""
from __future__ import annotations

import functools

import torch

from repro_torch.core.quantization import pack_int4, unpack_int4
from repro_torch.kernels import _lib
from repro_torch.kernels.ref import w4a8_matmul_int32_ref, w4a8_matmul_ref2

__all__ = ["w4a8_matmul", "w4a8_matmul_int32", "prepack", "unprepack", "plan"]

_K_ALIGN = 128  # K values per pipeline stage of the kernel
_N_ALIGN = 16  # channels per MMA tile (one warp)
_CHANNELS_PER_CTA = 64
_MAX_KSPLIT = 4
_MIN_STAGES_PER_SPLIT = 4
_CTAS_PER_SM = 3


def _pad(k: int, n: int):
    return -(-k // _K_ALIGN) * _K_ALIGN, -(-n // _N_ALIGN) * _N_ALIGN


def prepack(wp: torch.Tensor) -> torch.Tensor:
    """(K/2, N) int8, int4 packed along K as ``pack_int4`` packs it ->
    (N16, K64, 512) int8, N16 = ceil(N/16), K64 = 2*ceil(K/128): for the 16
    channels c = 16*i .. 16*i+15 and the K chunk k = 64*j .. 64*j+63, byte
    16*(4*g + t) + q holds W[k+16t+q, c+g] in its low nibble and
    W[k+16t+q, c+g+8] in its high one (g < 8, t < 4, q < 16): the 16 bytes
    that MMA lane 4g+t takes as its operand.  Padding is zeros."""
    k2, n = wp.shape
    k = 2 * k2
    kp, np_ = _pad(k, n)
    w = torch.zeros((kp, np_), dtype=torch.int32, device=wp.device)
    w[:k, :n] = unpack_int4(wp, axis=0).to(torch.int32)
    # (j, t, q, i, h, g) -> (i, j, g, t, q, h)
    w = w.reshape(kp // 64, 4, 16, np_ // 16, 2, 8).permute(3, 0, 5, 1, 2, 4)
    byte = (w[..., 1] << 4) | (w[..., 0] & 0xF)
    return byte.to(torch.int8).reshape(np_ // 16, kp // 64, 512).contiguous()


def unprepack(wpp: torch.Tensor, k: int, n: int) -> torch.Tensor:
    """Inverse of ``prepack`` for a (K, N) weight: back to (K/2, N)."""
    n16, k64, _ = wpp.shape
    p = wpp.to(torch.int32).reshape(n16, k64, 8, 4, 16)
    w = torch.stack([(p << 28) >> 28, p >> 4], dim=-1)  # (i, j, g, t, q, h)
    w = w.permute(1, 3, 4, 0, 5, 2).reshape(k64 * 64, n16 * 16)
    return pack_int4(w[:k, :n].to(torch.int8), axis=0)


@functools.lru_cache(maxsize=None)
def plan(m: int, k: int, n: int, sms: int) -> _lib.Plan:
    """The launch plan: every 64-channel tile for all M tokens in one CTA
    (one pass per 128 tokens), so the weight is read once per pass; K split
    until there are about three CTAs per SM to hide load latency, at most 4
    ways and each split at least 4 stages."""
    mt, passes = _lib.token_tiles(m)
    kp, np_ = _pad(k, n)
    k_stages = kp // _K_ALIGN
    ctas = -(-(np_ // _N_ALIGN) // (_CHANNELS_PER_CTA // _N_ALIGN))
    want = -(-_CTAS_PER_SM * sms // (ctas * passes))
    ksplit = max(1, min(want, _MAX_KSPLIT, k_stages // _MIN_STAGES_PER_SPLIT))
    sps = -(-k_stages // ksplit)
    return _lib.Plan(mt, passes, ctas, -(-k_stages // sps), sps, k_stages)


def w4a8_matmul(xq: torch.Tensor, wp: torch.Tensor, sx: torch.Tensor,
                sw: torch.Tensor) -> torch.Tensor:
    """y = (xq @ unpack_int4(wp)) * sx * sw with int32 accumulation.

    xq (M, K) int8; wp either (K/2, N) int8 nibble-packed along K (low
    nibble = element 2i) or its ``prepack``; sx (M, 1) f32; sw (1, N) f32
    -> (M, N) f32."""
    k = xq.shape[1]
    n = sw.shape[-1]
    if xq.device.type == "cpu":
        return w4a8_matmul_ref2(xq, unprepack(wp, k, n) if wp.dim() == 3 else wp, sx, sw)
    return _launch("w4a8_matmul", xq, wp, n, sx, sw)


def w4a8_matmul_int32(xq: torch.Tensor, wp: torch.Tensor, n: int) -> torch.Tensor:
    """acc = xq @ unpack_int4(wp) as int32 (M, N), the kernel's unscaled
    epilogue; wp as in ``w4a8_matmul`` for a weight of N columns."""
    k = xq.shape[1]
    if xq.device.type == "cpu":
        return w4a8_matmul_int32_ref(xq, unprepack(wp, k, n) if wp.dim() == 3 else wp)
    return _launch("w4a8_matmul_int32", xq, wp, n, None, None)


def _launch(name: str, xq, wp, n: int, sx, sw) -> torch.Tensor:
    m, k = xq.shape
    scaled = sx is not None
    dev = _lib.require_cuda(name, *(t for t in (xq, wp, sx, sw) if t is not None))
    if xq.dtype != torch.int8 or wp.dtype != torch.int8:
        raise TypeError(f"{name}: xq and wp must be int8")
    if scaled and (sx.dtype != torch.float32 or sw.dtype != torch.float32):
        raise TypeError(f"{name}: scales must be float32")
    if wp.dim() == 2:
        if wp.shape != (k // 2, n):
            raise ValueError(f"{name}: shapes {xq.shape} {wp.shape} N={n}")
        wp = prepack(wp)
    kp, np_ = _pad(k, n)
    if wp.shape != (np_ // 16, kp // 64, 512) or (scaled and (
            sx.shape != (m, 1) or sw.shape != (1, n))):
        raise ValueError(f"{name}: shapes {xq.shape} {wp.shape} N={n}"
                         + (f" {sx.shape} {sw.shape}" if scaled else ""))
    if k % 4 or xq.data_ptr() % 4:
        raise ValueError(f"{name}: needs K % 4 == 0 and 4-byte aligned activations")
    p = plan(m, k, n, _lib.sm_count(dev))
    out = torch.empty((m, n), dtype=torch.float32 if scaled else torch.int32, device=dev)
    ws = cnt = None
    if p.ksplit > 1:
        ws = _lib.scratch(dev, "w4a8_ws", _lib.split_k_elems(p), torch.int32)
        cnt = _lib.scratch(dev, "w4a8_cnt", p.passes * p.ctas, torch.int32)
    err = _lib.lib().repro_w4a8_matmul(
        xq.data_ptr(), wp.data_ptr(), sx.data_ptr() if scaled else None,
        sw.data_ptr() if scaled else None, out.data_ptr(),
        ws.data_ptr() if ws is not None else None, cnt.data_ptr() if cnt is not None else None,
        m, k, n, np_ // 16, kp // 64, p.mt, p.ksplit, p.stages_per_split, _lib.stream_ptr(dev),
    )
    _lib.check(err, name)
    _lib.launches[name] += 1
    return out

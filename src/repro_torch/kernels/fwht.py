"""LRU rotation wrappers: ``csrc/fwht.cu`` on the card, the plain versions
(kernels/ref.py) on the CPU.

Replaces the Pallas kernel ``repro/kernels/fwht.py:block_rotate_pallas``
(``block_rotate``: one stage) and the stage composition of
``repro/kernels/ops.py:lru_rotate`` (``rotate_plan``: a whole
RotationPlan, exact, tiled or two_block, in one launch).  Both count their
launches in ``_lib.launches["block_rotate"]``.
"""
from __future__ import annotations

import functools
from typing import NamedTuple

import torch

from repro_torch.core import hadamard
from repro_torch.core import rotation as rot
from repro_torch.kernels import _lib
from repro_torch.kernels.ref import block_rotate_ref, rotate_plan_ref

__all__ = ["block_rotate", "rotate_plan"]

KINDS = {"single": 0, "tiled": 1, "two_block": 2}  # csrc/fwht.cu Kind
MAX_THREADS = 1024
MAX_SMEM = 227 * 1024  # bytes of shared memory a block may opt into (H100)
CTA_THREADS = 256  # units join a CTA up to this many threads (csrc/fwht.cu kWarpThreads)
WAVES = 2  # ... while the call still has this many CTAs per SM


@functools.lru_cache(maxsize=None)
def _hm(m: int, dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    """The +-1 H_m factor in x's dtype on x's device, as the reference
    passes it to its kernel."""
    return torch.as_tensor(hadamard.hadamard_matrix(m), dtype=dtype, device=device)


class Layout(NamedTuple):
    """How csrc/fwht.cu runs one call: ``vec`` elements a thread, ``per_cta``
    units a CTA, ``warp`` (a unit's threads divide a warp and hold one
    H_m column each: the mix runs on shuffles), ``threads`` a CTA and
    ``smem`` bytes of shared memory."""

    vec: int
    per_cta: int
    warp: bool
    threads: int
    smem: int


@functools.lru_cache(maxsize=None)
def layout(kind: str, n: int, m: int, k: int, esize: int, tokens: int, sms: int) -> Layout:
    """The kernel's layout for one call, from shapes alone; ValueError where
    the design does not reach (a block wider than a CTA's threads or its
    shared memory)."""
    b = m << k
    if kind == "single" and n % b:
        raise ValueError(f"block_rotate: n={n} is not a multiple of B={b}")
    if kind == "tiled" and (n % b or n < 2 * b or b % 2):
        raise ValueError(f"rotate_plan: a tiled plan needs n % B == 0 and n >= 2B (n={n}, B={b})")
    if kind == "two_block" and not b < n <= 2 * b:
        raise ValueError(f"rotate_plan: a two_block plan needs B < n <= 2B (n={n}, B={b})")
    sizes = [n, b] + ([b // 2] if kind == "tiled" else []) + ([n - b] if kind == "two_block"
                                                               else [])
    vec = 16 // esize
    while vec > 1 and any(s % vec for s in sizes):
        vec //= 2
    u = b // vec
    h_floats = (m * m + 3) // 4 * 4
    unit_floats = b if kind == "single" else 2 * b
    if u > MAX_THREADS or 4 * (h_floats + unit_floats) > MAX_SMEM:
        raise ValueError(f"LRU rotation: a block of B={b} (m={m}) does not fit one CTA "
                         f"({u} threads, {4 * (h_floats + unit_floats)} bytes of shared memory)")
    warp = 32 % u == 0 and (1 << k) >= vec
    units = tokens * (1 if kind == "two_block" else n // b)
    per_cta = max(1, min(CTA_THREADS // u, units // (WAVES * sms),
                         (MAX_SMEM // 4 - h_floats) // unit_floats))
    threads = -(-per_cta * u // 32) * 32
    smem = 0 if warp else 4 * (h_floats + per_cta * unit_floats)
    return Layout(vec, per_cta, warp, threads, smem)


def _launch(x: torch.Tensor, m: int, k: int, kind: str, transpose: bool) -> torch.Tensor:
    n = x.shape[-1]
    lead = x.shape[:-1]
    x2 = x.reshape(-1, n).contiguous()
    dev = _lib.require_cuda("block_rotate", x2)
    if x2.data_ptr() % 16:  # an offset view: realign for 16-byte loads
        x2 = x2.clone()
    code = _lib.dtype_code(x.dtype)
    if code not in (0, 1):
        raise TypeError(f"LRU rotation takes float32 or bfloat16, got {x.dtype}")
    lay = layout(kind, n, m, k, x2.element_size(), x2.shape[0], _lib.sm_count(dev))
    out = torch.empty_like(x2)
    if x2.shape[0]:
        err = _lib.lib().repro_block_rotate(
            x2.data_ptr(), _hm(m, x.dtype, dev).data_ptr(), out.data_ptr(), x2.shape[0], n, m,
            k, KINDS[kind], int(transpose), lay.vec, lay.per_cta, int(lay.warp), lay.threads,
            lay.smem, code, _lib.stream_ptr(dev),
        )
        _lib.check(err, "block_rotate")
        _lib.launches["block_rotate"] += 1
    return out.reshape(*lead, n)


def block_rotate(x: torch.Tensor, m: int, k: int, transpose: bool = False) -> torch.Tensor:
    """y = x @ kron(I_{n/B}, H_B / sqrt(B)) over the last axis, B = m * 2**k.

    x: (..., n) with n % B == 0; leading dims flatten into tokens."""
    if x.device.type == "cpu":
        return block_rotate_ref(x, m, k, transpose=transpose)
    return _launch(x, m, k, "single", transpose)


def rotate_plan(x: torch.Tensor, plan: rot.RotationPlan, transpose: bool = False) -> torch.Tensor:
    """y = x @ R (``transpose``: x @ R^T) for any RotationPlan over the last
    axis, each stage rounded to x.dtype as ``rot.local_rotate`` composes
    them: one launch on the card."""
    if x.shape[-1] != plan.n:
        raise ValueError(f"rotate_plan: last dim {x.shape[-1]} != plan.n {plan.n}")
    if x.device.type == "cpu":
        return rotate_plan_ref(x, plan, transpose=transpose)
    kind = "single" if plan.kind == "exact" else plan.kind
    return _launch(x, plan.m, plan.k, kind, transpose)

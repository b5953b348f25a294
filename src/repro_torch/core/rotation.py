"""Local Rotation Unit (LRU) — decomposed FWHT rotation (torch counterpart of
repro/core/rotation.py; see there for the scheme).

Every scheme composes orthonormal block rotations, so the overall R is
exactly orthogonal and ``(x R)(R^T W) == x W``.  The plan search is pure
Python and returns the same plans as the reference; the apply functions are
the plain-torch versions (row-vector convention, y = x @ R) used offline to
fold rotations into weights and as the oracle of kernels/fwht.py.  The
analysis helpers follow the reference: the dense matrices
(``block_hadamard``, ``rotation_matrix``, numpy float64), the add-op and
adder-count proxies of the LRU and of a global rotation, and ``kurtosis``."""
from __future__ import annotations

import dataclasses
import functools
import math
from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch.core import hadamard

__all__ = [
    "RotationPlan",
    "plan_rotation",
    "search_mk",
    "local_rotate",
    "local_rotate_transpose",
    "rotate_weight_in",
    "block_hadamard",
    "rotation_matrix",
    "fwht",
    "rotation_cost",
    "rotation_area",
    "global_rotation_cost",
    "global_rotation_area",
    "kurtosis",
]

MAX_DEPTH = 6  # paper: RFA supports 2^1..2^6 FWHT
MAX_NPOT = 64  # largest H_m the HAU accumulates in one pass


@dataclasses.dataclass(frozen=True)
class RotationPlan:
    """How the LRU rotates a channel dimension ``n``."""

    n: int
    m: int  # npot Hadamard order (HAU factor)
    k: int  # FWHT depth (RFA factor); block B = m * 2**k
    kind: str  # "exact" | "tiled" | "two_block"

    @property
    def block(self) -> int:
        return self.m * (1 << self.k)

    @property
    def num_blocks(self) -> int:
        if self.kind == "exact":
            return 1
        if self.kind == "tiled":
            return self.n // self.block
        return 2

    @property
    def stages(self) -> int:
        return 1 if self.kind == "exact" else 2


def _stage_cost_per_channel(m: int, k: int) -> float:
    return float(k + m)


def _odd_part(n: int) -> int:
    while n % 2 == 0:
        n //= 2
    return n


def search_mk(
    n: int,
    max_depth: int = MAX_DEPTH,
    max_npot: int = MAX_NPOT,
    min_block: int = 512,
) -> Tuple[int, int, str]:
    """Find the (m, k, kind) realizing the LRU rotation of dim ``n``: exact,
    then tiled with the natural npot factor, then the cheapest generic tiled
    block, then two overlapped end blocks (same preference order as the
    reference)."""
    best: Optional[Tuple[float, int, int]] = None
    for k in range(max_depth, -1, -1):
        if n % (1 << k) == 0:
            m = n >> k
            if m <= max_npot and hadamard.is_available_order(m):
                c = _stage_cost_per_channel(m, k)
                if best is None or c < best[0]:
                    best = (c, m, k)
    if best is not None:
        return best[1], best[2], "exact"
    odd = _odd_part(n)
    if odd > 1:
        m = odd
        while m <= max_npot and not hadamard.is_available_order(m):
            m *= 2
        if m <= max_npot:
            k = max_depth
            while k > 0 and (m * (1 << k) >= n or n % (m * (1 << k)) != 0):
                k -= 1
            b = m * (1 << k)
            if 64 <= b < n and n % b == 0:
                return m, k, "tiled"
    cands = []
    for m in hadamard.available_orders(max_npot):
        for k in range(max_depth + 1):
            b = m * (1 << k)
            if 64 <= b < n and n % b == 0:
                cands.append((b, _stage_cost_per_channel(m, k), m, k))
    if cands:
        floor = min(min_block, max(c[0] for c in cands))
        cands = [c for c in cands if c[0] >= floor]
        cands.sort(key=lambda c: (c[1], -c[0]))
        b, _, m, k = cands[0]
        return m, k, "tiled"
    half = (n + 1) // 2
    best2: Optional[Tuple[float, int, int]] = None
    for m in hadamard.available_orders(1024):
        for k in range(max_depth + 1):
            b = m * (1 << k)
            if half <= b < n:
                c = _stage_cost_per_channel(m, k)
                if best2 is None or c < best2[0]:
                    best2 = (c, m, k)
    if best2 is None:
        raise ValueError(f"no LRU (m,k) decomposition found for n={n}")
    return best2[1], best2[2], "two_block"


@functools.lru_cache(maxsize=None)
def plan_rotation(n: int, max_depth: int = MAX_DEPTH, max_npot: int = MAX_NPOT) -> RotationPlan:
    m, k, kind = search_mk(n, max_depth, max_npot)
    return RotationPlan(n=n, m=m, k=k, kind=kind)


def rotation_cost(plan: RotationPlan) -> float:
    """Total add-ops of the LRU rotation over all stages (per token) —
    energy/latency proxy."""
    per_ch = _stage_cost_per_channel(plan.m, plan.k)
    if plan.kind == "exact":
        return plan.n * per_ch
    if plan.kind == "tiled":
        return 2 * plan.n * per_ch
    return 2 * plan.block * per_ch


def rotation_area(plan: RotationPlan) -> float:
    """Hardware-area proxy (adder count) of the LRU: one block-wide array
    reused across blocks and across the two stages."""
    return plan.block * _stage_cost_per_channel(plan.m, plan.k)


def global_rotation_area(n: int) -> float:
    """Area proxy of the baseline global rotation array: a full-width
    depth-log2(n/m) FWHT cascaded with the dense npot H_m stage, m the
    smallest multiple-of-4 Hadamard order containing odd(n)."""
    odd = _odd_part(n)
    if odd == 1:
        m = 1
    else:
        m = odd if odd % 4 == 0 else odd * (4 if odd % 2 else 2)
        while m % 4 != 0:
            m *= 2
    k = int(math.log2(n // m))
    return n * _stage_cost_per_channel(m, k)


def global_rotation_cost(n: int) -> float:
    """Op-count per token of the global rotation (one full-dim stage)."""
    return global_rotation_area(n)


@functools.lru_cache(maxsize=None)
def block_hadamard(m: int, k: int) -> np.ndarray:
    """Orthonormal H_B = kron(H_m, H_{2^k}) / sqrt(B), B = m * 2**k, in
    float64 (tests and small dims only)."""
    hm = hadamard.hadamard_matrix(m).astype(np.float64)
    h2 = hadamard.hadamard_matrix(1 << k).astype(np.float64)
    hb = np.kron(hm, h2)
    b = m * (1 << k)
    return (hb / math.sqrt(b)).astype(np.float64)


@functools.lru_cache(maxsize=None)
def rotation_matrix(n: int, max_depth: int = MAX_DEPTH, max_npot: int = MAX_NPOT) -> np.ndarray:
    """Dense n x n orthogonal matrix of the full LRU rotation, float64
    (row-vector convention: y = x @ R)."""
    plan = plan_rotation(n, max_depth, max_npot)
    hb = block_hadamard(plan.m, plan.k)
    b = plan.block
    if plan.kind == "exact":
        return hb
    if plan.kind == "tiled":
        nb = plan.num_blocks
        stage1 = np.kron(np.eye(nb), hb)
        shift = b // 2
        perm = np.roll(np.eye(plan.n), -shift, axis=1)  # x @ perm rolls left
        stage2 = perm @ np.kron(np.eye(nb), hb) @ perm.T
        return stage1 @ stage2
    up = np.eye(plan.n)
    up[:b, :b] = hb
    lo = np.eye(plan.n)
    lo[plan.n - b:, plan.n - b:] = hb
    return up @ lo


def _fwht_sylvester(x: torch.Tensor, depth: int) -> torch.Tensor:
    """kron(I_m, H_{2^depth}) applied along the last axis (butterflies)."""
    n = x.shape[-1]
    assert n % (1 << depth) == 0
    m = n >> depth
    lead = x.shape[:-1]
    size = 1 << depth
    y = x.reshape(*lead, m, size)
    h = 1
    while h < size:
        y = y.reshape(*lead, m, size // (2 * h), 2, h)
        a = y[..., 0, :] + y[..., 1, :]
        b = y[..., 0, :] - y[..., 1, :]
        y = torch.stack([a, b], dim=-2)
        h *= 2
    return y.reshape(*lead, n)


def fwht(x: torch.Tensor, depth: Optional[int] = None) -> torch.Tensor:
    """Unnormalized FWHT along the last axis, Sylvester order (the
    reference's ``fwht_jnp``).  With ``depth`` the last axis is ``m *
    2**depth`` and the transform acts within each contiguous 2**depth
    group: the kron(I_m, H_{2^depth}) factor."""
    n = x.shape[-1]
    if depth is None:
        depth = n.bit_length() - 1
        if 1 << depth != n:
            raise ValueError(f"a full FWHT needs a power-of-two length, got {n}")
    return _fwht_sylvester(x, depth)


def _apply_blocks(x: torch.Tensor, m: int, k: int, transpose: bool = False) -> torch.Tensor:
    """y = x @ kron(I_nb, H_B / sqrt(B)) along the last axis, B = m * 2**k:
    depth-k butterflies for the 2^k factor, a +-1 H_m product for the npot
    factor, in x.dtype (kron index i = a * 2^k + r)."""
    b = m * (1 << k)
    n = x.shape[-1]
    assert n % b == 0
    nb = n // b
    lead = x.shape[:-1]
    y = _fwht_sylvester(x, k)
    hm = torch.as_tensor(
        hadamard.hadamard_matrix(m).astype(np.float32), dtype=x.dtype, device=x.device
    )
    if transpose:
        hm = hm.T
    y = y.reshape(*lead, nb, m, 1 << k)
    y = torch.einsum("...gar,ab->...gbr", y, hm)
    y = y.reshape(*lead, n)
    return y * torch.tensor(1.0 / math.sqrt(b), dtype=x.dtype, device=x.device)


def local_rotate(x: torch.Tensor, plan: RotationPlan) -> torch.Tensor:
    """y = x @ R along the last axis (the LRU's 1- or 2-stage rotation)."""
    n, b = plan.n, plan.block
    assert x.shape[-1] == n, (x.shape, n)
    if plan.kind == "exact":
        return _apply_blocks(x, plan.m, plan.k)
    if plan.kind == "tiled":
        y = _apply_blocks(x, plan.m, plan.k)
        shift = b // 2
        y = torch.roll(y, -shift, dims=-1)
        y = _apply_blocks(y, plan.m, plan.k)
        return torch.roll(y, shift, dims=-1)
    upper = _apply_blocks(x[..., :b], plan.m, plan.k)
    x = torch.cat([upper, x[..., b:]], dim=-1)
    lower = _apply_blocks(x[..., n - b:], plan.m, plan.k)
    return torch.cat([x[..., : n - b], lower], dim=-1)


def local_rotate_transpose(x: torch.Tensor, plan: RotationPlan) -> torch.Tensor:
    """y = x @ R^T (inverse rotation; R orthogonal)."""
    n, b = plan.n, plan.block
    assert x.shape[-1] == n
    if plan.kind == "exact":
        return _apply_blocks(x, plan.m, plan.k, transpose=True)
    if plan.kind == "tiled":
        shift = b // 2
        y = torch.roll(x, -shift, dims=-1)
        y = _apply_blocks(y, plan.m, plan.k, transpose=True)
        y = torch.roll(y, shift, dims=-1)
        return _apply_blocks(y, plan.m, plan.k, transpose=True)
    lower = _apply_blocks(x[..., n - b:], plan.m, plan.k, transpose=True)
    x = torch.cat([x[..., : n - b], lower], dim=-1)
    upper = _apply_blocks(x[..., :b], plan.m, plan.k, transpose=True)
    return torch.cat([upper, x[..., b:]], dim=-1)


def rotate_weight_in(w: torch.Tensor, plan: RotationPlan) -> torch.Tensor:
    """Fold R into a weight along its input dim: (x @ R) @ (R^T w) == x @ w."""
    assert w.shape[0] == plan.n
    return local_rotate(w.T, plan).T


def kurtosis(x: torch.Tensor, axis: int = -1) -> torch.Tensor:
    """Pearson kurtosis along ``axis`` (3 for a Gaussian), the outlier
    metric, computed on x's device in x's dtype."""
    mu = torch.mean(x, dim=axis, keepdim=True)
    d = x - mu
    m2 = torch.mean(d ** 2, dim=axis, keepdim=True)
    m4 = torch.mean(d ** 4, dim=axis, keepdim=True)
    return torch.squeeze(m4 / (m2 ** 2 + 1e-12), dim=axis)

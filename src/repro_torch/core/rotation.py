"""Local Rotation Unit (LRU) — decomposed FWHT rotation (torch counterpart of
repro/core/rotation.py; see there for the scheme).

Every scheme composes orthonormal block rotations, so the overall R is
exactly orthogonal and ``(x R)(R^T W) == x W``.  The plan search is pure
Python and returns the same plans as the reference; the apply functions are
the plain-torch versions (row-vector convention, y = x @ R) used offline to
fold rotations into weights and as the oracle of kernels/fwht.py."""
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

"""Hadamard matrix constructions for outlier-free rotation (LRU substrate).

The paper's Local Rotation Unit decomposes a global Hadamard rotation of a
(possibly non-power-of-two) channel dimension ``n`` into FWHT butterflies of
depth <= 6 combined with a small "npot" Hadamard factor H_m, i.e. blocks of
size ``m * 2**k``.  This module provides the H_m constructions:

  * Sylvester (orders 2**j),
  * Paley I   (orders q+1,   q prime, q % 4 == 3),
  * Paley II  (orders 2(q+1), q prime, q % 4 == 1),
  * Kronecker products of the above.

All constructions are verified by ``H @ H.T == n * I`` (exact integer
arithmetic); ``hadamard_matrix`` raises if an order is not reachable.
Matrices are cached; entries are +-1 int8.
"""
from __future__ import annotations

import functools
from typing import Dict, List, Tuple

import numpy as np

__all__ = [
    "hadamard_matrix",
    "available_orders",
    "is_available_order",
    "fwht",
    "normalized_hadamard",
]


def _is_prime(q: int) -> bool:
    if q < 2:
        return False
    if q % 2 == 0:
        return q == 2
    i = 3
    while i * i <= q:
        if q % i == 0:
            return False
        i += 2
    return True


def _jacobsthal(q: int) -> np.ndarray:
    """Jacobsthal matrix Q[i, j] = chi(j - i) for prime q (quadratic residue
    character chi, chi(0) = 0)."""
    chi = np.full(q, -1, dtype=np.int8)
    chi[(np.arange(1, q, dtype=np.int64) ** 2) % q] = 1
    chi[0] = 0
    idx = (np.arange(q)[None, :] - np.arange(q)[:, None]) % q
    return chi[idx]


def _sylvester(order: int) -> np.ndarray:
    assert order >= 1 and (order & (order - 1)) == 0
    h = np.array([[1]], dtype=np.int8)
    while h.shape[0] < order:
        h = np.block([[h, h], [h, -h]]).astype(np.int8)
    return h


def _paley1(q: int) -> np.ndarray:
    """Order q + 1, q prime with q % 4 == 3."""
    qq = _jacobsthal(q)
    n = q + 1
    s = np.zeros((n, n), dtype=np.int8)
    s[0, 1:] = 1
    s[1:, 0] = -1
    s[1:, 1:] = qq
    h = s + np.eye(n, dtype=np.int8)
    return h.astype(np.int8)


def _paley2(q: int) -> np.ndarray:
    """Order 2 * (q + 1), q prime with q % 4 == 1."""
    qq = _jacobsthal(q)
    n = q + 1
    s = np.zeros((n, n), dtype=np.int8)
    s[0, 1:] = 1
    s[1:, 0] = 1
    s[1:, 1:] = qq
    a = np.array([[1, 1], [1, -1]], dtype=np.int8)
    b = np.array([[1, -1], [-1, -1]], dtype=np.int8)
    h = np.kron(s, a) + np.kron(np.eye(n, dtype=np.int8), b)
    return h.astype(np.int8)


@functools.lru_cache(maxsize=None)
def _base_orders(limit: int = 512) -> Dict[int, Tuple[str, int]]:
    """Orders reachable by a single base construction, -> (kind, param)."""
    out: Dict[int, Tuple[str, int]] = {1: ("sylvester", 1), 2: ("sylvester", 2)}
    o = 4
    while o <= limit:
        out[o] = ("sylvester", o)
        o *= 2
    for q in range(3, limit, 4):  # q % 4 == 3 -> order q+1
        if _is_prime(q) and q + 1 <= limit:
            out.setdefault(q + 1, ("paley1", q))
    for q in range(5, limit, 4):  # q % 4 == 1 -> order 2(q+1)
        if _is_prime(q) and 2 * (q + 1) <= limit:
            out.setdefault(2 * (q + 1), ("paley2", q))
    return out


@functools.lru_cache(maxsize=None)
def available_orders(limit: int = 512) -> Tuple[int, ...]:
    """All Hadamard orders <= limit reachable as products of base orders."""
    base = sorted(_base_orders(limit))
    reach = set(base)
    frontier = list(base)
    while frontier:
        a = frontier.pop()
        for b in base:
            p = a * b
            if p <= limit and p not in reach:
                reach.add(p)
                frontier.append(p)
    return tuple(sorted(reach))


def is_available_order(m: int, limit: int = 512) -> bool:
    return m in available_orders(max(limit, m))


@functools.lru_cache(maxsize=None)
def _factor_plan(order: int, limit: int) -> Tuple[int, ...]:
    """Greedy factorization of ``order`` into base orders (largest first)."""
    base = sorted(_base_orders(limit), reverse=True)

    def rec(rem: int) -> List[int] | None:
        if rem == 1:
            return []
        for b in base:
            if b > 1 and rem % b == 0:
                sub = rec(rem // b)
                if sub is not None:
                    return [b] + sub
        return None

    plan = rec(order)
    if plan is None:
        raise ValueError(f"no Hadamard construction found for order {order}")
    return tuple(plan)


@functools.lru_cache(maxsize=None)
def hadamard_matrix(order: int) -> np.ndarray:
    """A (+-1) Hadamard matrix of the given order, H @ H.T = order * I."""
    limit = max(512, order)
    plan = _factor_plan(order, limit)
    h = np.array([[1]], dtype=np.int8)
    base = _base_orders(limit)
    for o in plan:
        kind, param = base[o]
        if kind == "sylvester":
            piece = _sylvester(o)
        elif kind == "paley1":
            piece = _paley1(param)
        else:
            piece = _paley2(param)
        h = np.kron(h, piece).astype(np.int8)
    gram = h.astype(np.int64) @ h.astype(np.int64).T
    if not np.array_equal(gram, order * np.eye(order, dtype=np.int64)):
        raise AssertionError(f"construction for order {order} failed verification")
    return h


def normalized_hadamard(order: int, dtype=np.float32) -> np.ndarray:
    """Orthonormal Hadamard: Q @ Q.T = I."""
    return hadamard_matrix(order).astype(dtype) / np.sqrt(order).astype(dtype)


def fwht(x: np.ndarray, axis: int = -1) -> np.ndarray:
    """Unnormalized fast Walsh-Hadamard transform (numpy reference).

    Sylvester ordering; length along ``axis`` must be a power of two.
    """
    x = np.moveaxis(np.asarray(x), axis, -1).copy()
    n = x.shape[-1]
    assert n & (n - 1) == 0, "FWHT length must be a power of two"
    h = 1
    while h < n:
        y = x.reshape(*x.shape[:-1], n // (2 * h), 2, h)
        a = y[..., 0, :] + y[..., 1, :]
        b = y[..., 0, :] - y[..., 1, :]
        x = np.stack([a, b], axis=-2).reshape(*x.shape[:-1], n)
        h *= 2
    return np.moveaxis(x, -1, axis)

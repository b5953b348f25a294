"""Orthonormal rotations of the W4A8 target's LRU, built from their
published description: a block Hadamard H_B = kron(H_m, H_{2^k}) / sqrt(B),
B = m * 2**k, applied to the whole width ("exact") or to its B-wide blocks
twice, the second pass over blocks shifted by B/2 ("tiled").  H_m is
Sylvester's for a power of two and Paley's first construction for m = q + 1,
q a prime with q % 4 == 3.  Plain numpy and torch, row-vector convention
(y = x @ R).
"""
from __future__ import annotations

import functools

import numpy as np
import torch


def _sylvester(m: int) -> np.ndarray:
    h = np.array([[1]], dtype=np.int64)
    while h.shape[0] < m:
        h = np.block([[h, h], [h, -h]])
    return h


def _is_prime(q: int) -> bool:
    return q > 1 and all(q % p for p in range(2, int(q ** 0.5) + 1))


def _paley1(q: int) -> np.ndarray:
    chi = np.full(q, -1, dtype=np.int64)
    chi[(np.arange(1, q) ** 2) % q] = 1
    chi[0] = 0
    jac = chi[(np.arange(q)[None, :] - np.arange(q)[:, None]) % q]
    s = np.zeros((q + 1, q + 1), dtype=np.int64)
    s[0, 1:] = 1
    s[1:, 0] = -1
    s[1:, 1:] = jac
    return s + np.eye(q + 1, dtype=np.int64)


@functools.lru_cache(maxsize=None)
def hadamard(m: int) -> np.ndarray:
    """A +-1 Hadamard matrix of order m (checked: H H^T = m I)."""
    if m & (m - 1) == 0:
        h = _sylvester(m)
    elif (m - 1) % 4 == 3 and _is_prime(m - 1):
        h = _paley1(m - 1)
    else:
        raise ValueError(f"no construction here for a Hadamard matrix of order {m}")
    assert np.array_equal(h @ h.T, m * np.eye(m, dtype=np.int64))
    return h


@functools.lru_cache(maxsize=None)
def block_matrix(m: int, k: int, device) -> torch.Tensor:
    """H_B / sqrt(B) in float32 (made once per device)."""
    hb = np.kron(hadamard(m), _sylvester(1 << k)).astype(np.float64)
    return torch.as_tensor(hb / np.sqrt(hb.shape[0]), dtype=torch.float32, device=device)


def _blocks(x: torch.Tensor, hb: torch.Tensor) -> torch.Tensor:
    b = hb.shape[0]
    lead = x.shape[:-1]
    return (x.reshape(*lead, -1, b) @ hb).reshape(*lead, x.shape[-1])


def rotate(x: torch.Tensor, plan: dict) -> torch.Tensor:
    """x @ R along the last axis; ``plan`` = {"m", "k", "kind"}."""
    hb = block_matrix(int(plan["m"]), int(plan["k"]), str(x.device))
    if plan["kind"] == "exact":
        assert x.shape[-1] == hb.shape[0]
        return _blocks(x, hb)
    if plan["kind"] != "tiled":
        raise ValueError(f"rotation kind {plan['kind']!r}")
    shift = hb.shape[0] // 2
    y = torch.roll(_blocks(x, hb), -shift, dims=-1)
    return torch.roll(_blocks(y, hb), shift, dims=-1)

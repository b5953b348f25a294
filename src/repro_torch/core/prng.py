"""Threefry-2x32 keys and draws in numpy, bit for bit those of ``jax.random``
with its defaults (raw ``uint32[2]`` keys, the partitionable counter layout,
32-bit floats): the port's counterpart of what the reference takes from
``jax.random`` for its per-request key streams and host samplers.

Keys are ``np.uint32`` arrays of shape (2,).  ``PRNGKey``, ``split``,
``fold_in``, ``random_bits`` and ``uniform`` give JAX's bits exactly.
``normal`` takes JAX's uniform draw over (-1, 1) and XLA's float32
inverse-error-function polynomial, its Horner steps as fused
multiply-adds (as XLA's CPU code runs them); numpy's ``log1p`` may differ
from XLA's by an ulp, so a value may differ in its last bits (in 1-2% of
draws, by at most a few ulp).
``gumbel`` and ``categorical`` take ``np.log``, which differs from XLA's
``log`` by a few ulp on some inputs, so a Gumbel value may differ in its
last bits and a categorical draw only where the two largest perturbed
scores lie within those ulp of each other.

The algorithm follows ``jax/_src/prng.py`` (``_threefry2x32_lowering``,
``threefry_seed``, ``_threefry_split_foldlike``, ``_threefry_fold_in``,
``_threefry_random_bits_partitionable``) and ``jax/_src/random.py``
(``_uniform``, ``_gumbel`` in mode "low", ``categorical``)."""
from __future__ import annotations

import math
from typing import Sequence, Tuple, Union

import numpy as np

__all__ = ["PRNGKey", "split", "fold_in", "random_bits", "uniform", "normal", "gumbel",
           "categorical"]

Shape = Union[int, Sequence[int]]

_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = np.uint32(0x1BD11BDA)


def _rotl(x: np.ndarray, d: int) -> np.ndarray:
    return (x << np.uint32(d)) | (x >> np.uint32(32 - d))


def threefry2x32(key: np.ndarray, x0: np.ndarray, x1: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """The Threefry-2x32 hash (20 rounds) of the counter pairs (x0, x1)
    under ``key``; uint32 arrays of one shape in and out (numpy array
    arithmetic wraps modulo 2^32)."""
    k0, k1 = np.uint32(key[0]), np.uint32(key[1])
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    x0 = np.asarray(x0, np.uint32) + ks[0]
    x1 = np.asarray(x1, np.uint32) + ks[1]
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = x0 + x1
            x1 = _rotl(x1, r) ^ x0
        x0 = x0 + ks[(i + 1) % 3]
        x1 = x1 + ks[(i + 2) % 3] + np.uint32(i + 1)
    return x0, x1


def _key(key) -> np.ndarray:
    k = np.asarray(key)
    if k.shape != (2,) or k.dtype != np.uint32:
        raise TypeError(f"a key is a uint32 array of shape (2,), got {k.dtype} {k.shape}")
    return k


def _shape(shape: Shape) -> Tuple[int, ...]:
    return (int(shape),) if np.ndim(shape) == 0 else tuple(int(d) for d in shape)


def PRNGKey(seed: int) -> np.ndarray:
    """The key of an integer seed, as ``jax.random.PRNGKey`` makes it with
    64-bit types off: the seed must fit int64 and only its low 32 bits are
    kept (negative seeds wrap), high word 0."""
    seed = int(seed)
    if not -(1 << 63) <= seed < (1 << 63):
        raise OverflowError(f"seed {seed} does not fit int64")
    return np.array([0, seed & 0xFFFFFFFF], np.uint32)


def _counters(n: int) -> Tuple[np.ndarray, np.ndarray]:
    """The partitionable layout's counters of a flat iota of n: the high and
    low 32 bits of each index."""
    idx = np.arange(n, dtype=np.uint64)
    return (idx >> np.uint64(32)).astype(np.uint32), (idx & np.uint64(0xFFFFFFFF)).astype(np.uint32)


def split(key, num: int = 2) -> np.ndarray:
    """``num`` new keys, (num, 2): key i is the hash of the counter (0, i)."""
    hi, lo = _counters(int(num))
    b0, b1 = threefry2x32(_key(key), hi, lo)
    return np.stack([b0, b1], axis=-1)


def fold_in(key, data: int) -> np.ndarray:
    """The key of ``data`` (an int in [0, 2^32)) folded into ``key``: the
    hash of the counter pair (0, data)."""
    data = int(data)
    if not 0 <= data < (1 << 32):
        raise OverflowError(f"fold_in data {data} is out of bounds for uint32")
    b0, b1 = threefry2x32(_key(key), np.zeros(1, np.uint32), np.array([data], np.uint32))
    return np.array([b0[0], b1[0]], np.uint32)


def random_bits(key, shape: Shape = ()) -> np.ndarray:
    """Uniform 32-bit words of ``shape``: element i is the XOR of the two
    halves of the hash of the counter (hi(i), lo(i)) over the flat index."""
    shape = _shape(shape)
    hi, lo = _counters(math.prod(shape))
    b0, b1 = threefry2x32(_key(key), hi, lo)
    return (b0 ^ b1).reshape(shape)


def uniform(key, shape: Shape = (), minval: float = 0.0, maxval: float = 1.0) -> np.ndarray:
    """float32 uniforms in [minval, maxval): the top 23 bits of each word as
    the mantissa of a float in [1, 2), minus 1, scaled and shifted, then
    clamped below at minval.  XLA fuses the scale and shift into one fused
    multiply-add; the product of two float32 values is exact in float64, so
    the float64 sum rounded to float32 is that FMA's result unless the
    float64 rounding itself landed on a float32 tie, which needs range ends
    more than 2^29 apart in scale."""
    shape = _shape(shape)
    lo, hi = np.float32(minval), np.float32(maxval)
    bits = random_bits(key, shape)
    floats = ((bits >> np.uint32(9)) | np.uint32(0x3F800000)).view(np.float32) - np.float32(1.0)
    scaled = (floats.astype(np.float64) * np.float64(hi - lo) + np.float64(lo)).astype(np.float32)
    return np.maximum(lo, scaled).reshape(shape)


# XLA's float32 erf_inv (Giles' polynomial in w = -log1p(-x^2)): the
# coefficients for w < 5 and for w >= 5, highest degree first
_ERFINV_LT5 = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06, -4.39150654e-06,
               0.00021858087, -0.00125372503, -0.00417768164, 0.246640727, 1.50140941)
_ERFINV_GE5 = (-0.000200214257, 0.000100950558, 0.00134934322, -0.00367342844,
               0.00573950773, -0.0076224613, 0.00943887047, 1.00167406, 2.83297682)


def _erfinv32(x: np.ndarray) -> np.ndarray:
    x = x.astype(np.float32)
    w = -np.log1p(-x * x)
    lt = w < np.float32(5.0)
    w = np.where(lt, w - np.float32(2.5), np.sqrt(np.maximum(w, np.float32(0))) - np.float32(3.0))
    p = np.where(lt, np.float32(_ERFINV_LT5[0]), np.float32(_ERFINV_GE5[0]))
    w64 = w.astype(np.float64)
    for lo, hi in zip(_ERFINV_LT5[1:], _ERFINV_GE5[1:]):
        c = np.where(lt, np.float32(lo), np.float32(hi))
        # c + p * w in one rounding: the float32 product is exact in float64
        p = (c.astype(np.float64) + p.astype(np.float64) * w64).astype(np.float32)
    out = p * x
    return np.where(np.abs(x) == np.float32(1.0), x * np.float32(np.inf), out).astype(np.float32)


def normal(key, shape: Shape = ()) -> np.ndarray:
    """float32 standard normal draws, ``sqrt(2) * erfinv(u)`` with u uniform
    over (-1, 1) (``jax.random.normal``'s float32 path)."""
    lo = np.nextafter(np.float32(-1.0), np.float32(0.0))
    u = uniform(key, shape, lo, 1.0)
    return (np.float32(np.sqrt(2)) * _erfinv32(u)).astype(np.float32)


def gumbel(key, shape: Shape = ()) -> np.ndarray:
    """float32 standard Gumbel draws, ``-log(-log(u))`` with u uniform in
    [tiny, 1) (``jax.random.gumbel``'s mode "low")."""
    u = uniform(key, shape, np.finfo(np.float32).tiny, 1.0)
    return -np.log(-np.log(u))


def categorical(key, logits) -> int:
    """One draw from the softmax of a 1-D float32 ``logits`` row (``-inf``
    entries allowed): the first maximum of ``logits + gumbel``."""
    lg = np.asarray(logits, np.float32)
    if lg.ndim != 1:
        raise ValueError(f"categorical takes one row of logits, got shape {lg.shape}")
    return int(np.argmax(gumbel(key, lg.shape) + lg))

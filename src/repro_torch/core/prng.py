"""Threefry-2x32 keys and draws in numpy, bit for bit those of ``jax.random``
with its defaults (raw ``uint32[2]`` keys, the partitionable counter layout,
32-bit floats): the port's counterpart of what the reference takes from
``jax.random`` for its per-request key streams and host samplers.

Keys are ``np.uint32`` arrays of shape (2,).  ``PRNGKey``, ``split``,
``fold_in``, ``random_bits`` and ``uniform`` give JAX's bits exactly.
``normal`` takes JAX's uniform draw over (-1, 1) and XLA's float32
inverse-error-function polynomial over XLA's CPU ``log1p`` (``_log1p32``:
the Cephes rational near 0, else ``_log32``, the Cephes / Eigen
polynomial), every multiply-add that XLA's CPU backend fuses computed as
one fused multiply-add, so its draws equal JAX's on the CPU bit for bit.
``gumbel`` and ``categorical`` take ``np.log`` (several times faster than
``_log32`` on the host samplers' path), which differs from XLA's ``log``
in the last bit on some inputs, so a Gumbel value may differ in its last
bits and a categorical draw only where the two largest perturbed scores
lie within those ulp of each other.

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


def _fma32(a, b, c) -> np.ndarray:
    """float32 a * b + c in one rounding: the product of two float32 values
    is exact in float64, and the float64 sum rounds to the fused result
    unless it lands on a float32 tie (not met on these polynomials' ranges)."""
    return (np.float64(1.0) * np.asarray(a, np.float32) * np.asarray(b, np.float32)
            + np.asarray(c, np.float32)).astype(np.float32)


_LOG_P = (7.0376836292e-2, -1.1514610310e-1, 1.1676998740e-1, -1.2420140846e-1,
          1.4249322787e-1, -1.6668057665e-1, 2.0000714765e-1, -2.4999993993e-1,
          3.3333331174e-1)
# Cephes log1p rational for |x| < sqrt(2) - 1, highest degree first
_LOG1P_NUM = (4.5270000862445199635215e-5, 4.9854102823193375972212e-1,
              6.5787325942061044846969e0, 2.9911919328553073277375e1,
              6.0949667980987787057556e1, 5.7112963590585538103336e1,
              2.0039553499201281259648e1)
_LOG1P_DEN = (1.0, 1.5062909083469192043167e1, 8.3047565967967209469434e1,
              2.2176239823732856465394e2, 3.0909872225312059774938e2,
              2.1642788614495947685003e2, 6.0118660497603843919306e1)


def _log32(v: np.ndarray) -> np.ndarray:
    """XLA's float32 ``log`` on the CPU: v = m * 2^e with m in [sqrt(1/2),
    sqrt(2)), log(m) by the Cephes polynomial in m - 1, plus e * log(2) in
    two parts; the multiply-adds fused where XLA's backend fuses them."""
    v = np.asarray(v, np.float32)
    f32 = np.float32
    bits = np.maximum(v, f32(1.17549435e-38)).view(np.uint32)
    e = ((bits >> np.uint32(23)).astype(np.int32) - 0x7F).astype(np.float32) + f32(1.0)
    m = ((bits & np.uint32(0x807FFFFF)) | f32(0.5).view(np.uint32)).view(np.float32)
    small = m < f32(0.707106781186547524)
    x = (m - f32(1.0)) + np.where(small, m, f32(0.0))
    e = e - np.where(small, f32(1.0), f32(0.0))
    x2 = x * x
    x3 = x2 * x
    p = [f32(c) for c in _LOG_P]
    y = _fma32(_fma32(p[0], x, p[1]), x, p[2])
    y1 = _fma32(_fma32(p[3], x, p[4]), x, p[5])
    y2 = _fma32(_fma32(p[6], x, p[7]), x, p[8])
    y = _fma32(_fma32(y, x3, y1), x3, y2)
    y = _fma32(y, x3, e * f32(-2.12194440e-4))
    x = x - x2 * f32(0.5)  # exact product: fused or not, the same sum
    out = (x + y) + e * f32(0.693359375)  # exact product again
    out = np.where(v == f32(np.inf), v, out)
    out = np.where(v == 0, f32(-np.inf), out)
    return np.where((v < 0) | np.isnan(v), f32(np.nan), out).astype(np.float32)


def _log1p32(x: np.ndarray) -> np.ndarray:
    """XLA's float32 ``log1p`` on the CPU: the Cephes rational x - x^2/2 +
    x^3 P(x)/Q(x) for |x| < sqrt(2) - 1, else ``_log32(1 + x)``."""
    x = np.asarray(x, np.float32)
    f32 = np.float32
    num, den = np.zeros_like(x), np.zeros_like(x)
    for a, b in zip(_LOG1P_NUM, _LOG1P_DEN):
        num, den = _fma32(num, x, f32(a)), _fma32(den, x, f32(b))
    x2 = x * x
    near = ((x * x2) * (num / den) + f32(-0.5) * x2) + x  # -x^2/2 is exact
    return np.where(np.abs(x) < f32(0.41421356237309504880), near,
                    _log32(x + f32(1.0))).astype(np.float32)


def _erfinv32(x: np.ndarray) -> np.ndarray:
    x = x.astype(np.float32)
    w = -_log1p32(-x * x)
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

"""Operations and bytes of one call of each hand-written kernel, from its
shapes, and the chip's peaks: the yardstick of every ``*_roofline`` and
``mfu`` metric, frozen here so that a change to the program cannot move it.

Bytes count each input read once and each output written once, in the
form the kernel reads it; operations are multiply-adds times two.

* K1 ``w4a8_matmul`` (M, K) int8 codes by a (K, N) int4 weight: the
  codes, the weight two to a byte, float32 row and channel scales, the
  float32 output (a frozen copy of the program's ``core/costs.w4a8_bytes``).
* K3 ``bvq_matmul`` (M, K) activations by a weight decoded from ``nb``
  column blocks of codebooks (C codewords of v values, float32) and
  indices (``nb`` x K/v x bc, int32 as stored): activations, indices,
  codebooks, float32 output.
* K4 / K5 ``paged_attention`` (the fp and int8 bodies): the queries, the
  K and V of the positions each row's window reads (its length), their
  float32 per-(token, head) scales in the int8 body, the page table and
  lengths, the float32 output; operations are the score and value
  products, 4 * hd per (query head, visible key), causal bound.

``PEAKS``: NVIDIA's H100 SXM5 datasheet, dense, at its 700 W limit.
"""
from __future__ import annotations

from typing import Sequence

PEAKS = {
    "device": "NVIDIA H100 SXM5 datasheet, dense, 700 W power limit",
    "power_limit_w": 700.0,
    "bf16_flops": 989e12,
    "int8_ops": 1979e12,
    "fp8_flops": 1979e12,
    "tf32_flops": 495e12,
    "fp32_flops": 67e12,
    "hbm_bytes_per_s": 3.35e12,
    "hbm_bytes": 80e9,
}


def lower_bound_s(ops: float, nbytes: float, peak_ops: float) -> float:
    """The least time the chip could take: the larger of the two bounds."""
    return max(ops / peak_ops, nbytes / PEAKS["hbm_bytes_per_s"])


def k1_bytes(m: int, k: int, n: int) -> int:
    return m * k + k * n // 2 + 4 * m + 4 * n + 4 * m * n


def k1_ops(m: int, k: int, n: int) -> int:
    return 2 * m * k * n


def k3_bytes(m: int, k: int, n: int, nb: int, c: int, v: int, x_esize: int,
             idx_esize: int = 4) -> int:
    return m * k * x_esize + (k // v) * n * idx_esize + nb * c * v * 4 + 4 * m * n


def k3_ops(m: int, k: int, n: int) -> int:
    return 2 * m * k * n


def attn_bytes(lengths: Sequence[int], w: int, heads: int, kv_heads: int, hd: int,
               q_esize: int, kv_esize: int, int8: bool, table_width: int) -> int:
    """``lengths``: each row's valid positions, its window included."""
    b = len(lengths)
    pos = sum(int(n) for n in lengths)
    kv = 2 * pos * kv_heads * hd * kv_esize + (2 * 4 * pos * kv_heads if int8 else 0)
    return b * w * heads * hd * q_esize + kv + 4 * b * table_width + 4 * b + 4 * b * w * heads * hd


def attn_ops(lengths: Sequence[int], w: int, heads: int, hd: int) -> int:
    keys = sum(w * int(n) - w * (w - 1) // 2 for n in lengths)
    return 4 * heads * hd * keys


def linear_params(n_layers: int, d: int, heads: int, kv_heads: int, hd: int, d_ff: int,
                  swiglu: bool, vocab: int) -> int:
    """Parameters of every linear one token runs through, the head included."""
    attn = d * (heads + 2 * kv_heads) * hd + heads * hd * d
    ffn = (3 if swiglu else 2) * d * d_ff
    return n_layers * (attn + ffn) + d * vocab


def model_flops(rows: int, keys: int, params: int, n_layers: int, heads: int, hd: int) -> float:
    """2 x parameters per row plus the attention's score and value products."""
    return 2.0 * params * rows + 4.0 * n_layers * heads * hd * keys

"""BVQ — Blockwise Vector Quantization for draft-LLM weights (torch
counterpart of repro/core/bvq.py; see there for the paper mapping).

Each block of ``block_cols`` output channels owns a private codebook of
``codebook_size`` vectors of length ``vec_dim`` cut along the input dim.
The compressor runs Lloyd's algorithm with k-means++ seeding and then, for
``qat_steps > 0``, refines codebooks and assignments jointly (INT4
straight-through codebooks, Gumbel-softmax assignments, ``_qat_refine``).
Both are batched over blocks and draw from an explicit ``torch.Generator``
on the weight's device.  Its random bits differ from ``jax.random``'s, so
its codebooks differ from the reference's while reaching the same
reconstruction quality; fed the same noise, the refinement follows the
reference's step for step."""
from __future__ import annotations

import dataclasses
import math
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core import quantization as q

__all__ = [
    "BVQConfig",
    "BVQWeight",
    "bvq_compress",
    "bvq_reconstruct",
    "bvq_matmul_ref",
    "bits_per_weight",
    "dequant_codebooks",
    "kmeans",
    "reconstruct_dense",
]


@dataclasses.dataclass(frozen=True)
class BVQConfig:
    vec_dim: int = 8
    codebook_size: int = 256
    block_cols: int = 128
    kmeans_iters: int = 16
    qat_steps: int = 60  # Gumbel-softmax refinement steps (0 = k-means only)
    qat_lr: float = 5e-2
    tau_start: float = 2.0
    tau_end: float = 0.2
    codebook_bits: int = 4


@dataclasses.dataclass
class BVQWeight:
    """Compressed weight: W ~ gather(codebooks, indices).

    codebooks: (nb, C, v) int8 storage of INT4 values
    scales:    (nb, 1, 1) f32 per-block codebook scale
    indices:   (nb, K // v, block_cols) int32 (values < C)
    shape:     original (K, N)
    """

    codebooks: torch.Tensor
    scales: torch.Tensor
    indices: torch.Tensor
    shape: Tuple[int, int]
    vec_dim: int


def bits_per_weight(cfg: BVQConfig, k: int, n: int) -> float:
    """Average storage bits per original weight element of a (k, n) weight:
    indices, INT4 codebook entries and f32 block scales."""
    nb = n // cfg.block_cols
    index_bits = math.log2(cfg.codebook_size) / cfg.vec_dim
    cb_bits = nb * cfg.codebook_size * cfg.vec_dim * cfg.codebook_bits / (k * n)
    scale_bits = nb * 32 / (k * n)
    return index_bits + cb_bits + scale_bits


def _sq_dists(x: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """(nb, V, v) x (nb, C, v) -> (nb, V, C) squared euclidean distances."""
    x2 = torch.sum(x * x, dim=-1, keepdim=True)
    c2 = torch.sum(c * c, dim=-1)
    return x2 - 2.0 * torch.bmm(x, c.transpose(1, 2)) + c2[:, None, :]


def _rows(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Per-block row gather: x (nb, V, v), idx (nb, n) -> (nb, n, v)."""
    return torch.gather(x, 1, idx[..., None].expand(-1, -1, x.shape[-1]))


def _kmeanspp_init(vectors: torch.Tensor, k: int, gen: torch.Generator) -> torch.Tensor:
    """k-means++ seeding, batched over blocks: each next centroid is drawn
    with probability proportional to the squared distance from the nearest
    centroid already chosen."""
    nb, v_cnt, dim = vectors.shape
    first = torch.randint(0, v_cnt, (nb, 1), generator=gen, device=vectors.device)
    cents = torch.zeros((nb, k, dim), dtype=vectors.dtype, device=vectors.device)
    c = _rows(vectors, first)  # (nb, 1, v)
    cents[:, 0] = c[:, 0]
    mind = torch.sum((vectors - c) ** 2, dim=-1)
    for i in range(1, k):
        idx = torch.multinomial(mind + 1e-20, 1, generator=gen)  # (nb, 1)
        c = _rows(vectors, idx)
        cents[:, i] = c[:, 0]
        mind = torch.minimum(mind, torch.sum((vectors - c) ** 2, dim=-1))
    return cents


def kmeans(
    vectors: torch.Tensor, k: int, iters: int, gen: torch.Generator
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Lloyd's algorithm on (nb, V, v) vectors -> ((nb, k, v) centroids,
    (nb, V) assignments).  Empty clusters are re-seeded to the points
    currently farthest from their centroid."""
    cent = _kmeanspp_init(vectors, k, gen)
    nb, _, dim = vectors.shape
    for _ in range(iters):
        d = _sq_dists(vectors, cent)
        assign = torch.argmin(d, dim=-1)
        counts = torch.zeros((nb, k), dtype=vectors.dtype, device=vectors.device)
        counts.scatter_add_(1, assign, torch.ones_like(assign, dtype=vectors.dtype))
        sums = torch.zeros_like(cent)
        sums.scatter_add_(1, assign[..., None].expand(-1, -1, dim), vectors)
        new = sums / torch.clamp(counts[..., None], min=1.0)
        far = torch.argsort(-torch.amin(d, dim=-1), dim=-1)[:, :k]
        cent = torch.where(counts[..., None] > 0, new, _rows(vectors, far))
    assign = torch.argmin(_sq_dists(vectors, cent), dim=-1)
    return cent, assign


def _hard_touch_up(vectors: torch.Tensor, cb: torch.Tensor, assign: torch.Tensor) -> torch.Tensor:
    """One Lloyd update of the (nb, C, v) centroids against the hard
    (nb, V) assignments; a centroid no vector picked keeps its value."""
    nb, k, dim = cb.shape
    counts = torch.zeros((nb, k), dtype=vectors.dtype, device=vectors.device)
    counts.scatter_add_(1, assign, torch.ones_like(assign, dtype=vectors.dtype))
    sums = torch.zeros_like(cb)
    sums.scatter_add_(1, assign[..., None].expand(-1, -1, dim), vectors)
    return torch.where(counts[..., None] > 0, sums / torch.clamp(counts[..., None], min=1.0), cb)


def _f32(x) -> float:
    return float(np.float32(x))


def _gumbel(shape, gen: torch.Generator, device) -> torch.Tensor:
    """Standard Gumbel noise, -log(-log(u)) with u in [tiny, 1), drawn on
    ``device`` from ``gen``."""
    u = torch.rand(shape, generator=gen, device=device).clamp_min(torch.finfo(torch.float32).tiny)
    return -torch.log(-torch.log(u))


def _qat_refine(
    vectors: torch.Tensor,  # (nb, V, v)
    cent: torch.Tensor,  # (nb, C, v)
    cfg: BVQConfig,
    gen: Optional[torch.Generator] = None,
    noise: Optional[Sequence[torch.Tensor]] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Jointly refine each block's codebook (INT4 straight-through) and
    assignments (Gumbel-softmax over logits started at the negative squared
    distances, scaled by their per-block std) with a hand-rolled Adam over
    ``qat_steps`` steps, the temperature annealed geometrically from
    ``tau_start`` to ``tau_end``; then one Lloyd touch-up of the centroids
    against the hard (argmax) assignments.

    Batched over blocks as the reference is vmapped: the loss is the SUM
    over blocks of each block's mean squared reconstruction error, so each
    block's gradient is the one its own loss gives.  Step i's (nb, V, C)
    Gumbel noise is ``noise[i]`` when given (the parity tests pass the
    reference's draws), else drawn from ``gen`` on the vectors' device.
    Returns (centroids (nb, C, v), assignments (nb, V), final logits)."""
    logits = -_sq_dists(vectors, cent)
    logits = logits / (torch.std(logits, dim=(1, 2), keepdim=True, correction=0) + 1e-6)
    params = [logits, cent.clone()]
    mom = [torch.zeros_like(p) for p in params]
    vel = [torch.zeros_like(p) for p in params]
    b1, b2, eps = 0.9, 0.999, 1e-8
    ratio = np.float32(cfg.tau_end / cfg.tau_start)
    span = np.float32(max(cfg.qat_steps - 1, 1))
    for i in range(cfg.qat_steps):
        # the schedule and the bias corrections in float32, as the reference
        # computes them from its int32 step counter
        tau = _f32(np.float32(cfg.tau_start) * ratio ** (np.float32(i) / span))
        gumbel = noise[i] if noise is not None else _gumbel(logits.shape, gen, vectors.device)
        lg, cb = (p.detach().requires_grad_(True) for p in params)
        cbq = q.fake_quant_weight(cb, bits=cfg.codebook_bits, axis=(1, 2))
        soft = torch.softmax((lg + gumbel) / tau, dim=-1)  # (nb, V, C)
        loss = ((torch.bmm(soft, cbq) - vectors) ** 2).mean(dim=(1, 2)).sum()
        grads = torch.autograd.grad(loss, (lg, cb))
        t = np.float32(i + 1)
        c1, c2 = _f32(1 - np.float32(b1) ** t), _f32(1 - np.float32(b2) ** t)
        with torch.no_grad():
            for j, g in enumerate(grads):
                mom[j] = b1 * mom[j] + (1 - b1) * g
                vel[j] = b2 * vel[j] + (1 - b2) * g * g
                params[j] = params[j] - cfg.qat_lr * (mom[j] / c1) / (torch.sqrt(vel[j] / c2) + eps)
    logits, cb = params
    assign = torch.argmax(logits, dim=-1)
    return _hard_touch_up(vectors, cb, assign), assign, logits


def bvq_compress(w: torch.Tensor, cfg: BVQConfig, gen: torch.Generator) -> BVQWeight:
    """Compress a (K, N) weight into per-block codebooks + indices: k-means,
    then ``qat_steps`` of QAT refinement when it is positive."""
    k_dim, n_dim = w.shape
    assert k_dim % cfg.vec_dim == 0, (k_dim, cfg.vec_dim)
    assert n_dim % cfg.block_cols == 0, (n_dim, cfg.block_cols)
    nb = n_dim // cfg.block_cols
    rows = k_dim // cfg.vec_dim
    wb = w.float().reshape(rows, cfg.vec_dim, nb, cfg.block_cols)
    wb = wb.permute(2, 0, 3, 1).reshape(nb, rows * cfg.block_cols, cfg.vec_dim)
    cent, assign = kmeans(wb, cfg.codebook_size, cfg.kmeans_iters, gen)
    if cfg.qat_steps > 0:
        cent, assign, _ = _qat_refine(wb, cent, cfg, gen)
    cbq, scale = q.quantize_weight_int(cent, bits=cfg.codebook_bits, axis=(1, 2))
    return BVQWeight(
        codebooks=cbq,
        scales=scale,
        indices=assign.reshape(nb, rows, cfg.block_cols).to(torch.int32),
        shape=(k_dim, n_dim),
        vec_dim=cfg.vec_dim,
    )


def dequant_codebooks(bw: BVQWeight, dtype=torch.float32) -> torch.Tensor:
    return bw.codebooks.to(dtype) * bw.scales.to(dtype)


def reconstruct_dense(cb: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """(nb, C, v) dequantized codebooks + (nb, rows, bc) indices -> the
    (rows * v, nb * bc) weight, W[row*v + t, j*bc + col] = cb[j, idx[j,row,col], t]."""
    nb, rows, bc = idx.shape
    v = cb.shape[-1]
    gathered = _rows(cb, idx.reshape(nb, rows * bc).long())
    w = gathered.reshape(nb, rows, bc, v).permute(1, 3, 0, 2)
    return w.reshape(rows * v, nb * bc)


def bvq_reconstruct(bw: BVQWeight) -> torch.Tensor:
    """Gather-decode the full (K, N) f32 weight."""
    return reconstruct_dense(dequant_codebooks(bw), bw.indices)


def bvq_matmul_ref(x: torch.Tensor, bw: BVQWeight) -> torch.Tensor:
    """y = x @ reconstruct(bw), in x's dtype: the plain version of the
    BVQ matmul over a whole ``BVQWeight``."""
    return x @ bvq_reconstruct(bw).to(x.dtype)

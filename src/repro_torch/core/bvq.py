"""BVQ — Blockwise Vector Quantization for draft-LLM weights (torch
counterpart of repro/core/bvq.py; see there for the paper mapping).

Each block of ``block_cols`` output channels owns a private codebook of
``codebook_size`` vectors of length ``vec_dim`` cut along the input dim.
This port carries the k-means-only compressor (``qat_steps=0``, the setting
``launch/serve.build_pair`` uses): Lloyd's algorithm with k-means++ seeding,
batched over blocks, drawing from an explicit ``torch.Generator``.  Its
random bits differ from ``jax.random``'s, so its codebooks differ from the
reference's while reaching the same reconstruction quality."""
from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

from repro_torch.core import quantization as q

__all__ = [
    "BVQConfig",
    "BVQWeight",
    "bvq_compress",
    "bvq_reconstruct",
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


def bvq_compress(w: torch.Tensor, cfg: BVQConfig, gen: torch.Generator) -> BVQWeight:
    """Compress a (K, N) weight into per-block codebooks + indices."""
    if cfg.qat_steps != 0:
        raise NotImplementedError("the port compresses with k-means only (qat_steps=0)")
    k_dim, n_dim = w.shape
    assert k_dim % cfg.vec_dim == 0, (k_dim, cfg.vec_dim)
    assert n_dim % cfg.block_cols == 0, (n_dim, cfg.block_cols)
    nb = n_dim // cfg.block_cols
    rows = k_dim // cfg.vec_dim
    wb = w.float().reshape(rows, cfg.vec_dim, nb, cfg.block_cols)
    wb = wb.permute(2, 0, 3, 1).reshape(nb, rows * cfg.block_cols, cfg.vec_dim)
    cent, assign = kmeans(wb, cfg.codebook_size, cfg.kmeans_iters, gen)
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

"""Per-tensor int8 gradient compression with error feedback: the residual
of each quantization round is folded into the next (torch counterpart of
repro/optim/compression.py)."""
from __future__ import annotations

from typing import Any, NamedTuple, Tuple

import torch

from repro_torch.core.quantization import div_scalar
from repro_torch.core.tree import tree_leaves, tree_map, tree_unflatten

__all__ = ["ErrorFeedbackState", "ef_init", "compress_grads_int8", "decompress_grads_int8"]


class ErrorFeedbackState(NamedTuple):
    residual: Any  # a float32 tree shaped like the gradients


def ef_init(grads_like) -> ErrorFeedbackState:
    return ErrorFeedbackState(residual=tree_map(
        lambda g: torch.zeros(g.shape, dtype=torch.float32, device=g.device), grads_like))


def compress_grads_int8(grads, ef: ErrorFeedbackState) -> Tuple[Any, Any, ErrorFeedbackState]:
    """-> (int8 tree, float32 scale tree, new error-feedback state): each
    leaf plus its residual, scaled by its absmax / 127, rounded half to
    even and clipped to [-127, 127]; the new residual is what that lost."""
    def one(g, r):
        gf = g.float() + r
        scale = torch.clamp(div_scalar(torch.max(torch.abs(gf)), 127.0), min=1e-12)
        q = torch.clamp(torch.round(gf / scale), -127, 127).to(torch.int8)
        return q, scale, gf - q.float() * scale

    out = [one(g, r) for g, r in zip(tree_leaves(grads), tree_leaves(ef.residual))]
    qs, scales, res = (tree_unflatten(grads, [o[i] for o in out]) for i in range(3))
    return qs, scales, ErrorFeedbackState(residual=res)


def decompress_grads_int8(qs, scales):
    return tree_map(lambda q, s: q.float() * s, qs, scales)

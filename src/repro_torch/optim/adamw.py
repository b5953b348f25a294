"""AdamW with global-norm clipping and a configurable moment dtype (torch
counterpart of repro/optim/adamw.py, one device: the reference's ZeRO-1
``optimizer_specs`` waits for the sharded mesh, ROADMAP Queue 1).

The update follows the reference step for step: the global gradient norm
accumulated in float32 over the leaves (in ``jax.tree.leaves`` order), the
clip scale, bias corrections from an int32 step count, the moments and
the decoupled weight decay in float32, the moments stored back in
``moment_dtype`` and the parameters in their own dtype.  It is functional:
new trees come back and the inputs are left as they were."""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.core.tree import TORCH_DTYPES, tree_leaves, tree_map, tree_unflatten

__all__ = ["AdamWConfig", "adamw_init", "adamw_update"]


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    moment_dtype: str = "float32"


def adamw_init(params, cfg: AdamWConfig):
    """Zero moments in ``cfg.moment_dtype`` and a zero int32 count, on the
    parameters' device."""
    dt = TORCH_DTYPES[cfg.moment_dtype]
    zeros = lambda p: torch.zeros(p.shape, dtype=dt, device=p.device)  # noqa: E731
    device = tree_leaves(params)[0].device
    return {"mu": tree_map(zeros, params), "nu": tree_map(zeros, params),
            "count": torch.zeros((), dtype=torch.int32, device=device)}


@torch.no_grad()
def adamw_update(params, grads, state, cfg: AdamWConfig, lr_scale=1.0):
    """-> (new params, new state, {"grad_norm": float32 0-d tensor}).
    ``lr_scale`` multiplies ``cfg.lr`` (a float or a float32 0-d tensor,
    the schedule's value)."""
    gsq = sum(torch.sum(torch.square(g.float())) for g in tree_leaves(grads))
    gnorm = torch.sqrt(gsq)
    scale = torch.clamp(cfg.grad_clip / (gnorm + 1e-12), max=1.0)
    count = state["count"] + 1
    cf = count.float()
    f32 = lambda v: torch.tensor(v, dtype=torch.float32, device=cf.device)  # noqa: E731
    bc1 = 1.0 - torch.pow(f32(cfg.b1), cf)
    bc2 = 1.0 - torch.pow(f32(cfg.b2), cf)
    lr = f32(cfg.lr) * torch.as_tensor(lr_scale, dtype=torch.float32, device=cf.device)
    mdt = TORCH_DTYPES[cfg.moment_dtype]

    def upd(p, g, mu, nu):
        g = g.float() * scale
        mu32 = cfg.b1 * mu.float() + (1 - cfg.b1) * g
        nu32 = cfg.b2 * nu.float() + (1 - cfg.b2) * g * g
        step = (mu32 / bc1) / (torch.sqrt(nu32 / bc2) + cfg.eps)
        step = step + cfg.weight_decay * p.float()
        return (p.float() - lr * step).to(p.dtype), mu32.to(mdt), nu32.to(mdt)

    out = [upd(*leaves) for leaves in zip(*(tree_leaves(t) for t in (
        params, grads, state["mu"], state["nu"])))]
    new_p, new_mu, new_nu = (tree_unflatten(params, [o[i] for o in out]) for i in range(3))
    return new_p, {"mu": new_mu, "nu": new_nu, "count": count}, {"grad_norm": gnorm}

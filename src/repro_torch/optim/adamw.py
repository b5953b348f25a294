"""AdamW with global-norm clipping, a configurable moment dtype and ZeRO-1
sharded moments (torch counterpart of repro/optim/adamw.py).

The update follows the reference step for step: the global gradient norm
accumulated in float32 over the leaves (in ``jax.tree.leaves`` order), the
clip scale, bias corrections from an int32 step count, the moments and
the decoupled weight decay in float32, the moments stored back in
``moment_dtype`` and the parameters in their own dtype.  It is functional:
new trees come back and the inputs are left as they were.

On a mesh, ``optimizer_specs`` is the reference's: each moment takes its
parameter's spec and, under ZeRO-1, also shards its largest free dimension
that the axis divides over ``data``.  ``adamw_update_sharded`` then runs
the reference's update on the ranks' pieces: the gradients (each rank's
share of the global-batch loss) summed over the batch axes, the global
norm from every element once (each leaf's sum of squares all-reduced over
the axes its gradient is split on, a replicated leaf counted once), each
rank's moment slice and the matching slice of its parameter updated, and
the parameter slices all-gathered over ``data``.  ``grad_barrier`` keeps
the gradient reduction in the parameters' dtype (else float32);
``grad_constraint`` reduce-scatters a ZeRO-1 leaf's gradient straight
onto the rank's slice instead of all-reducing it whole."""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch.core.tree import TORCH_DTYPES, tree_leaves, tree_map, tree_unflatten

__all__ = ["AdamWConfig", "adamw_init", "adamw_update", "optimizer_specs", "adamw_init_sharded",
           "adamw_update_sharded", "zero_dim"]


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


def _spec_leaves(specs):
    """Spec tuples in ``tree_leaves`` order (a spec is a leaf)."""
    if isinstance(specs, dict):
        return [x for k in sorted(specs) for x in _spec_leaves(specs[k])]
    if isinstance(specs, list):
        return [x for v in specs for x in _spec_leaves(v)]
    return [tuple(specs)]


def _spec_map(fn, specs, *rest):
    if isinstance(specs, dict):
        return {k: _spec_map(fn, v, *(r[k] for r in rest)) for k, v in specs.items()}
    if isinstance(specs, list):
        return [_spec_map(fn, v, *(r[i] for r in rest)) for i, v in enumerate(specs)]
    return fn(tuple(specs), *rest)


def optimizer_specs(param_specs, abstract_params=None, zero1_axis: Optional[str] = "data",
                    axis_size: int = 1):
    """Moment specs (the reference's ``optimizer_specs``): each mirrors its
    parameter's spec and, with ``zero1_axis``, also shards its largest free
    dimension that ``axis_size`` divides over that axis (ZeRO-1).
    ``abstract_params`` (the full tree, tensors or shapes) gives the sizes;
    without it nothing is added."""

    def one(spec, shape=None):
        parts = list(spec)
        if zero1_axis and shape is not None:
            shape = tuple(shape.shape if isinstance(shape, torch.Tensor) else shape)
            parts = parts + [None] * (len(shape) - len(parts))
            free = [(shape[i], i) for i in range(len(shape))
                    if parts[i] is None and shape[i] % max(axis_size, 1) == 0
                    and shape[i] >= axis_size]
            if free:
                parts[max(free)[1]] = zero1_axis
        return tuple(parts)

    mom = (_spec_map(one, param_specs) if abstract_params is None
           else _spec_map(one, param_specs, abstract_params))
    return {"mu": mom, "nu": mom, "count": ()}


def zero_dim(param_spec, moment_spec) -> Optional[int]:
    """The dimension ZeRO-1 adds to a moment (None where it adds none)."""
    for i, (a, b) in enumerate(zip(tuple(moment_spec), tuple(param_spec) + (None,) * 8)):
        if a is not None and b is None:
            return i
    return None


def _slice(t: torch.Tensor, dim: Optional[int], mesh) -> torch.Tensor:
    if dim is None:
        return t
    n = t.shape[dim] // mesh.axis_size("data")
    return t.narrow(dim, mesh.axis_index("data") * n, n)


def adamw_init_sharded(params, cfg: AdamWConfig, param_specs, moment_specs, mesh):
    """Zero moments of the rank's slices (its parameter shard, cut again
    along the ZeRO-1 dimension) and a zero count."""
    dt = TORCH_DTYPES[cfg.moment_dtype]
    zd = [zero_dim(ps, ms) for ps, ms in zip(_spec_leaves(param_specs),
                                            _spec_leaves(moment_specs["mu"]))]
    leaves = tree_leaves(params)
    mom = [torch.zeros(_slice(p, d, mesh).shape, dtype=dt, device=p.device)
           for p, d in zip(leaves, zd)]
    return {"mu": tree_unflatten(params, mom), "nu": tree_unflatten(params, [m.clone() for m in mom]),
            "count": torch.zeros((), dtype=torch.int32, device=leaves[0].device)}


@torch.no_grad()
def adamw_update_sharded(params, grads, state, cfg: AdamWConfig, lr_scale, mesh, param_specs,
                         moment_specs, batch_axes="data", grad_barrier: bool = False,
                         grad_constraint: bool = False):
    """``adamw_update`` on a mesh: ``params`` / ``grads`` are the rank's
    shards (its gradients its share of the loss, not yet reduced over the
    batch axes), ``state`` its moment slices.  -> (new params, new state,
    {"grad_norm"})."""
    pspecs = _spec_leaves(param_specs)
    zdims = [zero_dim(ps, ms) for ps, ms in zip(pspecs, _spec_leaves(moment_specs["mu"]))]
    ps, gs = tree_leaves(params), tree_leaves(grads)
    reduced, split_axes = [], []
    for p, g, spec, zd in zip(ps, gs, pspecs, zdims):
        axes = {a for part in spec if part is not None
                for a in (part if isinstance(part, tuple) else (part,))}
        if "data" not in axes:  # FSDP leaves come summed from the gathers' backward
            g = g if grad_barrier else g.float()
            if grad_constraint and zd is not None:
                g = mesh.reduce_scatter(g, batch_axes, zd)
                axes = axes | {"data"}
            else:
                g = mesh.all_reduce(g, batch_axes)
        reduced.append(g)
        split_axes.append(tuple(a for a in mesh.axes if a in axes))
    groups = {}
    for g, axes in zip(reduced, split_axes):
        groups[axes] = groups.get(axes, 0) + torch.sum(torch.square(g.float()))
    gsq = sum(mesh.all_reduce(v, axes) if axes else v for axes, v in groups.items())
    gnorm = torch.sqrt(gsq)
    scale = torch.clamp(cfg.grad_clip / (gnorm + 1e-12), max=1.0)
    count = state["count"] + 1
    cf = count.float()
    f32 = lambda v: torch.tensor(v, dtype=torch.float32, device=cf.device)  # noqa: E731
    bc1 = 1.0 - torch.pow(f32(cfg.b1), cf)
    bc2 = 1.0 - torch.pow(f32(cfg.b2), cf)
    lr = f32(cfg.lr) * torch.as_tensor(lr_scale, dtype=torch.float32, device=cf.device)
    mdt = TORCH_DTYPES[cfg.moment_dtype]
    new_p, new_mu, new_nu = [], [], []
    for p, g, mu, nu, zd, axes in zip(ps, reduced, tree_leaves(state["mu"]),
                                      tree_leaves(state["nu"]), zdims, split_axes):
        pz = _slice(p, zd, mesh)
        gz = _slice(g, zd, mesh) if g.shape != pz.shape else g  # reduce-scattered already
        gz = gz.float() * scale
        mu32 = cfg.b1 * mu.float() + (1 - cfg.b1) * gz
        nu32 = cfg.b2 * nu.float() + (1 - cfg.b2) * gz * gz
        step = (mu32 / bc1) / (torch.sqrt(nu32 / bc2) + cfg.eps)
        step = step + cfg.weight_decay * pz.float()
        upd = (pz.float() - lr * step).to(p.dtype)
        new_p.append(mesh.all_gather(upd, "data", zd) if zd is not None else upd)
        new_mu.append(mu32.to(mdt))
        new_nu.append(nu32.to(mdt))
    return (tree_unflatten(params, new_p),
            {"mu": tree_unflatten(params, new_mu), "nu": tree_unflatten(params, new_nu),
             "count": count},
            {"grad_norm": gnorm})

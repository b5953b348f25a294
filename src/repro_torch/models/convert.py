"""Parameter and optimizer-state trees between the reference's layout and
the port's.

The reference stacks a model's layers along a leading axis (for
``lax.scan``): ``layers`` (n_layers, ...), the hybrid's ``layers`` (ng,
attn_every, ...) and ``tail`` (rem, ...), whisper's ``encoder`` and
``decoder``.  The port keeps Python lists of per-layer dicts (the
hybrid's ``layers`` a list of groups, each a list of blocks; an empty
``tail`` where the reference has none).  ``to_reference`` stacks a port
tree (torch tensors or numpy arrays), ``from_reference`` takes the layers
apart again (as views); neither changes a dtype.  ``params_from_numpy``
and ``optim_state_from_numpy`` carry a tree the reference made, as numpy
arrays, onto a device: every bfloat16 / float32 tree of ``lm.init_lm``
(the quantized serving trees add their own leaves in
``serving.quantized_lm.params_from_numpy``, which slices their layers
with ``from_reference`` too)."""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from repro_torch.core.tree import TORCH_DTYPES, from_numpy, tree_leaves, tree_map
from repro_torch.models.common import Family, ModelConfig

Params = Dict[str, Any]

__all__ = ["to_reference", "from_reference", "as_tensor", "fold_expert_split",
           "params_from_numpy", "optim_state_from_numpy", "specs_to_reference"]

# leaves the reference keeps in float32 whatever the model dtype
_F32_LEAVES = ("A_log", "D", "dt_bias", "router")


def _stacked_keys(cfg: ModelConfig):
    if cfg.family is Family.AUDIO:
        return ("encoder", "decoder")
    if cfg.family is Family.HYBRID:
        return ("layers", "tail")
    return ("layers",)


def _stack(trees):
    def one(*leaves):
        if isinstance(leaves[0], torch.Tensor):
            return torch.stack(leaves)
        return np.stack([np.asarray(x) for x in leaves])

    return tree_map(one, *trees)


def _take(tree, i: int):
    # leaves without an axis (a BVQ weight's ``shape`` and ``vec_dim``) are
    # the same for every layer and stay as they are
    return tree_map(lambda a: a[i] if np.ndim(a) else a, tree)


def _count(tree) -> int:
    return next(a for a in tree_leaves(tree) if np.ndim(a)).shape[0]


def to_reference(tree: Params, cfg: ModelConfig) -> Params:
    """A port tree (params, or a moment tree of the same shape) in the
    reference's layer-stacked layout."""
    out = dict(tree)
    for key in _stacked_keys(cfg):
        layers = tree.get(key)
        if not layers:
            out.pop(key, None)
            continue
        if cfg.family is Family.HYBRID and key == "layers":
            layers = [_stack(group) for group in layers]
        out[key] = _stack(layers)
    return out


def specs_to_reference(specs: Params, cfg: ModelConfig) -> Params:
    """A spec tree in the port's per-layer layout (``lm.param_specs``,
    ``optimizer_specs``' moments) in the reference's stacked layout: one
    spec per stacked leaf, the layer axis first and unsharded."""
    out = dict(specs)
    for key in _stacked_keys(cfg):
        layers = specs.get(key)
        if not layers:
            out.pop(key, None)
            continue
        first = layers[0]
        if cfg.family is Family.HYBRID and key == "layers":  # (ng, attn_every, ...)
            first = _prepend(first[0])
        out[key] = _prepend(first)
    return out


def _prepend(spec):
    if isinstance(spec, dict):
        return {k: _prepend(v) for k, v in spec.items()}
    return (None,) + tuple(spec)


def from_reference(tree: Params, cfg: ModelConfig) -> Params:
    """A tree in the reference's layer-stacked layout in the port's layout
    (each layer a view of the stacked arrays)."""
    out = dict(tree)
    for key in _stacked_keys(cfg):
        if key not in tree:
            out[key] = []
            continue
        layers = [_take(tree[key], i) for i in range(_count(tree[key]))]
        if cfg.family is Family.HYBRID and key == "layers":
            layers = [[_take(group, j) for j in range(_count(group))] for group in layers]
        out[key] = layers
    return out


def as_tensor(a, device, dtype: torch.dtype) -> torch.Tensor:
    """A numpy array (an ml_dtypes bfloat16 one too) as a tensor of
    ``dtype`` on ``device``."""
    arr = np.asarray(a)
    if arr.dtype.kind not in "biuf":  # bfloat16 from ml_dtypes
        return from_numpy(arr, arr.dtype.name, device).to(dtype)
    return torch.from_numpy(np.array(arr)).to(device=device, dtype=dtype)


def fold_expert_split(moe: Params, n_experts: int) -> Params:
    """The reference's (E * split, d, f / split) / (E * split, f / split, d)
    expert stacks, made when experts are fewer than the model axis, folded
    into the port's (E, d, f) / (E, f, d) (numpy arrays; split = 1 leaves
    them as they are)."""
    out = dict(moe)
    es, d, fs = np.shape(moe["w_gate"])
    split = es // n_experts
    for name in ("w_gate", "w_up"):
        w = np.asarray(moe[name]).reshape(n_experts, split, d, fs)
        out[name] = w.transpose(0, 2, 1, 3).reshape(n_experts, d, split * fs)
    out["w_down"] = np.asarray(moe["w_down"]).reshape(n_experts, split * fs, d)
    return out


def params_from_numpy(tree: Params, cfg: ModelConfig, device) -> Params:
    """The reference's ``init_lm`` tree of any family, as nested dicts of
    numpy arrays, -> the port's params on ``device``: float weights in the
    model dtype, the SSM's ``A_log`` / ``D`` / ``dt_bias`` and the MoE
    router in float32, as the reference keeps them; split expert stacks
    folded by ``fold_expert_split``."""
    def walk(node, name):
        if isinstance(node, dict):
            return {k: walk(v, k) for k, v in node.items()}
        if isinstance(node, list):
            return [walk(v, name) for v in node]
        return as_tensor(node, device, torch.float32 if name in _F32_LEAVES else cfg.tdtype)

    port = from_reference(tree, cfg)
    if cfg.family is Family.MOE:
        port["layers"] = [dict(lp, moe=fold_expert_split(lp["moe"], cfg.n_experts))
                          for lp in port["layers"]]
    return walk(port, None)


def optim_state_from_numpy(state: Params, cfg: ModelConfig, device) -> Params:
    """The reference's AdamW state (``{"mu", "nu", "count"}``, numpy) -> the
    port's on ``device``, each moment in the dtype it was stored in."""
    def moments(tree):
        return tree_map(lambda a: as_tensor(a, device, TORCH_DTYPES[np.asarray(a).dtype.name]),
                        from_reference(tree, cfg))

    return {"mu": moments(state["mu"]), "nu": moments(state["nu"]),
            "count": torch.tensor(int(np.asarray(state["count"])), dtype=torch.int32,
                                  device=device)}


"""The cell steps of the dry-run, the perf tool and the trainer (torch
counterpart of repro/launch/steps.py): the train, prefill or decode step of
an (arch config x shape) cell on a mesh, with its arguments.

The reference returns a jitted function and ``ShapeDtypeStruct``
arguments for ``.lower().compile()``.  The port has no compiler to hand a
program to; ``build_cell`` returns this rank's step function and its
arguments at the rank's shard shapes: meta tensors when the mesh is the
dry-run's abstract one (``mesh.make_mesh("meta", ...)``), which the
dry-run then runs once under its counters (``launch/dryrun.py``), or real
tensors made from ``seed`` when the mesh is on a device, which the caller
runs.  Nothing here allocates device memory on meta.

``input_specs(cfg, shape, mesh)`` gives the cell's data inputs as
``{name: (shape, dtype)}`` over the global batch and their specs
(``{name: spec tuple}``): the reference's ``ShapeDtypeStruct`` /
``NamedSharding`` pairs in the port's idiom.  ``abstract_model`` /
``abstract_opt`` / ``abstract_cache`` give the whole (unsharded) trees as
meta tensors, with ``lm.param_specs`` / ``lm.cache_specs`` their specs."""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.tree import tree_leaves, tree_map, tree_unflatten
from repro_torch.models import lm
from repro_torch.models.common import Family, ModelConfig, ShapeConfig
from repro_torch.optim import (AdamWConfig, adamw_init, adamw_init_sharded, adamw_update,
                               adamw_update_sharded, linear_warmup_cosine, optimizer_specs)

__all__ = ["param_counts", "batch_axes", "abstract_model", "abstract_opt", "abstract_cache",
           "input_specs", "CellSpec", "build_cell", "build_params"]


def param_counts(cfg: ModelConfig) -> Dict[str, float]:
    """Analytic parameter counts: total and flops-active-per-token.

    active: MoE counts router + top_k experts; hybrid counts the shared attn
    block once per application; whisper counts encoder + decoder (the
    encoder runs over frames, an approximation noted in EXPERIMENTS.md)."""
    d, f, v, hd = cfg.d_model, cfg.d_ff, cfg.vocab, cfg.hd
    attn = d * cfg.n_heads * hd * 2 + d * cfg.n_kv * hd * 2
    n_mats = 3 if cfg.act == "swiglu" else 2
    mlp = n_mats * d * f
    embed = 2 * v * d  # untied in/out embeddings
    if cfg.family is Family.SSM:
        din = cfg.d_inner
        per = d * (2 * din + 2 * cfg.ssm_groups * cfg.ssm_state + cfg.ssm_heads) + din * d
        total = embed + cfg.n_layers * per
        return {"total": total, "active": total}
    if cfg.family is Family.HYBRID:
        din = cfg.d_inner
        per = d * (2 * din + 2 * cfg.ssm_groups * cfg.ssm_state + cfg.ssm_heads) + din * d
        napp = cfg.n_layers // cfg.attn_every
        shared = attn + mlp
        total = embed + cfg.n_layers * per + shared
        active = embed + cfg.n_layers * per + napp * shared
        return {"total": total, "active": active}
    if cfg.family is Family.MOE:
        router = d * cfg.n_experts
        total = embed + cfg.n_layers * (attn + router + cfg.n_experts * mlp)
        active = embed + cfg.n_layers * (attn + router + cfg.top_k * mlp)
        return {"total": total, "active": active}
    if cfg.family is Family.AUDIO:
        enc = cfg.n_encoder_layers * (attn + mlp)
        dec = cfg.n_layers * (2 * attn + mlp)  # self + cross
        total = embed + enc + dec
        return {"total": total, "active": total}
    total = embed + cfg.n_layers * (attn + mlp)
    return {"total": total, "active": total}


def batch_axes(mesh, batch: Optional[int] = None):
    """The axes a batch shards over: ("pod", "data") or "data" without a
    size, else the largest prefix dividing it (``lm.batch_axes_for``)."""
    return lm.batch_axes_for(mesh, batch)


# ---------------------------------------------------------------------------
# Abstract params / optimizer state / caches (meta tensors)
# ---------------------------------------------------------------------------


def abstract_model(cfg: ModelConfig, tp: int) -> Tuple[Any, Any]:
    """(the whole params tree as meta tensors, its specs at model-axis size
    ``tp``)."""
    return lm.init_lm(None, cfg, "meta"), lm.param_specs(cfg, tp)


def abstract_opt(aparams, ocfg: AdamWConfig):
    """AdamW's state of ``aparams`` as meta tensors."""
    return adamw_init(aparams, ocfg)


def abstract_cache(cfg: ModelConfig, batch: int, s_max: int, tp: int):
    """The whole dense cache of ``batch`` rows and ``s_max`` positions at
    model-axis size ``tp``, as meta tensors."""
    return lm.init_cache(cfg, batch, s_max, "meta", tp=tp)


# ---------------------------------------------------------------------------
# input_specs
# ---------------------------------------------------------------------------


def input_specs(cfg: ModelConfig, shape: ShapeConfig, mesh
                ) -> Tuple[Dict[str, Tuple[Tuple[int, ...], torch.dtype]], Dict[str, tuple]]:
    """({name: (global shape, dtype)}, {name: spec}) of the cell's data
    inputs (params, optimizer state and cache are ``build_cell``'s):
    tokens (B, S + 1) to train, (B, S) to prefill, (B, 1) to decode; a
    VLM's image embeddings take ``n_vision_tokens`` of the sequence, the
    audio family's frames feed its encoder."""
    b = shape.global_batch
    ba = batch_axes(mesh, b)
    structs: Dict[str, Tuple[Tuple[int, ...], torch.dtype]] = {}
    specs: Dict[str, tuple] = {"tokens": (ba, None)}
    s = shape.seq_len
    extra = 1 if shape.kind == "train" else 0
    if shape.kind == "decode":
        structs["tokens"] = ((b, 1), torch.int32)
        return structs, specs
    if cfg.family is Family.VLM:
        structs["tokens"] = ((b, s - cfg.n_vision_tokens + extra), torch.int32)
        structs["vision_embeds"] = ((b, cfg.n_vision_tokens, cfg.d_model), cfg.tdtype)
        specs["vision_embeds"] = (ba, None, None)
    elif cfg.family is Family.AUDIO:
        structs["tokens"] = ((b, s + extra), torch.int32)
        structs["frames"] = ((b, cfg.n_audio_frames, cfg.d_model), cfg.tdtype)
        specs["frames"] = (ba, None, None)
    else:
        structs["tokens"] = ((b, s + extra), torch.int32)
    return structs, specs


# ---------------------------------------------------------------------------
# Cells
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class CellSpec:
    """One (arch x shape x mesh) cell on this rank: ``fn(*args)`` runs its
    step (``args`` at the rank's shard shapes, meta or real tensors)."""

    fn: Callable
    args: Tuple[Any, ...]
    kind: str


def _generator(device, seed: int) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(seed)


def build_params(cfg: ModelConfig, mesh, seed: int = 0, quant: Optional[str] = None):
    """This rank's params made from ``seed`` on the mesh's device: the
    target of ``launch.serve.build_sharded_target`` (the attention
    families, made one layer at a time; ``quant="w4a8"`` its W4A8 form),
    or for the SSM, hybrid and audio families the whole ``lm.init_lm``
    tree cut to the rank's shard.  A mesh of one rank gets the whole tree
    from the same draws."""
    from repro_torch.launch.serve import build_sharded_target

    dev = mesh.device
    if quant is not None or cfg.family in (Family.DENSE, Family.VLM, Family.MOE):
        return build_sharded_target(cfg, mesh, quantize=quant == "w4a8", seed=seed, device=dev)
    full = lm.init_lm(_generator(dev, seed), cfg, dev)
    if mesh.size == 1:
        return full
    return lm.shard_params(full, lm.param_specs(cfg, mesh.tp), mesh, cfg)


def _meta_params(cfg: ModelConfig, mesh, quant: Optional[str]):
    """The rank's params as meta tensors: the whole abstract tree cut by
    its specs (the W4A8 forms through ``quantized_lm.shard_quantized``,
    which prepacks as the serving tree does)."""
    from repro_torch.serving import quantized_lm as qlm

    if quant == "w4a8":
        tree = (qlm._abstract_moe(cfg) if cfg.family is Family.MOE
                else qlm.abstract_quantized(cfg, mesh.tp)[0])
        return qlm.shard_quantized(tree, cfg, mesh)
    aparams, specs = abstract_model(cfg, mesh.tp)
    return lm.shard_params(aparams, specs, mesh, cfg) if mesh.size > 1 else aparams


def _inputs(cfg: ModelConfig, shape: ShapeConfig, mesh, seed: int) -> Dict[str, torch.Tensor]:
    """The rank's rows of the cell's data inputs: meta tensors, or drawn
    from ``seed`` over the whole batch (tokens with numpy, embeddings with
    a generator on the device) and cut to the rank's rows, so every mesh
    shape sees the same global inputs."""
    structs, _ = input_specs(cfg, shape, mesh)
    dev = mesh.device
    out = {}
    rng = np.random.RandomState(seed)
    gen = None if dev.type == "meta" else _generator(dev, seed)
    for name, (shp, dt) in structs.items():
        if dev.type == "meta":
            full = torch.empty(shp, dtype=dt, device=dev)
        elif name == "tokens":
            full = torch.as_tensor(rng.randint(0, cfg.vocab, shp), dtype=dt, device=dev)
        else:
            full = torch.randn(shp, generator=gen, dtype=torch.float32, device=dev).to(dt)
        out[name] = lm.local_rows(full, mesh)
    return out


def _forward(cfg: ModelConfig, quant: Optional[str]):
    """(params, tokens, cache, mesh, last_logit_only, **extra) -> (logits,
    cache) of the cell's model: ``lm.apply_lm`` or the W4A8 forwards."""
    if quant is None:
        def fwd(params, tokens, cache, mesh, last, **extra):
            return lm.apply_lm(params, cfg, tokens, cache=cache, mesh=mesh,
                               last_logit_only=last, **extra)
        return fwd
    from repro_torch.serving import quantized_lm as qlm

    apply = qlm.apply_quantized_moe_lm if cfg.family is Family.MOE else qlm.apply_quantized_lm

    def qfwd(params, tokens, cache, mesh, last, **extra):
        return apply(params, cfg, tokens, cache=cache, mesh=mesh, last_logit_only=last)
    return qfwd


def build_cell(cfg: ModelConfig, shape: ShapeConfig, mesh, ocfg: Optional[AdamWConfig] = None,
               seed: int = 0, quant: Optional[str] = None, s_max: Optional[int] = None,
               params=None) -> CellSpec:
    """This rank's step of the cell and its arguments.

    * train (any family but the W4A8 forms): ``fn(params, opt_state, step,
      tokens[, frames | vision_embeds]) -> (params, opt_state, {"loss",
      "grad_norm"})``: ``lm.loss_fn``, the backward and AdamW under
      ``linear_warmup_cosine(step, 100, 10000)``, ZeRO-1 over ``data``
      where the reference's step uses it (not under FSDP);
    * prefill: ``fn(params, tokens[, extra], cache) -> (last position's
      logits, cache)`` into an empty cache of ``s_max`` positions (default
      ``seq_len``);
    * decode: ``fn(params, tokens, cache)``, one token against a cache
      holding ``seq_len - 1`` positions (a ``seq_len``-deep cache).

    ``quant="w4a8"`` serves the W4A8 + LRU target (the dense family) or the
    W4A8 MoE instead (the perf tool's quantized cells).  ``params``
    replaces the seeded ones (the rank's shard)."""
    meta = mesh.device.type == "meta"
    sharded = mesh.size > 1
    if params is None:
        params = _meta_params(cfg, mesh, quant) if meta else build_params(cfg, mesh, seed, quant)
    data = _inputs(cfg, shape, mesh, seed)
    extra = {k: v for k, v in data.items() if k != "tokens"}
    run_mesh = mesh if sharded or cfg.family is Family.MOE else None
    if shape.kind == "train":
        if quant is not None:
            raise ValueError("build_cell: the W4A8 forms serve; they have no train cell")
        return _train_cell(cfg, mesh, params, data, extra, ocfg)
    fwd = _forward(cfg, quant)
    batch = shape.global_batch
    depth = s_max or shape.seq_len
    dev = mesh.device
    cache = lm.init_cache(cfg, batch, depth, dev, mesh=mesh if sharded else None)
    names = list(extra)
    if shape.kind == "prefill":
        def prefill(params, tokens, *rest):
            *ex, cache = rest
            return fwd(params, tokens, cache, run_mesh, True, **dict(zip(names, ex)))
        return CellSpec(prefill, (params, data["tokens"], *extra.values(), cache), "prefill")
    cache["length"] = shape.seq_len - 1

    def decode(params, tokens, cache):
        return fwd(params, tokens, cache, run_mesh, False)
    return CellSpec(decode, (params, data["tokens"], cache), "decode")


def _train_cell(cfg: ModelConfig, mesh, params, data, extra, ocfg) -> CellSpec:
    ocfg = ocfg or AdamWConfig(moment_dtype=cfg.optim_dtype)
    sharded = mesh.size > 1
    if sharded:
        specs = lm.param_specs(cfg, mesh.tp)
        full = lm.init_lm(None, cfg, "meta")  # sizes only, for ZeRO-1's dimension choice
        moment_specs = optimizer_specs(specs, full, zero1_axis=None if cfg.fsdp else "data",
                                       axis_size=mesh.shape["data"])
        opt = adamw_init_sharded(params, ocfg, specs, moment_specs, mesh)
    else:
        opt = adamw_init(params, ocfg)
    names = list(extra)

    def train_step(params, opt_state, step, tokens, *ex):
        kw = dict(zip(names, ex))
        p = tree_map(lambda t: t.detach().requires_grad_(), params)
        loss = lm.loss_fn(p, cfg, tokens, mesh=mesh if sharded else None, **kw)
        grads = tree_unflatten(p, torch.autograd.grad(loss, tree_leaves(p)))
        lscale = linear_warmup_cosine(step, 100, 10000)
        if sharded:
            new_p, new_opt, m = adamw_update_sharded(
                p, grads, opt_state, ocfg, lscale, mesh, specs, moment_specs,
                lm.batch_axes_for(mesh), cfg.grad_barrier, cfg.grad_constraint)
        else:
            new_p, new_opt, m = adamw_update(p, grads, opt_state, ocfg, lscale)
        return new_p, new_opt, {"loss": loss.detach(), **m}

    return CellSpec(train_step, (params, opt, 0, data["tokens"], *extra.values()), "train")

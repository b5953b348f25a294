"""Decoder LM of every family (torch counterpart of repro/models/lm.py):
parameters, caches, the forward and the training loss.

Parameters are plain nested dicts of tensors with the reference's names
and per-layer shapes; where the reference stacks layers along a leading
axis (for ``lax.scan``), the port keeps a Python list of per-layer dicts
and loops over it (the hybrid: a list of ``ng`` groups of ``attn_every``
mamba blocks, then ``tail``; ``models/convert.py`` moves trees between
the two layouts).  An attention block is ``ln1, attn, ln2`` and then
``mlp`` (SwiGLU, squared-ReLU or GELU, with Qwen3's ``q_norm`` /
``k_norm`` in ``attn`` under ``qk_norm``) or, in the MoE family, ``moe``
(an f32 router and the experts' stacked SwiGLU weights).  An SSM block is
``ln`` and ``mamba`` (``models/ssm.py``).  zamba2's hybrid applies ONE
``shared_attn`` attention block after every ``attn_every`` mamba blocks:
one set of tensors, each application with its own KV cache entry, its
gradient the sum over the applications.  The audio family (whisper) is
the encoder-decoder of ``models/whisper.py``; ``init_lm`` / ``apply_lm``
/ ``init_cache`` / ``loss_fn`` hand it there.

``apply_lm`` takes the cache dicts of the quantized forwards (dense, or,
for the attention families, a paged pool with ``win_pos`` / ``tree_mask``
/ ``role_mask``), so every engine schedule runs on it unchanged; the SSM,
hybrid and audio families take a dense cache only, as in the reference.
Without a cache and with ``cfg.remat`` (and autograd on), each block runs
under ``torch.utils.checkpoint`` (``use_reentrant=False``): its
activations are recomputed in the backward pass, which changes no bit of
the loss or the gradients.  ``remat_policy="dots"`` is full remat here.

On a mesh (``mesh=``, a ``launch/mesh.DeviceMesh``) the attention
families run sharded: ``param_specs`` is the reference's spec tree in the
port's per-layer layout, ``shard_params`` takes a rank's slice of a full
tree, ``init_cache(..., mesh=)`` holds the rank's rows and virtual kv
heads.  ``apply_lm`` takes the rank's rows of the batch (``local_rows``)
and returns their logits over the whole vocabulary: the embedding and the
head are vocab-sharded (a masked lookup then an all-reduce; the head's
logits gathered over ``model``), and with ``cfg.seq_shard`` and S > 1
dividing by tp the residual stream is sharded over the sequence between
the blocks (Megatron), gathered before the column-parallel linears and
reduce-scattered after the row-parallel ones (``sp_once_per_block``: once
per block, around the whole block).  ``loss_fn(..., mesh=)`` is the mean
over the global batch."""
from __future__ import annotations

import math
from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.launch import mesh as M
from repro_torch.models import layers as L
from repro_torch.models import ssm as S
from repro_torch.models import whisper as W
from repro_torch.models.common import Family, ModelConfig

Params = Dict[str, Any]

__all__ = ["init_lm", "init_layer", "init_embed", "init_cache", "apply_lm", "loss_fn",
           "hybrid_groups", "param_count", "param_specs", "layer_specs", "shard_params",
           "shard_leaf", "unshard_leaf", "map_specs", "batch_axes_for", "local_rows", "split_experts"]

# the families whose blocks are attention + an FFN (dense or MoE)
_ATTENTION_FAMILIES = (Family.DENSE, Family.VLM, Family.MOE)
_BLOCK_OF = {Family.DENSE: "dense", Family.VLM: "dense", Family.MOE: "moe", Family.SSM: "ssm"}


def _normal(gen: torch.Generator, shape, dtype, device, scale: float) -> torch.Tensor:
    return torch.randn(shape, generator=gen, dtype=dtype, device=device) * scale


def hybrid_groups(cfg: ModelConfig) -> Tuple[int, int]:
    """(full groups of ``attn_every`` mamba blocks + the shared attention
    block, trailing mamba blocks)."""
    return cfg.n_layers // cfg.attn_every, cfg.n_layers % cfg.attn_every


def init_layer(gen: torch.Generator, cfg: ModelConfig, device, block: Optional[str] = None
               ) -> Params:
    """One block with the reference's init scales: ``block`` "dense"
    (attention + MLP), "moe" (attention + MoE) or "ssm" (norm + mamba2);
    by default the family's own block (the hybrid and audio families name
    it)."""
    block = block or _BLOCK_OF.get(cfg.family)
    if block is None:
        raise ValueError(f"init_layer: name the block of a {cfg.family.value} config")
    dt = cfg.tdtype
    if block == "ssm":
        return {"ln": {"g": torch.ones((cfg.d_model,), dtype=dt, device=device)},
                "mamba": S.mamba_init(gen, cfg, device)}
    d, f = cfg.d_model, cfg.d_ff
    s = 1.0 / math.sqrt(d)
    attn = L.attention_init(gen, cfg, device)
    layer = {"ln1": {"g": torch.ones((d,), dtype=dt, device=device)}, "attn": attn,
             "ln2": {"g": torch.ones((d,), dtype=dt, device=device)}}
    if block == "moe":
        e = cfg.n_experts
        layer["moe"] = {
            "router": _normal(gen, (d, e), torch.float32, device, s),
            "w_gate": _normal(gen, (e, d, f), dt, device, s),
            "w_up": _normal(gen, (e, d, f), dt, device, s),
            "w_down": _normal(gen, (e, f, d), dt, device, 1.0 / math.sqrt(f)),
        }
    else:
        layer["mlp"] = L.mlp_init(gen, cfg, device)
    return layer


def init_embed(gen: torch.Generator, cfg: ModelConfig, device) -> Params:
    dt = cfg.tdtype
    return {
        "embed": {
            "tok": _normal(gen, (cfg.vocab_padded, cfg.d_model), dt, device, 0.02),
            "head": _normal(gen, (cfg.d_model, cfg.vocab_padded), dt, device,
                            1.0 / math.sqrt(cfg.d_model)),
        },
        "final_norm": {"g": torch.ones((cfg.d_model,), dtype=dt, device=device)},
    }


def init_lm(gen: torch.Generator, cfg: ModelConfig, device) -> Params:
    """Random params of any family drawn from ``gen`` (whose device must
    match ``device``), one layer at a time."""
    if cfg.family is Family.AUDIO:
        return W.init_whisper(gen, cfg, device)
    params = init_embed(gen, cfg, device)
    if cfg.family is Family.HYBRID:
        ng, rem = hybrid_groups(cfg)
        params["layers"] = [[init_layer(gen, cfg, device, "ssm") for _ in range(cfg.attn_every)]
                            for _ in range(ng)]
        params["tail"] = [init_layer(gen, cfg, device, "ssm") for _ in range(rem)]
        params["shared_attn"] = init_layer(gen, cfg, device, "dense")
    else:
        params["layers"] = [init_layer(gen, cfg, device) for _ in range(cfg.n_layers)]
    return params


def param_count(params) -> int:
    """Elements of every tensor in a params tree."""
    if isinstance(params, torch.Tensor):
        return params.numel()
    if isinstance(params, dict):
        return sum(param_count(v) for v in params.values())
    if isinstance(params, (list, tuple)):
        return sum(param_count(v) for v in params)
    return 0


# ---------------------------------------------------------------------------
# Mesh layout
# ---------------------------------------------------------------------------


def batch_axes_for(mesh, batch: Optional[int] = None):
    """The axes the batch shards over (the reference's ``batch_axes_for``):
    "data" without a mesh, else ``pick_batch_axes`` (None: replicated)."""
    if mesh is None:
        return "data"
    if batch is None:
        return ("pod", "data") if "pod" in mesh.shape else "data"
    return L.pick_batch_axes(mesh, batch)


def local_rows(x: torch.Tensor, mesh) -> torch.Tensor:
    """This rank's rows of a global batch (dim 0): its block along the
    batch axes, or every row where the batch does not divide."""
    if mesh is None or mesh.size == 1:
        return x
    axes = L.pick_batch_axes(mesh, x.shape[0])
    if axes is None:
        return x
    n = mesh.axis_size(axes)
    per = x.shape[0] // n
    return x[mesh.axis_index(axes) * per:(mesh.axis_index(axes) + 1) * per]


def layer_specs(cfg: ModelConfig, tp: int, block: Optional[str] = None) -> Params:
    """One attention block's spec tree (the reference's ``_layer_init``
    specs without the stacked layer axis)."""
    block = block or _BLOCK_OF.get(cfg.family)
    out = {"ln1": L.rmsnorm_spec(), "attn": L.attention_specs(cfg, tp),
           "ln2": L.rmsnorm_spec()}
    if block == "moe":
        out["moe"] = L.moe_specs(cfg, tp)
    elif block == "dense":
        out["mlp"] = L.mlp_specs(cfg)
    else:
        raise NotImplementedError(f"specs of a {block} block: the attention families only")
    return out


def param_specs(cfg: ModelConfig, tp: int = 1) -> Params:
    """The spec tree of ``init_lm``'s params at model-axis size ``tp``: per
    leaf one axis name (or None) per dimension, the reference's
    ``init_lm(key, cfg, tp)[1]`` with its ``PartitionSpec`` leaves as
    tuples, in the port's per-layer layout (the attention families)."""
    if cfg.family not in _ATTENTION_FAMILIES:
        raise NotImplementedError(f"a mesh for the {cfg.family.value} family: "
                                  "ROADMAP Queue 1")
    return {"embed": L.embed_specs(cfg), "final_norm": L.rmsnorm_spec(),
            "layers": [layer_specs(cfg, tp) for _ in range(cfg.n_layers)]}


def split_experts(w: torch.Tensor, name: str, n_experts: int, split: int) -> torch.Tensor:
    """The port's (E, d, f) / (E, f, d) expert stack as the reference's
    (E * split, d, f / split) / (E * split, f / split, d), whose leading
    axis the model ranks split when experts are fewer than ranks."""
    if split == 1:
        return w
    e, a, b = w.shape
    if name == "w_down":
        return w.reshape(e * split, a // split, b)
    return w.reshape(e, a, split, b // split).permute(0, 2, 1, 3).reshape(e * split, a, b // split)


def shard_leaf(t: torch.Tensor, spec, mesh) -> torch.Tensor:
    """Rank ``mesh``'s block of a full tensor under ``spec`` (each named
    dimension cut into equal contiguous blocks, in axis order)."""
    for dim, part in enumerate(spec):
        if part is None:
            continue
        n = mesh.axis_size(part)
        if t.shape[dim] % n:
            raise ValueError(f"dim {dim} of {tuple(t.shape)} does not split over {part} ({n})")
        size = t.shape[dim] // n
        t = t.narrow(dim, mesh.axis_index(part) * size, size)
    return t.contiguous()


def unshard_leaf(t: torch.Tensor, spec, mesh) -> torch.Tensor:
    """The full tensor from every rank's ``shard_leaf`` block (a collective
    over the spec's axes)."""
    for dim, part in reversed(list(enumerate(spec))):
        if part is not None:
            t = mesh.all_gather(t, part, dim)
    return t


def map_specs(tree, specs, fn):
    """fn(leaf, spec) over a tree and its spec tree (tuples are specs)."""
    if isinstance(tree, dict):
        return {k: map_specs(v, specs[k], fn) for k, v in tree.items()}
    if isinstance(tree, list):
        return [map_specs(v, sp, fn) for v, sp in zip(tree, specs)]
    return fn(tree, specs)


def shard_params(params: Params, specs: Params, mesh, cfg: Optional[ModelConfig] = None
                 ) -> Params:
    """This rank's slice of a full params tree (``shard_leaf`` per leaf);
    with ``cfg`` given, expert stacks are first split as the reference
    stores them when experts are fewer than the model axis."""
    if cfg is not None and cfg.family is Family.MOE:
        split = L.moe_ff_split(cfg, mesh.tp)
        params = dict(params, layers=[
            dict(lp, moe={k: split_experts(v, k, cfg.n_experts, split) if k != "router" else v
                          for k, v in lp["moe"].items()}) for lp in params["layers"]])
    return map_specs(params, specs, lambda t, sp: shard_leaf(t, sp, mesh))


def init_cache(cfg: ModelConfig, batch: int, s_max: int, device,
               dtype: Optional[torch.dtype] = None, mesh=None) -> Params:
    """The dense cache of prefill and decode, written in place by
    ``apply_lm``: ``{"length": 0, "attn": {"k", "v"}}`` with (n_layers,
    batch, s_max, kv heads, hd) buffers for the attention families;
    ``"ssm": {"state", "conv"}`` with a leading (n_layers,) axis for the
    SSM family; for the hybrid, ``"ssm"`` with leading (ng, attn_every),
    ``"ssm_tail"`` with (rem,) and ``"attn"`` with one entry per shared
    block application (ng); whisper's cache for the audio family.  On a
    mesh, ``batch`` is the global batch: the cache holds this rank's rows
    (``local_rows``) and its ``kv_store_heads / tp`` virtual heads (every
    head where attention is replicated over ``model``), the reference's
    ``cache_specs``."""
    dt = dtype or cfg.tdtype
    fam = cfg.family
    heads = cfg.n_kv
    if mesh is not None and mesh.size > 1:
        if fam not in _ATTENTION_FAMILIES:
            raise NotImplementedError(f"a mesh for the {fam.value} family: ROADMAP Queue 1")
        axes = L.pick_batch_axes(mesh, batch)
        batch //= mesh.axis_size(axes) if axes is not None else 1
        heads = L.kv_store_heads(cfg, mesh.tp)
        if L.attn_tp_enabled(cfg, mesh.tp):
            heads //= mesh.tp
    if fam is Family.AUDIO:
        return W.init_whisper_cache(cfg, batch, s_max, device, dt)
    cache: Params = {"length": 0}

    def stacked(lead):
        base = S.init_ssm_cache(cfg, batch, dt, device)
        return {k: torch.zeros(lead + tuple(v.shape), dtype=v.dtype, device=device)
                for k, v in base.items()}

    def attn(n):
        shape = (n, batch, s_max, heads, cfg.hd)
        return {"k": torch.zeros(shape, dtype=dt, device=device),
                "v": torch.zeros(shape, dtype=dt, device=device)}

    if fam in _ATTENTION_FAMILIES:
        cache["attn"] = attn(cfg.n_layers)
    elif fam is Family.SSM:
        cache["ssm"] = stacked((cfg.n_layers,))
    else:  # hybrid
        ng, rem = hybrid_groups(cfg)
        cache["ssm"] = stacked((ng, cfg.attn_every))
        if rem:
            cache["ssm_tail"] = stacked((rem,))
        cache["attn"] = attn(ng)
    return cache


def _attention_block(p: Params, x: torch.Tensor, cfg: ModelConfig, i: int, cache, offset,
                     positions, paged, shard: L.Shard = L.Shard()) -> torch.Tensor:
    """Pre-norm attention (layer i's cache entry) and MLP or MoE."""
    if shard.sp and cfg.sp_once_per_block:
        full = L.Shard(shard.mesh, sp=False)
        x = M.gather_replicated(x, shard.mesh, "model", 1)
        return M.split(_attention_block(p, x, cfg, i, cache, offset, positions, paged, full),
                       shard.mesh, "model", 1)
    x = x + L.attention_apply(p["attn"], L.rmsnorm(shard.gain(p["ln1"]), x), cfg, i, cache,
                              offset, positions, paged, shard)
    z = L.rmsnorm(shard.gain(p["ln2"]), x)
    if "moe" in p:
        return x + (L.moe_apply(p["moe"], z, cfg) if shard.mesh is None else
                    L.moe_apply(p["moe"], z, cfg, shard))
    return x + L.mlp_apply(p["mlp"], z, cfg, shard)


def _ssm_block(p: Params, x: torch.Tensor, cfg: ModelConfig, state: Optional[Params],
               decode: bool) -> torch.Tensor:
    """Pre-norm mamba2 block.  ``state`` holds views of this block's entry
    in the cache (``state``, ``conv``), overwritten in place with the new
    state; None trains or scores without a cache."""
    z = L.rmsnorm(p["ln"], x)
    if decode:
        y, new = S.mamba_decode(p["mamba"], z, cfg, state)
    else:
        y, fstate, tail = S.mamba_apply(p["mamba"], z, cfg,
                                        state["state"] if state is not None else None,
                                        state["conv"] if state is not None else None)
        new = {"state": fstate, "conv": tail}
    if state is not None:
        state["state"].copy_(new["state"])
        state["conv"].copy_(new["conv"])
    return x + y


def _ssm_state(tree: Optional[Params], *index) -> Optional[Params]:
    return None if tree is None else {k: v[index] for k, v in tree.items()}


def _embed(params: Params, cfg: ModelConfig, tokens: torch.Tensor, shard: L.Shard
           ) -> torch.Tensor:
    """Token embeddings; on a mesh from the rank's vocabulary block."""
    tok = shard.full(params["embed"]["tok"], L.embed_specs(cfg)["tok"])
    return L.embed_lookup(tok, tokens, shard).to(cfg.tdtype)


def _head(params: Params, cfg: ModelConfig, x: torch.Tensor, shard: L.Shard) -> torch.Tensor:
    """Logits over the whole (padded) vocabulary: on a mesh each rank's
    vocabulary block of the whole sequence, then gathered over ``model``."""
    head = shard.full(params["embed"]["head"], L.embed_specs(cfg)["head"]).to(cfg.tdtype)
    logits = L.linear(shard.enter(x) if shard.tp > 1 else x, head)
    logits = M.gather_replicated(logits, shard.mesh, "model", logits.dim() - 1)
    if cfg.vocab_padded != cfg.vocab:
        pad = torch.arange(cfg.vocab_padded, device=logits.device) >= cfg.vocab
        logits = logits.masked_fill(pad, -1e9)
    return logits


def _shard_of(cfg: ModelConfig, mesh, s: int) -> L.Shard:
    """The blocks' context: none without a mesh; on a mesh (one rank too,
    where the MoE block takes the reference's all-to-all path as it does
    for any mesh) sequence sharding where the reference constrains it."""
    if mesh is None:
        return L.Shard()
    if cfg.family not in _ATTENTION_FAMILIES:
        raise NotImplementedError(f"a mesh for the {cfg.family.value} family: ROADMAP Queue 1")
    tp = mesh.tp
    return L.Shard(mesh, sp=bool(cfg.seq_shard and tp > 1 and s > 1 and s % tp == 0))


def apply_lm(params: Params, cfg: ModelConfig, tokens: torch.Tensor,
             cache: Optional[Params] = None,
             vision_embeds: Optional[torch.Tensor] = None,
             frames: Optional[torch.Tensor] = None,
             mesh=None) -> Tuple[torch.Tensor, Optional[Params]]:
    """The forward of every family: embed (after ``vision_embeds`` (B,
    T_img, d), which a VLM's image tokens prepend), the blocks, final norm,
    head; logits past ``vocab`` (a padded vocabulary) are -1e9.  The SSM
    and hybrid families run the chunked scan when S > 1 (prefill, extend,
    training) and the recurrent step when S == 1 with a cache; the audio
    family is ``whisper.apply_whisper`` (``frames`` (B, n_frames, d) feed
    its encoder).  Cache tensors are written in place; the returned cache
    dict carries the advanced length.  With ``mesh`` (the attention
    families) ``params`` is the rank's shard, ``tokens`` its rows, and the
    logits its rows' over the whole vocabulary."""
    fam = cfg.family
    if cache is not None and "page_table" in cache and fam not in _ATTENTION_FAMILIES:
        raise NotImplementedError(f"paged KV cache: family {fam.value}")
    if fam is Family.AUDIO and mesh is None:
        return W.apply_whisper(params, cfg, tokens, frames=frames, cache=cache)
    b = tokens.shape[0]
    s = tokens.shape[1] + (vision_embeds.shape[1] if vision_embeds is not None else 0)
    shard = _shard_of(cfg, mesh, s)
    x = _embed(params, cfg, tokens, shard)
    if vision_embeds is not None:
        x = torch.cat([vision_embeds.to(cfg.tdtype), x], dim=1)
    if shard.sp:
        x = M.split(x, shard.mesh, "model", 1)
    decode = cache is not None and s == 1
    if fam is Family.SSM:  # no attention: no positions
        offset, positions, paged = (int(cache["length"]) if cache is not None else 0), None, None
    else:
        offset, positions, paged = L.forward_cache_ctx(cache, b, s, x.device)

    def attn_block(p, i):
        return L.remat(lambda xc: _attention_block(p, xc, cfg, i, cache, offset, positions,
                                                    paged, shard), cfg, cache is not None)

    def ssm_block(p, state):
        return L.remat(lambda xc: _ssm_block(p, xc, cfg, state, decode), cfg, cache is not None)

    ssm = cache.get("ssm") if cache is not None else None
    if fam is Family.SSM:
        for i, p in enumerate(params["layers"]):
            x = ssm_block(p, _ssm_state(ssm, i))(x)
    elif fam is Family.HYBRID:
        for g, group in enumerate(params["layers"]):
            for j, p in enumerate(group):
                x = ssm_block(p, _ssm_state(ssm, g, j))(x)
            x = attn_block(params["shared_attn"], g)(x)
        tail = cache.get("ssm_tail") if cache is not None else None
        for t, p in enumerate(params["tail"]):
            x = ssm_block(p, _ssm_state(tail, t))(x)
    else:
        for i, p in enumerate(params["layers"]):
            x = attn_block(p, i)(x)
    x = L.rmsnorm(shard.gain(params["final_norm"]), x)
    return _head(params, cfg, x, shard), L.advance_cache(cache, offset, s)


def loss_fn(params: Params, cfg: ModelConfig, tokens: torch.Tensor,
            vision_embeds: Optional[torch.Tensor] = None,
            frames: Optional[torch.Tensor] = None, mesh=None) -> torch.Tensor:
    """Next-token cross-entropy over tokens (B, S+1): inputs ``[:, :-1]``,
    targets ``[:, 1:]``; a VLM scores its text positions only, the audio
    family is ``whisper.whisper_loss_fn`` over ``frames``.  On a mesh,
    ``tokens`` are the rank's rows of a global batch the batch axes
    divide, and the loss is the mean over the global batch (its gradient
    on each rank is the rank's share, summed over ``data`` after the
    backward)."""
    if cfg.family is Family.AUDIO:
        return W.whisper_loss_fn(params, cfg, tokens, frames)
    logits, _ = apply_lm(params, cfg, tokens[:, :-1], vision_embeds=vision_embeds, mesh=mesh)
    if vision_embeds is not None:
        logits = logits[:, vision_embeds.shape[1]:, :]
    loss = L.xent(logits, tokens[:, 1:])
    if mesh is not None and mesh.dp > 1:
        axes = batch_axes_for(mesh)
        loss = M.all_reduce(loss, mesh, axes) / mesh.axis_size(axes)
    return loss

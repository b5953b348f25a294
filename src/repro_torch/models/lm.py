"""Decoder LM of the attention families (dense, VLM, MoE): parameters,
caches and the bf16 forward (torch counterpart of repro/models/lm.py's
attention-family parts).

Parameters are plain nested dicts of tensors with the reference's names
and per-layer shapes; where the reference stacks layers along a leading
axis (for ``lax.scan``), the port keeps a Python list of per-layer dicts
and loops over it.  A block is ``ln1, attn, ln2`` and then ``mlp`` (SwiGLU,
squared-ReLU or GELU, with Qwen3's ``q_norm`` / ``k_norm`` in ``attn``
under ``qk_norm``) or, in the MoE family, ``moe`` (an f32 router and the
experts' stacked SwiGLU weights).  ``apply_lm`` takes the cache dicts of
the quantized forwards (dense, or a paged pool with ``win_pos`` /
``tree_mask`` / ``role_mask``), so every engine schedule runs on it
unchanged.  The SSM, hybrid and audio families are not ported: their
configs load, and ``init_lm`` / ``apply_lm`` raise naming the family."""
from __future__ import annotations

import math
from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.models import layers as L
from repro_torch.models.common import Family, ModelConfig

Params = Dict[str, Any]

__all__ = ["init_lm", "init_layer", "init_embed", "init_cache", "apply_lm", "param_count"]

# the families whose blocks are attention + an FFN (dense or MoE)
_ATTENTION_FAMILIES = (Family.DENSE, Family.VLM, Family.MOE)


def _normal(gen: torch.Generator, shape, dtype, device, scale: float) -> torch.Tensor:
    return torch.randn(shape, generator=gen, dtype=dtype, device=device) * scale


def _check_family(cfg: ModelConfig) -> None:
    if cfg.family not in _ATTENTION_FAMILIES:
        raise NotImplementedError(f"the port does not serve the {cfg.family.value} family "
                                  f"({cfg.name})")


def init_layer(gen: torch.Generator, cfg: ModelConfig, device) -> Params:
    """One block (attention + MLP, or attention + MoE in the MoE family)
    with the reference's init scales."""
    _check_family(cfg)
    d, h, kv, hd, f = cfg.d_model, cfg.n_heads, cfg.n_kv, cfg.hd, cfg.d_ff
    dt = cfg.tdtype
    s = 1.0 / math.sqrt(d)
    attn = {
        "wq": _normal(gen, (d, h, hd), dt, device, s),
        "wk": _normal(gen, (d, kv, hd), dt, device, s),
        "wv": _normal(gen, (d, kv, hd), dt, device, s),
        "wo": _normal(gen, (h, hd, d), dt, device, s / math.sqrt(h)),
    }
    if cfg.qk_norm:
        attn["q_norm"] = torch.ones((hd,), dtype=dt, device=device)
        attn["k_norm"] = torch.ones((hd,), dtype=dt, device=device)
    layer = {"ln1": {"g": torch.ones((d,), dtype=dt, device=device)}, "attn": attn,
             "ln2": {"g": torch.ones((d,), dtype=dt, device=device)}}
    if cfg.family is Family.MOE:
        e = cfg.n_experts
        layer["moe"] = {
            "router": _normal(gen, (d, e), torch.float32, device, s),
            "w_gate": _normal(gen, (e, d, f), dt, device, s),
            "w_up": _normal(gen, (e, d, f), dt, device, s),
            "w_down": _normal(gen, (e, f, d), dt, device, 1.0 / math.sqrt(f)),
        }
    elif cfg.act == "swiglu":
        layer["mlp"] = {
            "w_gate": _normal(gen, (d, f), dt, device, s),
            "w_up": _normal(gen, (d, f), dt, device, s),
            "w_down": _normal(gen, (f, d), dt, device, 1.0 / math.sqrt(f)),
        }
    else:  # squared_relu, gelu: two matrices, no gate
        layer["mlp"] = {
            "w_up": _normal(gen, (d, f), dt, device, s),
            "w_down": _normal(gen, (f, d), dt, device, 1.0 / math.sqrt(f)),
        }
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
    """Random LM params drawn from ``gen`` (whose device must match
    ``device``)."""
    _check_family(cfg)
    params = init_embed(gen, cfg, device)
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


def init_cache(cfg: ModelConfig, batch: int, s_max: int, device,
               dtype: Optional[torch.dtype] = None) -> Params:
    """Dense KV cache for prefill: ``{"length": 0, "attn": {"k", "v"}}``
    with (n_layers, batch, s_max, kv heads, hd) buffers."""
    _check_family(cfg)
    shape = (cfg.n_layers, batch, s_max, L.kv_store_heads(cfg), cfg.hd)
    dt = dtype or cfg.tdtype
    return {
        "length": 0,
        "attn": {
            "k": torch.zeros(shape, dtype=dt, device=device),
            "v": torch.zeros(shape, dtype=dt, device=device),
        },
    }


def apply_lm(params: Params, cfg: ModelConfig, tokens: torch.Tensor,
             cache: Optional[Params] = None,
             vision_embeds: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, Optional[Params]]:
    """The attention families' forward (the reference's ``apply_lm`` over
    ``_dense_block``): embed (after ``vision_embeds`` (B, T_img, d), which
    a VLM's image tokens prepend), pre-norm attention and MLP or MoE
    blocks, final norm, head; logits past ``vocab`` (a padded vocabulary)
    are -1e9.  Cache tensors are written in place; the returned cache dict
    carries the advanced length."""
    _check_family(cfg)
    b = tokens.shape[0]
    x = params["embed"]["tok"][tokens.long()].to(cfg.tdtype)
    if vision_embeds is not None:
        x = torch.cat([vision_embeds.to(cfg.tdtype), x], dim=1)
    s = x.shape[1]
    offset, positions, paged = L.forward_cache_ctx(cache, b, s)
    for i, p in enumerate(params["layers"]):
        x = x + L.attention_apply(p["attn"], L.rmsnorm(p["ln1"], x), cfg, i, cache, offset,
                                  positions, paged)
        z = L.rmsnorm(p["ln2"], x)
        x = x + (L.moe_apply(p["moe"], z, cfg) if cfg.family is Family.MOE
                 else L.mlp_apply(p["mlp"], z, cfg))
    x = L.rmsnorm(params["final_norm"], x)
    logits = L.linear(x, params["embed"]["head"].to(cfg.tdtype))
    if cfg.vocab_padded != cfg.vocab:
        pad = torch.arange(cfg.vocab_padded, device=logits.device) >= cfg.vocab
        logits = logits.masked_fill(pad, -1e9)
    return logits, L.advance_cache(cache, offset, s)

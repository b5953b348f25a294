"""Dense-family decoder LM: parameters, caches and the bf16 forward
(torch counterpart of the dense parts of repro/models/lm.py).

Parameters are plain nested dicts of tensors with the reference's names
and per-layer shapes; where the reference stacks layers along a leading
axis (for ``lax.scan``), the port keeps a Python list of per-layer dicts
and loops over it.  ``apply_lm`` takes the cache dicts of the quantized
forwards (dense, or a paged pool with ``win_pos`` / ``tree_mask`` /
``role_mask``), so every engine schedule runs on it unchanged."""
from __future__ import annotations

import math
from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.models import layers as L
from repro_torch.models.common import Family, ModelConfig

Params = Dict[str, Any]

__all__ = ["init_lm", "init_layer", "init_embed", "init_cache", "apply_lm"]


def _normal(gen: torch.Generator, shape, dtype, device, scale: float) -> torch.Tensor:
    return torch.randn(shape, generator=gen, dtype=dtype, device=device) * scale


def _check_dense(cfg: ModelConfig) -> None:
    if cfg.family not in (Family.DENSE, Family.VLM) or cfg.act != "swiglu" or cfg.qk_norm:
        raise NotImplementedError(f"the port serves dense SwiGLU blocks, not {cfg.name}")


def init_layer(gen: torch.Generator, cfg: ModelConfig, device) -> Params:
    """One dense (attention + SwiGLU) block with the reference's init scales."""
    _check_dense(cfg)
    d, h, kv, hd, f = cfg.d_model, cfg.n_heads, cfg.n_kv, cfg.hd, cfg.d_ff
    dt = cfg.tdtype
    s = 1.0 / math.sqrt(d)
    return {
        "ln1": {"g": torch.ones((d,), dtype=dt, device=device)},
        "attn": {
            "wq": _normal(gen, (d, h, hd), dt, device, s),
            "wk": _normal(gen, (d, kv, hd), dt, device, s),
            "wv": _normal(gen, (d, kv, hd), dt, device, s),
            "wo": _normal(gen, (h, hd, d), dt, device, s / math.sqrt(h)),
        },
        "ln2": {"g": torch.ones((d,), dtype=dt, device=device)},
        "mlp": {
            "w_gate": _normal(gen, (d, f), dt, device, s),
            "w_up": _normal(gen, (d, f), dt, device, s),
            "w_down": _normal(gen, (f, d), dt, device, 1.0 / math.sqrt(f)),
        },
    }


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
    """Random dense-LM params drawn from ``gen`` (whose device must match
    ``device``)."""
    params = init_embed(gen, cfg, device)
    params["layers"] = [init_layer(gen, cfg, device) for _ in range(cfg.n_layers)]
    return params


def init_cache(cfg: ModelConfig, batch: int, s_max: int, device,
               dtype: Optional[torch.dtype] = None) -> Params:
    """Dense KV cache for prefill: ``{"length": 0, "attn": {"k", "v"}}``
    with (n_layers, batch, s_max, kv heads, hd) buffers."""
    if cfg.family not in (Family.DENSE, Family.VLM):
        raise NotImplementedError(f"init_cache: family {cfg.family} is not ported")
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
             cache: Optional[Params] = None) -> Tuple[torch.Tensor, Optional[Params]]:
    """The dense family's forward (the reference's ``apply_lm`` over
    ``_dense_block``): embed, pre-norm attention and SwiGLU blocks, final
    norm, head; logits past ``vocab`` (a padded vocabulary) are -1e9.
    Cache tensors are written in place; the returned cache dict carries
    the advanced length."""
    _check_dense(cfg)
    b, s = tokens.shape
    offset, positions, paged = L.forward_cache_ctx(cache, b, s)
    x = params["embed"]["tok"][tokens.long()].to(cfg.tdtype)
    for i, p in enumerate(params["layers"]):
        x = x + L.attention_apply(p["attn"], L.rmsnorm(p["ln1"], x), cfg, i, cache, offset,
                                  positions, paged)
        x = x + L.mlp_apply(p["mlp"], L.rmsnorm(p["ln2"], x))
    x = L.rmsnorm(params["final_norm"], x)
    logits = L.linear(x, params["embed"]["head"].to(cfg.tdtype))
    if cfg.vocab_padded != cfg.vocab:
        pad = torch.arange(cfg.vocab_padded, device=logits.device) >= cfg.vocab
        logits = logits.masked_fill(pad, -1e9)
    return logits, L.advance_cache(cache, offset, s)

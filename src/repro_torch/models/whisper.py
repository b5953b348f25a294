"""Whisper-large-v3 backbone, an encoder-decoder transformer (torch
counterpart of repro/models/whisper.py).

The conv/mel front end is a stub, as in the reference: the encoder takes
precomputed frame embeddings (B, n_frames, d).  The encoder is
bidirectional attention and a GELU MLP over a learned positional table;
the decoder is causal self-attention (cached when serving), then
cross-attention onto the encoder states, then the GELU MLP.  Stacks are
Python lists of per-layer dicts (``models/convert.py`` moves them to and
from the reference's layer-stacked arrays).  The cache holds each decoder
layer's self-attention K/V and its cross-attention K/V, written by the
forward that is given ``frames`` and read by the decode steps after it.
Without a cache and with ``cfg.remat`` each layer runs under
``torch.utils.checkpoint``."""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.models import layers as L
from repro_torch.models.common import ModelConfig

Params = Dict[str, Any]

__all__ = ["init_whisper", "encode", "apply_whisper", "init_whisper_cache",
           "whisper_loss_fn"]


def _ones(cfg: ModelConfig, device) -> Params:
    return {"g": torch.ones((cfg.d_model,), dtype=cfg.tdtype, device=device)}


def init_whisper(gen: torch.Generator, cfg: ModelConfig, device) -> Params:
    """Random whisper params drawn from ``gen`` with the reference's init
    scales, one layer at a time."""
    def enc_layer():
        return {"ln1": _ones(cfg, device), "attn": L.attention_init(gen, cfg, device),
                "ln2": _ones(cfg, device), "mlp": L.mlp_init(gen, cfg, device)}

    def dec_layer():
        return {"ln1": _ones(cfg, device), "self": L.attention_init(gen, cfg, device),
                "ln2": _ones(cfg, device), "cross": L.attention_init(gen, cfg, device),
                "ln3": _ones(cfg, device), "mlp": L.mlp_init(gen, cfg, device)}

    d, dt = cfg.d_model, cfg.tdtype
    encoder = [enc_layer() for _ in range(cfg.n_encoder_layers)]
    decoder = [dec_layer() for _ in range(cfg.n_layers)]
    embed = {
        "tok": torch.randn((cfg.vocab_padded, d), generator=gen, dtype=dt, device=device) * 0.02,
        "head": torch.randn((d, cfg.vocab_padded), generator=gen, dtype=dt, device=device)
        * (1.0 / d ** 0.5),
    }
    enc_pos = torch.randn((cfg.n_audio_frames, d), generator=gen, dtype=dt, device=device) * 0.01
    return {"embed": embed, "enc_pos": enc_pos, "encoder": encoder, "decoder": decoder,
            "enc_norm": _ones(cfg, device), "dec_norm": _ones(cfg, device)}


def _project(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x (B, T, d) through a (d, heads, hd) weight -> (B, T, heads, hd)."""
    d, h, hd = w.shape
    return L.linear(x, w.reshape(d, h * hd)).reshape(*x.shape[:2], h, hd)


def _out(p: Params, o: torch.Tensor) -> torch.Tensor:
    h, hd, d = p["wo"].shape
    return L.linear(o.reshape(*o.shape[:2], h * hd), p["wo"].reshape(h * hd, d))


def _queries(p: Params, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    q = _project(x, p["wq"])
    return L.qk_head_norm(q, p["q_norm"]) if cfg.qk_norm else q


def _bidirectional(p: Params, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """The encoder's self-attention: no mask, no rotary positions."""
    k, v = _project(x, p["wk"]), _project(x, p["wv"])
    if cfg.qk_norm:
        k = L.qk_head_norm(k, p["k_norm"])
    return _out(p, L.flash_attention(_queries(p, x, cfg), k, v, causal=False))


def _cross(p: Params, x: torch.Tensor, cfg: ModelConfig, xk, xv) -> torch.Tensor:
    """Cross-attention of the decoder's x onto the encoder's K/V (no rotary
    positions, no mask)."""
    return _out(p, L.flash_attention(_queries(p, x, cfg), xk, xv, causal=False))


def _cross_kv(p: Params, enc: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """One decoder layer's cross-attention K/V of the encoder states."""
    return _project(enc, p["cross"]["wk"]), _project(enc, p["cross"]["wv"])


def encode(params: Params, cfg: ModelConfig, frames: torch.Tensor) -> torch.Tensor:
    """frames (B, n_frames, d), the stubbed conv output -> encoder states."""
    x = frames.to(cfg.tdtype) + params["enc_pos"][None]

    def layer(p, xc):
        xc = xc + _bidirectional(p["attn"], L.rmsnorm(p["ln1"], xc), cfg)
        return xc + L.mlp_apply(p["mlp"], L.rmsnorm(p["ln2"], xc), cfg)

    for p in params["encoder"]:
        x = L.remat(lambda xc, p=p: layer(p, xc), cfg, False)(x)
    return L.rmsnorm(params["enc_norm"], x)


def init_whisper_cache(cfg: ModelConfig, batch: int, s_max: int, device,
                       dtype: Optional[torch.dtype] = None) -> Params:
    """Per decoder layer: self-attention K/V (n_layers, B, s_max, kv heads,
    hd) and cross-attention K/V (n_layers, B, n_frames, kv heads, hd)."""
    dt = dtype or cfg.tdtype
    kvs = L.kv_store_heads(cfg)
    shape = (cfg.n_layers, batch, s_max, kvs, cfg.hd)
    xshape = (cfg.n_layers, batch, cfg.n_audio_frames, kvs, cfg.hd)
    return {"k": torch.zeros(shape, dtype=dt, device=device),
            "v": torch.zeros(shape, dtype=dt, device=device),
            "xk": torch.zeros(xshape, dtype=dt, device=device),
            "xv": torch.zeros(xshape, dtype=dt, device=device),
            "length": 0}


def apply_whisper(params: Params, cfg: ModelConfig, tokens: torch.Tensor,
                  frames: Optional[torch.Tensor] = None,
                  cache: Optional[Params] = None) -> Tuple[torch.Tensor, Optional[Params]]:
    """The decoder over tokens (B, S).  ``frames`` run the encoder first
    (and, with a cache, write each layer's cross K/V); a cached step
    without frames reads the cross K/V the cache holds.  Cache tensors are
    written in place; the returned cache carries the advanced length."""
    b, s = tokens.shape
    x = params["embed"]["tok"][tokens.long()].to(cfg.tdtype)
    enc = encode(params, cfg, frames) if frames is not None else None
    # the self-attention's cache, in the attention layers' dense form
    self_cache = None if cache is None else {"length": cache["length"],
                                             "attn": {"k": cache["k"], "v": cache["v"]}}
    offset, positions, _ = L.forward_cache_ctx(self_cache, b, s, x.device)

    def layer(i, p, xc):
        xc = xc + L.attention_apply(p["self"], L.rmsnorm(p["ln1"], xc), cfg, i, self_cache,
                                    offset, positions, None)
        if cache is not None and enc is None:
            xk, xv = cache["xk"][i], cache["xv"][i]
        else:
            xk, xv = _cross_kv(p, enc)
            if cache is not None:
                cache["xk"][i].copy_(xk)
                cache["xv"][i].copy_(xv)
        xc = xc + _cross(p["cross"], L.rmsnorm(p["ln2"], xc), cfg, xk, xv)
        return xc + L.mlp_apply(p["mlp"], L.rmsnorm(p["ln3"], xc), cfg)

    for i, p in enumerate(params["decoder"]):
        x = L.remat(lambda xc, i=i, p=p: layer(i, p, xc), cfg, cache is not None)(x)
    x = L.rmsnorm(params["dec_norm"], x)
    logits = L.linear(x, params["embed"]["head"].to(cfg.tdtype))
    if cfg.vocab_padded != cfg.vocab:
        pad = torch.arange(cfg.vocab_padded, device=logits.device) >= cfg.vocab
        logits = logits.masked_fill(pad, -1e9)
    return logits, (None if cache is None else dict(cache, length=offset + s))


def whisper_loss_fn(params: Params, cfg: ModelConfig, tokens: torch.Tensor,
                    frames: torch.Tensor) -> torch.Tensor:
    """Next-token cross-entropy of the decoder over tokens (B, S+1) given
    the frames."""
    logits, _ = apply_whisper(params, cfg, tokens[:, :-1], frames=frames)
    return L.xent(logits, tokens[:, 1:])

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
``torch.utils.checkpoint``.  Every attention runs through
``layers.attention_apply`` (the encoder's bidirectional, the decoder's
causal cached one, and the cross-attention onto given K / V), so the
mesh's tensor and sequence parallelism reach whisper as they reach the
decoder families (``whisper_specs``)."""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.launch import mesh as M
from repro_torch.models import layers as L
from repro_torch.models.common import ModelConfig

Params = Dict[str, Any]

__all__ = ["init_whisper", "whisper_specs", "encode", "apply_whisper", "init_whisper_cache",
           "whisper_cache_specs", "whisper_loss_fn"]


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


def whisper_specs(cfg: ModelConfig, tp: int) -> Params:
    """The reference's ``init_whisper`` specs (PartitionSpecs as tuples) in
    the port's per-layer layout: attention heads over ``model`` where the
    axis divides them (else replicated), the FFN and the vocabulary over
    ``model``, the d_model axis over ``data`` under FSDP."""
    def enc_layer():
        return {"ln1": L.rmsnorm_spec(), "attn": L.attention_specs(cfg, tp),
                "ln2": L.rmsnorm_spec(), "mlp": L.mlp_specs(cfg)}

    def dec_layer():
        return {"ln1": L.rmsnorm_spec(), "self": L.attention_specs(cfg, tp),
                "ln2": L.rmsnorm_spec(), "cross": L.attention_specs(cfg, tp),
                "ln3": L.rmsnorm_spec(), "mlp": L.mlp_specs(cfg)}

    return {"embed": L.embed_specs(cfg), "enc_pos": (None, None),
            "encoder": [enc_layer() for _ in range(cfg.n_encoder_layers)],
            "decoder": [dec_layer() for _ in range(cfg.n_layers)],
            "enc_norm": L.rmsnorm_spec(), "dec_norm": L.rmsnorm_spec()}


def _shard(cfg: ModelConfig, mesh, s: int) -> L.Shard:
    """A stream's context: sequence-sharded over ``model`` where the
    reference's ``_sp_constrain`` shards it (S > 1 and divisible by tp)."""
    if mesh is None:
        return L.Shard()
    tp = mesh.tp
    return L.Shard(mesh, sp=bool(cfg.seq_shard and tp > 1 and s > 1 and s % tp == 0))


def encode(params: Params, cfg: ModelConfig, frames: torch.Tensor, mesh=None
           ) -> torch.Tensor:
    """frames (B, n_frames, d), the stubbed conv output -> encoder states
    (on a mesh, this rank's sequence shard where the frames divide by
    tp)."""
    return _encode(params, cfg, frames, mesh)[0]


def _encode(params: Params, cfg: ModelConfig, frames: torch.Tensor, mesh
            ) -> Tuple[torch.Tensor, L.Shard]:
    """``encode``, and the states' context."""
    shard = _shard(cfg, mesh, frames.shape[1])
    x = frames.to(cfg.tdtype) + params["enc_pos"][None]
    if shard.sp:
        x = M.split(x, shard.mesh, "model", 1)

    def layer(p, xc):
        xc = xc + L.attention_apply(p["attn"], L.rmsnorm(shard.gain(p["ln1"]), xc), cfg, 0,
                                    None, 0, None, None, shard, causal=False, use_rope=False)
        return xc + L.mlp_apply(p["mlp"], L.rmsnorm(shard.gain(p["ln2"]), xc), cfg, shard)

    for p in params["encoder"]:
        x = L.remat(lambda xc, p=p: layer(p, xc), cfg, False)(x)
    return L.rmsnorm(shard.gain(params["enc_norm"]), x), shard


def init_whisper_cache(cfg: ModelConfig, batch: int, s_max: int, device,
                       dtype: Optional[torch.dtype] = None,
                       heads: Optional[int] = None) -> Params:
    """Per decoder layer: self-attention K/V (n_layers, B, s_max, kv heads,
    hd) and cross-attention K/V (n_layers, B, n_frames, kv heads, hd);
    ``heads`` the rank's on a mesh (default every kv head)."""
    dt = dtype or cfg.tdtype
    kvs = heads or L.kv_store_heads(cfg)
    shape = (cfg.n_layers, batch, s_max, kvs, cfg.hd)
    xshape = (cfg.n_layers, batch, cfg.n_audio_frames, kvs, cfg.hd)
    return {"k": torch.zeros(shape, dtype=dt, device=device),
            "v": torch.zeros(shape, dtype=dt, device=device),
            "xk": torch.zeros(xshape, dtype=dt, device=device),
            "xv": torch.zeros(xshape, dtype=dt, device=device),
            "length": 0}


def whisper_cache_specs(cfg: ModelConfig, tp: int, batch_axes) -> Params:
    """The reference's ``whisper_cache_specs`` as tuples."""
    h = "model" if L.attn_tp_enabled(cfg, tp) else None
    sp = (None, batch_axes, None, h, None)
    return {"k": sp, "v": sp, "xk": sp, "xv": sp, "length": ()}


def apply_whisper(params: Params, cfg: ModelConfig, tokens: torch.Tensor,
                  frames: Optional[torch.Tensor] = None,
                  cache: Optional[Params] = None, mesh=None,
                  last_logit_only: bool = False) -> Tuple[torch.Tensor, Optional[Params]]:
    """The decoder over tokens (B, S).  ``frames`` run the encoder first
    (and, with a cache, write each layer's cross K/V); a cached step
    without frames reads the cross K/V the cache holds.  Cache tensors are
    written in place; the returned cache carries the advanced length.

    On a mesh ``params`` is the rank's shard and ``tokens`` / ``frames``
    its rows: heads over ``model`` where the axis divides them (else
    attention replicated), the FFN and the vocabulary over ``model``, the
    decoder's and the encoder's streams each sequence-sharded where their
    length divides by tp; the cross K/V are projected from the whole
    encoder sequence in the rank's heads, and so cached."""
    b, s = tokens.shape
    shard = _shard(cfg, mesh, s)
    x = L.embed_tokens(params["embed"], cfg, tokens, shard)
    if shard.sp:
        x = M.split(x, shard.mesh, "model", 1)
    enc = None
    if frames is not None:
        states, enc_shard = _encode(params, cfg, frames, mesh)
        enc = L.enter_states(states, cfg, enc_shard)
    # the self-attention's cache, in the attention layers' dense form
    self_cache = None if cache is None else {"length": cache["length"],
                                             "attn": {"k": cache["k"], "v": cache["v"]}}
    offset, positions, _ = L.forward_cache_ctx(self_cache, b, s, x.device)

    def layer(i, p, xc):
        xc = xc + L.attention_apply(p["self"], L.rmsnorm(shard.gain(p["ln1"]), xc), cfg, i,
                                    self_cache, offset, positions, None, shard)
        if cache is not None and enc is None:
            xk, xv = cache["xk"][i], cache["xv"][i]
        else:
            xk, xv = L.cross_kv(p["cross"], enc, cfg, shard)
            if cache is not None:
                cache["xk"][i].copy_(xk)
                cache["xv"][i].copy_(xv)
        xc = xc + L.attention_apply(p["cross"], L.rmsnorm(shard.gain(p["ln2"]), xc), cfg, i,
                                    None, 0, positions, None, shard, causal=False,
                                    use_rope=False, kv=(xk, xv))
        return xc + L.mlp_apply(p["mlp"], L.rmsnorm(shard.gain(p["ln3"]), xc), cfg, shard)

    for i, p in enumerate(params["decoder"]):
        x = L.remat(lambda xc, i=i, p=p: layer(i, p, xc), cfg, cache is not None)(x)
    x = L.rmsnorm(shard.gain(params["dec_norm"]), x)
    logits = L.lm_head(params["embed"], cfg, x, shard, last_logit_only)
    return logits, (None if cache is None else dict(cache, length=offset + s))


def whisper_loss_fn(params: Params, cfg: ModelConfig, tokens: torch.Tensor,
                    frames: torch.Tensor, mesh=None) -> torch.Tensor:
    """Next-token cross-entropy of the decoder over tokens (B, S+1) given
    the frames (on a mesh, the mean over the rank's rows)."""
    logits, _ = apply_whisper(params, cfg, tokens[:, :-1], frames=frames, mesh=mesh)
    return L.xent(logits, tokens[:, 1:])

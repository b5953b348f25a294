"""Analytic parameter counts of a configuration (the part of
repro/launch/steps.py that does not build sharded step functions; the
dry-run cells wait for the sharded mesh, ROADMAP Queue 1)."""
from __future__ import annotations

from typing import Dict

from repro_torch.models.common import Family, ModelConfig

__all__ = ["param_counts"]


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

"""A family the benchmark does not have, added as a file: a dense bf16
target that drafts for itself (the draft is the target), so every
proposal is accepted.  Its reference is the float32 dense forward over
the weights remade from the seed."""
from __future__ import annotations

import numpy as np

from benchkit import weights
from benchkit.spec import spec_of
from reference import lm_ref
from roofline import counts


def load(raw):
    return spec_of(raw, raw["name"])


def vocab(spec):
    return spec.vocab


def pair(spec, seed, s_max, device):
    from repro_torch.models.common import Family, ModelConfig
    from repro_torch.serving.engine import ServingModel
    cfg = ModelConfig(name=spec.name, family=Family.DENSE, n_layers=spec.n_layers,
                      d_model=spec.d_model, n_heads=spec.n_heads, n_kv=spec.n_kv, d_ff=spec.d_ff,
                      vocab=spec.vocab, head_dim=spec.head_dim, qk_norm=spec.qk_norm,
                      rope_theta=spec.rope_theta, act=spec.act,
                      dtype=str(spec.dtype).replace("torch.", ""))
    emb = weights.embed(spec, seed, "target", device)
    params = {"embed": {"tok": emb["tok"], "head": emb["head"]}, "final_norm": {"g": emb["final_g"]},
              "layers": [weights.layer(spec, seed, "target", i, device) for i in range(spec.n_layers)]}
    make = lambda: ServingModel(cfg=cfg, params=params, mode="bf16", s_max=s_max, device=device)  # noqa: E731
    return make(), make()


def keep(spec, target, draft):
    return None


def _logits(spec, seed, seqs, rows, device, precision):
    return lm_ref.logits_at(spec, "bf16", None, lambda i: weights.layer(spec, seed, "target", i, device),
                            weights.embed(spec, seed, "target", device), seqs, rows, device, precision)


def target_logits(spec, seed, seqs, starts, device, precision="program"):
    return _logits(spec, seed, seqs, [np.arange(s0 - 1, len(s) - 1) for s, s0 in zip(seqs, starts)],
                   device, precision)


def draft_logits(spec, seed, kept, seq, rows, device, precision="program"):
    return _logits(spec, seed, [seq], [np.asarray(rows)], device, precision)[0]


def draft_readings(spec, seed, kept, device):
    return {}


def role_of_forward(spec, calls):
    return "target" if calls == spec.n_layers else None


def forward_flops(spec, role, rows, keys):
    params = counts.linear_params(spec.n_layers, spec.d_model, spec.n_heads, spec.n_kv,
                                  spec.head_dim, spec.d_ff, spec.act == "swiglu", spec.vocab)
    return counts.model_flops(rows, keys, params, spec.n_layers, spec.n_heads, spec.head_dim)

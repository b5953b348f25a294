"""The ``dense`` family: a dense pre-norm decoder target (GQA, optional
qk-norm, SwiGLU or squared ReLU) served as ``w4a8`` (W4A8 + LRU) or
``bf16``, and a draft that is the target's config cut to ``draft_layers``
with weights of its own, served as ``bvq`` (BVQ codebooks, K3) or
``bf16``.

The configuration file's keys: the Hugging Face names read by
``benchkit.spec.spec_of``, and ``serving``: ``target``, ``draft``,
``draft_layers``, ``bvq`` (the BVQ settings the program compresses the
draft with) and ``lru`` (the rotation plans of a W4A8 target, which the
reference applies itself).

The reference (``reference/lm_ref.py``) remakes every weight from the
seed.  The one thing it takes from the program is a BVQ draft's codebooks
and indices (the program's k-means, which it would otherwise have to
repeat): it decodes them itself, and ``draft_readings`` holds them
against the dense weights remade from the seed: ``draft_lloyd_gain`` is
how far one more k-means (Lloyd) update would still lower the
compression's squared error, as a share of the weight's energy (small
where the k-means ran, large where it was skipped), and
``draft_weight_err`` reports the compression's error.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from benchkit import weights
from benchkit.spec import ModelSpec, spec_of
from reference import lm_ref
from roofline import counts

LINEARS = ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down")


@dataclasses.dataclass(frozen=True)
class Pair:
    target: ModelSpec
    draft: ModelSpec
    target_mode: str  # w4a8 | bf16
    draft_mode: str  # bvq | bf16
    bvq: Dict[str, int]
    lru: Optional[dict]


def load(raw: dict) -> Pair:
    serving = raw["serving"]
    target = spec_of(raw, raw["name"])
    if serving["target"] not in ("w4a8", "bf16") or serving["draft"] not in ("bvq", "bf16"):
        raise ValueError(f"serving modes {serving['target']!r} / {serving['draft']!r}")
    return Pair(target=target, draft=target.cut(int(serving["draft_layers"]), f"{raw['name']}-draft"),
                target_mode=serving["target"], draft_mode=serving["draft"],
                bvq=dict(serving.get("bvq", {})), lru=serving.get("lru"))


def vocab(m: Pair) -> int:
    return m.target.vocab


# -- the program's pair ------------------------------------------------------


def model_config(spec: ModelSpec):
    from repro_torch.models.common import Family, ModelConfig
    return ModelConfig(
        name=spec.name, family=Family.DENSE, n_layers=spec.n_layers, d_model=spec.d_model,
        n_heads=spec.n_heads, n_kv=spec.n_kv, d_ff=spec.d_ff, vocab=spec.vocab,
        head_dim=spec.head_dim, qk_norm=spec.qk_norm, rope_theta=spec.rope_theta,
        act=spec.act, dtype=str(spec.dtype).replace("torch.", ""),
    )


def dense_params(spec: ModelSpec, seed: int, role: str, device) -> dict:
    emb = weights.embed(spec, seed, role, device)
    return {"embed": {"tok": emb["tok"], "head": emb["head"]},
            "final_norm": {"g": emb["final_g"]},
            "layers": [weights.layer(spec, seed, role, i, device)
                       for i in range(spec.n_layers)]}


def pair(m: Pair, seed: int, s_max: int, device):
    """(target ServingModel, draft ServingModel).  The target is made one
    layer at a time; a W4A8 layer is packed by ``quantize_layer`` as it
    comes.  A BVQ draft is compressed by ``bvq_compress_lm`` with the
    configured settings and a generator drawn from the seed."""
    from repro_torch.core import bvq as bvq_mod
    from repro_torch.serving import quantized_lm as qlm
    from repro_torch.serving.engine import ServingModel

    tcfg, dcfg = model_config(m.target), model_config(m.draft)
    if m.target_mode == "w4a8":
        emb = weights.embed(m.target, seed, "target", device)
        tparams = qlm.quantize_embed({"tok": emb["tok"], "head": emb["head"]},
                                     {"g": emb["final_g"]}, tcfg)
        del emb
        tparams["layers"] = [
            qlm.quantize_layer(weights.layer(m.target, seed, "target", i, device), tcfg)
            for i in range(m.target.n_layers)]
    else:
        tparams = dense_params(m.target, seed, "target", device)
    dparams = dense_params(m.draft, seed, "draft", device)
    if m.draft_mode == "bvq":
        dparams = qlm.bvq_compress_lm(dparams, dcfg, bvq_mod.BVQConfig(**m.bvq),
                                      weights.generator(seed, "bvq", 0, device))
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    return (ServingModel(cfg=tcfg, params=tparams, mode=m.target_mode, s_max=s_max, device=device),
            ServingModel(cfg=dcfg, params=dparams, mode=m.draft_mode, s_max=s_max, device=device))


def keep(m: Pair, target, draft) -> Optional[List[dict]]:
    """A BVQ draft's codebooks and indices, per layer and linear."""
    if m.draft_mode != "bvq":
        return None
    return [{k: (lp[k]["cb"].clone(), lp[k]["idx"].clone()) for k in LINEARS if k in lp}
            for lp in draft.params["layers"]]


# -- the reference -----------------------------------------------------------


def target_logits(m: Pair, seed: int, seqs: Sequence[np.ndarray], starts: Sequence[int], device,
                  precision: str = "program") -> List[torch.Tensor]:
    rows = [np.arange(s0 - 1, len(s) - 1) for s, s0 in zip(seqs, starts)]
    return lm_ref.logits_at(m.target, m.target_mode, m.lru,
                            lambda i: weights.layer(m.target, seed, "target", i, device),
                            weights.embed(m.target, seed, "target", device), seqs, rows, device,
                            precision)


def _decoded_layer(m: Pair, seed: int, kept, i: int, device) -> dict:
    """Draft layer ``i`` in the dense layout: the seed's norm gains, and
    for a BVQ draft its linears decoded from the kept codebooks."""
    lp = weights.layer(m.draft, seed, "draft", i, device)
    if kept is None:
        return lp
    s = m.draft
    shapes = {"wq": (s.d_model, s.n_heads, s.head_dim), "wk": (s.d_model, s.n_kv, s.head_dim),
              "wv": (s.d_model, s.n_kv, s.head_dim), "wo": (s.n_heads, s.head_dim, s.d_model)}
    for k, (cb, idx) in kept[i].items():
        w = lm_ref.bvq_decode(cb, idx)
        group = "attn" if k in shapes else "mlp"
        lp[group][k] = w.reshape(shapes[k]) if k in shapes else w
    return lp


def draft_logits(m: Pair, seed: int, kept, seq: np.ndarray, rows: Sequence[int], device,
                 precision: str = "program") -> torch.Tensor:
    """The draft's float32 logits at ``rows`` of one sequence (a BVQ
    draft's numerics are its decoded weights, served in bf16: the
    control takes them to float8 like a bf16 draft's)."""
    return lm_ref.logits_at(m.draft, "bf16", None,
                            lambda i: _decoded_layer(m, seed, kept, i, device),
                            weights.embed(m.draft, seed, "draft", device), [seq],
                            [np.asarray(rows)], device, precision)[0]


def lloyd_gain(cb: torch.Tensor, idx: torch.Tensor, w: torch.Tensor) -> float:
    """||decode(cb) - decode(means)||^2 / ||w||^2: the drop in squared
    error that moving every codeword to the mean of the (K, N) weight's
    v-vectors it stands for would bring (an unused codeword stays)."""
    nb, c, v = cb.shape
    _, rows, bc = idx.shape
    w = w.float()
    vec = w.reshape(rows, v, nb, bc).permute(2, 0, 3, 1).reshape(nb, rows * bc, v)
    a = idx.reshape(nb, rows * bc).long()
    sums = torch.zeros((nb, c, v), device=w.device).scatter_add_(1, a[..., None].expand(-1, -1, v),
                                                                   vec)
    n = torch.zeros((nb, c), device=w.device).scatter_add_(1, a, torch.ones_like(a, dtype=torch.float32))
    means = torch.where(n[..., None] > 0, sums / n.clamp(min=1.0)[..., None], cb.float())
    gap = lm_ref.bvq_decode(cb, idx) - lm_ref.bvq_decode(means, idx)
    return float(gap.square().sum() / w.square().sum())


def draft_readings(m: Pair, seed: int, kept, device) -> Dict[str, float]:
    """A BVQ draft's ``draft_lloyd_gain`` and ``draft_weight_err`` (the
    largest over its linears; the error is the decoded weight's relative
    Frobenius distance from the dense one)."""
    if kept is None:
        return {}
    gain = err = 0.0
    for i in range(m.draft.n_layers):
        lp = weights.layer(m.draft, seed, "draft", i, device)
        dense = {**lp["attn"], **lp["mlp"]}
        for k, (cb, idx) in kept[i].items():
            w = lm_ref.bvq_decode(cb, idx)
            ref = dense[k].reshape(w.shape).float()
            err = max(err, float((w - ref).norm() / ref.norm()))
            gain = max(gain, lloyd_gain(cb, idx, ref))
    return {"draft_lloyd_gain": gain, "draft_weight_err": err}


# -- counts --------------------------------------------------------------------


def role_of_forward(m: Pair, calls: int) -> Optional[str]:
    for role, spec in (("target", m.target), ("draft", m.draft)):
        if spec.n_layers == calls:
            return role
    return None


def forward_flops(m: Pair, role: str, rows: int, keys: int) -> float:
    s = m.target if role == "target" else m.draft
    params = counts.linear_params(s.n_layers, s.d_model, s.n_heads, s.n_kv, s.head_dim, s.d_ff,
                                  s.act == "swiglu", s.vocab)
    return counts.model_flops(rows, keys, params, s.n_layers, s.n_heads, s.head_dim)

"""Builders for the paper's serving pair, and the target-only greedy
reference decode (torch counterpart of repro/launch/serve.py).

``build_pair`` builds the smoke-scale pair (TLM_SMOKE quantized to W4A8
with the LRU rotation, DLM_SMOKE compressed with BVQ); ``build_paper_pair``
builds it at the paper's widths (LLaMA2-7B target, LLaMA-68M draft),
initialising and quantizing the target one layer at a time so its
full-precision weights are never resident together.  Weights are random,
drawn from a ``torch.Generator`` seeded by ``seed`` on ``device``.
"""
from __future__ import annotations

import dataclasses
from typing import List, Tuple

import torch

from repro_torch.configs.paper_pair import DLM, DLM_SMOKE, TLM, TLM_SMOKE
from repro_torch.core import bvq as bvq_mod
from repro_torch.models import lm
from repro_torch.serving import quantized_lm as qlm
from repro_torch.serving.engine import ServingModel, make_interface

__all__ = ["PAIR_BVQ", "build_pair", "build_paper_pair", "greedy_reference", "to_device"]

# the draft's compression settings (as in the reference's build_pair)
PAIR_BVQ = bvq_mod.BVQConfig(
    vec_dim=4, codebook_size=64, block_cols=32, kmeans_iters=8, qat_steps=0
)
_BVQ_SEED = 7


def _generator(device, seed: int) -> torch.Generator:
    return torch.Generator(device=torch.device(device)).manual_seed(seed)


def build_pair(seed: int = 0, s_max: int = 256, quantize: bool = True,
               device="cuda") -> Tuple[ServingModel, ServingModel]:
    """(target ServingModel, draft ServingModel) at smoke scale."""
    if not quantize:
        raise NotImplementedError("the port serves the quantized pair (w4a8 target, bvq draft)")
    gen = _generator(device, seed)
    tparams = lm.init_lm(gen, TLM_SMOKE, device)
    dparams = lm.init_lm(gen, DLM_SMOKE, device)
    tq = qlm.quantize_dense_lm(tparams, TLM_SMOKE)
    dq = qlm.bvq_compress_lm(dparams, DLM_SMOKE, PAIR_BVQ, _generator(device, _BVQ_SEED))
    return (
        ServingModel(cfg=TLM_SMOKE, params=tq, mode="w4a8", s_max=s_max, device=device),
        ServingModel(cfg=DLM_SMOKE, params=dq, mode="bvq", s_max=s_max, device=device),
    )


def build_paper_pair(seed: int = 0, s_max: int = 256,
                     device="cuda") -> Tuple[ServingModel, ServingModel]:
    """The pair at the paper's widths and depths (all 32 target layers)."""
    tcfg = TLM
    gen = _generator(device, seed)
    emb = lm.init_embed(gen, tcfg, device)
    tq = qlm.quantize_embed(emb["embed"], emb["final_norm"], tcfg)
    del emb
    tq["layers"] = [qlm.quantize_layer(lm.init_layer(gen, tcfg, device), tcfg)
                    for _ in range(tcfg.n_layers)]
    dparams = lm.init_lm(gen, DLM, device)
    dq = qlm.bvq_compress_lm(dparams, DLM, PAIR_BVQ, _generator(device, _BVQ_SEED))
    return (
        ServingModel(cfg=tcfg, params=tq, mode="w4a8", s_max=s_max, device=device),
        ServingModel(cfg=DLM, params=dq, mode="bvq", s_max=s_max, device=device),
    )


def _to(tree, device):
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to(v, device) for v in tree]
    return tree.to(device)


def to_device(model: ServingModel, device) -> ServingModel:
    """A copy of ``model`` with its params on ``device``."""
    return dataclasses.replace(model, params=_to(model.params, device), device=device)


def greedy_reference(target: ServingModel, prompt, n: int) -> List[int]:
    """Plain autoregressive greedy decode of the target over a dense cache:
    what a lossless greedy speculative decode must reproduce."""
    iface = make_interface(target)
    tokens = torch.as_tensor(prompt, dtype=torch.int32, device=target.device).reshape(1, -1)
    _, cache = iface.prefill(target.params, tokens[:, :-1])
    cur = tokens[:, -1:]
    out = []
    for _ in range(n):
        lg, cache = iface.extend(target.params, cur, cache)
        cur = torch.argmax(lg[:, -1], dim=-1).to(torch.int32).reshape(1, 1)
        out.append(int(cur))
    return out

"""Builders for the paper's serving pair, the target-only greedy
reference decode, and the serving driver (torch counterpart of
repro/launch/serve.py)::

    python -m repro_torch.launch.serve --mode apsd --check [--device cpu]

``build_pair`` builds the smoke-scale pair (TLM_SMOKE quantized to W4A8
with the LRU rotation, DLM_SMOKE compressed with BVQ); ``build_paper_pair``
builds it at the paper's widths (LLaMA2-7B target, LLaMA-68M draft),
initialising and quantizing the target one layer at a time so its
full-precision weights are never resident together.  With
``quantize=False`` both build the dense pair instead: the same random
weights, served in the model dtype by ``lm.apply_lm`` (``mode="bf16"``).
Weights are random, drawn from a ``torch.Generator`` seeded by ``seed`` on
``device``.
"""
from __future__ import annotations

import argparse
import dataclasses
import time
from typing import List, Tuple

import torch

from repro_torch.configs.paper_pair import DLM, DLM_SMOKE, TLM, TLM_SMOKE
from repro_torch.core import bvq as bvq_mod
from repro_torch.core import prng
from repro_torch.core.apsd import APSDConfig
from repro_torch.core.speculative import SDConfig
from repro_torch.models import lm
from repro_torch.serving import quantized_lm as qlm
from repro_torch.serving.engine import ServingModel, make_interface, serve_apsd, serve_sd

__all__ = ["PAIR_BVQ", "build_pair", "build_paper_pair", "greedy_reference", "main",
           "to_device"]

# the draft's compression settings (as in the reference's build_pair)
PAIR_BVQ = bvq_mod.BVQConfig(
    vec_dim=4, codebook_size=64, block_cols=32, kmeans_iters=8, qat_steps=0
)
_BVQ_SEED = 7


def _generator(device, seed: int) -> torch.Generator:
    return torch.Generator(device=torch.device(device)).manual_seed(seed)


def _serving_pair(tcfg, tparams, dcfg, dparams, quantize: bool, s_max: int,
                  device) -> Tuple[ServingModel, ServingModel]:
    """The ServingModels over a target (already W4A8 when ``quantize``) and
    a dense draft, compressed here with BVQ when ``quantize``."""
    if quantize:
        dparams = qlm.bvq_compress_lm(dparams, dcfg, PAIR_BVQ, _generator(device, _BVQ_SEED))
    t_mode, d_mode = ("w4a8", "bvq") if quantize else ("bf16", "bf16")
    return (
        ServingModel(cfg=tcfg, params=tparams, mode=t_mode, s_max=s_max, device=device),
        ServingModel(cfg=dcfg, params=dparams, mode=d_mode, s_max=s_max, device=device),
    )


def build_pair(seed: int = 0, s_max: int = 256, quantize: bool = True,
               device="cuda") -> Tuple[ServingModel, ServingModel]:
    """(target ServingModel, draft ServingModel) at smoke scale: the W4A8
    target and BVQ draft, or with ``quantize=False`` the dense pair."""
    gen = _generator(device, seed)
    tparams = lm.init_lm(gen, TLM_SMOKE, device)
    dparams = lm.init_lm(gen, DLM_SMOKE, device)
    if quantize:
        tparams = qlm.quantize_dense_lm(tparams, TLM_SMOKE)
    return _serving_pair(TLM_SMOKE, tparams, DLM_SMOKE, dparams, quantize, s_max, device)


def build_paper_pair(seed: int = 0, s_max: int = 256, quantize: bool = True,
                     device="cuda") -> Tuple[ServingModel, ServingModel]:
    """The pair at the paper's widths and depths (all 32 target layers),
    the target made one layer at a time on ``device``: quantized as it is
    made, or kept in bf16 with ``quantize=False`` (6.7 B parameters,
    ~13.5 GB)."""
    tcfg = TLM
    gen = _generator(device, seed)
    emb = lm.init_embed(gen, tcfg, device)
    if quantize:
        tparams = qlm.quantize_embed(emb["embed"], emb["final_norm"], tcfg)
        del emb
        tparams["layers"] = [qlm.quantize_layer(lm.init_layer(gen, tcfg, device), tcfg)
                             for _ in range(tcfg.n_layers)]
    else:
        tparams = dict(emb, layers=[lm.init_layer(gen, tcfg, device)
                                    for _ in range(tcfg.n_layers)])
    dparams = lm.init_lm(gen, DLM, device)
    return _serving_pair(tcfg, tparams, DLM, dparams, quantize, s_max, device)


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


def main(argv=None) -> int:
    """Decode one prompt with the smoke pair: ``ad`` (the target alone),
    ``sd`` (fixed draft length) or ``apsd`` (adaptive); ``--check`` asserts
    that the speculative output equals the target's own greedy decode."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--mode", choices=["sd", "apsd", "ad"], default="apsd")
    ap.add_argument("--tokens", type=int, default=48)
    ap.add_argument("--draft-len", type=int, default=4)
    ap.add_argument("--no-quant", action="store_true")
    ap.add_argument("--check", action="store_true", help="assert losslessness")
    ap.add_argument("--device", default="cuda", help="torch device (cuda, or cpu)")
    args = ap.parse_args(argv)

    target, draft = build_pair(quantize=not args.no_quant, device=args.device)
    prompt = torch.tensor([[5, 17, 3, 99]], dtype=torch.int32)
    key = prng.PRNGKey(0)

    t0 = time.time()
    if args.mode == "ad":
        toks = greedy_reference(target, prompt, args.tokens)
        stats = None
    elif args.mode == "sd":
        toks, stats = serve_sd(
            key, target, draft, prompt,
            SDConfig(draft_len=args.draft_len, temperature=0.0, max_tokens=args.tokens),
        )
    else:
        toks, stats = serve_apsd(
            key, target, draft, prompt,
            APSDConfig(short_dl=2, long_dl=6, temperature=0.0, max_tokens=args.tokens),
        )
    toks = [int(t) for t in toks]
    dt = time.time() - t0
    print(f"mode={args.mode} tokens={len(toks)} wall={dt:.2f}s")
    print("output:", toks)
    if stats is not None:
        if hasattr(stats, "acceptance_rate"):
            print(f"acceptance={float(stats.acceptance_rate):.3f}")
        else:
            print(f"rejected_ratio={stats.rejected_ratio:.3f} "
                  f"par_rounds={stats.par_rounds}/{stats.rounds}")
    if args.check and args.mode in ("sd", "apsd"):
        ref = greedy_reference(target, prompt, args.tokens)
        assert ref == toks, "speculative output != AD reference"
        print("LOSSLESS: speculative output == autoregressive reference")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

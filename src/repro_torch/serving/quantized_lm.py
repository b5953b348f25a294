"""W4A8 target-LM and BVQ draft-LM serving forwards (torch counterpart of
repro/serving/quantized_lm.py; see there for the paper mapping).

W4A8 + LRU (the target): RMSNorm scales fold into the next projections,
the residual stream is rotated offline by R1 = plan_rotation(d_model), the
d_ff activation is rotated online by R2 = plan_rotation(d_ff) before
w_down (``ops.lru_rotate``, the block-rotation kernel), and every linear,
the head included, is an int4-weight / dynamic int8-activation GEMM
(``ops.w4a8_linear``, the W4A8 kernel).

BVQ (the draft): every linear but the head is decoded from per-block
codebooks on the fly (``ops.bvq_linear``, the BVQ kernel).

Both forwards take a paged pool (the engine's steps), a dense cache
(prefill) or no cache, and loop over a list of per-layer parameter dicts.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.core import bvq as bvq_mod
from repro_torch.core import quantization as q
from repro_torch.core import rotation as rot
from repro_torch.kernels import ops
from repro_torch.kernels.w4a8_matmul import prepack
from repro_torch.models import layers as L
from repro_torch.models.common import Family, ModelConfig

Params = Dict[str, Any]

__all__ = [
    "quantize_dense_lm",
    "quantize_layer",
    "quantize_embed",
    "apply_quantized_lm",
    "bvq_compress_lm",
    "bvq_compress_layer",
    "apply_bvq_lm",
    "params_from_numpy",
]


# ---------------------------------------------------------------------------
# Offline transformation (rotation folding + quantization)
# ---------------------------------------------------------------------------


def _fold_norm_into(w: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """Absorb an RMSNorm scale into the input side of a linear weight."""
    return w * g.reshape((-1,) + (1,) * (w.dim() - 1)).to(w.dtype)


def _rot_in(w: torch.Tensor, plan) -> torch.Tensor:
    """W <- R^T W along the input (first) axis, any trailing shape."""
    shape = w.shape
    w2 = rot.rotate_weight_in(w.reshape(shape[0], -1).float(), plan)
    return w2.reshape(shape)


def _rot_out(w: torch.Tensor, plan) -> torch.Tensor:
    """W <- W R along the output (last) axis."""
    shape = w.shape
    w2 = rot.local_rotate(w.reshape(-1, shape[-1]).float(), plan)
    return w2.reshape(shape)


def _quant_pack(w: torch.Tensor) -> Params:
    """(K, N) -> int4 packed along K, in the W4A8 kernel's fragment order
    (``w4a8_matmul.prepack``), + per-output-channel scales."""
    wq, sw = q.quantize_weight_int(w.float(), bits=4, axis=0)
    return {"packed": prepack(q.pack_int4(wq, axis=0)), "sw": sw.reshape(1, -1)}


def _check_dense(cfg: ModelConfig) -> None:
    if cfg.family not in (Family.DENSE, Family.VLM) or cfg.qk_norm or cfg.act != "swiglu":
        raise NotImplementedError(f"quantized serving path: dense SwiGLU only, not {cfg.name}")


def quantize_layer(lp: Params, cfg: ModelConfig) -> Params:
    """One block into the W4A8 serving form: fold the norms, rotate by R1
    (residual) and R2 (w_down input), quantize and pack every linear."""
    _check_dense(cfg)
    r1 = rot.plan_rotation(cfg.d_model)
    r2 = rot.plan_rotation(cfg.d_ff)
    d, h, kv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv, cfg.hd
    wq_ = _fold_norm_into(lp["attn"]["wq"], lp["ln1"]["g"]).reshape(d, h * hd)
    wk_ = _fold_norm_into(lp["attn"]["wk"], lp["ln1"]["g"]).reshape(d, kv * hd)
    wv_ = _fold_norm_into(lp["attn"]["wv"], lp["ln1"]["g"]).reshape(d, kv * hd)
    wo_ = lp["attn"]["wo"].reshape(h * hd, d)
    wg_ = _fold_norm_into(lp["mlp"]["w_gate"], lp["ln2"]["g"])
    wu_ = _fold_norm_into(lp["mlp"]["w_up"], lp["ln2"]["g"])
    wd_ = _rot_in(_rot_out(lp["mlp"]["w_down"], r1), r2)
    return {
        "wq": _quant_pack(_rot_in(wq_, r1)),
        "wk": _quant_pack(_rot_in(wk_, r1)),
        "wv": _quant_pack(_rot_in(wv_, r1)),
        "wo": _quant_pack(_rot_out(wo_, r1)),
        "w_gate": _quant_pack(_rot_in(wg_, r1)),
        "w_up": _quant_pack(_rot_in(wu_, r1)),
        "w_down": _quant_pack(wd_),
    }


def quantize_embed(embed: Params, final_norm: Params, cfg: ModelConfig) -> Params:
    """Embedding rotated by R1 (output side) and the head with the final
    norm folded in, rotated by R1 (input side) and quantized."""
    r1 = rot.plan_rotation(cfg.d_model)
    tok = rot.local_rotate(embed["tok"].float(), r1)
    head = _fold_norm_into(embed["head"], final_norm["g"]).float()
    return {"embed": tok.to(cfg.tdtype), "head": _quant_pack(_rot_in(head, r1))}


def quantize_dense_lm(params: Params, cfg: ModelConfig) -> Params:
    """Dense-LM params -> the W4A8 + LRU serving form (bits=4, rotate=True,
    the reference's defaults)."""
    out = quantize_embed(params["embed"], params["final_norm"], cfg)
    out["layers"] = [quantize_layer(lp, cfg) for lp in params["layers"]]
    return out


def bvq_compress_layer(lp: Params, cfg: ModelConfig, bcfg: bvq_mod.BVQConfig,
                       gen: torch.Generator) -> Params:
    """Compress one block's seven linears; codebooks are dequantized here,
    once, instead of inside every matmul."""
    d, h, kv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv, cfg.hd

    def one(w):
        bw = bvq_mod.bvq_compress(w.float(), bcfg, gen)
        return {"cb": bvq_mod.dequant_codebooks(bw), "idx": bw.indices}

    return {
        "ln1": lp["ln1"],
        "ln2": lp["ln2"],
        "wq": one(lp["attn"]["wq"].reshape(d, h * hd)),
        "wk": one(lp["attn"]["wk"].reshape(d, kv * hd)),
        "wv": one(lp["attn"]["wv"].reshape(d, kv * hd)),
        "wo": one(lp["attn"]["wo"].reshape(h * hd, d)),
        "w_gate": one(lp["mlp"]["w_gate"]),
        "w_up": one(lp["mlp"]["w_up"]),
        "w_down": one(lp["mlp"]["w_down"]),
    }


def bvq_compress_lm(params: Params, cfg: ModelConfig, bcfg: bvq_mod.BVQConfig,
                    gen: torch.Generator) -> Params:
    """Compress every linear of a dense LM into BVQ codebooks + indices."""
    _check_dense(cfg)
    return {
        "embed": params["embed"]["tok"],
        "head": params["embed"]["head"],
        "final_norm": params["final_norm"],
        "layers": [bvq_compress_layer(lp, cfg, bcfg, gen) for lp in params["layers"]],
    }


# ---------------------------------------------------------------------------
# Forwards
# ---------------------------------------------------------------------------


def _norm_only(x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    xf = x.float()
    return (xf * torch.rsqrt(L.row_mean_sq(xf) + eps)).to(x.dtype)


def _qlinear(x: torch.Tensor, qw: Params) -> torch.Tensor:
    return ops.w4a8_linear(x, qw["packed"], qw["sw"])


def _bvq(x: torch.Tensor, bw: Params) -> torch.Tensor:
    return ops.bvq_linear(x, bw["cb"], bw["idx"])


def apply_quantized_lm(
    qparams: Params,
    cfg: ModelConfig,
    tokens: torch.Tensor,
    cache: Optional[Params] = None,
) -> Tuple[torch.Tensor, Optional[Params]]:
    """W4A8 serving forward (dense family), logits in the model dtype.
    Cache tensors are written in place; the returned cache dict carries the
    advanced length."""
    b, s = tokens.shape
    h, kv, hd = cfg.n_heads, cfg.n_kv, cfg.hd
    r2 = rot.plan_rotation(cfg.d_ff)
    offset, positions, paged = L.forward_cache_ctx(cache, b, s)
    x = qparams["embed"][tokens.long()].to(cfg.tdtype)
    for i, p in enumerate(qparams["layers"]):
        z = _norm_only(x)
        q_ = _qlinear(z, p["wq"]).reshape(b, s, h, hd)
        k_ = _qlinear(z, p["wk"]).reshape(b, s, kv, hd)
        v_ = _qlinear(z, p["wv"]).reshape(b, s, kv, hd)
        q_ = L.rope(q_, positions, cfg.rope_theta)
        k_ = L.rope(k_, positions, cfg.rope_theta)
        att = L.attend(i, q_, k_, v_, cache, offset, paged).reshape(b, s, h * hd)
        x = x + _qlinear(att, p["wo"])
        z2 = _norm_only(x)
        g_ = _qlinear(z2, p["w_gate"])
        u_ = _qlinear(z2, p["w_up"])
        hid = ops.lru_rotate(L.silu_mul(g_, u_, x.dtype), r2)  # the LRU's online stage
        x = x + _qlinear(hid, p["w_down"])
    return _qlinear(_norm_only(x), qparams["head"]), L.advance_cache(cache, offset, s)


def apply_bvq_lm(
    qparams: Params,
    cfg: ModelConfig,
    tokens: torch.Tensor,
    cache: Optional[Params] = None,
) -> Tuple[torch.Tensor, Optional[Params]]:
    """BVQ draft forward: weights decoded from codebooks on the fly."""
    b, s = tokens.shape
    h, kv, hd = cfg.n_heads, cfg.n_kv, cfg.hd
    offset, positions, paged = L.forward_cache_ctx(cache, b, s)
    x = qparams["embed"][tokens.long()].to(cfg.tdtype)
    for i, p in enumerate(qparams["layers"]):
        z = L.rmsnorm(p["ln1"], x)
        q_ = _bvq(z, p["wq"]).reshape(b, s, h, hd).to(x.dtype)
        k_ = _bvq(z, p["wk"]).reshape(b, s, kv, hd).to(x.dtype)
        v_ = _bvq(z, p["wv"]).reshape(b, s, kv, hd).to(x.dtype)
        q_ = L.rope(q_, positions, cfg.rope_theta)
        k_ = L.rope(k_, positions, cfg.rope_theta)
        att = L.attend(i, q_, k_, v_, cache, offset, paged).reshape(b, s, h * hd)
        x = x + _bvq(att, p["wo"]).to(x.dtype)
        z2 = L.rmsnorm(p["ln2"], x)
        g_ = _bvq(z2, p["w_gate"])
        u_ = _bvq(z2, p["w_up"]).to(x.dtype)
        x = x + _bvq(L.silu_mul(g_, u_, x.dtype), p["w_down"]).to(x.dtype)
    x = L.rmsnorm(qparams["final_norm"], x)
    return x @ qparams["head"].to(x.dtype), L.advance_cache(cache, offset, s)


# ---------------------------------------------------------------------------
# Weights carried across from the reference
# ---------------------------------------------------------------------------


def _tensor(a, device, dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    arr = np.asarray(a)
    if arr.dtype.kind not in "biuf":  # e.g. bfloat16 from ml_dtypes
        arr = arr.astype(np.float32)
    t = torch.from_numpy(np.array(arr)).to(device)
    return t.to(dtype) if dtype is not None else t


def _layer(tree, i: int):
    """Slice layer i out of a layer-stacked nested dict of arrays."""
    if isinstance(tree, dict):
        return {k: _layer(v, i) for k, v in tree.items()}
    return np.asarray(tree)[i]


def params_from_numpy(tree: Params, cfg: ModelConfig, mode: str, device) -> Params:
    """The reference's parameter tree, as nested dicts of numpy arrays,
    -> the port's params on ``device``.

    ``mode`` names the tree: "bf16" (``lm.init_lm``), "w4a8"
    (``quantize_dense_lm``; the packed weights are reordered for the W4A8
    kernel, ``w4a8_matmul.prepack``) or "bvq" (``bvq_compress_lm``, each BVQWeight
    given as its fields ``codebooks``, ``scales``, ``indices``, ``shape``,
    ``vec_dim``).  Layer-stacked arrays (leading axis n_layers) are split
    into the port's per-layer list; float weights take the model dtype."""
    dt = cfg.tdtype
    n = cfg.n_layers

    def fp(a):
        return _tensor(a, device, dt)

    if mode == "bf16":
        layers = tree["layers"]
        return {
            "embed": {"tok": fp(tree["embed"]["tok"]), "head": fp(tree["embed"]["head"])},
            "final_norm": {"g": fp(tree["final_norm"]["g"])},
            "layers": [
                {
                    grp: {name: fp(arr) for name, arr in _layer(layers[grp], i).items()}
                    for grp in ("ln1", "attn", "ln2", "mlp")
                }
                for i in range(n)
            ],
        }

    if mode == "w4a8":
        def qw(d):
            return {"packed": prepack(_tensor(d["packed"], device, torch.int8)),
                    "sw": _tensor(d["sw"], device, torch.float32)}

        names = ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down")
        return {
            "embed": fp(tree["embed"]),
            "head": qw(tree["head"]),
            "layers": [
                {name: qw(_layer(tree["layers"][name], i)) for name in names}
                for i in range(n)
            ],
        }

    if mode == "bvq":
        def bw(d, i):
            cb = np.asarray(d["codebooks"])[i]
            sc = np.asarray(d["scales"])[i]
            bwt = bvq_mod.BVQWeight(
                codebooks=_tensor(cb, device, torch.int8),
                scales=_tensor(sc, device, torch.float32),
                indices=_tensor(np.asarray(d["indices"])[i], device, torch.int32),
                shape=tuple(d["shape"]),
                vec_dim=int(d["vec_dim"]),
            )
            return {"cb": bvq_mod.dequant_codebooks(bwt), "idx": bwt.indices}

        names = ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down")
        layers = tree["layers"]
        return {
            "embed": fp(tree["embed"]),
            "head": fp(tree["head"]),
            "final_norm": {"g": fp(tree["final_norm"]["g"])},
            "layers": [
                {
                    "ln1": {"g": fp(np.asarray(layers["ln1"]["g"])[i])},
                    "ln2": {"g": fp(np.asarray(layers["ln2"]["g"])[i])},
                    **{name: bw(layers[name], i) for name in names},
                }
                for i in range(n)
            ],
        }
    raise ValueError(f"params_from_numpy: unknown mode {mode!r}")

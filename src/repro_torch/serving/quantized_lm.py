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

Both serve the dense family's SwiGLU blocks, GQA and Qwen3's qk-norm (the
norm weights ride along as ``qk_extra``); like the reference, which reads
``w_gate`` unconditionally, they take no two-matrix MLP (raised here as
``NotImplementedError``).  Both take a paged pool (the engine's steps), a
dense cache (prefill) or no cache, and loop over a list of per-layer
parameter dicts.

W4A8 MoE (the reference's single-device branch): attention and the head
through the W4A8 kernel, every expert packed int4 and dequantized per
layer for the dense combine (``layers.moe_apply_dense``), the router kept
f32; a dense cache or none, as in the reference.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.core import bvq as bvq_mod
from repro_torch.core import quantization as q
from repro_torch.core import rotation as rot
from repro_torch.kernels import ops
from repro_torch.kernels.w4a8_matmul import prepack
from repro_torch.models import convert
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
    "quantize_moe_lm",
    "quantize_moe_layer",
    "apply_quantized_moe_lm",
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
    if cfg.family not in (Family.DENSE, Family.VLM):
        raise NotImplementedError(f"the W4A8 and BVQ forwards serve the dense family, not "
                                  f"{cfg.name} ({cfg.family.value})")
    if cfg.act != "swiglu":
        raise NotImplementedError(f"the W4A8 and BVQ forwards serve SwiGLU blocks, not "
                                  f"{cfg.name}'s {cfg.act} MLP")


def _qk_extra(attn: Params) -> Params:
    """Qwen3's per-head norm weights, carried beside the packed linears."""
    return {k: attn[k] for k in ("q_norm", "k_norm") if k in attn}


def _qk_norm(q_: torch.Tensor, k_: torch.Tensor, p: Params, cfg: ModelConfig):
    if cfg.qk_norm:
        extra = p["qk_extra"]
        return L.qk_head_norm(q_, extra["q_norm"]), L.qk_head_norm(k_, extra["k_norm"])
    return q_, k_


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
        "qk_extra": _qk_extra(lp["attn"]),
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
    _check_dense(cfg)
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
        "qk_extra": _qk_extra(lp["attn"]),
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


def _w4a8_attention(p: Params, z: torch.Tensor, cfg: ModelConfig, i: int, cache, offset,
                    positions, paged) -> torch.Tensor:
    """Layer i's W4A8 attention block on its normed input ``z``: q/k/v
    through the W4A8 kernel, qk-norm where the config asks for it, rope,
    attention over the cache, and the output projection ``wo``."""
    b, s, _ = z.shape
    h, kv, hd = cfg.n_heads, cfg.n_kv, cfg.hd
    q_ = _qlinear(z, p["wq"]).reshape(b, s, h, hd)
    k_ = _qlinear(z, p["wk"]).reshape(b, s, kv, hd)
    v_ = _qlinear(z, p["wv"]).reshape(b, s, kv, hd)
    q_, k_ = _qk_norm(q_, k_, p, cfg)
    q_ = L.rope(q_, positions, cfg.rope_theta)
    k_ = L.rope(k_, positions, cfg.rope_theta)
    att = L.attend(i, q_, k_, v_, cache, offset, paged).reshape(b, s, h * hd)
    return _qlinear(att, p["wo"])


def apply_quantized_lm(
    qparams: Params,
    cfg: ModelConfig,
    tokens: torch.Tensor,
    cache: Optional[Params] = None,
) -> Tuple[torch.Tensor, Optional[Params]]:
    """W4A8 serving forward (dense family), logits in the model dtype.
    Cache tensors are written in place; the returned cache dict carries the
    advanced length."""
    _check_dense(cfg)
    b, s = tokens.shape
    r2 = rot.plan_rotation(cfg.d_ff)
    offset, positions, paged = L.forward_cache_ctx(cache, b, s, tokens.device)
    x = qparams["embed"][tokens.long()].to(cfg.tdtype)
    for i, p in enumerate(qparams["layers"]):
        x = x + _w4a8_attention(p, _norm_only(x), cfg, i, cache, offset, positions, paged)
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
    _check_dense(cfg)
    b, s = tokens.shape
    h, kv, hd = cfg.n_heads, cfg.n_kv, cfg.hd
    offset, positions, paged = L.forward_cache_ctx(cache, b, s, tokens.device)
    x = qparams["embed"][tokens.long()].to(cfg.tdtype)
    for i, p in enumerate(qparams["layers"]):
        z = L.rmsnorm(p["ln1"], x)
        q_ = _bvq(z, p["wq"]).reshape(b, s, h, hd).to(x.dtype)
        k_ = _bvq(z, p["wk"]).reshape(b, s, kv, hd).to(x.dtype)
        v_ = _bvq(z, p["wv"]).reshape(b, s, kv, hd).to(x.dtype)
        q_, k_ = _qk_norm(q_, k_, p, cfg)
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
# W4A8 MoE (the reference's single-device branch)
# ---------------------------------------------------------------------------


def _quant_pack_experts(w: torch.Tensor) -> Params:
    """(E, K, F) -> int4 packed along K, (E, K/2, F), in the reference's
    layout (no kernel reads it: the forward dequantizes), + per-(expert,
    output) scales (E, 1, F)."""
    wq, sw = q.quantize_weight_int(w.float(), bits=4, axis=1)
    return {"packed": q.pack_int4(wq, axis=1), "sw": sw}


def _dequant_experts(qw: Params, dtype: torch.dtype) -> torch.Tensor:
    return (q.unpack_int4(qw["packed"], axis=1).float() * qw["sw"]).to(dtype)


def _check_moe(cfg: ModelConfig) -> None:
    if cfg.family is not Family.MOE:
        raise NotImplementedError(f"the W4A8 MoE forward serves the MoE family, not {cfg.name}")


def quantize_moe_layer(lp: Params, cfg: ModelConfig) -> Params:
    """One MoE block into the W4A8 form: the attention linears packed for
    the W4A8 kernel, the experts packed int4 per (expert, output channel),
    norms and the f32 router as they are.  No rotation folding, as in the
    reference (a rotated residual would change the router's input)."""
    _check_moe(cfg)
    d, h, kv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv, cfg.hd
    a, m = lp["attn"], lp["moe"]
    return {
        "ln1": lp["ln1"],
        "ln2": lp["ln2"],
        "wq": _quant_pack(a["wq"].reshape(d, h * hd)),
        "wk": _quant_pack(a["wk"].reshape(d, kv * hd)),
        "wv": _quant_pack(a["wv"].reshape(d, kv * hd)),
        "wo": _quant_pack(a["wo"].reshape(h * hd, d)),
        "router": m["router"],
        "w_gate": _quant_pack_experts(m["w_gate"]),
        "w_up": _quant_pack_experts(m["w_up"]),
        "w_down": _quant_pack_experts(m["w_down"]),
    }


def quantize_moe_lm(params: Params, cfg: ModelConfig) -> Params:
    """MoE params -> the W4A8 MoE serving form (the reference's
    ``quantize_moe_lm``): embedding and final norm as they are, the head
    packed, every layer through ``quantize_moe_layer``."""
    return {
        "embed": params["embed"]["tok"],
        "head": _quant_pack(params["embed"]["head"].float()),
        "final_norm": params["final_norm"],
        "layers": [quantize_moe_layer(lp, cfg) for lp in params["layers"]],
    }


def apply_quantized_moe_lm(
    qparams: Params,
    cfg: ModelConfig,
    tokens: torch.Tensor,
    cache: Optional[Params] = None,
) -> Tuple[torch.Tensor, Optional[Params]]:
    """W4A8 MoE forward over a dense cache or none (the reference's
    ``apply_quantized_moe_lm`` without a mesh): W4A8 attention linears,
    the experts dequantized per layer into the dense combine, the head
    through the W4A8 kernel; logits in the model dtype."""
    _check_moe(cfg)
    if cache is not None and "page_table" in cache:
        raise NotImplementedError("the W4A8 MoE forward takes a dense cache, as the reference's")
    b, s = tokens.shape
    offset, positions, paged = L.forward_cache_ctx(cache, b, s, tokens.device)
    x = qparams["embed"][tokens.long()].to(cfg.tdtype)
    for i, p in enumerate(qparams["layers"]):
        x = x + _w4a8_attention(p, L.rmsnorm(p["ln1"], x), cfg, i, cache, offset, positions,
                                paged)
        experts = {"router": p["router"]}
        for name in ("w_gate", "w_up", "w_down"):
            experts[name] = _dequant_experts(p[name], x.dtype)
        x = x + L.moe_apply_dense(experts, L.rmsnorm(p["ln2"], x), cfg)
        del experts
    logits = _qlinear(L.rmsnorm(qparams["final_norm"], x), qparams["head"])
    return logits, L.advance_cache(cache, offset, s)


# ---------------------------------------------------------------------------
# Weights carried across from the reference
# ---------------------------------------------------------------------------


def params_from_numpy(tree: Params, cfg: ModelConfig, mode: str, device) -> Params:
    """The reference's parameter tree, as nested dicts of numpy arrays,
    -> the port's params on ``device``.

    ``mode`` names the tree: "bf16" (``lm.init_lm``'s tree of any family,
    through ``models.convert.params_from_numpy``), "w4a8"
    (``quantize_dense_lm``; the packed weights are reordered for the W4A8
    kernel, ``w4a8_matmul.prepack``), "bvq" (``bvq_compress_lm``, each
    BVQWeight given as its fields ``codebooks``, ``scales``, ``indices``,
    ``shape``, ``vec_dim``) or "w4a8_moe" (``quantize_moe_lm``: attention
    and head prepacked, experts kept as packed (E, K/2, F) + (E, 1, F)
    scales).  Layer-stacked arrays (leading axis n_layers) are split into
    the port's per-layer list (``convert.from_reference``); float weights
    take the model dtype, the MoE router and every scale float32."""
    if mode == "bf16":
        return convert.params_from_numpy(tree, cfg, device)
    dt = cfg.tdtype
    layers = convert.from_reference(tree, cfg)["layers"]

    def fp(a):
        return convert.as_tensor(a, device, dt)

    def f32(a):
        return convert.as_tensor(a, device, torch.float32)

    def qw(d):
        return {"packed": prepack(convert.as_tensor(d["packed"], device, torch.int8)),
                "sw": f32(d["sw"])}

    def qk_extra(lp):
        return {k: fp(a) for k, a in lp.get("qk_extra", {}).items()}

    names = ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down")
    if mode == "w4a8":
        return {
            "embed": fp(tree["embed"]),
            "head": qw(tree["head"]),
            "layers": [
                {**{name: qw(lp[name]) for name in names}, "qk_extra": qk_extra(lp)}
                for lp in layers
            ],
        }

    if mode == "bvq":
        def bw(d):
            bwt = bvq_mod.BVQWeight(
                codebooks=convert.as_tensor(d["codebooks"], device, torch.int8),
                scales=convert.as_tensor(d["scales"], device, torch.float32),
                indices=convert.as_tensor(d["indices"], device, torch.int32),
                shape=tuple(d["shape"]),
                vec_dim=int(d["vec_dim"]),
            )
            return {"cb": bvq_mod.dequant_codebooks(bwt), "idx": bwt.indices}

        return {
            "embed": fp(tree["embed"]),
            "head": fp(tree["head"]),
            "final_norm": {"g": fp(tree["final_norm"]["g"])},
            "layers": [
                {
                    "ln1": {"g": fp(lp["ln1"]["g"])},
                    "ln2": {"g": fp(lp["ln2"]["g"])},
                    **{name: bw(lp[name]) for name in names},
                    "qk_extra": qk_extra(lp),
                }
                for lp in layers
            ],
        }

    if mode == "w4a8_moe":
        def experts(d):
            return {"packed": convert.as_tensor(d["packed"], device, torch.int8),
                    "sw": f32(d["sw"])}

        def moe_layer(lp):
            return {"ln1": {"g": fp(lp["ln1"]["g"])}, "ln2": {"g": fp(lp["ln2"]["g"])},
                    **{name: qw(lp[name]) for name in ("wq", "wk", "wv", "wo")},
                    "router": f32(lp["router"]),
                    **{name: experts(lp[name]) for name in ("w_gate", "w_up", "w_down")}}

        return {
            "embed": fp(tree["embed"]),
            "head": qw(tree["head"]),
            "final_norm": {"g": fp(tree["final_norm"]["g"])},
            "layers": [moe_layer(lp) for lp in layers],
        }
    raise ValueError(f"params_from_numpy: unknown mode {mode!r}")

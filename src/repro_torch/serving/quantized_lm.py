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

On a mesh (``mesh=``, a ``launch/mesh.DeviceMesh`` over ranks) the W4A8
forwards run on their shards (``quantized_param_specs``,
``quantized_moe_param_specs``; ``quantize_layer`` / ``params_from_numpy``
take a rank's slice of each weight as the reference packs it and only then
``prepack`` it, since prepacking pads K to 128 and N to 16): the
column-parallel wq / wk / wv / w_gate / w_up / head through the W4A8 kernel
on their N block, the row-parallel wo / w_down through its int32 epilogue
on their K block, the ranks' int32 accumulators all-reduced exactly and
scaled once, in the kernel's order, by the row's activation scale (from
the absolute maximum over the whole row: wo's heads are all-reduced with
MAX) and the per-channel weight scale.  The d_ff activation is all-gathered
before the R2 rotation, which runs on the whole vector (one launch a
layer), and each rank quantizes it whole and keeps its K block.  So the
sharded W4A8 forward is one device's bit for bit.  The W4A8 MoE takes the
expert-parallel all-to-all (``layers.moe_dispatch_a2a``) with the W4A8
kernel once per local expert on its (tp * cap, d) slots, as the
reference's ``_moe_a2a_quant`` (int8 tokens, int4 experts, int32
accumulation).  FSDP (``cfg.fsdp``) over prepacked weights is not ported.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.core import bvq as bvq_mod
from repro_torch.core import quantization as q
from repro_torch.core import rotation as rot
from repro_torch.kernels import ops
from repro_torch.kernels.w4a8_matmul import prepack, w4a8_matmul, w4a8_matmul_int32
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
    "quantized_param_specs",
    "quantized_moe_param_specs",
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


def _quant_pack(w: torch.Tensor, spec=None, mesh=None) -> Params:
    """(K, N) -> int4 packed along K, in the W4A8 kernel's fragment order
    (``w4a8_matmul.prepack``), + per-output-channel scales; with a mesh,
    the rank's block under ``spec`` (``_finish``)."""
    wq, sw = q.quantize_weight_int(w.float(), bits=4, axis=0)
    return _finish({"packed": q.pack_int4(wq, axis=0), "sw": sw.reshape(1, -1)}, spec, mesh)


def _finish(qw: Params, spec, mesh) -> Params:
    """A weight packed as the reference packs it ((K/2, N) + (1, N)
    scales): its rank block under ``spec`` on a mesh, then prepacked."""
    if _sharded(mesh):
        if "data" in tuple(spec["packed"]):
            raise NotImplementedError("FSDP over prepacked W4A8 weights is not ported")
        from repro_torch.models.lm import shard_leaf
        qw = {"packed": shard_leaf(qw["packed"], spec["packed"], mesh),
              "sw": shard_leaf(qw["sw"], spec["sw"], mesh)}
    return {"packed": prepack(qw["packed"]), "sw": qw["sw"].contiguous()}


def _sharded(mesh) -> bool:
    return mesh is not None and mesh.size > 1


def _lin_in(fs=None):
    """Specs of a column-parallel packed weight: N over ``model``."""
    return {"packed": (fs, "model"), "sw": (None, "model")}


def _lin_out(fs=None):
    """Specs of a row-parallel packed weight: K over ``model``."""
    return {"packed": ("model", fs), "sw": (None, None)}


def quantized_param_specs(cfg: ModelConfig) -> Params:
    """The reference's ``quantized_param_specs`` (the W4A8 target's spec
    tree, PartitionSpecs as tuples) in the port's per-layer layout; the
    packed specs are of the reference's (K/2, N) packing."""
    fs = "data" if cfg.fsdp else None

    def layer():
        return {"wq": _lin_in(fs), "wk": _lin_in(fs), "wv": _lin_in(fs), "wo": _lin_out(fs),
                "w_gate": _lin_in(fs), "w_up": _lin_in(fs), "w_down": _lin_out(fs),
                "qk_extra": {"q_norm": (None,), "k_norm": (None,)} if cfg.qk_norm else {}}

    return {"embed": ("model", fs), "head": _lin_in(fs),
            "layers": [layer() for _ in range(cfg.n_layers)]}


def quantized_moe_param_specs(cfg: ModelConfig) -> Params:
    """The reference's ``quantized_moe_param_specs`` in the port's layout."""
    fs = "data" if cfg.fsdp else None

    def experts():
        return {"packed": ("model", fs, None), "sw": ("model", None, None)}

    def layer():
        return {"ln1": {"g": (None,)}, "ln2": {"g": (None,)}, "wq": _lin_in(fs),
                "wk": _lin_in(fs), "wv": _lin_in(fs), "wo": _lin_out(fs),
                "router": (None, None), "w_gate": experts(), "w_up": experts(),
                "w_down": experts()}

    return {"embed": ("model", fs), "head": _lin_in(fs), "final_norm": {"g": (None,)},
            "layers": [layer() for _ in range(cfg.n_layers)]}


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


def quantize_layer(lp: Params, cfg: ModelConfig, mesh=None) -> Params:
    """One block into the W4A8 serving form: fold the norms, rotate by R1
    (residual) and R2 (w_down input), quantize and pack every linear (on a
    mesh, the rank's block of each)."""
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
    sp = quantized_param_specs(cfg)["layers"][0] if _sharded(mesh) else {}
    return {
        "wq": _quant_pack(_rot_in(wq_, r1), sp.get("wq"), mesh),
        "wk": _quant_pack(_rot_in(wk_, r1), sp.get("wk"), mesh),
        "wv": _quant_pack(_rot_in(wv_, r1), sp.get("wv"), mesh),
        "wo": _quant_pack(_rot_out(wo_, r1), sp.get("wo"), mesh),
        "w_gate": _quant_pack(_rot_in(wg_, r1), sp.get("w_gate"), mesh),
        "w_up": _quant_pack(_rot_in(wu_, r1), sp.get("w_up"), mesh),
        "w_down": _quant_pack(wd_, sp.get("w_down"), mesh),
        "qk_extra": _qk_extra(lp["attn"]),
    }


def quantize_embed(embed: Params, final_norm: Params, cfg: ModelConfig, mesh=None) -> Params:
    """Embedding rotated by R1 (output side) and the head with the final
    norm folded in, rotated by R1 (input side) and quantized (on a mesh,
    the rank's vocabulary block of each)."""
    r1 = rot.plan_rotation(cfg.d_model)
    tok = rot.local_rotate(embed["tok"].float(), r1).to(cfg.tdtype)
    head = _fold_norm_into(embed["head"], final_norm["g"]).float()
    if _sharded(mesh):
        from repro_torch.models.lm import shard_leaf
        tok = shard_leaf(tok, ("model", None), mesh)
    return {"embed": tok, "head": _quant_pack(_rot_in(head, r1), _lin_in(), mesh)}


def quantize_dense_lm(params: Params, cfg: ModelConfig, mesh=None) -> Params:
    """Dense-LM params -> the W4A8 + LRU serving form (bits=4, rotate=True,
    the reference's defaults); on a mesh, the rank's shard."""
    out = quantize_embed(params["embed"], params["final_norm"], cfg, mesh)
    out["layers"] = [quantize_layer(lp, cfg, mesh) for lp in params["layers"]]
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


def _qlinear_rows(xq: torch.Tensor, sx: torch.Tensor, qw: Params, shard: L.Shard,
                  lead, dtype) -> torch.Tensor:
    """A row-parallel W4A8 linear from this rank's K block of the
    activation codes xq (M, K / tp) and the whole row's scales sx (M, 1):
    the kernel's int32 epilogue, the exact all-reduce of the accumulators
    over ``model``, then (float(acc) * sx) * sw, the kernel's own order."""
    acc = w4a8_matmul_int32(xq.contiguous(), qw["packed"], qw["sw"].shape[-1])
    acc = shard.mesh.all_reduce(acc, "model")
    return ((acc.float() * sx) * qw["sw"]).reshape(*lead, -1).to(dtype)


def _wo(att: torch.Tensor, qw: Params, shard: L.Shard) -> torch.Tensor:
    """wo on this rank's heads: the row's absolute maximum all-reduced with
    MAX, so the codes are one device's."""
    if shard.tp == 1:
        return _qlinear(att, qw)
    a2 = att.reshape(-1, att.shape[-1])
    amax = shard.mesh.all_reduce(a2.float().abs().amax(dim=-1, keepdim=True), "model", "max")
    xq, sx = q.quantize_act_int8(a2, amax=amax)
    return _qlinear_rows(xq, sx, qw, shard, att.shape[:-1], att.dtype)


def _k_block(t: torch.Tensor, shard: L.Shard) -> torch.Tensor:
    n = t.shape[-1] // shard.tp
    return t[..., shard.r * n:(shard.r + 1) * n]


def _w4a8_attention(p: Params, z: torch.Tensor, cfg: ModelConfig, i: int, cache, offset,
                    positions, paged, shard: L.Shard = L.Shard()) -> torch.Tensor:
    """Layer i's W4A8 attention block on its normed input ``z``: q/k/v
    through the W4A8 kernel, qk-norm where the config asks for it, rope,
    attention over the cache, and the output projection ``wo``.

    On a mesh q / k / v come out as the rank's column block: with
    tensor-parallel attention its q heads, its kv heads where ``model``
    divides n_kv, else every kv head gathered and repeated to the rank's
    virtual heads; otherwise every head gathered and attention run whole,
    the rank keeping its K block for ``wo``."""
    b, s, _ = z.shape
    kv, hd = cfg.n_kv, cfg.hd
    q_, k_, v_ = (_qlinear(z, p[name]) for name in ("wq", "wk", "wv"))
    tp_on = L.attn_tp_enabled(cfg, shard.tp)
    if shard.tp > 1 and not tp_on:
        q_, k_, v_ = (shard.mesh.all_gather(t, "model", 2) for t in (q_, k_, v_))
    elif tp_on and kv % shard.tp:
        k_, v_ = (shard.mesh.all_gather(t, "model", 2) for t in (k_, v_))
    q_ = q_.reshape(b, s, -1, hd)
    k_ = k_.reshape(b, s, -1, hd)
    v_ = v_.reshape(b, s, -1, hd)
    q_, k_ = _qk_norm(q_, k_, p, cfg)
    q_ = L.rope(q_, positions, cfg.rope_theta)
    k_ = L.rope(k_, positions, cfg.rope_theta)
    if tp_on and kv % shard.tp:
        (first, n), _ = L.virtual_heads(cfg, shard.tp, shard.r)
        rep = L.kv_store_heads(cfg, shard.tp) // kv
        k_, v_ = (torch.repeat_interleave(t, rep, dim=2)[:, :, first:first + n]
                  for t in (k_, v_))
    att = L.attend(i, q_, k_, v_, cache, offset, paged).reshape(b, s, -1)
    if shard.tp > 1 and not tp_on:
        att = _k_block(att, shard)
    return _wo(att, p["wo"], shard)


def _w4a8_down(hid: torch.Tensor, qw: Params, r2, shard: L.Shard) -> torch.Tensor:
    """The LRU's online R2 stage and w_down: on a mesh the rank's d_ff
    columns are all-gathered, rotated whole (one launch), quantized whole,
    and the rank's K block goes through the int32 epilogue."""
    if shard.tp == 1:
        return _qlinear(ops.lru_rotate(hid, r2), qw)
    hid = ops.lru_rotate(shard.mesh.all_gather(hid, "model", hid.dim() - 1), r2)
    xq, sx = q.quantize_act_int8(hid.reshape(-1, hid.shape[-1]))
    return _qlinear_rows(_k_block(xq, shard), sx, qw, shard, hid.shape[:-1], hid.dtype)


def _head(x: torch.Tensor, qw: Params, shard: L.Shard) -> torch.Tensor:
    logits = _qlinear(x, qw)
    if shard.tp == 1:
        return logits
    return shard.mesh.all_gather(logits, "model", logits.dim() - 1)


def _shard_of(cfg: ModelConfig, mesh, cache) -> L.Shard:
    if mesh is None:
        return L.Shard()
    if not _sharded(mesh):
        return L.Shard(mesh)
    if cfg.fsdp:
        raise NotImplementedError("FSDP over prepacked W4A8 weights is not ported")
    if cache is not None and "page_table" in cache:
        raise NotImplementedError("a sharded W4A8 forward takes a dense cache (the Engine's "
                                  "paged pool runs on one device, as the reference's)")
    return L.Shard(mesh)


def apply_quantized_lm(
    qparams: Params,
    cfg: ModelConfig,
    tokens: torch.Tensor,
    cache: Optional[Params] = None,
    mesh=None,
) -> Tuple[torch.Tensor, Optional[Params]]:
    """W4A8 serving forward (dense family), logits in the model dtype.
    Cache tensors are written in place; the returned cache dict carries the
    advanced length.  On a mesh ``qparams`` is the rank's shard,
    ``tokens`` its rows (``lm.local_rows``) and the logits theirs over the
    whole vocabulary."""
    _check_dense(cfg)
    shard = _shard_of(cfg, mesh, cache)
    b, s = tokens.shape
    r2 = rot.plan_rotation(cfg.d_ff)
    offset, positions, paged = L.forward_cache_ctx(cache, b, s, tokens.device)
    x = L.embed_lookup(qparams["embed"], tokens, shard).to(cfg.tdtype)
    for i, p in enumerate(qparams["layers"]):
        x = x + _w4a8_attention(p, _norm_only(x), cfg, i, cache, offset, positions, paged,
                                shard)
        z2 = _norm_only(x)
        g_ = _qlinear(z2, p["w_gate"])
        u_ = _qlinear(z2, p["w_up"])
        x = x + _w4a8_down(L.silu_mul(g_, u_, x.dtype), p["w_down"], r2, shard)
    return _head(_norm_only(x), qparams["head"], shard), L.advance_cache(cache, offset, s)


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


def _shard_experts(qw: Params, name: str, cfg: ModelConfig, mesh) -> Params:
    """Packed experts (E, K/2, F) + (E, 1, F) scales -> the rank's experts
    on a mesh (one rank too; split as the reference stacks them when
    experts are fewer than ranks, cut over ``model``), each prepacked for
    the W4A8 kernel of the all-to-all path; as they are without one (the
    dense branch dequantizes them)."""
    if mesh is None:
        return qw
    from repro_torch.models.lm import shard_leaf, split_experts
    split = L.moe_ff_split(cfg, mesh.tp)
    packed = split_experts(qw["packed"], name, cfg.n_experts, split)
    sw = (torch.repeat_interleave(qw["sw"], split, dim=0) if name == "w_down" else
          split_experts(qw["sw"], name, cfg.n_experts, split))
    packed = shard_leaf(packed, ("model", None, None), mesh)
    return {"packed": torch.stack([prepack(w) for w in packed]),
            "sw": shard_leaf(sw, ("model", None, None), mesh)}


def _dequant_experts(qw: Params, dtype: torch.dtype) -> torch.Tensor:
    return (q.unpack_int4(qw["packed"], axis=1).float() * qw["sw"]).to(dtype)


def _check_moe(cfg: ModelConfig) -> None:
    if cfg.family is not Family.MOE:
        raise NotImplementedError(f"the W4A8 MoE forward serves the MoE family, not {cfg.name}")


def quantize_moe_layer(lp: Params, cfg: ModelConfig, mesh=None) -> Params:
    """One MoE block into the W4A8 form: the attention linears packed for
    the W4A8 kernel, the experts packed int4 per (expert, output channel),
    norms and the f32 router as they are (on a mesh, the rank's shard).  No
    rotation folding, as in the reference (a rotated residual would change
    the router's input)."""
    _check_moe(cfg)
    d, h, kv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv, cfg.hd
    a, m = lp["attn"], lp["moe"]
    sp = quantized_moe_param_specs(cfg)["layers"][0] if _sharded(mesh) else {}
    return {
        "ln1": lp["ln1"],
        "ln2": lp["ln2"],
        "wq": _quant_pack(a["wq"].reshape(d, h * hd), sp.get("wq"), mesh),
        "wk": _quant_pack(a["wk"].reshape(d, kv * hd), sp.get("wk"), mesh),
        "wv": _quant_pack(a["wv"].reshape(d, kv * hd), sp.get("wv"), mesh),
        "wo": _quant_pack(a["wo"].reshape(h * hd, d), sp.get("wo"), mesh),
        "router": m["router"],
        **{name: _shard_experts(_quant_pack_experts(m[name]), name, cfg, mesh)
           for name in ("w_gate", "w_up", "w_down")},
    }


def quantize_moe_lm(params: Params, cfg: ModelConfig, mesh=None) -> Params:
    """MoE params -> the W4A8 MoE serving form (the reference's
    ``quantize_moe_lm``): embedding and final norm as they are, the head
    packed, every layer through ``quantize_moe_layer`` (on a mesh, the
    rank's shard)."""
    tok = params["embed"]["tok"]
    if _sharded(mesh):
        from repro_torch.models.lm import shard_leaf
        tok = shard_leaf(tok, ("model", None), mesh)
    return {
        "embed": tok,
        "head": _quant_pack(params["embed"]["head"].float(), _lin_in(), mesh),
        "final_norm": params["final_norm"],
        "layers": [quantize_moe_layer(lp, cfg, mesh) for lp in params["layers"]],
    }


def _moe_a2a_quant(p: Params, x: torch.Tensor, cfg: ModelConfig, shard: L.Shard
                   ) -> torch.Tensor:
    """The reference's ``_moe_a2a_quant`` on this rank's tokens x (B, S,
    d): the expert-parallel dispatch (``layers.moe_dispatch_a2a``), and on
    each local expert's (tp * cap, d) slots int8 tokens times its int4
    gate / up through the W4A8 kernel, silu(g) * u in float32 quantized to
    int8 again, times int4 down, cast to x's dtype."""
    b, s, d = x.shape

    def experts(recv):
        outs = []
        for e in range(recv.shape[0]):
            xq, sx = q.quantize_act_int8(recv[e])
            g = w4a8_matmul(xq, p["w_gate"]["packed"][e], sx, p["w_gate"]["sw"][e])
            u = w4a8_matmul(xq, p["w_up"]["packed"][e], sx, p["w_up"]["sw"][e])
            hq, sh = q.quantize_act_int8(torch.nn.functional.silu(g) * u)
            outs.append(w4a8_matmul(hq, p["w_down"]["packed"][e], sh,
                                    p["w_down"]["sw"][e]).to(x.dtype))
        return torch.stack(outs)

    return L.moe_dispatch_a2a(x.reshape(-1, d), p["router"], cfg, shard,
                              experts).reshape(b, s, d)


def apply_quantized_moe_lm(
    qparams: Params,
    cfg: ModelConfig,
    tokens: torch.Tensor,
    cache: Optional[Params] = None,
    mesh=None,
) -> Tuple[torch.Tensor, Optional[Params]]:
    """W4A8 MoE forward over a dense cache or none: W4A8 attention linears,
    the head through the W4A8 kernel, logits in the model dtype.  Without
    a mesh the experts are dequantized per layer into the dense combine
    (the reference's ``mesh=None`` branch); on a mesh (of one rank too, as
    in the reference) ``qparams`` is the rank's shard, built with the same
    mesh (``quantize_moe_lm`` / ``params_from_numpy(..., mesh=)``: the
    experts prepacked), ``tokens`` its rows, and the experts run the
    all-to-all through the W4A8 kernel (``_moe_a2a_quant``)."""
    _check_moe(cfg)
    if cache is not None and "page_table" in cache:
        raise NotImplementedError("the W4A8 MoE forward takes a dense cache, as the reference's")
    shard = _shard_of(cfg, mesh, cache)
    b, s = tokens.shape
    offset, positions, paged = L.forward_cache_ctx(cache, b, s, tokens.device)
    x = L.embed_lookup(qparams["embed"], tokens, shard).to(cfg.tdtype)
    for i, p in enumerate(qparams["layers"]):
        x = x + _w4a8_attention(p, L.rmsnorm(p["ln1"], x), cfg, i, cache, offset, positions,
                                paged, shard)
        z2 = L.rmsnorm(p["ln2"], x)
        if shard.mesh is not None:
            x = x + _moe_a2a_quant(p, z2, cfg, shard)
            continue
        experts = {"router": p["router"]}
        for name in ("w_gate", "w_up", "w_down"):
            experts[name] = _dequant_experts(p[name], x.dtype)
        x = x + L.moe_apply_dense(experts, z2, cfg)
        del experts
    logits = _head(L.rmsnorm(qparams["final_norm"], x), qparams["head"], shard)
    return logits, L.advance_cache(cache, offset, s)


# ---------------------------------------------------------------------------
# Weights carried across from the reference
# ---------------------------------------------------------------------------


def params_from_numpy(tree: Params, cfg: ModelConfig, mode: str, device, mesh=None) -> Params:
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
    take the model dtype, the MoE router and every scale float32.  With a
    mesh ("w4a8", "w4a8_moe") each weight is cut to the rank's block, as
    the reference packs it, before it is prepacked; local experts are
    prepacked one by one into an (e_loc, N16, K64, 512) stack."""
    if mode == "bf16":
        return convert.params_from_numpy(tree, cfg, device)
    dt = cfg.tdtype
    layers = convert.from_reference(tree, cfg)["layers"]

    def fp(a):
        return convert.as_tensor(a, device, dt)

    def f32(a):
        return convert.as_tensor(a, device, torch.float32)

    def qw(d, spec=None):
        return _finish({"packed": convert.as_tensor(d["packed"], device, torch.int8),
                        "sw": f32(d["sw"])}, spec, mesh)

    def vocab_block(t):
        if not _sharded(mesh):
            return t
        from repro_torch.models.lm import shard_leaf
        return shard_leaf(t, ("model", None), mesh)

    def qk_extra(lp):
        return {k: fp(a) for k, a in lp.get("qk_extra", {}).items()}

    names = ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down")
    if mode == "w4a8":
        sp = quantized_param_specs(cfg)["layers"][0] if _sharded(mesh) else {}
        return {
            "embed": vocab_block(fp(tree["embed"])),
            "head": qw(tree["head"], _lin_in()),
            "layers": [
                {**{name: qw(lp[name], sp.get(name)) for name in names},
                 "qk_extra": qk_extra(lp)}
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
        sp = quantized_moe_param_specs(cfg)["layers"][0] if _sharded(mesh) else {}

        def experts(d, name):
            return _shard_experts({"packed": convert.as_tensor(d["packed"], device, torch.int8),
                                   "sw": f32(d["sw"])}, name, cfg, mesh)

        def moe_layer(lp):
            return {"ln1": {"g": fp(lp["ln1"]["g"])}, "ln2": {"g": fp(lp["ln2"]["g"])},
                    **{name: qw(lp[name], sp.get(name)) for name in ("wq", "wk", "wv", "wo")},
                    "router": f32(lp["router"]),
                    **{name: experts(lp[name], name) for name in ("w_gate", "w_up", "w_down")}}

        return {
            "embed": vocab_block(fp(tree["embed"])),
            "head": qw(tree["head"], _lin_in()),
            "final_norm": {"g": fp(tree["final_norm"]["g"])},
            "layers": [moe_layer(lp) for lp in layers],
        }
    raise ValueError(f"params_from_numpy: unknown mode {mode!r}")

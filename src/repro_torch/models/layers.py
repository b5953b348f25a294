"""Layer library of the serving forwards (torch counterpart of the parts of
repro/models/layers.py the serving forwards reach): norms, rotary, the
attention block (with Qwen3's per-head qk-norm), the SwiGLU / squared-ReLU
/ GELU MLPs, the MoE block's dense combine, prefill attention over a dense
cache, and the paged KV cache.  Every row-wise op gives a row the
same bits whatever the number of rows in the call (tests/test_torch_rows.py),
so a speculative verify scores a row exactly as a one-token step does.

``attend`` is the one attention route of all three forwards (the W4A8
target, the BVQ draft, the bf16 ``lm.apply_lm``): a paged pool runs
``kernels.paged_attn.paged_attention`` (the CUDA kernel on the card, its
plain version on the CPU); a dense fp cache and the cache-free case run
the plain torch ``decode_attention`` / ``flash_attention``, as they are
plain jnp in the reference (a bf16 / fp16 ``flash_attention`` on the
card runs K8, ``kernels.prefill_attn``); a dense int8 cache
(``kv_quant``) runs a one-token step through K7 (``kernels.decode_attn``)
on the card and the reference's bfloat16 ``_decode_attention`` math on
the CPU.  The dense blocks' linears are plain torch matmuls (``linear``),
as the reference's are ``einsum``s outside any Pallas kernel.  The MoE
block runs the reference's single-device dense combine
(``moe_apply_dense``: every token through every expert, gated by the
softmax of its top-k router logits) as batched torch products over the
expert axis, in the same fixed row blocks.

On a mesh (``launch/mesh.DeviceMesh``, one process per rank) every block
takes its rank's shard of the parameters (``*_specs`` give the layout, the
reference's ``PartitionSpec`` trees as plain tuples) and a ``Shard``
context: q heads, the FFN's inner dim, experts and the vocabulary split
over ``model``; column-parallel ``wq`` / ``w_gate`` / ``w_up`` take the
replicated (or, under Megatron sequence sharding, all-gathered) input,
row-parallel ``wo`` / ``w_down`` end in an all-reduce (or a
reduce-scatter onto the sequence shards).  GQA with fewer kv heads than
ranks repeats them to ``kv_store_heads`` virtual heads, so each rank
attends its own heads with no collective; a head count the model axis
does not divide runs attention replicated over ``model``.  ``fsdp=True``
shards the non-TP weight axis over ``data`` and gathers it before use.
The collectives carry their Megatron backward pairs, so training runs
through the same code.  ``moe_apply_a2a`` is the GShard expert-parallel
dispatch over the ``model`` group's all-to-all.

On meta tensors (the dry-run's shape-only trace) ``linear``,
``flash_attention`` and ``moe_apply_dense`` take every row in one block:
the same products, traced once."""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.core.quantization import div_scalar
from repro_torch.kernels.decode_attn import decode_attention_int8
from repro_torch.kernels.paged_attn import paged_attention
from repro_torch.kernels.prefill_attn import prefill_attention
from repro_torch.launch import mesh as M
from repro_torch.models.common import ModelConfig

__all__ = [
    "row_mean_sq",
    "rmsnorm",
    "qk_head_norm",
    "rope",
    "silu_mul",
    "kv_store_heads",
    "attn_tp_enabled",
    "pick_batch_axes",
    "moe_ff_split",
    "Shard",
    "rmsnorm_spec",
    "attention_specs",
    "mlp_specs",
    "moe_specs",
    "embed_specs",
    "moe_apply_a2a",
    "moe_dispatch_a2a",
    "moe_capacity",
    "topk_dispatch",
    "embed_lookup",
    "embed_tokens",
    "lm_head",
    "virtual_heads",
    "linear",
    "attention_init",
    "attention_apply",
    "cross_kv",
    "enter_states",
    "mlp_init",
    "mlp_apply",
    "topk_gates",
    "moe_apply_dense",
    "moe_apply",
    "attend",
    "decode_attention",
    "decode_attention_int8_step",
    "advance_cache",
    "flash_attention",
    "flash_attention_plain",
    "PagedCache",
    "kv_quantize",
    "paged_attention_update",
    "forward_cache_ctx",
    "xent",
    "remat",
]


# the row count of every GEMM in flash_attention and linear (see there):
# enough for a verify window of 8 rows x 9 slots in one block
ROW_BLOCK = 128


def row_mean_sq(xf: torch.Tensor) -> torch.Tensor:
    """mean(xf * xf) over the last axis (keepdim), summed in stages of at
    most 32 terms (zero-padded) so that a row's bits do not depend on the
    number of rows: a CUDA reduction picks its thread layout, and with it
    the order of a row's sum, from the number of outputs once a row has
    more than 32 terms (one torch.mean over d = 4096 gave other bits at 4
    and 8 rows than among 160 on an H100)."""
    n = xf.shape[-1]
    s = xf * xf
    while s.shape[-1] > 32:
        if s.shape[-1] % 32:
            s = F.pad(s, (0, -s.shape[-1] % 32))
        s = s.unflatten(-1, (-1, 32)).sum(-1)
    return s.sum(-1, keepdim=True) / n


def rmsnorm(params: dict, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    xf = x.float()
    y = xf * torch.rsqrt(row_mean_sq(xf) + eps)
    return (y * params["g"].float()).to(x.dtype)


def qk_head_norm(x: torch.Tensor, g: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """Qwen3's RMSNorm of each head over hd (the reference's
    ``_qk_head_norm``), its mean staged by ``row_mean_sq``."""
    xf = x.float()
    return (xf * torch.rsqrt(row_mean_sq(xf) + eps) * g.float()).to(x.dtype)


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x: (B, S, H, hd); positions: (B, S) int."""
    hd = x.shape[-1]
    half = hd // 2
    freqs = torch.exp(
        -math.log(theta) * torch.arange(half, dtype=torch.float32, device=x.device) / half
    )
    ang = positions[..., None].float() * freqs
    cos = torch.cos(ang)[..., None, :]
    sin = torch.sin(ang)[..., None, :]
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def silu_mul(g: torch.Tensor, u: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """silu(g) in float32, cast to the model dtype, times u."""
    return F.silu(g.float()).to(dtype) * u


def attn_tp_enabled(cfg: ModelConfig, tp: int) -> bool:
    """Attention heads split over ``model``: tp > 1 and divides n_heads."""
    return cfg.n_heads % tp == 0 and tp > 1


def kv_store_heads(cfg: ModelConfig, tp: int = 1) -> int:
    """KV heads the cache stores over the whole model axis (the reference's
    rule): ``n_kv`` unless attention is tensor-parallel, then n_kv * rep
    virtual heads, rep = tp // gcd(n_kv, tp), so every rank holds whole
    heads (``tp=1``: exactly ``n_kv``)."""
    if not attn_tp_enabled(cfg, tp):
        return cfg.n_kv
    return cfg.n_kv * (tp // math.gcd(cfg.n_kv, tp))


def pick_batch_axes(mesh, batch: int):
    """The largest prefix of ("pod", "data") whose size product divides
    ``batch`` (one name, a tuple, or None: the batch is replicated over
    ``data``, as long-context decode's batch of 1 is)."""
    axes = ("pod", "data") if "pod" in mesh.shape else ("data",)
    chosen, prod = [], 1
    for a in axes:
        if batch % (prod * mesh.shape[a]) == 0:
            chosen.append(a)
            prod *= mesh.shape[a]
    if not chosen:
        return None
    return chosen[0] if len(chosen) == 1 else tuple(chosen)


def moe_ff_split(cfg: ModelConfig, tp: int) -> int:
    """Ways each expert's FFN columns split when experts are fewer than the
    model axis (the reference's rule: the (expert x slice) grid covers the
    axis exactly)."""
    e = cfg.n_experts
    if tp <= e:
        if e % tp:
            raise ValueError(f"{e} experts do not split over {tp} ranks")
        return 1
    if tp % e:
        raise ValueError(f"{tp} ranks do not split {e} experts")
    return tp // e


# ---------------------------------------------------------------------------
# Sharding: spec trees and the per-block context
# ---------------------------------------------------------------------------


def _fs(cfg: ModelConfig):
    return "data" if cfg.fsdp else None


def rmsnorm_spec() -> dict:
    return {"g": (None,)}


def attention_specs(cfg: ModelConfig, tp: int) -> dict:
    """The reference's ``attention_init`` specs: q heads (and wo's) over
    ``model`` when attention is tensor-parallel, wk / wv replicated (their
    heads are repeated to virtual heads on use), the d_model axis over
    ``data`` under FSDP."""
    h = "model" if attn_tp_enabled(cfg, tp) else None
    fs = _fs(cfg)
    out = {"wq": (fs, h, None), "wk": (fs, None, None), "wv": (fs, None, None),
           "wo": (h, None, fs)}
    if cfg.qk_norm:
        out["q_norm"] = (None,)
        out["k_norm"] = (None,)
    return out


def mlp_specs(cfg: ModelConfig) -> dict:
    fs = _fs(cfg)
    out = {"w_up": (fs, "model"), "w_down": ("model", fs)}
    if cfg.act == "swiglu":
        out["w_gate"] = (fs, "model")
    return out


def moe_specs(cfg: ModelConfig, tp: int) -> dict:
    """Experts over ``model`` (the (E * split) stack the reference stores
    when experts are fewer than ranks), the router replicated."""
    fs = _fs(cfg)
    return {"router": (None, None), "w_gate": ("model", fs, None),
            "w_up": ("model", fs, None), "w_down": ("model", None, fs)}


def embed_specs(cfg: ModelConfig) -> dict:
    fs = _fs(cfg)
    return {"tok": ("model", fs), "head": (fs, "model")}


@dataclasses.dataclass(frozen=True)
class Shard:
    """How a block runs: on ``mesh`` (None: one device), with the residual
    stream's sequence sharded over ``model`` (``sp``, Megatron sequence
    sharding) or replicated over it."""

    mesh: object = None
    sp: bool = False

    @property
    def tp(self) -> int:
        return M.axis_size(self.mesh, "model")

    @property
    def r(self) -> int:
        return M.axis_index(self.mesh, "model")

    def enter(self, x: torch.Tensor) -> torch.Tensor:
        """The input of a column-parallel linear: the sequence gathered
        (sp) or the replicated stream entering the partitioned region."""
        if self.sp:
            return M.all_gather(x, self.mesh, "model", 1)
        return M.copy_to_region(x, self.mesh, "model")

    def leave(self, y: torch.Tensor) -> torch.Tensor:
        """A row-parallel linear's partial sums: reduce-scattered onto the
        sequence shards (sp) or all-reduced."""
        if self.sp:
            return M.reduce_scatter(y, self.mesh, "model", 1)
        return M.all_reduce(y, self.mesh, "model")

    def region(self, w: torch.Tensor) -> torch.Tensor:
        """A replicated parameter used inside a computation partitioned over
        ``model``: its gradient is the sum of the ranks' parts."""
        return M.copy_to_region(w, self.mesh, "model")

    def gain(self, g: dict) -> dict:
        """A norm's gain: partitioned over the sequence shards under sp."""
        return {"g": self.region(g["g"])} if self.sp else g

    def full(self, w: torch.Tensor, spec) -> torch.Tensor:
        """w with its FSDP (``data``) axes gathered."""
        for dim, part in enumerate(spec):
            if part == "data":
                w = M.all_gather(w, self.mesh, "data", dim)
        return w


def flash_attention(
    q: torch.Tensor,  # (B, Sq, H, hd)
    k: torch.Tensor,  # (B, Skv, Hkv, hd)
    v: torch.Tensor,
    causal: bool,
    q_offset: int = 0,
) -> torch.Tensor:
    """Streaming-softmax attention over KV chunks (prefill).  Dots take
    model-dtype operands with float32 accumulation; softmax statistics and
    the accumulator stay float32, as in the reference.

    The query rows run in blocks of ``ROW_BLOCK``, the last one zero-padded,
    so every product has one shape however many rows the call has: a CUDA
    GEMM picks its kernel by shape, and a row's bits then depended on the
    call's row count (a prefix-cache hit's 7-15-row tail extend against the
    full prefill, on an H100).  The padded rows are dropped.  Meta tensors
    (the dry-run's trace) run every row in one block: the same products,
    traced once.

    On the card, a bf16 or fp16 call that autograd does not record runs K8
    (``kernels/prefill_attn.py``) instead: one launch for the whole call,
    the same function at the same precision, its rows' bits independent
    of the call's row count as here.  CPU and meta tensors, float32, and
    calls recorded for a backward (training) run the blocks below."""
    if _k8_takes(q, k, v):
        return prefill_attention(q, k, v, causal, q_offset)
    return flash_attention_plain(q, k, v, causal, q_offset)


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool,
                          q_offset: int = 0, kv_chunk: int = 1024) -> torch.Tensor:
    """``flash_attention``'s plain torch version (K8's plain version): the
    query rows in ``ROW_BLOCK`` blocks, each over the keys in chunks."""
    sq = q.shape[1]
    if q.device.type == "meta":
        return _flash_block(q, k, v, causal, q_offset, kv_chunk)
    outs = []
    for i in range(0, sq, ROW_BLOCK):
        qb = q[:, i:i + ROW_BLOCK]
        pad = ROW_BLOCK - qb.shape[1]
        out = _flash_block(F.pad(qb, (0, 0, 0, 0, 0, pad)) if pad else qb, k, v, causal,
                           q_offset + i, kv_chunk)
        outs.append(out[:, :ROW_BLOCK - pad])
    return outs[0] if len(outs) == 1 else torch.cat(outs, dim=1)


def _k8_takes(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> bool:
    """K8 runs a CUDA call in bf16 or fp16 that autograd does not record
    through, as ``linear``'s blocks do."""
    if q.device.type != "cuda" or q.dtype not in (torch.bfloat16, torch.float16):
        return False
    return not (torch.is_grad_enabled()
                and (q.requires_grad or k.requires_grad or v.requires_grad))


def _flash_block(q, k, v, causal: bool, q_offset: int, kv_chunk: int) -> torch.Tensor:
    b, sq, h, hd = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    g = h // hkv
    scale = 1.0 / math.sqrt(hd)
    dot_dt = q.dtype
    qf = (q.reshape(b, sq, hkv, g, hd).float() * scale).to(dot_dt).float()
    n_chunks = max(skv // kv_chunk, 1)
    while skv % n_chunks:
        n_chunks -= 1
    ck = skv // n_chunks
    q_pos = torch.arange(sq, device=q.device)[None, :] + q_offset
    m = torch.full((b, hkv, g, sq), -math.inf, device=q.device)
    l = torch.zeros((b, hkv, g, sq), device=q.device)
    acc = torch.zeros((b, hkv, g, sq, hd), device=q.device)
    for c in range(n_chunks):
        kb = k[:, c * ck:(c + 1) * ck].to(dot_dt).float()
        vb = v[:, c * ck:(c + 1) * ck].to(dot_dt).float()
        scores = torch.einsum("bqkgh,bckh->bkgqc", qf, kb)
        if causal:
            kv_pos = c * ck + torch.arange(ck, device=q.device)
            mask = q_pos[:, :, None] >= kv_pos[None, None, :]
            scores = torch.where(mask[:, None, None], scores, torch.full_like(scores, -1e30))
        m_new = torch.maximum(m, scores.amax(dim=-1))
        p = torch.exp(scores - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(dim=-1)
        pv = torch.einsum("bkgqc,bckh->bkgqh", p.to(dot_dt).float(), vb)
        acc = acc * corr[..., None] + pv
        m = m_new
    out = acc / torch.clamp(l[..., None], min=1e-30)
    out = out.permute(0, 3, 1, 2, 4).reshape(b, sq, h, hd)
    return out.to(q.dtype)


def decode_attention(
    q: torch.Tensor,  # (B, 1, H, hd)
    cache_k: torch.Tensor,  # (B, S_max, hkv, hd): model dtype or int8
    cache_v: torch.Tensor,
    length: int,  # valid prefix INCLUDING the new token
    k_scale: Optional[torch.Tensor] = None,  # (B, S_max, hkv, 1) f32 for an int8 cache
    v_scale: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """One token's attention over a dense cache, the reference's
    ``_decode_attention``: dots in bfloat16 for a bfloat16 cache and for
    an int8 one (in a float32 model too, as the reference computes it),
    else float32, accumulated in float32; an int8 cache's K scale
    multiplies the scores and its V scale the softmax weights."""
    b, sq, h, hd = q.shape
    s_max, hkv = cache_k.shape[1], cache_k.shape[2]
    g = h // hkv
    scale = 1.0 / math.sqrt(hd)
    low = k_scale is not None or cache_k.dtype == torch.bfloat16
    dot_dt = torch.bfloat16 if low else torch.float32
    qf = (q.reshape(b, sq, hkv, g, hd).float() * scale).to(dot_dt).float()
    scores = torch.einsum("bqkgh,bskh->bkgqs", qf, cache_k.to(dot_dt).float())
    if k_scale is not None:
        scores = scores * k_scale[..., 0].permute(0, 2, 1)[:, :, None, None, :]
    valid = torch.arange(s_max, device=q.device) < length
    scores = torch.where(valid, scores, torch.full_like(scores, -1e30))
    p = torch.softmax(scores, dim=-1)
    if v_scale is not None:
        p = p * v_scale[..., 0].permute(0, 2, 1)[:, :, None, None, :]
    out = torch.einsum("bkgqs,bskh->bkgqh", p.to(dot_dt).float(), cache_v.to(dot_dt).float())
    out = out.permute(0, 3, 1, 2, 4).reshape(b, sq, h, hd)
    return out.to(q.dtype)


def decode_attention_int8_step(q: torch.Tensor, ck, cv, ks, vs, length: int) -> torch.Tensor:
    """One token's attention over a dense int8 cache through K7
    (``kernels.decode_attn``; on the card the CUDA kernel, on meta tensors
    its plain version, charged the kernel's bytes): q (B, 1, H, hd) as
    (B, KVS, G, hd), the scales (B, S, KVS, 1) as (B, S, KVS).  K7 keeps
    float32 throughout where the CPU route (``decode_attention``) rounds
    the dots' operands to bfloat16 as the reference does."""
    b, _, h, hd = q.shape
    kvs = ck.shape[2]
    n = torch.tensor([length], dtype=torch.int32, device=q.device)
    out = decode_attention_int8(q.reshape(b, kvs, h // kvs, hd), ck, ks[..., 0], cv,
                                vs[..., 0], n)
    return out.reshape(b, 1, h, hd).to(q.dtype)


@dataclasses.dataclass
class PagedCache:
    """One layer's view of the device-resident paged KV pool, shared by the
    whole batch: each row owns the pages its ``page_table`` row names and
    ``length`` is per row.  ``k``/``v`` (and the scales) are views into the
    engine's pool tensors, so writes through them land in the pool.

    With ``k_scale``/``v_scale`` the pool is int8: new tokens quantize on
    the write (values and scales in the same call) and the attention kernel
    dequantizes each page, so pages stay int8 at rest.  ``tree_mask`` (B,
    S, S) replaces the causal window with a speculation tree's ancestor
    relation; None keeps the causal window."""

    k: torch.Tensor  # (P + scratch, page_size, kvh, hd)
    v: torch.Tensor
    page_table: torch.Tensor  # (B, max_pages) int32
    length: torch.Tensor  # (B,) int32 — tokens already written per request
    k_scale: Optional[torch.Tensor] = None  # (P + scratch, page_size, kvh, 1) f32
    v_scale: Optional[torch.Tensor] = None
    tree_mask: Optional[torch.Tensor] = None  # (B, S, S) f32 window visibility


def forward_cache_ctx(cache: Optional[dict], b: int, s: int, device=None):
    """Shared forward preamble: ``(offset, positions (B, S), paged)``.

    A cache carrying ``page_table`` is the paged pool (``{"lengths" (B,),
    "page_table" (B, mp), "attn": {"k": (L, P, ps, kvh, hd), "v": ...[,
    "k_scale", "v_scale"]}}``): offset is the per-row length tensor and
    ``paged`` the ``(page_table, tree_mask)`` pair the layers need.  The
    speculation-tree keys are optional: ``win_pos`` (B, S) gives each
    window slot its depth, so positions = offset + win_pos (slot order is
    BFS, RoPE follows depth), and ``tree_mask`` (B, S, S) its ancestor
    relation.  A dense cache (``{"length": int, "attn": {"k": (L, B, S_max,
    kvh, hd), ...}}``) or None yields an int offset and ``paged=None``; with
    no cache the positions are made on ``device`` (the tokens' device).

    Role mask (fused slots): an optional ``"role_mask"`` (B,) bool selects
    the rows that take part in this forward.  A masked row's length becomes
    0 and its whole page-table row the pool's scratch page (its last), so
    its writes land where no request reads; several masked rows may write
    the same scratch slots, so their outputs are garbage no caller reads."""
    if cache is not None and "page_table" in cache:
        offset = cache["lengths"]
        table = cache["page_table"]
        mask = cache.get("role_mask")
        if mask is not None:
            scratch = cache["attn"]["k"].shape[1] - 1
            offset = torch.where(mask, offset, torch.zeros_like(offset))
            table = torch.where(mask[:, None], table, torch.full_like(table, scratch))
        win_pos = cache.get("win_pos")
        if win_pos is None:
            win_pos = torch.arange(s, device=offset.device)[None, :]
        positions = offset[:, None].long() + win_pos.long()
        return offset, positions.expand(b, s), (table, cache.get("tree_mask"))
    offset = int(cache["length"]) if cache is not None else 0
    device = cache["attn"]["k"].device if cache is not None else device
    positions = (offset + torch.arange(s, device=device))[None, :].expand(b, s)
    return offset, positions, None


def kv_quantize(x: torch.Tensor):
    """Symmetric int8 quantization per (token, head) over the last axis
    (the reference's ``_kv_quantize``): (..., hd) -> (int8 values, float32
    scales (..., 1)).  Computed in float32; torch.round rounds half to
    even, as jnp.round does."""
    xf = x.float()
    scale = div_scalar(torch.clamp(xf.abs().amax(dim=-1, keepdim=True), min=1e-8), 127.0)
    q = torch.clamp(torch.round(xf / scale), -127, 127).to(torch.int8)
    return q, scale


def paged_attention_update(
    q: torch.Tensor,  # (B, S, H, hd) — post-rope queries
    k_new: torch.Tensor,  # (B, S, kvh, hd) — post-rope
    v_new: torch.Tensor,
    pc: PagedCache,
) -> torch.Tensor:
    """Scatter the S new tokens into their pool pages, then attend over the
    valid per-row prefix (+ the window, causal or tree-masked, when S > 1).

    The reference returns updated pool arrays (its pools are donated to
    XLA); here the pools are written in place with ``index_copy_``.  Rows
    write disjoint pages; inactive rows all target the scratch page, where
    duplicate writes are harmless.  An int8 pool gets the span quantized,
    values and scales written in the same call.  Returns ``out (B, S, H,
    hd)``."""
    b, s, h, hd = q.shape
    n_pages, ps, kvh, _ = pc.k.shape
    mp = pc.page_table.shape[1]
    pos = pc.length[:, None].long() + torch.arange(s, device=q.device)[None, :]
    page = torch.gather(pc.page_table.long(), 1, torch.clamp(pos // ps, max=mp - 1))
    # positions past the table span divert to the scratch page (the pool's
    # last) rather than overwrite the row's own committed KV
    page = torch.where(pos >= mp * ps, torch.full_like(page, n_pages - 1), page)
    flat = (page * ps + pos % ps).reshape(-1)
    if pc.k_scale is not None:
        kq, ks = kv_quantize(k_new)
        vq, vs = kv_quantize(v_new)
        writes = ((pc.k, kq), (pc.v, vq), (pc.k_scale, ks), (pc.v_scale, vs))
    else:
        writes = ((pc.k, k_new), (pc.v, v_new))
    for pool, span in writes:
        width = pool.shape[-1]
        pool.view(n_pages * ps, kvh, width).index_copy_(
            0, flat, span.to(pool.dtype).reshape(b * s, kvh, width)
        )
    new_len = pc.length + s
    q5 = q.reshape(b, s, kvh, h // kvh, hd)
    out = paged_attention(q5, pc.k, pc.v, pc.page_table, new_len,
                          k_scale=pc.k_scale, v_scale=pc.v_scale, tree_mask=pc.tree_mask)
    return out.reshape(b, s, h, hd).to(q.dtype)


def attend(i: int, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, cache: Optional[dict],
           offset, paged) -> torch.Tensor:
    """Layer i's attention of post-rope (B, S, heads, hd) q / k / v, with
    ``(offset, paged)`` from ``forward_cache_ctx``: through the paged pool
    (fp or int8 stores, causal or tree window), into a dense cache, or
    cache-free causal attention.

    A dense cache holding ``k_scale`` / ``v_scale`` is int8
    (``ModelConfig.kv_quant``): the new tokens are written as codes and
    per-(token, head) scales (``kv_quantize``).  A one-token step attends
    with K7 on the card (and on meta tensors), with the reference's
    ``_decode_attention`` on the CPU; a wider step (prefill, extend)
    dequantizes the whole buffer and runs ``flash_attention`` over it, as
    the reference does.  An fp dense cache runs ``decode_attention`` /
    ``flash_attention``."""
    if paged is not None:
        table, tree_mask = paged
        attn = cache["attn"]
        pc = PagedCache(
            k=attn["k"][i], v=attn["v"][i], page_table=table, length=offset,
            k_scale=attn["k_scale"][i] if "k_scale" in attn else None,
            v_scale=attn["v_scale"][i] if "v_scale" in attn else None,
            tree_mask=tree_mask,
        )
        return paged_attention_update(q, k, v, pc)
    if cache is None:
        return flash_attention(q, k, v, causal=True)
    s = q.shape[1]
    attn = cache["attn"]
    ck, cv = attn["k"][i], attn["v"][i]
    if "k_scale" not in attn:
        ck[:, offset:offset + s] = k.to(ck.dtype)
        cv[:, offset:offset + s] = v.to(cv.dtype)
        if s == 1:
            return decode_attention(q, ck, cv, offset + 1)
        return flash_attention(q, ck, cv, causal=True, q_offset=offset)
    ks, vs = attn["k_scale"][i], attn["v_scale"][i]
    for buf, sbuf, t in ((ck, ks, k), (cv, vs, v)):
        codes, sc = kv_quantize(t)
        buf[:, offset:offset + s] = codes
        sbuf[:, offset:offset + s] = sc
    if s == 1:
        if q.device.type == "cpu":
            return decode_attention(q, ck, cv, offset + 1, ks, vs)
        return decode_attention_int8_step(q, ck, cv, ks, vs, offset + 1)
    kf, vf = ((buf.float() * sbuf).to(q.dtype) for buf, sbuf in ((ck, ks), (cv, vs)))
    return flash_attention(q, kf, vf, causal=True, q_offset=offset)


def advance_cache(cache: Optional[dict], offset, s: int) -> Optional[dict]:
    """The cache dict a forward returns: its tensors were written in place,
    its length (per row for a paged pool) moves on by the S new tokens."""
    if cache is None:
        return None
    new = dict(cache)
    new["lengths" if "page_table" in cache else "length"] = offset + s
    return new


def linear(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x (..., K) @ w (K, N), the rows in blocks of ``ROW_BLOCK``, the last
    one zero-padded, so that every product has one shape (as in
    ``flash_attention``): a row's bits do not depend on how many rows share
    the call (a one-token step, a verify window, a prefill).

    Where autograd records through x or w (training), the product is one
    matmul instead: the weight's gradient is then one GEMM accumulated in
    float32, not a sum of per-block products in the weight's dtype, and
    training needs no row invariance."""
    if (torch.is_grad_enabled() and (x.requires_grad or w.requires_grad)) or \
            x.device.type == "meta":  # the dry-run's trace: one product
        return x @ w
    lead = x.shape[:-1]
    x2 = x.reshape(-1, x.shape[-1])
    outs = []
    for i in range(0, x2.shape[0], ROW_BLOCK):
        xb = x2[i:i + ROW_BLOCK]
        pad = ROW_BLOCK - xb.shape[0]
        outs.append(((F.pad(xb, (0, 0, 0, pad)) if pad else xb) @ w)[:ROW_BLOCK - pad])
    y = outs[0] if len(outs) == 1 else torch.cat(outs)
    return y.reshape(*lead, w.shape[-1])


def attention_apply(p: dict, x: torch.Tensor, cfg: ModelConfig, i: int, cache: Optional[dict],
                    offset, positions: torch.Tensor, paged, shard: Shard = Shard(), *,
                    causal: bool = True, use_rope: bool = True, kv=None) -> torch.Tensor:
    """The dense family's attention block over the normed input x (B, S,
    d): q / k / v from the (d, heads, hd) weights, rope, layer i's
    ``attend``, and the (heads, hd, d) output projection (the reference's
    ``einsum``s as ``linear``s over the weights' flat views).  Whisper's
    blocks take the reference's switches: ``causal=False`` without a
    cache (the encoder), ``use_rope=False``, and ``kv``, K / V given in
    the rank's heads (``cross_kv``: cross-attention, never cached here).

    On a mesh ``p`` is this rank's shard: with tensor-parallel attention
    the rank's q heads, the kv heads its virtual heads repeat (wk / wv are
    replicated), attention over its own heads and the cache's, and wo's
    rows, ending in the all-reduce (or reduce-scatter); otherwise attention
    runs whole on every rank of ``model``, on the gathered sequence under
    sp, and each rank keeps its own rows."""
    specs = attention_specs(cfg, shard.tp)
    w = {k: shard.full(v, specs[k]) for k, v in p.items()}
    how = (causal, use_rope, kv)
    if attn_tp_enabled(cfg, shard.tp):
        return _attention_tp(w, x, cfg, i, cache, offset, positions, paged, shard, how)
    if shard.sp:
        x = M.gather_replicated(x, shard.mesh, "model", 1)
    out = _attention_local(w, x, cfg, i, cache, offset, positions, paged, cfg.n_kv, how)
    return M.split(out, shard.mesh, "model", 1) if shard.sp else out


def _attend_how(i, q, k, v, cache, offset, paged, how) -> torch.Tensor:
    """``attend``, or whisper's uncached non-causal attention (encoder
    self-attention, cross-attention onto given K / V)."""
    causal, _, kv = how
    if kv is not None:
        return flash_attention(q, kv[0], kv[1], causal=False)
    if cache is None and not causal:
        return flash_attention(q, k, v, causal=False)
    return attend(i, q, k, v, cache, offset, paged)


def _attention_local(w, x, cfg, i, cache, offset, positions, paged, kv_heads: int,
                     how=(True, True, None)) -> torch.Tensor:
    """Attention of every head, on one rank's whole input."""
    b, s, d = x.shape
    h, hd = w["wq"].shape[1], cfg.hd
    q = linear(x, w["wq"].reshape(d, h * hd)).reshape(b, s, h, hd)
    k = v = None
    if how[2] is None:
        k = linear(x, w["wk"].reshape(d, kv_heads * hd)).reshape(b, s, kv_heads, hd)
        v = linear(x, w["wv"].reshape(d, kv_heads * hd)).reshape(b, s, kv_heads, hd)
    if cfg.qk_norm:
        q = qk_head_norm(q, w["q_norm"])
        k = qk_head_norm(k, w["k_norm"]) if k is not None else None
    if how[1]:
        q = rope(q, positions, cfg.rope_theta)
        k = rope(k, positions, cfg.rope_theta) if k is not None else None
    out = _attend_how(i, q, k, v, cache, offset, paged, how).reshape(b, s, h * hd)
    return linear(out, w["wo"].reshape(h * hd, d))


def virtual_heads(cfg: ModelConfig, tp: int, r: int):
    """Rank r's virtual kv heads (first, count) and the real kv heads they
    repeat (first, count): heads repeat contiguously, virtual head v
    serving q heads [v * H / store, (v + 1) * H / store)."""
    store = kv_store_heads(cfg, tp)
    rep, n = store // cfg.n_kv, store // tp
    first = r * n
    lo, hi = first // rep, (first + n - 1) // rep + 1
    return (first, n), (lo, hi - lo)


def _local_kv(w, xin, cfg, shard: Shard, positions, use_rope: bool):
    """k and v of this rank's virtual kv heads from the replicated wk / wv
    (qk-norm and rope applied before the repeat)."""
    (vfirst, vn), (lo, nreal) = virtual_heads(cfg, shard.tp, shard.r)
    rep = kv_store_heads(cfg, shard.tp) // cfg.n_kv
    b, s, d = xin.shape
    hd = cfg.hd
    wk = shard.region(w["wk"])[:, lo:lo + nreal]
    wv = shard.region(w["wv"])[:, lo:lo + nreal]
    k = linear(xin, wk.reshape(d, nreal * hd)).reshape(b, s, nreal, hd)
    v = linear(xin, wv.reshape(d, nreal * hd)).reshape(b, s, nreal, hd)
    if cfg.qk_norm and "k_norm" in w:
        k = qk_head_norm(k, shard.region(w["k_norm"]))
    if use_rope:
        k = rope(k, positions, cfg.rope_theta)
    off = vfirst - lo * rep
    k = torch.repeat_interleave(k, rep, dim=2)[:, :, off:off + vn]
    v = torch.repeat_interleave(v, rep, dim=2)[:, :, off:off + vn]
    return k, v


def cross_kv(p: dict, enc: torch.Tensor, cfg: ModelConfig, shard: Shard = Shard()):
    """Cross-attention K / V of the encoder states ``enc`` (B, T, d, the
    whole sequence, as ``enter_states`` hands it over) in the heads this
    rank attends: its virtual heads under tensor-parallel attention, else
    every kv head.  No qk-norm and no rope, as the reference's
    ``_cross_kv``."""
    specs = attention_specs(cfg, shard.tp)
    w = {k: shard.full(p[k], specs[k]) for k in ("wk", "wv")}
    if attn_tp_enabled(cfg, shard.tp):
        return _local_kv(w, enc, cfg, shard, None, False)
    b, t, d = enc.shape
    kv, hd = cfg.n_kv, cfg.hd
    return tuple(linear(enc, w[n].reshape(d, kv * hd)).reshape(b, t, kv, hd)
                 for n in ("wk", "wv"))


def enter_states(x: torch.Tensor, cfg: ModelConfig, shard: Shard) -> torch.Tensor:
    """A residual stream under ``shard`` (sequence-sharded or replicated)
    whole on this rank, as ``cross_kv``'s input: entering the partitioned
    heads (all-gathered under sp, else copied into the region) with
    tensor-parallel attention, else gathered replicated (each rank then
    computes every head)."""
    if shard.mesh is None:
        return x
    if attn_tp_enabled(cfg, shard.tp):
        return shard.enter(x)
    return M.gather_replicated(x, shard.mesh, "model", 1) if shard.sp else x


def _attention_tp(w, x, cfg, i, cache, offset, positions, paged, shard: Shard,
                  how=(True, True, None)):
    xin = shard.enter(x)
    b, s, d = xin.shape
    hl, hd = w["wq"].shape[1], cfg.hd
    q = linear(xin, w["wq"].reshape(d, hl * hd)).reshape(b, s, hl, hd)
    if cfg.qk_norm:
        q = qk_head_norm(q, shard.region(w["q_norm"]))
    if how[1]:
        q = rope(q, positions, cfg.rope_theta)
    k = v = None
    if how[2] is None:
        k, v = _local_kv(w, xin, cfg, shard, positions, how[1])
    out = _attend_how(i, q, k, v, cache, offset, paged, how).reshape(b, s, hl * hd)
    return shard.leave(linear(out, w["wo"].reshape(hl * hd, d)))


def _normal(gen: torch.Generator, shape, dtype, device, scale: float) -> torch.Tensor:
    return torch.randn(shape, generator=gen, dtype=dtype, device=device) * scale


def attention_init(gen: torch.Generator, cfg: ModelConfig, device) -> dict:
    """An attention block's (d, heads, hd) / (heads, hd, d) weights with the
    reference's init scales (and Qwen3's qk-norm gains under ``qk_norm``)."""
    d, h, kv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv, cfg.hd
    dt = cfg.tdtype
    s = 1.0 / math.sqrt(d)
    attn = {
        "wq": _normal(gen, (d, h, hd), dt, device, s),
        "wk": _normal(gen, (d, kv, hd), dt, device, s),
        "wv": _normal(gen, (d, kv, hd), dt, device, s),
        "wo": _normal(gen, (h, hd, d), dt, device, s / math.sqrt(h)),
    }
    if cfg.qk_norm:
        attn["q_norm"] = torch.ones((hd,), dtype=dt, device=device)
        attn["k_norm"] = torch.ones((hd,), dtype=dt, device=device)
    return attn


def mlp_init(gen: torch.Generator, cfg: ModelConfig, device) -> dict:
    """The FFN of ``cfg.act`` with the reference's init scales: SwiGLU's
    gate, up and down, or the two matrices of squared ReLU and GELU."""
    d, f, dt = cfg.d_model, cfg.d_ff, cfg.tdtype
    s_in, s_out = 1.0 / math.sqrt(d), 1.0 / math.sqrt(f)
    if cfg.act == "swiglu":
        return {"w_gate": _normal(gen, (d, f), dt, device, s_in),
                "w_up": _normal(gen, (d, f), dt, device, s_in),
                "w_down": _normal(gen, (f, d), dt, device, s_out)}
    return {"w_up": _normal(gen, (d, f), dt, device, s_in),
            "w_down": _normal(gen, (f, d), dt, device, s_out)}


def mlp_apply(p: dict, x: torch.Tensor, cfg: ModelConfig, shard: Shard = Shard()
              ) -> torch.Tensor:
    """The FFN of ``cfg.act``: SwiGLU (silu of the gate in float32, cast to
    x's dtype, times up), squared ReLU or tanh-form GELU (of up in float32,
    cast to x's dtype), then down.  On a mesh ``p`` holds this rank's
    columns of the inner dim (w_gate / w_up) and rows of w_down."""
    specs = mlp_specs(cfg)
    w = {k: shard.full(v, specs[k]) for k, v in p.items()}
    x = shard.enter(x)
    if cfg.act == "swiglu":
        h = silu_mul(linear(x, w["w_gate"]), linear(x, w["w_up"]), x.dtype)
    elif cfg.act == "squared_relu":
        r = F.relu(linear(x, w["w_up"]).float())
        h = (r * r).to(x.dtype)
    elif cfg.act == "gelu":  # jax.nn.gelu defaults to the tanh form
        h = F.gelu(linear(x, w["w_up"]).float(), approximate="tanh").to(x.dtype)
    else:
        raise ValueError(f"unknown activation {cfg.act!r}")
    return shard.leave(linear(h, w["w_down"]))


def topk_gates(logits: torch.Tensor, k: int):
    """(gates (T, k), expert ids (T, k)): the k largest router logits,
    largest first and ties to the lower expert id, as ``jax.lax.top_k``
    orders them (a stable sort: ``torch.topk`` promises no order among
    equal values), and the softmax over them."""
    vals, ids = torch.sort(logits, dim=-1, descending=True, stable=True)
    return torch.softmax(vals[..., :k], dim=-1), ids[..., :k]


def moe_apply_dense(p: dict, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """Every token through every expert, gated by the softmax of its top-k
    router logits (the reference's ``moe_apply_dense``): the router's
    float32 GEMM, the expert products batched over the expert axis in x's
    dtype, and the float32 gated combine, each over fixed blocks of
    ``ROW_BLOCK`` token rows (the last zero-padded), so that a row's bits
    do not depend on the call's row count.  Experts are stacked (E, d, f)
    and (E, f, d)."""
    b, s, d = x.shape
    e = cfg.n_experts
    wg, wu, wd = p["w_gate"], p["w_up"], p["w_down"]
    t = x.reshape(-1, d)
    outs = []
    block = t.shape[0] if x.device.type == "meta" else ROW_BLOCK  # the dry-run: one block
    for i in range(0, t.shape[0], block):
        tb = t[i:i + block]
        pad = block - tb.shape[0]
        tb = F.pad(tb, (0, 0, 0, pad)) if pad else tb
        gates, ids = topk_gates(tb.float() @ p["router"].float(), cfg.top_k)
        combine = torch.zeros((block, e), dtype=torch.float32, device=x.device)
        combine.scatter_(1, ids, gates)
        h = silu_mul(torch.matmul(tb, wg), torch.matmul(tb, wu), x.dtype)  # (E, T, f)
        y = torch.matmul(h, wd).float().permute(1, 2, 0)  # (T, d, E)
        outs.append(torch.matmul(y, combine[:, :, None])[:block - pad, :, 0])
    out = outs[0] if len(outs) == 1 else torch.cat(outs)
    return out.to(x.dtype).reshape(b, s, d)


def embed_lookup(tok: torch.Tensor, tokens: torch.Tensor, shard: Shard) -> torch.Tensor:
    """Rows of the embedding ``tok`` for ``tokens``; on a mesh ``tok`` is the
    rank's vocabulary block: a masked lookup, then the all-reduce over
    ``model`` that completes every row (exactly: one rank holds each)."""
    if shard.tp == 1:
        return tok[tokens.long()]
    n = tok.shape[0]
    local = tokens.long() - shard.r * n
    inside = (local >= 0) & (local < n)
    x = tok[torch.where(inside, local, torch.zeros_like(local))]
    x = torch.where(inside[..., None], x, torch.zeros_like(x))
    return M.all_reduce(x, shard.mesh, "model")


def embed_tokens(embed: dict, cfg: ModelConfig, tokens: torch.Tensor, shard: Shard
                 ) -> torch.Tensor:
    """Token embeddings in the model dtype; on a mesh from the rank's
    vocabulary block (its FSDP axis gathered)."""
    tok = shard.full(embed["tok"], embed_specs(cfg)["tok"])
    return embed_lookup(tok, tokens, shard).to(cfg.tdtype)


def lm_head(embed: dict, cfg: ModelConfig, x: torch.Tensor, shard: Shard,
            last_logit_only: bool = False) -> torch.Tensor:
    """Logits over the whole (padded) vocabulary, -1e9 past ``vocab``: on
    a mesh each rank's vocabulary block of the whole sequence, then
    gathered over ``model``.  ``last_logit_only`` keeps the last position
    (the reference's prefill cells)."""
    head = shard.full(embed["head"], embed_specs(cfg)["head"]).to(cfg.tdtype)
    x = shard.enter(x) if shard.tp > 1 else x
    if last_logit_only:
        x = x[:, -1:]
    logits = linear(x, head)
    logits = M.gather_replicated(logits, shard.mesh, "model", logits.dim() - 1)
    if cfg.vocab_padded != cfg.vocab:
        pad = torch.arange(cfg.vocab_padded, device=logits.device) >= cfg.vocab
        logits = logits.masked_fill(pad, -1e9)
    return logits


def topk_dispatch(t: torch.Tensor, router: torch.Tensor, cfg: ModelConfig, cap: int):
    """The GShard dispatch of tokens t (T, d): the top-k router gates, and
    for each (token, choice) its expert, its slot (its rank among the
    expert's choosers in token order, the cumulative one-hot) and whether
    it fits the capacity ``cap`` -> (flat_ids, slot, keep, flat_gates,
    flat_tok), each (T * k,)."""
    n_tok = t.shape[0]
    gates, ids = topk_gates(t.float() @ router.float(), cfg.top_k)
    flat_ids = ids.reshape(-1)
    onehot = F.one_hot(flat_ids, cfg.n_experts).to(torch.int32)
    slot = ((torch.cumsum(onehot, dim=0) - 1) * onehot).sum(-1)
    keep = slot < cap
    flat_tok = torch.arange(n_tok, device=t.device).repeat_interleave(cfg.top_k)
    return flat_ids, slot, keep, gates.reshape(-1), flat_tok


def moe_capacity(cfg: ModelConfig, n_tok: int) -> int:
    """Slots per (rank, expert): the reference's max(int(cf * T * k / E), 4)
    from the rank's own token count."""
    return max(int(cfg.capacity_factor * n_tok * cfg.top_k / cfg.n_experts), 4)


def moe_dispatch_a2a(t, router, cfg: ModelConfig, shard: Shard, experts):
    """GShard expert parallelism of tokens t (T, d): slots of capacity
    ``moe_capacity`` per expert, shipped over ``model``'s all-to-all to
    their (expert x ff slice) owners, ``experts(recv)`` on the owner's
    (e_loc, tp * cap, d) slots, shipped back, ff slices summed, and the
    gated combine in float32 (tokens past capacity drop to the residual).

    The owner orders its received slots expert-major, (e_loc, peer, cap):
    the all-to-all delivers them peer-major, (peer, e_loc, cap), so they
    are transposed before the expert GEMMs and back after them.  The
    reference reshapes without that transpose, which pairs expert e's
    weights with another expert's slots whenever a rank holds more than
    one expert (ROADMAP, reference notes).  Each token's k gated outputs
    add in choice order from zero, as the reference's scatter-add does on
    the CPU, with no atomics: the result does not depend on the run."""
    tp, e, d = shard.tp, cfg.n_experts, t.shape[-1]
    split = moe_ff_split(cfg, tp)
    e_loc = max(e // tp, 1)
    cap = moe_capacity(cfg, t.shape[0])
    flat_ids, slot, keep, flat_gates, flat_tok = topk_dispatch(t, router, cfg, cap)
    # a choice past capacity writes the spare last row, dropped: no
    # boolean indexing, so the trace needs no values (meta tensors)
    dest = torch.where(keep, flat_ids * cap + slot, torch.full_like(slot, e * cap))
    buf = torch.zeros((e * cap + 1, d), dtype=t.dtype, device=t.device)
    buf = buf.index_put((dest,), t[flat_tok])[:e * cap].reshape(e, cap, d)
    if split > 1:
        buf = torch.repeat_interleave(buf, split, dim=0)
    recv = M.all_to_all(buf.reshape(tp, e_loc, cap, d), shard.mesh, "model")
    y = experts(recv.transpose(0, 1).reshape(e_loc, tp * cap, d))
    y = y.reshape(e_loc, tp, cap, d).transpose(0, 1)
    back = M.all_to_all(y.contiguous(), shard.mesh, "model")
    back = back.reshape(e, split, cap, d).sum(dim=1) if split > 1 else back.reshape(e, cap, d)
    picked = back.reshape(e * cap, d)[(flat_ids * cap + slot.clamp(max=cap - 1))].float()
    contrib = torch.where(keep[:, None], picked * flat_gates[:, None], torch.zeros_like(picked))
    contrib = contrib.reshape(t.shape[0], cfg.top_k, d)
    out = torch.zeros((t.shape[0], d), dtype=torch.float32, device=t.device)
    for j in range(cfg.top_k):  # the reference's scatter-add order, no atomics
        out = out + contrib[:, j]
    return out.to(t.dtype)


def moe_apply_a2a(p: dict, x: torch.Tensor, cfg: ModelConfig, shard: Shard) -> torch.Tensor:
    """The bf16 expert-parallel MoE block on this rank's tokens x (B, S, d)
    (its sequence shard under sp, else the rows every model rank holds)
    and its experts p (e_loc, d, f / split) / (e_loc, f / split, d).

    Without sequence sharding every model rank dispatches the same tokens,
    so a backward would sum each expert's gradient tp times: autograd
    through that case raises."""
    if shard.tp > 1 and not shard.sp and torch.is_grad_enabled() and (
            x.requires_grad or any(v.requires_grad for v in p.values())):
        raise NotImplementedError(
            "moe_apply_a2a: no backward without sequence sharding (every model rank "
            "dispatches the same tokens, so each expert's gradient would count tp "
            "copies); train with seq_shard and S % tp == 0, or moe_impl='dense'")
    specs = moe_specs(cfg, shard.tp)
    w = {k: shard.full(v, specs[k]) for k, v in p.items()}
    b, s, d = x.shape
    router = shard.region(w["router"]) if shard.sp else w["router"]

    def experts(recv):
        h = silu_mul(torch.matmul(recv, w["w_gate"]), torch.matmul(recv, w["w_up"]), x.dtype)
        return torch.matmul(h, w["w_down"])

    return moe_dispatch_a2a(x.reshape(-1, d), router, cfg, shard, experts).reshape(b, s, d)


def moe_apply(p: dict, x: torch.Tensor, cfg: ModelConfig, shard: Shard = Shard()
              ) -> torch.Tensor:
    """The MoE block: the all-to-all expert-parallel path on a mesh when
    ``cfg.moe_impl`` is "a2a" (the reference's choice), else the dense
    combine (on a mesh over every expert, gathered over ``model``)."""
    if shard.mesh is None:
        return moe_apply_dense(p, x, cfg)
    if cfg.moe_impl == "a2a":
        return moe_apply_a2a(p, x, cfg, shard)
    specs = moe_specs(cfg, shard.tp)
    gather = M.all_gather if shard.sp else M.gather_replicated
    w = {k: shard.full(v, specs[k]) for k, v in p.items()}
    e = cfg.n_experts
    full = {"router": shard.region(w["router"]) if shard.sp else w["router"]}
    for name in ("w_gate", "w_up", "w_down"):
        t = gather(w[name], shard.mesh, "model", 0)
        es, a, b = t.shape
        split = es // e
        if name == "w_down":
            full[name] = t.reshape(e, split * a, b)
        else:
            full[name] = t.reshape(e, split, a, b).permute(0, 2, 1, 3).reshape(e, a, split * b)
    return moe_apply_dense(full, x, cfg)


def xent(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """Mean cross-entropy of logits (B, S, V), taken in float32, against
    targets (B, S): logsumexp minus the gold logit (the reference's
    ``loss_fn`` and ``whisper_loss_fn``)."""
    logits = logits.float()
    gold = torch.gather(logits, -1, targets.long()[..., None])[..., 0]
    return torch.mean(torch.logsumexp(logits, dim=-1) - gold)


def remat(fn, cfg: ModelConfig, cached: bool):
    """``fn`` under activation checkpointing (``use_reentrant=False``) where
    the reference remats a block: no cache, ``cfg.remat``, and autograd
    recording.  Recomputation changes no bit of the outputs or gradients."""
    if cached or not cfg.remat or not torch.is_grad_enabled():
        return fn
    return lambda *args: checkpoint(fn, *args, use_reentrant=False)

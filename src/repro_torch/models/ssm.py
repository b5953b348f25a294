"""Mamba2 (SSD, state-space duality) blocks: the chunked scan of training and
prefill, and the O(1)-state decode step (torch counterpart of
repro/models/ssm.py)  [arXiv:2405.21060].

Per head h the state evolves as
    S_t = exp(dt_t * A_h) * S_{t-1} + dt_t * B_t (x) u_t
    y_t = C_t . S_t + D_h * u_t
with B_t, C_t shared across head groups (``ssm_groups``).  The chunked
dual form runs an attention-like intra-chunk term and a chunk-level
recurrence; the port computes all of it in float32 (the intra-chunk
scores, the chunk states, the recurrence and the read-out) and returns y
in the input's dtype, with a Python loop over the chunks in place of the
reference's ``lax.scan``.  The depthwise causal conv is the reference's
shift-and-sum over the ``ssm_conv`` taps, never ``F.conv1d`` (cuDNN
convolutions may run in TF32 on the card).  The in and out projections
are ``layers.linear``: outside training a row's bits do not depend on the
row count, so a cached decode step projects as the chunked pass does.

On a mesh (``mamba_apply_sharded`` / ``mamba_decode_sharded``, a
``layers.Shard``) each rank holds the reference's blocks
(``mamba_specs``): contiguous cuts over ``model`` of w_in's output columns
[z | x | B | C | dt], of the conv's d_inner + 2 g n channels, of the
heads' A_log / D / dt_bias, of the norm's gain and of w_out's rows; under
FSDP w_in and w_out also over ``data``.  A contiguous cut of w_in's
columns or of the conv channels does not fall on head boundaries, so per
layer the rank all-gathers over ``model``, in one packed collective, its
in-projection columns, its conv weights' channels and its cached conv
history's channels, then takes its heads' z, x and dt and the B / C
groups every head reads; the SSD runs on its heads; the gated RMSNorm
over the whole d_inner all-reduces its sum of squares; w_out is
row-parallel (``Shard.leave``: an all-reduce, or a reduce-scatter onto
the sequence shards).  Three collectives a layer.  The ssm state
holds the rank's heads and the conv cache its contiguous channel block,
the reference's cache specs."""
from __future__ import annotations

import math
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.launch import mesh as M
from repro_torch.models.common import ModelConfig
from repro_torch.models.layers import Shard, linear, rmsnorm, row_mean_sq

Params = Dict[str, Any]

__all__ = ["mamba_init", "mamba_specs", "mamba_apply", "mamba_decode", "mamba_apply_sharded",
           "mamba_decode_sharded", "init_ssm_cache", "ssd_chunked"]


def mamba_init(gen: torch.Generator, cfg: ModelConfig, device) -> Params:
    """One mamba2 block's parameters with the reference's shapes and init
    scales, drawn from ``gen`` (whose device must match ``device``)."""
    d, din, h = cfg.d_model, cfg.d_inner, cfg.ssm_heads
    g, n = cfg.ssm_groups, cfg.ssm_state
    conv_ch = din + 2 * g * n
    dt = cfg.tdtype

    def normal(shape, scale):
        return torch.randn(shape, generator=gen, dtype=dt, device=device) * scale

    return {
        # in_proj -> [z (din), x (din), B (g*n), C (g*n), dt (h)]
        "w_in": normal((d, 2 * din + 2 * g * n + h), 1.0 / math.sqrt(d)),
        "conv_w": normal((cfg.ssm_conv, conv_ch), 0.2),
        "conv_b": torch.zeros((conv_ch,), dtype=dt, device=device),
        "A_log": torch.log(torch.linspace(1.0, 16.0, h, dtype=torch.float32, device=device)),
        "D": torch.ones((h,), dtype=torch.float32, device=device),
        "dt_bias": torch.zeros((h,), dtype=torch.float32, device=device),
        "w_out": normal((din, d), 1.0 / math.sqrt(din)),
        "norm": {"g": torch.ones((din,), dtype=dt, device=device)},
    }


def mamba_specs(cfg: ModelConfig) -> Params:
    """The reference's ``mamba_init`` specs: everything over ``model``,
    w_in / w_out also over ``data`` under FSDP."""
    fs = "data" if cfg.fsdp else None
    return {"w_in": (fs, "model"), "conv_w": (None, "model"), "conv_b": ("model",),
            "A_log": ("model",), "D": ("model",), "dt_bias": ("model",),
            "w_out": ("model", fs), "norm": {"g": ("model",)}}


def _split_in(proj: torch.Tensor, cfg: ModelConfig):
    din, g, n = cfg.d_inner, cfg.ssm_groups, cfg.ssm_state
    return proj[..., :din], proj[..., din:2 * din + 2 * g * n], proj[..., 2 * din + 2 * g * n:]


def _causal_conv_with_history(combined: torch.Tensor, s: int, w: torch.Tensor,
                              b: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv: ``combined`` (B, W-1+S, C) already carries the
    left history; the last ``s`` outputs (B, S, C), silu in float32."""
    out = combined[:, 0:s, :] * w[0]
    for i in range(1, w.shape[0]):
        out = out + combined[:, i:i + s, :] * w[i]
    return F.silu((out + b).float()).to(combined.dtype)


def _segsum(a: torch.Tensor) -> torch.Tensor:
    """a: (..., q) -> (..., q, q) segment sums out[.., i, j] = sum_{j < k <= i}
    a[.., k]: 0 on the diagonal, -inf above it, masked before any exp (the
    differences of a cumsum grow large and positive above the diagonal)."""
    q = a.shape[-1]
    cs = torch.cumsum(a, dim=-1)
    diff = cs[..., :, None] - cs[..., None, :]
    idx = torch.arange(q, device=a.device)
    mask = idx[:, None] >= idx[None, :]
    return torch.where(mask, diff, torch.full_like(diff, -math.inf))


def ssd_chunked(x: torch.Tensor, da: torch.Tensor, b_mat: torch.Tensor, c_mat: torch.Tensor,
                chunk: int, init_state: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (B, S, H, P) dt-scaled inputs, da (B, S, H) log-decays (negative),
    b_mat / c_mat (B, S, H, N) -> (y (B, S, H, P) in x's dtype, final state
    (B, H, P, N) float32).  S must be a multiple of min(chunk, S)."""
    bsz, s, h, p = x.shape
    n = b_mat.shape[-1]
    q = min(chunk, s)
    assert s % q == 0, (s, q)
    nc = s // q
    xr = x.float().reshape(bsz, nc, q, h, p)
    dar = da.float().reshape(bsz, nc, q, h)
    br = b_mat.float().reshape(bsz, nc, q, h, n)
    cr = c_mat.float().reshape(bsz, nc, q, h, n)

    # intra-chunk (diagonal) term: attention-like with the decay kernel
    ell = torch.exp(_segsum(dar.permute(0, 1, 3, 2)))  # (b, nc, h, q, q)
    scores = torch.einsum("bclhn,bcshn->bchls", cr, br)
    y_diag = torch.einsum("bchls,bcshp->bclhp", scores * ell, xr)

    # each chunk's contribution to the running state
    da_cum = torch.cumsum(dar, dim=2)  # (b, nc, q, h)
    da_total = da_cum[:, :, -1, :]  # (b, nc, h)
    decay_to_end = torch.exp(da_total[:, :, None, :] - da_cum)
    states = torch.einsum("bcshn,bcsh,bcshp->bchpn", br, decay_to_end, xr)

    # inter-chunk recurrence: prev[c] is the state before chunk c
    st = (init_state.float() if init_state is not None
          else torch.zeros((bsz, h, p, n), dtype=torch.float32, device=x.device))
    prev = []
    for c in range(nc):
        prev.append(st)
        st = states[:, c] + torch.exp(da_total[:, c])[:, :, None, None] * st
    prev_states = torch.stack(prev, dim=1)  # (b, nc, h, p, n)

    # off-diagonal term: the prior state read out through the decay
    y_off = torch.einsum("bclhn,bchpn,bclh->bclhp", cr, prev_states, torch.exp(da_cum))
    y = (y_diag + y_off).reshape(bsz, s, h, p)
    return y.to(x.dtype), st


def _expand_groups(m: torch.Tensor, heads: int) -> torch.Tensor:
    """(B, S, G, N) -> (B, S, H, N), each group repeated H/G times."""
    g = m.shape[2]
    return m if g == heads else torch.repeat_interleave(m, heads // g, dim=2)


def mamba_apply(params: Params, xin: torch.Tensor, cfg: ModelConfig,
                init_state: Optional[torch.Tensor] = None,
                conv_state: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Full-sequence SSD over xin (B, S, d) -> (y (B, S, d), final ssm state,
    conv tail).  ``conv_state`` (B, W-1, C) carries the previous window's
    last W-1 conv inputs so that an extend is exact; None is a fresh
    sequence."""
    bsz, s, _ = xin.shape
    h, p, n, g = cfg.ssm_heads, cfg.ssm_headdim, cfg.ssm_state, cfg.ssm_groups
    z, xbc, dt_raw = _split_in(linear(xin, params["w_in"]), cfg)
    width = cfg.ssm_conv
    if conv_state is None:
        conv_state = torch.zeros((bsz, width - 1, xbc.shape[-1]), dtype=xbc.dtype,
                                 device=xbc.device)
    combined = torch.cat([conv_state.to(xbc.dtype), xbc], dim=1)  # (B, W-1+S, C)
    conv_tail = combined[:, -(width - 1):, :]
    xbc = _causal_conv_with_history(combined, s, params["conv_w"], params["conv_b"])
    din = cfg.d_inner
    xpart = xbc[..., :din].reshape(bsz, s, h, p)
    b_mat = xbc[..., din:din + g * n].reshape(bsz, s, g, n)
    c_mat = xbc[..., din + g * n:].reshape(bsz, s, g, n)
    dt = F.softplus(dt_raw.float() + params["dt_bias"])  # (B, S, H)
    da = dt * -torch.exp(params["A_log"])
    x_scaled = xpart * dt[..., None].to(xpart.dtype)
    b_h, c_h = _expand_groups(b_mat, h), _expand_groups(c_mat, h)
    # pad S to a chunk multiple: zero inputs add nothing to the states and
    # a zero log-decay (exp(0) = 1) leaves the recurrence as it is (exact)
    q = min(cfg.ssm_chunk, s)
    pad = (-s) % q
    if pad:
        x_scaled = F.pad(x_scaled, (0, 0, 0, 0, 0, pad))
        b_h = F.pad(b_h, (0, 0, 0, 0, 0, pad))
        c_h = F.pad(c_h, (0, 0, 0, 0, 0, pad))
        da = F.pad(da, (0, 0, 0, pad))
    y, final_state = ssd_chunked(x_scaled, da, b_h, c_h, q, init_state)
    if pad:
        y = y[:, :s]
    y = y + params["D"].to(y.dtype)[None, None, :, None] * xpart
    y = y.reshape(bsz, s, din)
    y = rmsnorm(params["norm"], y * F.silu(z.float()).to(y.dtype))
    return linear(y, params["w_out"]), final_state, conv_tail


def init_ssm_cache(cfg: ModelConfig, batch: int, dtype, device) -> Dict[str, torch.Tensor]:
    """One block's recurrent cache: the float32 ssm state and the conv
    tail."""
    h, p, n, g = cfg.ssm_heads, cfg.ssm_headdim, cfg.ssm_state, cfg.ssm_groups
    conv_ch = cfg.d_inner + 2 * g * n
    return {
        "state": torch.zeros((batch, h, p, n), dtype=torch.float32, device=device),
        "conv": torch.zeros((batch, cfg.ssm_conv - 1, conv_ch), dtype=dtype, device=device),
    }


def mamba_decode(params: Params, xin: torch.Tensor, cfg: ModelConfig,
                 cache: Dict[str, torch.Tensor]) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """One-token recurrent step over xin (B, 1, d): O(1) state update, no KV
    growth.  Returns (y (B, 1, d), the new cache dict)."""
    bsz = xin.shape[0]
    h, p, n, g = cfg.ssm_heads, cfg.ssm_headdim, cfg.ssm_state, cfg.ssm_groups
    z, xbc_new, dt_raw = _split_in(linear(xin, params["w_in"]), cfg)
    # conv over [cached tail, new]: the newest output column, by the chunked
    # pass's shift-and-sum (the reference's einsum rounds once where the
    # taps' sum rounds per term: in bf16 a step would lose the chunked bits)
    window = torch.cat([cache["conv"].to(xbc_new.dtype), xbc_new], dim=1)  # (B, W, C)
    xbc = _causal_conv_with_history(window, 1, params["conv_w"], params["conv_b"])[:, 0]
    din = cfg.d_inner
    xpart = xbc[..., :din].reshape(bsz, h, p)
    b_h = torch.repeat_interleave(xbc[..., din:din + g * n].reshape(bsz, g, n), h // g, dim=1)
    c_h = torch.repeat_interleave(xbc[..., din + g * n:].reshape(bsz, g, n), h // g, dim=1)
    dt = F.softplus(dt_raw[:, 0].float() + params["dt_bias"])  # (B, H)
    decay = torch.exp(dt * -torch.exp(params["A_log"]))
    dbx = torch.einsum("bhp,bhn->bhpn", (xpart * dt[..., None].to(xpart.dtype)).float(),
                       b_h.float())
    state = cache["state"] * decay[:, :, None, None] + dbx
    y = torch.einsum("bhpn,bhn->bhp", state, c_h.float()).to(xin.dtype)
    y = y + params["D"].to(y.dtype)[None, :, None] * xpart
    y = y.reshape(bsz, 1, din)
    y = rmsnorm(params["norm"], y * F.silu(z.float()).to(y.dtype))
    return linear(y, params["w_out"]), {"state": state, "conv": window[:, 1:, :]}


# ---------------------------------------------------------------------------
# On a mesh
# ---------------------------------------------------------------------------


def _rank_cut(cfg: ModelConfig, shard: Shard):
    """(heads per rank, d_inner per rank, this rank's first head); the
    model axis must divide the heads."""
    h, tp = cfg.ssm_heads, shard.tp
    if h % tp or (cfg.d_inner + 2 * cfg.ssm_groups * cfg.ssm_state) % tp:
        raise ValueError(f"{cfg.name}: {h} ssm heads (and their conv channels) do not split "
                         f"over {tp} model ranks")
    hl = h // tp
    return hl, hl * cfg.ssm_headdim, shard.r * hl


def _rank_channels(full: torch.Tensor, cfg: ModelConfig, shard: Shard) -> torch.Tensor:
    """This rank's conv channels of a tensor over all d_inner + 2 g n:
    its heads' x channels, then every B / C channel."""
    _, dl, h0 = _rank_cut(cfg, shard)
    x0 = h0 * cfg.ssm_headdim
    return torch.cat([full[..., x0:x0 + dl], full[..., cfg.d_inner:]], dim=-1)


def _gather_packed(parts, shard: Shard):
    """One all-gather over ``model`` of several tensors of one dtype, each
    cut over ``model`` along its last dimension: packed flat, gathered, and
    each returned whole (the ranks' blocks joined along its last
    dimension); None stays None."""
    live = [t for t in parts if t is not None]
    flat = torch.cat([t.reshape(1, -1) for t in live], dim=1)
    full = M.all_gather(flat, shard.mesh, "model", 0)  # (tp, n)
    out, at = [], 0
    for t in parts:
        if t is None:
            out.append(None)
            continue
        n = t.numel()
        blocks = full[:, at:at + n].reshape((shard.tp,) + tuple(t.shape))
        out.append(torch.cat(blocks.unbind(0), dim=-1))
        at += n
    return out


def _rank_inputs(params: Params, z_in: torch.Tensor, cfg: ModelConfig, shard: Shard,
                 conv_state: Optional[torch.Tensor]):
    """The rank's shard of the block's inputs, from one all-gather over
    ``model`` of its in-projection columns, its conv weights' channels and
    its cached conv history's channels: (z of its heads, xbc over all
    channels, dt_raw of its heads, the conv weights and bias of its
    channels, the conv history over all channels or None)."""
    specs = mamba_specs(cfg)
    hl, dl, h0 = _rank_cut(cfg, shard)
    din, gn = cfg.d_inner, cfg.ssm_groups * cfg.ssm_state
    w_in = shard.full(params["w_in"], specs["w_in"])
    proj = linear(shard.enter(z_in), w_in)
    conv = conv_state.to(proj.dtype) if conv_state is not None else None
    proj, conv_w, conv_b, conv = _gather_packed(
        [proj, params["conv_w"].to(proj.dtype), params["conv_b"].to(proj.dtype), conv], shard)
    z = proj[..., h0 * cfg.ssm_headdim:h0 * cfg.ssm_headdim + dl]
    xbc = proj[..., din:2 * din + 2 * gn]
    dt_raw = proj[..., 2 * din + 2 * gn + h0:2 * din + 2 * gn + h0 + hl]
    return (z, xbc, dt_raw, _rank_channels(conv_w, cfg, shard),
            _rank_channels(conv_b, cfg, shard), conv)


def _rank_bc(xbc: torch.Tensor, cfg: ModelConfig, shard: Shard):
    """(x of the rank's heads (..., hl, P), B and C of its heads (..., hl,
    N)) from its conv output (..., dl + 2 g n)."""
    hl, dl, h0 = _rank_cut(cfg, shard)
    g, n, h, p = cfg.ssm_groups, cfg.ssm_state, cfg.ssm_heads, cfg.ssm_headdim
    lead = xbc.shape[:-1]
    xpart = xbc[..., :dl].reshape(*lead, hl, p)
    bc = [torch.repeat_interleave(xbc[..., dl + i * g * n:dl + (i + 1) * g * n].reshape(
        *lead, g, n), h // g, dim=-2)[..., h0:h0 + hl, :] for i in (0, 1)]
    return xpart, bc[0], bc[1]


def _rank_out(params: Params, y: torch.Tensor, z: torch.Tensor, cfg: ModelConfig,
              shard: Shard, eps: float = 1e-6) -> torch.Tensor:
    """The gated RMSNorm over the whole d_inner (the rank's sum of squares
    all-reduced over ``model``; the sum's gradient reaches every rank),
    then the row-parallel w_out and the reduction over ``model``."""
    _, dl, _ = _rank_cut(cfg, shard)
    yg = y * F.silu(z.float()).to(y.dtype)
    xf = yg.float()
    ss = M.copy_to_region(M.all_reduce(row_mean_sq(xf) * dl, shard.mesh, "model"),
                          shard.mesh, "model")
    yn = (xf * torch.rsqrt(ss / cfg.d_inner + eps) * params["norm"]["g"].float()).to(y.dtype)
    w_out = shard.full(params["w_out"], mamba_specs(cfg)["w_out"])
    return shard.leave(linear(yn, w_out))


def _full_conv(conv: Optional[torch.Tensor], bsz: int, like: torch.Tensor,
               cfg: ModelConfig) -> torch.Tensor:
    """The conv history over all channels (B, W-1, C): the gathered cache,
    or zeros for a fresh sequence."""
    if conv is not None:
        return conv
    c = cfg.d_inner + 2 * cfg.ssm_groups * cfg.ssm_state
    return torch.zeros((bsz, cfg.ssm_conv - 1, c), dtype=like.dtype, device=like.device)


def _conv_block(tail: torch.Tensor, cfg: ModelConfig, shard: Shard) -> torch.Tensor:
    """This rank's contiguous block of a conv history over all channels."""
    c = tail.shape[-1] // shard.tp
    return tail[..., shard.r * c:(shard.r + 1) * c]


def mamba_apply_sharded(params: Params, xin: torch.Tensor, cfg: ModelConfig, shard: Shard,
                        init_state: Optional[torch.Tensor] = None,
                        conv_state: Optional[torch.Tensor] = None
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``mamba_apply`` on this rank's shard (``params``: the rank's blocks
    under ``mamba_specs``; ``xin``: its stream, sequence-sharded under
    ``shard.sp``; ``init_state`` (B, hl, P, N) its heads' state;
    ``conv_state`` (B, W-1, C / tp) its conv block) -> (its part of the
    output, reduced over ``model``; its heads' final state; its block of
    the new conv history)."""
    hl, dl, h0 = _rank_cut(cfg, shard)
    p, width = cfg.ssm_headdim, cfg.ssm_conv
    z, xbc_all, dt_raw, conv_w, conv_b, conv = _rank_inputs(params, xin, cfg, shard, conv_state)
    bsz, s = xbc_all.shape[:2]
    combined = torch.cat([_full_conv(conv, bsz, xbc_all, cfg), xbc_all], dim=1)
    conv_tail = _conv_block(combined[:, -(width - 1):, :], cfg, shard)
    xbc = _causal_conv_with_history(_rank_channels(combined, cfg, shard), s, conv_w, conv_b)
    xpart, b_h, c_h = _rank_bc(xbc, cfg, shard)
    dt = F.softplus(dt_raw.float() + params["dt_bias"])
    da = dt * -torch.exp(params["A_log"])
    x_scaled = xpart * dt[..., None].to(xpart.dtype)
    q = min(cfg.ssm_chunk, s)
    pad = (-s) % q
    if pad:
        x_scaled = F.pad(x_scaled, (0, 0, 0, 0, 0, pad))
        b_h = F.pad(b_h, (0, 0, 0, 0, 0, pad))
        c_h = F.pad(c_h, (0, 0, 0, 0, 0, pad))
        da = F.pad(da, (0, 0, 0, pad))
    y, final_state = ssd_chunked(x_scaled, da, b_h, c_h, q, init_state)
    if pad:
        y = y[:, :s]
    y = (y + params["D"].to(y.dtype)[None, None, :, None] * xpart).reshape(bsz, s, dl)
    return _rank_out(params, y, z, cfg, shard), final_state, conv_tail


def mamba_decode_sharded(params: Params, xin: torch.Tensor, cfg: ModelConfig, shard: Shard,
                         cache: Dict[str, torch.Tensor]
                         ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """``mamba_decode`` on this rank's shard; ``cache`` holds its heads'
    state and its conv block."""
    hl, dl, _ = _rank_cut(cfg, shard)
    z, xbc_new, dt_raw, conv_w, conv_b, conv = _rank_inputs(params, xin, cfg, shard,
                                                             cache["conv"])
    bsz = xbc_new.shape[0]
    window = torch.cat([_full_conv(conv, bsz, xbc_new, cfg), xbc_new], dim=1)
    xbc = _causal_conv_with_history(_rank_channels(window, cfg, shard), 1, conv_w, conv_b)[:, 0]
    xpart, b_h, c_h = _rank_bc(xbc, cfg, shard)
    dt = F.softplus(dt_raw[:, 0].float() + params["dt_bias"])
    decay = torch.exp(dt * -torch.exp(params["A_log"]))
    dbx = torch.einsum("bhp,bhn->bhpn", (xpart * dt[..., None].to(xpart.dtype)).float(),
                       b_h.float())
    state = cache["state"] * decay[:, :, None, None] + dbx
    y = torch.einsum("bhpn,bhn->bhp", state, c_h.float()).to(xin.dtype)
    y = (y + params["D"].to(y.dtype)[None, :, None] * xpart).reshape(bsz, 1, dl)
    return (_rank_out(params, y, z, cfg, shard),
            {"state": state, "conv": _conv_block(window[:, 1:, :], cfg, shard)})

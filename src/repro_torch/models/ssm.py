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
row count, so a cached decode step projects as the chunked pass does."""
from __future__ import annotations

import math
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.models.common import ModelConfig
from repro_torch.models.layers import linear, rmsnorm

Params = Dict[str, Any]

__all__ = ["mamba_init", "mamba_apply", "mamba_decode", "init_ssm_cache", "ssd_chunked"]


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

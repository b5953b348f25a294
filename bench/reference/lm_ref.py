"""The plain reference of a dense decoder (a served pair's target or its
draft): float32, one layer at a time, over whole sequences (prompt and
served tokens), causal.

Its caller hands it each layer's weights in the benchmark's dense layout
(remade from the seed by ``benchkit.weights``, or a BVQ draft's linears
decoded by ``bvq_decode``), and it derives what the program derives from
them on its own:

* ``bf16`` targets: the bfloat16 weights widened to float32.
* ``w4a8`` targets (the paper's W4A8 + LRU): the RMSNorm gains folded into
  the next linears, the residual stream rotated by R1 (d_model) and the
  FFN's inner activation by R2 (d_ff), as the configuration's ``lru``
  plans state; every linear, the head included, quantized to int4 per
  output channel (absmax / 7) and its input to int8 per token (absmax /
  127), both round-half-even, computed in float32 on the dequantized
  values.

``precision="control"`` is the same model one step lower: W4A4 for a
W4A8 target (4-bit activations), float8 e4m3 weights and activations (per
channel / per token absmax scales) for a bf16 one.  TF32 is switched off.

Layer equations (Qwen3 / Nemotron-4 dense blocks, pre-norm): x += attn(
norm(x)); x += mlp(norm(x)); logits = head(norm(x)).  Attention: GQA,
optional per-head RMSNorm of q and k (Qwen3), rotary embedding on the two
halves of each head (theta from the config), softmax(q k^T / sqrt(hd)).
MLP: SwiGLU (silu(g) * u) or squared ReLU.  Imports nothing of the program.
"""
from __future__ import annotations

import math
from typing import Callable, List, Optional, Sequence

import numpy as np
import torch

from benchkit.spec import ModelSpec
from reference import hadamard

Q_BLOCK = 1024  # queries per attention block


def _div(x: torch.Tensor, v: float) -> torch.Tensor:
    return x / torch.tensor(v, dtype=x.dtype, device=x.device)


def _int_q(x: torch.Tensor, dim: int, qmax: int) -> torch.Tensor:
    """Symmetric absmax quantization along ``dim``, dequantized."""
    s = torch.clamp(_div(x.abs().amax(dim=dim, keepdim=True), qmax), min=1e-8)
    return torch.clamp(torch.round(x / s), -qmax, qmax) * s


def _fp8_q(x: torch.Tensor, dim: int) -> torch.Tensor:
    s = torch.clamp(_div(x.abs().amax(dim=dim, keepdim=True), 448.0), min=1e-12)
    return (x / s).to(torch.float8_e4m3fn).float() * s


class _Numerics:
    """How weights and activations are rounded before each linear."""

    def __init__(self, mode: str, precision: str):
        self.mode, self.precision = mode, precision
        if mode not in ("w4a8", "bf16") or precision not in ("program", "control"):
            raise ValueError(f"numerics {mode}/{precision}")

    def weight(self, w: torch.Tensor) -> torch.Tensor:  # (K, N), per output channel
        if self.mode == "w4a8":
            return _int_q(w, 0, 7)
        return _fp8_q(w, 0) if self.precision == "control" else w

    def act(self, x: torch.Tensor) -> torch.Tensor:  # per token
        if self.mode == "w4a8":
            return _int_q(x, -1, 127 if self.precision == "program" else 7)
        return _fp8_q(x, -1) if self.precision == "control" else x

    def linear(self, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        return self.act(x) @ w


def _rms(x: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps)


def _rope(x: torch.Tensor, pos: torch.Tensor, theta: float) -> torch.Tensor:
    half = x.shape[-1] // 2
    freqs = torch.exp(-math.log(theta) * torch.arange(half, dtype=torch.float32,
                                                      device=x.device) / half)
    ang = pos[:, None].float() * freqs
    cos, sin = torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def _attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Causal GQA over one sequence: q (n, h, hd), k / v (n, kv, hd)."""
    n, h, hd = q.shape
    rep = h // k.shape[1]
    k = k.repeat_interleave(rep, dim=1).transpose(0, 1)  # (h, n, hd)
    v = v.repeat_interleave(rep, dim=1).transpose(0, 1)
    qt = q.transpose(0, 1) / math.sqrt(hd)
    out = torch.empty_like(qt)
    for i in range(0, n, Q_BLOCK):
        j = min(n, i + Q_BLOCK)
        s = qt[:, i:j] @ k[:, :j].transpose(1, 2)
        mask = torch.arange(j, device=q.device)[None, :] > torch.arange(i, j, device=q.device)[:, None]
        s = s.masked_fill(mask, float("-inf"))
        out[:, i:j] = torch.softmax(s, dim=-1) @ v[:, :j]
    return out.transpose(0, 1).reshape(n, h * hd)


def _layer_weights(mode: str, lru: Optional[dict], spec: ModelSpec, lp: dict,
                   num: _Numerics) -> dict:
    """A layer's float32 linears as the forward multiplies them."""
    d, h, kv, hd = spec.d_model, spec.n_heads, spec.n_kv, spec.head_dim
    a, m = lp["attn"], lp["mlp"]
    w = {"wq": a["wq"].reshape(d, h * hd), "wk": a["wk"].reshape(d, kv * hd),
         "wv": a["wv"].reshape(d, kv * hd), "wo": a["wo"].reshape(h * hd, d)}
    w.update(m)
    w = {k: t.float() for k, t in w.items()}
    g1, g2 = lp["ln1"]["g"].float()[:, None], lp["ln2"]["g"].float()[:, None]
    if mode == "w4a8":
        r1, r2 = lru["d_model"], lru["d_ff"]
        rin1 = lambda t: hadamard.rotate(t.T.contiguous(), r1).T  # noqa: E731  R1^T t
        for k in ("wq", "wk", "wv"):
            w[k] = rin1(w[k] * g1)
        w["wo"] = hadamard.rotate(w["wo"], r1)
        for k in ("w_gate", "w_up"):
            if k in w:
                w[k] = rin1(w[k] * g2)
        w["w_down"] = hadamard.rotate(hadamard.rotate(w["w_down"], r1).T.contiguous(), r2).T
    else:
        for k in ("wq", "wk", "wv"):
            w[k] = w[k] * g1
        for k in ("w_gate", "w_up"):
            if k in w:
                w[k] = w[k] * g2
    out = {k: num.weight(t.contiguous()) for k, t in w.items()}
    if spec.qk_norm:
        out["q_norm"], out["k_norm"] = a["q_norm"].float(), a["k_norm"].float()
    return out


def _block(x: torch.Tensor, lens: Sequence[int], w: dict, spec: ModelSpec, num: _Numerics,
           r2: Optional[dict] = None) -> torch.Tensor:
    """One pre-norm block over the concatenated sequences; ``r2`` rotates
    the FFN's inner activation (the W4A8 target's online R2)."""
    h, kv, hd = spec.n_heads, spec.n_kv, spec.head_dim
    z = _rms(x, spec.eps)
    q = num.linear(z, w["wq"]).reshape(-1, h, hd)
    k = num.linear(z, w["wk"]).reshape(-1, kv, hd)
    v = num.linear(z, w["wv"]).reshape(-1, kv, hd)
    if spec.qk_norm:
        q, k = _rms(q, spec.eps) * w["q_norm"], _rms(k, spec.eps) * w["k_norm"]
    att, o = [], 0
    for n in lens:
        pos = torch.arange(n, device=x.device)
        att.append(_attention(_rope(q[o:o + n], pos, spec.rope_theta),
                              _rope(k[o:o + n], pos, spec.rope_theta), v[o:o + n]))
        o += n
    x = x + num.linear(torch.cat(att), w["wo"])
    z = _rms(x, spec.eps)
    if spec.act == "swiglu":
        hid = torch.nn.functional.silu(num.linear(z, w["w_gate"])) * num.linear(z, w["w_up"])
    else:
        hid = torch.relu(num.linear(z, w["w_up"])) ** 2
    if r2 is not None:
        hid = hadamard.rotate(hid, r2)
    return x + num.linear(hid, w["w_down"])


@torch.no_grad()
def logits_at(spec: ModelSpec, mode: str, lru: Optional[dict], layer: Callable[[int], dict],
              emb: dict, seqs: Sequence[np.ndarray], rows: Sequence[np.ndarray], device,
              precision: str = "program") -> List[torch.Tensor]:
    """For each sequence (token ids) the float32 logits at its ``rows``
    (positions, each predicting the token after it), (len(rows), V).
    ``layer(i)`` gives layer i's weights, ``emb`` the token table, head
    and final norm gain (``benchkit.weights``' layout); ``mode`` is how the
    program serves them (``w4a8`` or ``bf16``), ``lru`` a W4A8 model's
    rotation plans."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    num = _Numerics(mode, precision)
    lens = [len(s) for s in seqs]
    toks = torch.as_tensor(np.concatenate(seqs).astype(np.int64), device=device)
    r2 = lru["d_ff"] if mode == "w4a8" else None
    x = emb["tok"][toks].float()
    if mode == "w4a8":
        x = hadamard.rotate(x, lru["d_model"])
    head = emb["head"].float() * emb["final_g"].float()[:, None]
    del emb
    for i in range(spec.n_layers):
        lp = layer(i)
        w = _layer_weights(mode, lru, spec, lp, num)
        del lp
        x = _block(x, lens, w, spec, num, r2)
        del w
    if mode == "w4a8":
        head = hadamard.rotate(head.T.contiguous(), lru["d_model"]).T
    head = num.weight(head.contiguous())
    flat, o = [], 0
    for n, r in zip(lens, rows):
        flat.append(torch.as_tensor(np.asarray(r, np.int64) + o, device=device))
        o += n
    logits = num.linear(_rms(x[torch.cat(flat)], spec.eps), head)
    return list(torch.split(logits, [len(r) for r in rows]))


def bvq_decode(cb: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """The (K, N) weight of BVQ codebooks cb (nb, C, v) and indices idx
    (nb, K / v, bc): W[r v + t, j bc + c] = cb[j, idx[j, r, c], t]."""
    nb, _, v = cb.shape
    _, rows, bc = idx.shape
    w = torch.stack([cb[j][idx[j].long()] for j in range(nb)])  # (nb, rows, bc, v)
    return w.permute(1, 3, 0, 2).reshape(rows * v, nb * bc).float()

"""The benchmark's weights, made from ``--seed`` on the device.

Every part of a model (the embedding and head, each layer) has a random
stream of its own, so the program's pair and the reference can each
remake any part alone: same seed, same role, same part, same device give
the same bits.  Each part is drawn in one ``torch.randn`` call in the type
it is served in (bfloat16) and cut into views.

The layout is the one the program's dense forward takes: per layer
``ln1``/``ln2`` gains, ``attn`` with wq (d, h, hd), wk / wv (d, kv, hd),
wo (h, hd, d) and, with qk-norm, the per-head gains; ``mlp`` with w_gate /
w_up (d, f) and w_down (f, d) for SwiGLU, w_up / w_down for squared ReLU.
The init scales are the usual 1/sqrt(fan-in) (wo also over sqrt(h)), 0.02
for the token table; norm gains are ones.  Pure torch and numpy: nothing
here imports the program.
"""
from __future__ import annotations

import math
from typing import Dict

import numpy as np
import torch

from benchkit.spec import ModelSpec

ROLES = {"target": 1, "draft": 2, "bvq": 3}
EMBED_PART = 1 << 20  # the part id of the embedding table and head


def stream_seed(seed: int, role: str, part: int) -> int:
    """A 63-bit generator seed for (run seed, role, part)."""
    ss = np.random.SeedSequence([int(seed) % (1 << 64), ROLES[role], int(part)])
    lo, hi = (int(v) for v in ss.generate_state(2, np.uint32))
    return ((hi << 32) | lo) & ((1 << 63) - 1)


def generator(seed: int, role: str, part: int, device) -> torch.Generator:
    return torch.Generator(device=torch.device(device)).manual_seed(stream_seed(seed, role, part))


def _draw(sizes, seed: int, role: str, part: int, device, dtype) -> Dict[str, torch.Tensor]:
    """One randn call over every named (shape, scale) of a part."""
    total = sum(math.prod(shape) for shape, _ in sizes.values())
    flat = torch.randn(total, generator=generator(seed, role, part, device), dtype=dtype,
                       device=device)
    out, o = {}, 0
    for name, (shape, scale) in sizes.items():
        n = math.prod(shape)
        out[name] = flat[o:o + n].view(shape) * scale
        o += n
    return out


def layer(spec: ModelSpec, seed: int, role: str, i: int, device) -> dict:
    """Layer ``i`` of the model ``role`` ("target" or "draft")."""
    d, h, kv, hd, f = spec.d_model, spec.n_heads, spec.n_kv, spec.head_dim, spec.d_ff
    s = 1.0 / math.sqrt(d)
    sizes = {"wq": ((d, h, hd), s), "wk": ((d, kv, hd), s), "wv": ((d, kv, hd), s),
             "wo": ((h, hd, d), s / math.sqrt(h))}
    if spec.act == "swiglu":
        sizes["w_gate"] = ((d, f), s)
    sizes["w_up"] = ((d, f), s)
    sizes["w_down"] = ((f, d), 1.0 / math.sqrt(f))
    w = _draw(sizes, seed, role, i, device, spec.dtype)
    ones = lambda n: torch.ones((n,), dtype=spec.dtype, device=device)  # noqa: E731
    attn = {k: w[k] for k in ("wq", "wk", "wv", "wo")}
    if spec.qk_norm:
        attn["q_norm"], attn["k_norm"] = ones(hd), ones(hd)
    mlp = {k: w[k] for k in ("w_gate", "w_up", "w_down") if k in w}
    return {"ln1": {"g": ones(d)}, "attn": attn, "ln2": {"g": ones(d)}, "mlp": mlp}


def embed(spec: ModelSpec, seed: int, role: str, device) -> dict:
    """The token table (V, d), the head (d, V) and the final norm gain."""
    d, v = spec.d_model, spec.vocab
    w = _draw({"tok": ((v, d), 0.02), "head": ((d, v), 1.0 / math.sqrt(d))}, seed, role,
              EMBED_PART, device, spec.dtype)
    return {"tok": w["tok"], "head": w["head"],
            "final_g": torch.ones((d,), dtype=spec.dtype, device=device)}

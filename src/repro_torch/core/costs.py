"""The port's FLOP / byte count of one serving program.

The reference stamps each profiled program with XLA's ``cost_analysis()``;
the port has no compiler to ask, so it counts the work itself from the
model's shapes, its weights as stored and the KV the program touches.
``Engine._profiled`` charges every profiled call its own count, and
``Engine.profile_summary`` reports the mean per call, so that
``bytes * calls / wall_s`` is the achieved rate of the calls it timed.

A model here is anything with ``.cfg`` (a ``ModelConfig``) and ``.params``
(its params tree); a store is one paged KV pool's dict of device arrays,
each (L, P, page_size, ...), as ``paged_cache.device_pool_store`` makes it.

``w4a8_bytes``, ``rotate_bytes`` and ``decode_int8_bytes`` are the bytes
one call of K1, K2 and K7 moves, each input read once and each output
written once, in the forms the kernels read them: the int4 weight packed
two to a byte with its float32 scales, the int8 cache with its float32
scales.  The dry-run (``launch/dryrun.py``) charges them to a kernel call
traced on meta tensors in place of the plain version's ops (which widen
the weight and the cache to float).
"""
from __future__ import annotations

import dataclasses
from typing import Dict

import numpy as np
import torch

__all__ = ["w4a8_bytes", "rotate_bytes", "decode_int8_bytes", "tensor_bytes", "linear_params",
           "kv_token_bytes", "program_cost", "window_cost", "prefill_cost", "compaction_cost"]


def w4a8_bytes(m: int, k: int, n: int) -> int:
    """K1 on (M, K) int8 codes and a (K, N) int4 weight: the codes, the
    packed weight (K * N / 2), the row and channel scales (float32) and
    the (M, N) float32 (or int32) output."""
    return m * k + k * n // 2 + 4 * m + 4 * n + 4 * m * n


def rotate_bytes(m: int, n: int, esize: int) -> int:
    """K2 on M rows of n elements of ``esize`` bytes: read and written."""
    return 2 * m * n * esize


def decode_int8_bytes(b: int, s: int, kvs: int, g: int, hd: int, q_esize: int) -> int:
    """K7 for (B, KVS, G, hd) queries over S cached tokens: the queries, the
    int8 K and V, their float32 per-(token, head) scales, the length and
    the float32 output."""
    return (b * kvs * g * hd * q_esize + 2 * b * s * kvs * hd + 2 * 4 * b * s * kvs + 4
            + 4 * b * kvs * g * hd)


def tensor_bytes(tree) -> int:
    """Bytes of every tensor in a params tree (dicts, lists, dataclasses
    such as BVQWeight): the weights as stored."""
    if isinstance(tree, torch.Tensor):
        return tree.numel() * tree.element_size()
    if isinstance(tree, dict):
        return sum(tensor_bytes(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(tensor_bytes(v) for v in tree)
    if dataclasses.is_dataclass(tree):
        return sum(tensor_bytes(getattr(tree, f.name)) for f in dataclasses.fields(tree))
    return 0


def _embed_table(params) -> torch.Tensor:
    """The token-embedding table of a params tree (the W4A8 and BVQ forms
    keep it at ``params["embed"]``, the dense form at ``["embed"]["tok"]``)."""
    emb = params["embed"]
    return emb["tok"] if isinstance(emb, dict) else emb


def linear_params(cfg) -> int:
    """Parameters of every linear a token's forward runs: per layer the q,
    k and v projections (k and v over the ``n_kv`` heads of GQA) and o,
    then the FFN: gate, up and down of a SwiGLU MLP, up and down of a
    two-matrix (squared-ReLU, GELU) one, or in the MoE family the f32
    router and every expert's gate, up and down (the dense combine runs
    each token through every expert); plus the LM head."""
    d, hd, f = cfg.d_model, cfg.hd, cfg.d_ff
    attn = d * (cfg.n_heads + 2 * cfg.n_kv) * hd + cfg.n_heads * hd * d
    if cfg.n_experts:
        ffn = d * cfg.n_experts + 3 * d * f * cfg.n_experts
    else:
        ffn = (3 if cfg.act == "swiglu" else 2) * d * f
    return cfg.n_layers * (attn + ffn) + d * cfg.vocab_padded


def kv_token_bytes(store: Dict[str, torch.Tensor]) -> int:
    """Bytes one cached token occupies in one layer of a store: K and V
    (and, for int8, their scales) over every kv head."""
    return sum(a[0, 0, 0].numel() * a.element_size() for a in store.values())


def program_cost(model, store: Dict[str, torch.Tensor], rows: int, keys: int, kv_read: int,
                 kv_written: int) -> Dict[str, float]:
    """FLOPs and bytes of one forward of ``model``:

    * FLOPs = 2 · P_lin · rows + 4 · n_layers · n_heads · hd · keys, where
      P_lin counts every linear's parameters (``linear_params``), rows the
      tokens the forward runs (every batch row times the window, the
      masked rows too: they are computed) and keys the (query, key) pairs
      its attention scores, the score and the value product 2 FLOPs each;
    * bytes = the weights as stored (``tensor_bytes``: packed int4 plus
      scales, BVQ indices plus codebooks and scales, bf16 tensors) less the
      embedding table, plus the ``rows`` embedding rows gathered, plus the
      KV read and written: (kv_read + kv_written) tokens times
      ``kv_token_bytes(store)`` per layer, over every layer."""
    cfg = model.cfg
    table = _embed_table(model.params)
    weights = tensor_bytes(model.params) - table.numel() * table.element_size()
    gathered = rows * table.shape[-1] * table.element_size()
    kv = (kv_read + kv_written) * cfg.n_layers * kv_token_bytes(store)
    flops = 2.0 * linear_params(cfg) * rows + 4.0 * cfg.n_layers * cfg.n_heads * cfg.hd * keys
    return {"flops": float(flops), "bytes": float(weights + gathered + kv)}


def window_cost(model, store: Dict[str, torch.Tensor], lengths, width: int) -> Dict[str, float]:
    """``program_cost`` of one paged forward over a (B, width) window: row b
    holds ``lengths[b]`` committed tokens, its query w attends its
    ``lengths[b] + w + 1`` keys (causal, or fewer under a tree mask: the
    count is the causal bound), reads ``lengths[b] + width`` tokens of KV
    and writes ``width``."""
    lengths = np.asarray(lengths, np.int64)
    b = lengths.shape[0]
    keys = int(width * lengths.sum() + b * width * (width + 1) // 2)
    return program_cost(model, store, b * width, keys, int(lengths.sum()) + b * width,
                        b * width)


def prefill_cost(model, store: Dict[str, torch.Tensor], prompt_len: int,
                 matched: int) -> Dict[str, float]:
    """``program_cost`` of one request's prefill: the rows of
    prompt[matched:-1] (a prefix-cache hit covers the first ``matched``),
    causal over the prompt, the matched rows read."""
    rows = max(prompt_len - 1 - matched, 0)
    keys = rows * matched + rows * (rows + 1) // 2
    return program_cost(model, store, rows, keys, matched + rows, rows)


def compaction_cost(model, store: Dict[str, torch.Tensor], moved: int) -> Dict[str, float]:
    """A tree compaction copies ``moved`` tokens' KV within one store, every
    layer: read once, written once, no FLOPs."""
    return {"flops": 0.0, "bytes": float(2 * moved * model.cfg.n_layers * kv_token_bytes(store))}

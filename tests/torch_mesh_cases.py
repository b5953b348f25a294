"""Rank functions of the mesh tests: each runs on every rank of a world
started by ``repro_torch.launch.mesh.spawn`` and returns what the test
compares in the parent.  This module imports torch, numpy and the port
only (no JAX), so the spawned ranks start fast; the tests hold the
results to the JAX package in the parent process."""
from __future__ import annotations

import dataclasses
import os

import numpy as np
import torch

from repro_torch.core.tree import tree_map
from repro_torch.models import convert
from repro_torch.models import lm
from repro_torch.models.common import ModelConfig
from repro_torch.serving import quantized_lm as qlm


def with_fields(cfg: ModelConfig, **kw) -> ModelConfig:
    return dataclasses.replace(cfg, **kw)


def _rows(mesh, x):
    return lm.local_rows(torch.as_tensor(np.asarray(x)), mesh)


def _keeps_rows(mesh, batch: int):
    """The first global row this rank holds (None where the parent need not
    collect it: model index > 0)."""
    if mesh.coords["model"]:
        return None
    axes = lm.batch_axes_for(mesh, batch)
    return 0 if axes is None else mesh.axis_index(axes) * (batch // mesh.axis_size(axes))


def _greedy(forward, cache, tokens, steps, **prefill_kw):
    """Prefill, then ``steps`` greedy tokens over the dense cache."""
    logits, cache = forward(tokens, cache, **prefill_kw)
    out = [logits[:, -1].float()]
    nxt = logits[:, -1].argmax(-1)
    toks = [nxt]
    for _ in range(steps - 1):
        logits, cache = forward(nxt[:, None], cache)
        out.append(logits[:, -1].float())
        nxt = logits[:, -1].argmax(-1)
        toks.append(nxt)
    return torch.stack(out, 1), torch.stack(toks, 1)


def lm_cases(mesh, cases):
    """``cases``: list of (cfg, reference params as numpy, tokens (B, S)
    numpy, decode steps, vision embeds or None).  Per case: the rank's
    rows' logits without a cache, and, with steps > 0, the greedy tokens
    and step logits over the dense cache (prefill then decode)."""
    out = []
    for cfg, tree, tokens, steps, vision in cases:
        full = convert.params_from_numpy(tree, cfg, "cpu")
        params = lm.shard_params(full, lm.param_specs(cfg, mesh.tp), mesh, cfg)
        toks = _rows(mesh, tokens)
        kw = {"vision_embeds": _rows(mesh, vision)} if vision is not None else {}
        with torch.no_grad():
            logits, _ = lm.apply_lm(params, cfg, toks, mesh=mesh, **kw)
            res = {"logits": logits.float().numpy()}
            if steps:
                s_max = tokens.shape[1] + steps + (vision.shape[1] if vision is not None else 0)
                cache = lm.init_cache(cfg, tokens.shape[0], s_max, "cpu", mesh=mesh)

                def fwd(t, c, **k):
                    return lm.apply_lm(params, cfg, t, cache=c, mesh=mesh, **k)

                step_logits, greedy = _greedy(fwd, cache, toks, steps, **kw)
                res["step_logits"] = step_logits.numpy()
                res["tokens"] = greedy.numpy()
        res["keep"] = _keeps_rows(mesh, tokens.shape[0])
        out.append(res)
    return out


def quant_cases(mesh, cases):
    """``cases``: list of (cfg, quantized reference params as numpy, mode
    "w4a8" or "w4a8_moe", tokens, decode steps).  The W4A8 forwards on the
    rank's shard: logits without a cache and greedy decode over the dense
    cache."""
    out = []
    for cfg, tree, mode, tokens, steps in cases:
        params = qlm.params_from_numpy(tree, cfg, mode, "cpu", mesh=mesh)
        fwd_fn = qlm.apply_quantized_lm if mode == "w4a8" else qlm.apply_quantized_moe_lm
        toks = _rows(mesh, tokens)
        with torch.no_grad():
            logits, _ = fwd_fn(params, cfg, toks, mesh=mesh)
            res = {"logits": logits.float().numpy(), "keep": _keeps_rows(mesh, tokens.shape[0])}
            if steps:
                cache = lm.init_cache(cfg, tokens.shape[0], tokens.shape[1] + steps, "cpu",
                                      mesh=mesh)
                step_logits, greedy = _greedy(
                    lambda t, c: fwd_fn(params, cfg, t, cache=c, mesh=mesh), cache, toks, steps)
                res["step_logits"] = step_logits.numpy()
                res["tokens"] = greedy.numpy()
        out.append(res)
    return out


def collect(results, key):
    """The global batch from the ranks' rows (each block once, in order)."""
    blocks = {r["keep"]: r[key] for r in results if r["keep"] is not None}
    return np.concatenate([blocks[k] for k in sorted(blocks)], axis=0)


def numpy_tree(tree):
    return tree_map(lambda t: t.detach().float().numpy() if isinstance(t, torch.Tensor) else t,
                    tree)


def train_case(mesh, cfg, params_np, steps, seq_len, batch, ckpt_dir=None, save_at=None):
    """``steps`` Trainer steps on the mesh from the reference's weights:
    per step the loss and grad_norm; then the full params (gathered), and
    with ``ckpt_dir`` a checkpoint saved at step ``save_at``."""
    from repro_torch.launch.train import Trainer

    full = convert.params_from_numpy(params_np, cfg, "cpu")
    tr = Trainer(cfg, mesh, seq_len=seq_len, global_batch=batch, params=full, device="cpu",
                 ckpt_dir=ckpt_dir)
    hist = []
    for _ in range(steps):
        m = tr.train_step()
        hist.append((float(m["loss"]), float(m["grad_norm"])))
        if ckpt_dir is not None and tr.step == save_at:
            tr.save(tr.step)
        tr.step += 1
    if tr.ckpt is not None:
        tr.ckpt.wait()
    params, mu, _ = tr.full_state()
    out = {"hist": hist, "rank": mesh.rank, "params": numpy_tree(params),
           "mu": numpy_tree(mu)}
    if mesh.size > 1:
        out["mu_local"] = {k: tuple(v.shape) for k, v in
                           {"wq": tr.opt_state["mu"]["layers"][0]["attn"]["wq"],
                            "tok": tr.opt_state["mu"]["embed"]["tok"]}.items()}
        out["moment_specs"] = tr.moment_specs["mu"]["layers"][0]["attn"]["wq"]
    return out


def restore_case(mesh, cfg, ckpt_dir, seq_len, batch):
    """A Trainer on this mesh restored from ``ckpt_dir``: its step and its
    params and moments gathered whole."""
    from repro_torch.launch.train import Trainer

    from repro_torch.checkpoint import load_checkpoint, save_checkpoint
    from repro_torch.core.tree import tree_leaves

    tr = Trainer(cfg, mesh, seq_len=seq_len, global_batch=batch, device="cpu", ckpt_dir=ckpt_dir)
    assert tr.restore()
    params, mu, _ = tr.full_state()
    out = {"step": tr.step, "params": numpy_tree(params), "mu": numpy_tree(mu),
           "count": int(tr.opt_state["count"])}
    if mesh.size > 1:  # the store's own mesh round trip: gathered to rank 0, cut on load
        specs = {"params": convert.specs_to_reference(tr.specs, cfg)}
        local = {"params": convert.to_reference(tr.params, cfg)}
        where = os.path.join(ckpt_dir, "mesh_round_trip")
        save_checkpoint(where, 0, local, mesh=mesh, specs=specs)
        mesh.barrier()
        _, back, _ = load_checkpoint(where, 0, device="cpu", mesh=mesh, specs=specs)
        out["round_trip_bitwise"] = all(torch.equal(a, b) for a, b in zip(
            tree_leaves(back["params"]), tree_leaves(local["params"])))
    return out


def elastic_case(mesh, cfg, ckpt_dir, fail_at, steps, seq_len, batch, params_np):
    """An elastic run over this world (hosts = data rows of ``model``
    ranks) from the reference's weights that loses host 1 at tick
    ``fail_at``; the surviving ranks return the history, the ranks that
    left return None."""
    from repro_torch.launch.train import elastic_trainer
    from repro_torch.runtime import FaultToleranceConfig

    ticks = iter([None] * fail_at + [1] + [None] * 1000)
    et = elastic_trainer(cfg, mesh, FaultToleranceConfig(ckpt_dir=ckpt_dir, ckpt_every=2),
                         model=mesh.shape["model"], failure_source=lambda: next(ticks),
                         seq_len=seq_len, global_batch=batch, device="cpu",
                         params=convert.params_from_numpy(params_np, cfg, "cpu"))
    hist = et.run(steps)
    return None if hist is None else {"hist": hist, "rank": mesh.rank}


def collectives_case(mesh):
    """Every collective of the mesh on this rank, with the autograd pairs'
    backward: values the parent checks against their definitions."""
    from repro_torch.launch import mesh as M

    dev = mesh.device
    r = float(mesh.rank + 1)
    x = torch.full((4, 2), r, device=dev)
    out = {"rank": mesh.rank, "coords": dict(mesh.coords), "shape": dict(mesh.shape),
           "backend": mesh.backend, "transport": mesh.transport,
           "model_index": mesh.axis_index("model"), "data_index": mesh.axis_index("data")}
    out["sum_model"] = mesh.all_reduce(x, "model")[0, 0].item()
    out["max_all"] = mesh.all_reduce(x, ("data", "model"), "max")[0, 0].item()
    out["gather_model"] = mesh.all_gather(x, "model", 1)[0].tolist()
    out["rs_data"] = mesh.reduce_scatter(torch.full((4, 2), r, device=dev), "data", 0).tolist()
    a2a = torch.arange(mesh.tp * 2, dtype=torch.float32, device=dev).reshape(mesh.tp, 2) \
        + 100 * mesh.rank
    out["a2a_model"] = mesh.all_to_all(a2a, "model").tolist()
    out["int32_sum"] = mesh.all_reduce(torch.tensor([2 ** 30 // 4], dtype=torch.int32,
                                                    device=dev), "model").item()
    out["bf16_gather"] = mesh.all_gather(torch.full((2,), r, dtype=torch.bfloat16, device=dev),
                                         "model", 0).tolist()
    out["int8_a2a"] = mesh.all_to_all(torch.full((mesh.tp, 3), mesh.rank, dtype=torch.int8,
                                                 device=dev), "model")[:, 0].tolist()
    w = torch.full((2, 2), r, device=dev, requires_grad=True)
    y = M.all_reduce(w * 1.0, mesh, "model")  # sum forward, identity backward
    g_ar = torch.autograd.grad(y.sum(), w)[0]
    w2 = torch.full((2, 2), r, device=dev, requires_grad=True)
    g_copy = torch.autograd.grad(M.copy_to_region(w2, mesh, "model").sum() * r, w2)[0]
    w3 = torch.ones((2, 3), device=dev, requires_grad=True)
    z = M.all_gather(w3, mesh, "model", 0)  # backward: reduce-scatter
    g_gather = torch.autograd.grad(
        (z * torch.arange(z.numel(), device=dev).reshape(z.shape)).sum(), w3)[0]
    w4 = torch.ones((2 * mesh.tp, 3), device=dev, requires_grad=True)
    g_rs = torch.autograd.grad(M.reduce_scatter(w4, mesh, "model", 0).sum() * r, w4)[0]
    w5 = torch.ones((2 * mesh.tp, 3), device=dev, requires_grad=True)
    g_split = torch.autograd.grad(M.split(w5, mesh, "model", 0).sum() * r, w5)[0]
    w6 = torch.ones((2, 3), device=dev, requires_grad=True)
    g_rep = torch.autograd.grad(M.gather_replicated(w6, mesh, "model", 0).sum() * 2, w6)[0]
    out.update(g_ar=g_ar.tolist(), g_copy=g_copy.tolist(), g_gather=g_gather.tolist(),
               g_rs=g_rs.tolist(), g_split=g_split.tolist(), g_rep=g_rep.tolist(),
               device=str(g_rep.device))
    mesh.comm.clear()
    mesh.all_reduce(x, "model")
    out["comm"] = dict(mesh.comm)
    return out


def moe_layer_case(mesh, cases):
    """The expert-parallel MoE layer on this rank: ``cases`` is a list of
    (cfg, moe weights as numpy in the port's (E, d, f) layout, or packed
    W4A8 experts ``{"w_gate": {"packed", "sw"}, ...}`` with the router, x
    (B, S, d) numpy, seq_sharded, quantized).  Each rank returns its block
    of the output and where it sits ((row, column) offsets; None for the
    duplicate blocks of model ranks > 0 without sequence sharding)."""
    from repro_torch.models import layers as L

    out = []
    for cfg, moe, x, sp, quant in cases:
        shard = L.Shard(mesh, sp=sp)
        rows = lm.local_rows(torch.from_numpy(x), mesh)
        b0 = _keeps_rows(mesh, x.shape[0]) if not sp else None
        if b0 is None:  # row block of this rank even where model index > 0
            axes = lm.batch_axes_for(mesh, x.shape[0])
            b0 = 0 if axes is None else mesh.axis_index(axes) * rows.shape[0]
        s0 = 0
        if sp:
            n = x.shape[1] // mesh.tp
            s0 = mesh.coords["model"] * n
            rows = rows[:, s0:s0 + n]
        with torch.no_grad():
            if quant:
                p = {"router": torch.from_numpy(moe["router"])}
                for name in ("w_gate", "w_up", "w_down"):
                    p[name] = qlm._shard_experts(
                        {k: torch.from_numpy(np.asarray(v)) for k, v in moe[name].items()},
                        name, cfg, mesh)
                y = qlm._moe_a2a_quant(p, rows.contiguous(), cfg, shard)
            else:
                split = L.moe_ff_split(cfg, mesh.tp)
                p = {k: torch.from_numpy(v) for k, v in moe.items()}
                p = {k: v if k == "router" else lm.split_experts(v, k, cfg.n_experts, split)
                     for k, v in p.items()}
                p = {k: lm.shard_leaf(v, L.moe_specs(cfg, mesh.tp)[k], mesh) for k, v in p.items()}
                y = L.moe_apply_a2a(p, rows.contiguous(), cfg, shard)
        refused = None
        if not quant and not sp:  # a backward here would count tp copies of each token
            try:
                L.moe_apply_a2a(p, rows.contiguous().requires_grad_(), cfg, shard)
                refused = False
            except NotImplementedError:
                refused = True
        keep = sp or mesh.coords["model"] == 0
        out.append({"y": y.numpy(), "at": (b0, s0) if keep else None, "refused": refused})
    return out


def assemble(results, shape):
    """The (B, S, d) output from every rank's block."""
    full = np.full(shape, np.nan, dtype=np.float32)
    for r in results:
        if r["at"] is not None:
            b0, s0 = r["at"]
            b, s, _ = r["y"].shape
            full[b0:b0 + b, s0:s0 + s] = r["y"]
    return full


def cuda_w4a8_case(mesh, arch, n_layers, tokens):
    """On the card: K1 scaled and int32 on this rank's column and row
    shards of one weight against the whole weight's K1 (bitwise), and a
    ``n_layers``-layer W4A8 target (``arch`` at full width) sharded, against
    the same target on one device computed by this rank."""
    from repro_torch import configs
    from repro_torch.kernels import _lib
    from repro_torch.kernels.w4a8_matmul import prepack, w4a8_matmul, w4a8_matmul_int32
    from repro_torch.launch.serve import build_sharded_target
    from repro_torch.core import quantization as q

    dev = mesh.device
    g = torch.Generator(device=dev).manual_seed(0)
    m, k, n = 8, 4096, 1024
    x = torch.randn((m, k), generator=g, device=dev)
    xq, sx = q.quantize_act_int8(x)
    wq, sw = q.quantize_weight_int(torch.randn((k, n), generator=g, device=dev), 4, axis=0)
    wp = q.pack_int4(wq, axis=0)
    full = w4a8_matmul(xq, prepack(wp), sx, sw)
    r, tp = mesh.coords["model"], mesh.tp
    cols = slice(r * n // tp, (r + 1) * n // tp)
    col = w4a8_matmul(xq, prepack(wp[:, cols].contiguous()), sx, sw[:, cols].contiguous())
    rows = slice(r * k // tp, (r + 1) * k // tp)
    acc = w4a8_matmul_int32(xq[:, rows].contiguous(),
                            prepack(wp[r * k // tp // 2:(r + 1) * k // tp // 2].contiguous()), n)
    row = (mesh.all_reduce(acc, "model").float() * sx) * sw
    out = {"column_bitwise": bool(torch.equal(col, full[:, cols])),
           "row_bitwise": bool(torch.equal(row, full))}
    cfg = dataclasses.replace(configs.get_config(arch), n_layers=n_layers)
    toks = lm.local_rows(torch.as_tensor(tokens, device=dev), mesh)
    with torch.no_grad():
        one = build_sharded_target(cfg, None, quantize=True, seed=0, device=dev)
        want, _ = qlm.apply_quantized_lm(one, cfg, toks)
        del one
        shard = build_sharded_target(cfg, mesh, quantize=True, seed=0, device=dev)
        _lib.launches.clear()
        got, _ = qlm.apply_quantized_lm(shard, cfg, toks, mesh=mesh)
    out.update(forward_bitwise=bool(torch.equal(got, want)),
               max_abs=float((got.float() - want.float()).abs().max()),
               launches=dict(_lib.launches), device=str(dev))
    return out

"""The plain reference (bench/reference) against the port at smoke sizes on
the CPU: the W4A8 + LRU target's derivation, the bf16 target, the BVQ
draft's forward, and the rotations the configurations state."""
from __future__ import annotations

import dataclasses
import json

import numpy as np
import pytest
import torch

import bench_testkit as kit
from benchkit import weights
from benchkit.spec import load
from reference import hadamard, lm_ref


def _cfg(name):
    return load(kit.DATA / "configs" / f"{name}.json", kit.BENCH)


def _served(cfg, seed, toks, start):
    return cfg.family.target_logits(cfg.model, seed, [toks], [start], "cpu")[0]


def test_w4a8_target_one_layer_matches_the_port():
    """One layer, float32: the reference's own derivation (folds, R1 and R2,
    int4 weights, int8 activations) gives the port's logits to rounding;
    deeper stacks differ by .5-boundary code flips, which the chip check's
    limit takes in."""
    from repro_torch.serving import quantized_lm as qlm
    cfg = _cfg("qwen3-smoke-w4a8")
    one = cfg.model.target.cut(1, "one")
    cfg = dataclasses.replace(cfg, model=dataclasses.replace(cfg.model, target=one))
    seed = 2**31 + 5
    tcfg = cfg.family.model_config(one)
    emb = weights.embed(one, seed, "target", "cpu")
    params = qlm.quantize_embed({"tok": emb["tok"], "head": emb["head"]}, {"g": emb["final_g"]}, tcfg)
    params["layers"] = [qlm.quantize_layer(weights.layer(one, seed, "target", 0, "cpu"), tcfg)]
    toks = np.random.default_rng(0).integers(0, one.vocab, size=40)
    with torch.no_grad():
        port, _ = qlm.apply_quantized_lm(params, tcfg, torch.as_tensor(toks[None]))
    ref = _served(cfg, seed, toks, 20)
    assert torch.allclose(port[0, 19:39].float(), ref, atol=1e-4, rtol=0)


def test_bf16_target_matches_the_port():
    from repro_torch.models import lm
    cfg = _cfg("nemotron-smoke-bf16")
    seed = 11
    tcfg = cfg.family.model_config(cfg.model.target)
    params = cfg.family.dense_params(cfg.model.target, seed, "target", "cpu")
    toks = np.random.default_rng(1).integers(0, cfg.model.target.vocab, size=48)
    with torch.no_grad():
        port, _ = lm.apply_lm(params, tcfg, torch.as_tensor(toks[None]))
    ref = _served(cfg, seed, toks, 10)
    assert torch.allclose(port[0, 9:47].float(), ref, atol=2e-4, rtol=0)


def test_bvq_draft_forward_matches_the_port():
    """The draft's forward over the weights its codebooks decode to, and
    the decoded weights a compression of the dense ones, not them."""
    from repro_torch.serving import quantized_lm as qlm
    cfg = _cfg("qwen3-smoke-w4a8")
    fam, m, seed = cfg.family, cfg.model, 3
    target, draft = fam.pair(m, seed, 64, "cpu")
    kept = fam.keep(m, target, draft)
    toks = np.random.default_rng(2).integers(0, m.draft.vocab, size=24)
    with torch.no_grad():
        port, _ = qlm.apply_bvq_lm(draft.params, fam.model_config(m.draft), torch.as_tensor(toks[None]))
    ref = fam.draft_logits(m, seed, kept, toks, np.arange(24), "cpu")
    assert torch.allclose(port[0].float(), ref, atol=1e-4, rtol=0)
    assert 0.01 < fam.draft_readings(m, seed, kept, "cpu")["draft_weight_err"] < 0.9
    # the bf16 draft (no kept operands) is remade from the seed whole
    n = _cfg("nemotron-smoke-bf16")
    _, ndraft = n.family.pair(n.model, seed, 64, "cpu")
    from repro_torch.models import lm
    with torch.no_grad():
        port, _ = lm.apply_lm(ndraft.params, n.family.model_config(n.model.draft),
                              torch.as_tensor(toks[None]))
    ref = n.family.draft_logits(n.model, seed, None, toks, np.arange(24), "cpu")
    assert torch.allclose(port[0].float(), ref, atol=2e-4, rtol=0)


@pytest.mark.parametrize("name", ["qwen3-8b-w4a8.json"])
def test_configured_rotations_are_the_ports(name):
    from repro_torch.core import rotation as rot
    raw = json.loads((kit.BENCH / "configs" / name).read_text())
    for key, dim in (("d_model", raw["hidden_size"]), ("d_ff", raw["intermediate_size"])):
        plan = raw["serving"]["lru"][key]
        port = rot.plan_rotation(dim)
        assert (port.m, port.k, port.kind) == (plan["m"], plan["k"], plan["kind"])
        x = torch.randn(3, dim, generator=torch.Generator().manual_seed(dim))
        assert torch.allclose(hadamard.rotate(x, plan), rot.local_rotate(x, port), atol=1e-5)
        assert torch.allclose(hadamard.rotate(x, plan).norm(dim=-1), x.norm(dim=-1), rtol=1e-5)


def test_weights_remake_any_part_alone():
    spec = _cfg("qwen3-smoke-w4a8").model.target
    a = weights.layer(spec, 7, "target", 2, "cpu")
    b = weights.layer(spec, 7, "target", 2, "cpu")
    c = weights.layer(spec, 7, "target", 1, "cpu")
    d = weights.layer(spec, 8, "target", 2, "cpu")
    assert torch.equal(a["attn"]["wq"], b["attn"]["wq"])
    assert not torch.equal(a["attn"]["wq"], c["attn"]["wq"])
    assert not torch.equal(a["attn"]["wq"], d["attn"]["wq"])
    assert weights.stream_seed(2**31 + 3, "draft", 0) != weights.stream_seed(3, "draft", 0)

"""The quantized forwards on the repo's decoder configurations, port against
the JAX package, weights made by the JAX package and carried across with
``params_from_numpy``:

- ``qwen3-smoke`` (GQA, qk-norm) through W4A8 + LRU (``quantize_dense_lm``
  + ``apply_quantized_lm``) and through BVQ (``bvq_compress_lm`` +
  ``apply_bvq_lm``), at prefill and for a 4-token paged window over fp and
  int8 pools;
- ``moonshot-smoke`` through the W4A8 MoE forward (``quantize_moe_lm`` +
  ``apply_quantized_moe_lm``, the reference's single-device branch), at
  prefill and a dense-cache extend, and the port's own offline transforms
  against the reference's packed weights;
- the W4A8 / BVQ forwards refusing the blocks the reference cannot take
  (a two-matrix MLP, the MoE family);
- the port's Engine on the qwen3-smoke W4A8 target with a BVQ draft
  against the JAX Engine, token for token, chain and mixed-KV tree.

Tolerances (ROADMAP Queue 3's numerics note): W4A8 logits per token row,
at most one row in eight beyond 1e-5 and none beyond 2e-2 (a last-bit
difference may move one dynamic int8 activation across a .5 boundary); on
a paged window every such flip is snapped to the reference's after a
check, and then every row is held to 1e-5.  BVQ: atol 1e-4.  MoE rows also
follow the router near-tie rule of tests/test_torch_families.py."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")  # the reference side of every test here

import jax
import jax.numpy as jnp
from test_torch_families import _router_keep
from test_torch_models import (  # noqa: F401
    BVQ_ATOL, ROW_EXACT, assert_w4a8_close, one_thread, to_numpy_tree,
)
from test_torch_tree_int8 import TREE, _map, _record_activations, _snap_flips, _window_cache

from repro import configs as jconfigs
from repro.core import bvq as jbvq
from repro.models import lm as jlm
from repro.serving import Engine as JaxEngine
from repro.serving import EngineConfig as JaxEngineConfig
from repro.serving import SamplingParams as JaxSamplingParams
from repro.serving import quantized_lm as jqlm
from repro.serving.engine import ServingModel as JaxServingModel
from repro_torch import configs as tconfigs
from repro_torch.kernels.w4a8_matmul import unprepack
from repro_torch.models import layers as tL
from repro_torch.models import lm as tlm
from repro_torch.serving import quantized_lm as tqlm
from repro_torch.serving.engine import Engine, EngineConfig, SamplingParams, ServingModel

pytestmark = pytest.mark.usefixtures("one_thread")
J_QWEN, T_QWEN = jconfigs.get_smoke("qwen3-8b"), tconfigs.get_smoke("qwen3-8b")
J_MOE, T_MOE = jconfigs.get_smoke("moonshot-v1-16b-a3b"), tconfigs.get_smoke("moonshot-v1-16b-a3b")
S_MAX = 96
BVQ_CFG = dict(vec_dim=4, codebook_size=64, block_cols=32, kmeans_iters=8, qat_steps=0)


@pytest.fixture(scope="module")
def qwen():
    params, _ = jlm.init_lm(jax.random.PRNGKey(0), J_QWEN, tp=1)
    # jitted: one compile, where op-by-op dispatch took ~25 s on the CPU
    wq = jax.jit(lambda p: jqlm.quantize_dense_lm(p, J_QWEN, bits=4, rotate=True))(params)
    bq = jqlm.bvq_compress_lm(params, J_QWEN, jbvq.BVQConfig(**BVQ_CFG), jax.random.PRNGKey(7))
    return (params, wq, bq,
            tqlm.params_from_numpy(to_numpy_tree(wq), T_QWEN, "w4a8", "cpu"),
            tqlm.params_from_numpy(to_numpy_tree(bq), T_QWEN, "bvq", "cpu"))


@pytest.fixture(scope="module")
def moe():
    params, _ = jlm.init_lm(jax.random.PRNGKey(2), J_MOE, tp=1)
    qp = jax.jit(lambda p: jqlm.quantize_moe_lm(p, J_MOE))(params)
    return params, qp, tqlm.params_from_numpy(to_numpy_tree(qp), T_MOE, "w4a8_moe", "cpu")


def _tokens(cfg, b, s, seed):
    return np.random.RandomState(seed).randint(0, cfg.vocab, (b, s)).astype(np.int32)


def test_qwen3_w4a8_carries_qk_norm(qwen):
    _, wq, _, tw, tb = qwen
    for lp, blp in zip(tw["layers"], tb["layers"]):
        assert set(lp["qk_extra"]) == set(blp["qk_extra"]) == {"q_norm", "k_norm"}
        assert lp["qk_extra"]["q_norm"].shape == (T_QWEN.hd,)
    np.testing.assert_array_equal(tw["layers"][1]["qk_extra"]["k_norm"].numpy(),
                                  np.asarray(wq["layers"]["qk_extra"]["k_norm"])[1])


def test_qwen3_w4a8_prefill_matches(qwen):
    _, wq, _, tw, _ = qwen
    toks = _tokens(T_QWEN, 2, 12, seed=0)
    want, _ = jqlm.apply_quantized_lm(wq, J_QWEN, None, jnp.asarray(toks), use_pallas=False)
    got, _ = tqlm.apply_quantized_lm(tw, T_QWEN, torch.from_numpy(toks))
    assert_w4a8_close(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("quantized", [False, True], ids=["fp", "int8"])
def test_qwen3_w4a8_paged_window_matches(qwen, monkeypatch, quantized):
    """Every row to 1e-5 once the int8 activations a rounding flip made
    differ are snapped to the reference's (checked flips), against the
    reference run eagerly so that each activation is recorded (against
    its jitted forward, whose fused ops round otherwise, one fp-window row
    differs by 0.0225, past the per-row rule's 2e-2)."""
    _, wq, _, tw, _ = qwen
    cache = _window_cache(T_QWEN, quantized, False, seed=1)
    toks = _tokens(T_QWEN, 4, 4, seed=2)
    seen = _record_activations(monkeypatch)
    with jax.disable_jit():  # the layer scan runs in Python, so each call records
        want, _ = jqlm.apply_quantized_lm(wq, J_QWEN, None, jnp.asarray(toks),
                                          cache=_map(cache, jnp.asarray), use_pallas=False,
                                          paged_impl="gather")
    flips = _snap_flips(monkeypatch, seen)
    got, _ = tqlm.apply_quantized_lm(tw, T_QWEN, torch.from_numpy(toks),
                                     cache=_map(cache, lambda a: torch.from_numpy(np.array(a))))
    assert len(flips) == len(seen)
    print(f"int8 activation flips snapped per call: {flips}")
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ROW_EXACT)


def test_qwen3_quantize_dense_lm_matches_reference(qwen):
    """The port's fold + rotate + quantize of the carried float params
    gives the reference's packed weights (codes but at rare rounding ties)
    and carries the qk-norm weights."""
    params, wq, _, _, _ = qwen
    tparams = tqlm.params_from_numpy(to_numpy_tree(params), T_QWEN, "bf16", "cpu")
    ours = tqlm.quantize_dense_lm(tparams, T_QWEN)
    for i, lp in enumerate(ours["layers"]):
        for name in ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down"):
            ref = {k: np.asarray(v)[i] for k, v in wq["layers"][name].items()}
            np.testing.assert_allclose(lp[name]["sw"].numpy(), ref["sw"], rtol=1e-5)
            k, n = 2 * ref["packed"].shape[0], ref["packed"].shape[1]
            assert np.mean(unprepack(lp[name]["packed"], k, n).numpy() == ref["packed"]) > 0.999
        np.testing.assert_array_equal(lp["qk_extra"]["q_norm"].numpy(),
                                      np.asarray(wq["layers"]["qk_extra"]["q_norm"])[i])


def test_qwen3_bvq_prefill_and_paged_match(qwen):
    _, _, bq, _, tb = qwen
    toks = _tokens(T_QWEN, 2, 12, seed=3)
    want, _ = jqlm.apply_bvq_lm(bq, J_QWEN, None, jnp.asarray(toks), use_pallas=False)
    got, _ = tqlm.apply_bvq_lm(tb, T_QWEN, torch.from_numpy(toks))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=BVQ_ATOL)
    cache = _window_cache(T_QWEN, False, True, seed=4)
    toks = _tokens(T_QWEN, 4, 4, seed=5)
    want, _ = jqlm.apply_bvq_lm(bq, J_QWEN, None, jnp.asarray(toks),
                                cache=_map(cache, jnp.asarray), use_pallas=False,
                                paged_impl="gather")
    got, _ = tqlm.apply_bvq_lm(tb, T_QWEN, torch.from_numpy(toks),
                               cache=_map(cache, lambda a: torch.from_numpy(np.array(a))))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=BVQ_ATOL)


@pytest.mark.parametrize("arch", ["nemotron-4-15b", "moonshot-v1-16b-a3b"])
def test_w4a8_and_bvq_refuse_what_the_reference_cannot_take(arch):
    """A squared-ReLU MLP has no w_gate (the reference raises a KeyError),
    and the MoE family has its own forward: NotImplementedError here."""
    cfg = tconfigs.get_smoke(arch)
    params = tlm.init_lm(torch.Generator().manual_seed(0), cfg, "cpu")
    with pytest.raises(NotImplementedError):
        tqlm.quantize_dense_lm(params, cfg)
    with pytest.raises(NotImplementedError):
        tqlm.bvq_compress_lm(params, cfg, None, torch.Generator())
    with pytest.raises(NotImplementedError):
        tqlm.apply_quantized_lm({}, cfg, torch.zeros((1, 2), dtype=torch.int32))


class _Routers:
    """The router inputs of every layer of the port's W4A8 MoE forwards
    inside the context (patched ``layers.moe_apply_dense``)."""

    def __init__(self, monkeypatch):
        self.z = []
        orig = tL.moe_apply_dense

        def record(p, x, cfg):
            self.z.append(x.float().numpy().copy())
            return orig(p, x, cfg)

        monkeypatch.setattr(tL, "moe_apply_dense", record)

    def keep(self, tparams):
        routers = [lp["router"].numpy() for lp in tparams["layers"]]
        return _router_keep(self.z[-len(routers):], routers, T_MOE)


def test_moe_w4a8_prefill_and_extend_match(moe, monkeypatch):
    """No cache, then a dense-cache prefill of 9 tokens and a one-token
    and a 3-token extend."""
    _, qp, tq = moe
    rec = _Routers(monkeypatch)
    toks = _tokens(T_MOE, 2, 13, seed=6)
    want, _ = jqlm.apply_quantized_moe_lm(qp, J_MOE, None, jnp.asarray(toks))
    got, _ = tqlm.apply_quantized_moe_lm(tq, T_MOE, torch.from_numpy(toks))
    keep = rec.keep(tq)
    assert_w4a8_close(got.numpy()[keep], np.asarray(want)[keep])
    jc = jlm.init_cache(J_MOE, 2, 32)
    tc = tlm.init_cache(T_MOE, 2, 32, "cpu")
    for lo, hi in ((0, 9), (9, 10), (10, 13)):
        want, jc = jqlm.apply_quantized_moe_lm(qp, J_MOE, None, jnp.asarray(toks[:, lo:hi]),
                                               cache=jc)
        got, tc = tqlm.apply_quantized_moe_lm(tq, T_MOE, torch.from_numpy(toks[:, lo:hi]),
                                              cache=tc)
        keep = rec.keep(tq)
        assert_w4a8_close(got.numpy()[keep], np.asarray(want)[keep])
        assert int(tc["length"]) == int(jc["length"]) == hi


def test_moe_quantize_matches_reference(moe):
    """The port's ``quantize_moe_lm`` of the carried float params: expert
    codes and scales as the reference packs them, the router f32 as it
    is, the attention linears and head as the reference's after the
    kernel's reorder."""
    params, qp, _ = moe
    tparams = tqlm.params_from_numpy(to_numpy_tree(params), T_MOE, "bf16", "cpu")
    assert tparams["layers"][0]["moe"]["router"].dtype == torch.float32
    ours = tqlm.quantize_moe_lm(tparams, T_MOE)
    for i, lp in enumerate(ours["layers"]):
        np.testing.assert_array_equal(lp["router"].numpy(), np.asarray(qp["layers"]["router"])[i])
        for name in ("w_gate", "w_up", "w_down"):
            ref = {k: np.asarray(v)[i] for k, v in qp["layers"][name].items()}
            np.testing.assert_allclose(lp[name]["sw"].numpy(), ref["sw"], rtol=1e-5)
            assert np.mean(lp[name]["packed"].numpy() == ref["packed"]) > 0.999
        for name in ("wq", "wk", "wv", "wo"):
            ref = {k: np.asarray(v)[i] for k, v in qp["layers"][name].items()}
            k, n = 2 * ref["packed"].shape[0], ref["packed"].shape[1]
            assert np.mean(unprepack(lp[name]["packed"], k, n).numpy() == ref["packed"]) > 0.999
    with pytest.raises(NotImplementedError):
        tqlm.apply_quantized_moe_lm(ours, dataclasses.replace(T_QWEN),
                                    torch.zeros((1, 2), dtype=torch.int32))


# ---------------------------------------------------------------------------
# Engine: the qwen3-smoke W4A8 target with its BVQ-compressed twin drafting
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name,kinds,cfg", [
    ("chain", None, dict()),
    ("mixed_tree", ["none", "int8", "none"], dict(TREE, kv_quant="mixed")),
], ids=lambda v: v if isinstance(v, str) else None)
def test_qwen3_engine_tokens_match_jax_engine(qwen, name, kinds, cfg):
    """The W4A8 + LRU target and, as its draft, the BVQ compression of the
    same weights (so proposals are accepted): the port's Engine emits the
    JAX Engine's tokens, chain fp and tree over mixed KV."""
    _, wq, bq, tw, tb = qwen
    jt = JaxServingModel(cfg=J_QWEN, params=wq, mode="w4a8", s_max=S_MAX)
    jd = JaxServingModel(cfg=J_QWEN, params=bq, mode="bvq", s_max=S_MAX)
    tt = ServingModel(T_QWEN, tw, mode="w4a8", s_max=S_MAX, device="cpu")
    td = ServingModel(T_QWEN, tb, mode="bvq", s_max=S_MAX, device="cpu")
    prompts = [np.random.RandomState(8 + i).randint(0, T_QWEN.vocab, 4 + 3 * i).astype(np.int32)
               for i in range(3)]
    kinds = kinds or [None] * len(prompts)
    want, _ = JaxEngine(jt, jd, JaxEngineConfig(max_batch=3, **cfg)).run(
        prompts, [JaxSamplingParams(max_tokens=10, kv_quant=k) for k in kinds])
    eng = Engine(tt, td, EngineConfig(max_batch=3, **cfg), device="cpu")
    got, summary = eng.run(prompts, [SamplingParams(max_tokens=10, kv_quant=k) for k in kinds])
    assert [g.tolist() for g in got] == [np.asarray(w).tolist() for w in want]
    assert summary["acceptance_rate"] > 0
    for st in eng.pool_stats():
        assert st.used_pages == 0

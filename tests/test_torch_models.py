"""Port model forwards against the JAX reference on the smoke pair, with
weights carried across (params_from_numpy): the W4A8 target and the BVQ
draft, at prefill and for a W=4 paged verify window.  The JAX side runs
its plain path (use_pallas=False, paged_impl="gather").

Tolerance: the two packages agree to float32 rounding (~1e-6 on O(1)
logits) except where a last-bit difference (the norms' reductions and
rsqrt round differently in XLA and torch) moves a dynamic int8 activation
across a .5 quantization boundary.  Such a flip moves every logit of that
token row by up to a few activation quanta times a weight scale (~1e-2).
So W4A8 logits are held per token row: at most one row in eight may
differ by more than 1e-5, and none by more than 2e-2.  The BVQ draft has
no activation quantization and is held to atol 1e-4 everywhere."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")  # the reference side of every test here

import jax
import jax.numpy as jnp

from repro.configs.paper_pair import DLM_SMOKE as J_DLM, TLM_SMOKE as J_TLM
from repro.core import bvq as jbvq
from repro.models import lm as jlm
from repro.serving import quantized_lm as jqlm
from repro_torch.configs.paper_pair import DLM_SMOKE, TLM_SMOKE
from repro_torch.serving import quantized_lm as tqlm

ROW_EXACT = 1e-5
ROW_FLIP_MAX = 2e-2
BVQ_ATOL = 1e-4


def assert_w4a8_close(got, want):
    """Per token row (last axis): float32 agreement, or a bounded
    activation-quantization flip in at most one row in eight."""
    diff = np.abs(got - want).reshape(-1, got.shape[-1]).max(axis=-1)
    assert diff.max() <= ROW_FLIP_MAX, diff.max()
    assert np.mean(diff > ROW_EXACT) <= 0.125, diff


def to_numpy_tree(tree):
    """JAX pytree -> nested dicts of numpy arrays (BVQWeight as its fields)."""
    if isinstance(tree, jbvq.BVQWeight):
        return {"codebooks": np.asarray(tree.codebooks), "scales": np.asarray(tree.scales),
                "indices": np.asarray(tree.indices), "shape": tuple(tree.shape),
                "vec_dim": tree.vec_dim}
    if isinstance(tree, dict):
        return {k: to_numpy_tree(v) for k, v in tree.items()}
    return np.asarray(tree)


@pytest.fixture(scope="module")
def target():
    params, _ = jlm.init_lm(jax.random.PRNGKey(0), J_TLM, tp=1)
    qp = jqlm.quantize_dense_lm(params, J_TLM, bits=4, rotate=True)
    return params, qp, tqlm.params_from_numpy(to_numpy_tree(qp), TLM_SMOKE, "w4a8", "cpu")


@pytest.fixture(scope="module")
def draft():
    params, _ = jlm.init_lm(jax.random.PRNGKey(1), J_DLM, tp=1)
    bcfg = jbvq.BVQConfig(vec_dim=4, codebook_size=64, block_cols=32, kmeans_iters=8,
                          qat_steps=0)
    qp = jqlm.bvq_compress_lm(params, J_DLM, bcfg, jax.random.PRNGKey(7))
    return qp, tqlm.params_from_numpy(to_numpy_tree(qp), DLM_SMOKE, "bvq", "cpu")


def _tokens(b, s, seed=0):
    return np.random.RandomState(seed).randint(0, 512, (b, s)).astype(np.int32)


def _paged_cache(cfg, seed=1):
    """A paged pool holding random committed prefixes: 4 rows with lengths
    (9, 0, 21, 4), distinct pages, scratch in every unowned table slot."""
    ps, mp, n_pages = 8, 4, 12
    rng = np.random.RandomState(seed)
    shape = (cfg.n_layers, n_pages + 1, ps, cfg.n_kv, cfg.hd)
    lengths = np.array([9, 0, 21, 4], np.int32)
    table = np.full((4, mp), n_pages, np.int32)
    perm, used = rng.permutation(n_pages), 0
    for i, ln in enumerate(lengths):
        own = -(-(ln + 4) // ps)
        table[i, :own] = perm[used:used + own]
        used += own
    k = rng.randn(*shape).astype(np.float32)
    v = rng.randn(*shape).astype(np.float32)
    return lengths, table, k, v


def _run_jax_paged(apply, params, cfg, tokens, cache_np):
    lengths, table, k, v = cache_np
    cache = {"lengths": jnp.asarray(lengths), "page_table": jnp.asarray(table),
             "attn": {"k": jnp.asarray(k), "v": jnp.asarray(v)}}
    logits, nc = apply(params, cfg, None, jnp.asarray(tokens), cache=cache,
                       use_pallas=False, paged_impl="gather")
    return np.asarray(logits), np.asarray(nc["attn"]["k"]), np.asarray(nc["lengths"])


def _run_port_paged(apply, params, cfg, tokens, cache_np):
    lengths, table, k, v = (torch.from_numpy(np.array(a)) for a in cache_np)
    cache = {"lengths": lengths, "page_table": table, "attn": {"k": k, "v": v}}
    logits, nc = apply(params, cfg, torch.from_numpy(tokens), cache=cache)
    return logits.numpy(), k.numpy(), nc["lengths"].numpy()


def test_w4a8_prefill_logits_match(target):
    _, qp, tp = target
    toks = _tokens(2, 12)
    want, _ = jqlm.apply_quantized_lm(qp, J_TLM, None, jnp.asarray(toks), use_pallas=False)
    got, _ = tqlm.apply_quantized_lm(tp, TLM_SMOKE, torch.from_numpy(toks))
    assert_w4a8_close(got.numpy(), np.asarray(want))


def test_w4a8_paged_verify_window_matches(target):
    _, qp, tp = target
    toks = _tokens(4, 4, seed=2)
    cache_np = _paged_cache(TLM_SMOKE)
    want, want_k, want_len = _run_jax_paged(jqlm.apply_quantized_lm, qp, J_TLM, toks, cache_np)
    got, got_k, got_len = _run_port_paged(tqlm.apply_quantized_lm, tp, TLM_SMOKE, toks, cache_np)
    np.testing.assert_array_equal(got_len, want_len)
    assert_w4a8_close(got, want)
    # the window's K landed in the same pool slots (other slots untouched)
    assert_w4a8_close(got_k, want_k)


def test_bvq_prefill_logits_match(draft):
    qp, tp = draft
    toks = _tokens(2, 12, seed=3)
    want, _ = jqlm.apply_bvq_lm(qp, J_DLM, None, jnp.asarray(toks), use_pallas=False)
    got, _ = tqlm.apply_bvq_lm(tp, DLM_SMOKE, torch.from_numpy(toks))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=BVQ_ATOL)


@pytest.mark.parametrize("width", [1, 4])
def test_bvq_paged_window_matches(draft, width):
    qp, tp = draft
    toks = _tokens(4, width, seed=4)
    cache_np = _paged_cache(DLM_SMOKE, seed=5)
    want, want_k, _ = _run_jax_paged(jqlm.apply_bvq_lm, qp, J_DLM, toks, cache_np)
    got, got_k, _ = _run_port_paged(tqlm.apply_bvq_lm, tp, DLM_SMOKE, toks, cache_np)
    np.testing.assert_allclose(got, want, atol=BVQ_ATOL)
    np.testing.assert_allclose(got_k, want_k, atol=BVQ_ATOL)


def test_quantize_dense_lm_matches_reference(target):
    """The port's offline fold + rotate + quantize on the carried float
    params reproduces the reference's packed weights: scales to float32
    rounding and int4 codes except at rare rounding-boundary ties."""
    params, qp, _ = target
    tparams = tqlm.params_from_numpy(to_numpy_tree(params), TLM_SMOKE, "bf16", "cpu")
    ours = tqlm.quantize_dense_lm(tparams, TLM_SMOKE)
    np.testing.assert_allclose(ours["embed"].numpy(), np.asarray(qp["embed"]), atol=1e-5)
    pairs = [(ours["head"], qp["head"])] + [
        (ours["layers"][i][name], {k: np.asarray(v)[i] for k, v in qp["layers"][name].items()})
        for i in range(TLM_SMOKE.n_layers)
        for name in ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down")
    ]
    for mine, ref in pairs:
        np.testing.assert_allclose(mine["sw"].numpy(), np.asarray(ref["sw"]), rtol=1e-5)
        same = np.mean(mine["packed"].numpy() == np.asarray(ref["packed"]))
        assert same > 0.999, same

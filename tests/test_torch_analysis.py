"""The port's analysis helpers against the JAX package on the same numpy
inputs: the paper's performance model (``core/perfmodel.py``), the LRU's
dense matrices, cost and area proxies, FWHT and kurtosis
(``core/rotation.py``), BVQ's bits per weight and plain matmul
(``core/bvq.py``), the offline-quantized linear layer
(``core/quantization.py``), and the Markov toy LM (``core/toylm.py``)
through ``sd_generate`` / ``apsd_generate``.

Tolerances: the performance model, the cost / area proxies, the dense
matrices, bits per weight, the int4 codes and the toy LM's logits table
and tokens are exact; FWHT atol 1e-5 (float32); kurtosis rtol 1e-5; the
weight scales and ``quantized_linear_apply`` rtol 1e-6, the latter once
each int8 activation that a rounding flip made differ (one step apart, at
a .5 boundary: checked) is snapped to the reference's."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")  # the reference side of every test here

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from test_torch_models import one_thread  # noqa: E402,F401

from repro.core import apsd as japsd  # noqa: E402
from repro.core import bvq as jbvq  # noqa: E402
from repro.core import perfmodel as jpm  # noqa: E402
from repro.core import quantization as jquant  # noqa: E402
from repro.core import rotation as jrot  # noqa: E402
from repro.core import speculative as jsd  # noqa: E402
from repro.core import toylm as jtoy  # noqa: E402
from repro_torch.core import apsd as tapsd  # noqa: E402
from repro_torch.core import bvq as tbvq  # noqa: E402
from repro_torch.core import perfmodel as tpm  # noqa: E402
from repro_torch.core import prng  # noqa: E402
from repro_torch.core import quantization as tquant  # noqa: E402
from repro_torch.core import rotation as trot  # noqa: E402
from repro_torch.core import speculative as tsd  # noqa: E402
from repro_torch.core import toylm as ttoy  # noqa: E402

pytestmark = pytest.mark.usefixtures("one_thread")

# the dims tests/test_rotation.py plans and prices
ROTATION_DIMS = [
    352, 768, 896, 1280, 1364, 1408, 1792, 2048, 3584, 4096, 4864, 5120, 6144, 8192, 12288,
    14336, 16384, 22016, 24576, 32768, 53248,
]
FLIP_EPS = 1e-3


# ---------------------------------------------------------------------------
# Performance model
# ---------------------------------------------------------------------------


def _result(r):
    """A DecodingResult as plain values (the enums are each package's own)."""
    return {k: (v.name if hasattr(v, "name") else v) for k, v in dataclasses.asdict(r).items()}


def test_fig6_table_equals_reference():
    table = tpm.fig6_table()
    assert table == jpm.fig6_table()
    assert tpm.PAPER_BANDS == jpm.PAPER_BANDS
    for row in table:
        for key, (lo, hi) in tpm.PAPER_BANDS.items():
            assert lo <= row[key] <= hi, (row["pair"], key, row[key])


@pytest.mark.parametrize("mode", [m.name for m in jpm.SDMode])
def test_simulate_decoding_equals_reference(mode):
    hw_t, hw_j = tpm.HWConfig(), jpm.HWConfig()
    assert dataclasses.asdict(hw_t) == dataclasses.asdict(hw_j)
    for pc_t, pc_j in zip(tpm.fig6_pairs(), jpm.fig6_pairs()):
        got = tpm.simulate_decoding(pc_t.tlm, pc_t.dlm, hw_t, tpm.SDMode[mode], pc_t.alpha,
                                    n_tokens=512, seq_dl=pc_t.seq_dl, short_dl=pc_t.short_dl,
                                    long_dl=pc_t.long_dl, seed=3)
        want = jpm.simulate_decoding(pc_j.tlm, pc_j.dlm, hw_j, jpm.SDMode[mode], pc_j.alpha,
                                     n_tokens=512, seq_dl=pc_j.seq_dl, short_dl=pc_j.short_dl,
                                     long_dl=pc_j.long_dl, seed=3)
        assert _result(got) == _result(want)


@pytest.mark.parametrize("tree_window", [None, 9])
@pytest.mark.parametrize("precision", ["BF16", "W4A8", "BVQ"])
def test_program_model_equals_reference(precision, tree_window):
    for pc_t, pc_j in zip(tpm.fig6_pairs(), jpm.fig6_pairs()):
        for pipelined in (True, False):
            got = tpm.program_model(pc_t.tlm, pc_t.dlm, precision=tpm.Precision[precision],
                                    verify_window=5, draft_window=2, tree_window=tree_window,
                                    pipelined=pipelined)
            want = jpm.program_model(pc_j.tlm, pc_j.dlm, precision=jpm.Precision[precision],
                                     verify_window=5, draft_window=2, tree_window=tree_window,
                                     pipelined=pipelined)
            assert got == want
    lm = tpm.LMSpec("t", 1e9, 8, 1024)
    assert tpm.step_time(lm, tpm.HWConfig(), tpm.Precision.W4A8, 3) == jpm.step_time(
        jpm.LMSpec("t", 1e9, 8, 1024), jpm.HWConfig(), jpm.Precision.W4A8, 3)


# ---------------------------------------------------------------------------
# Rotation helpers
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n", ROTATION_DIMS)
def test_rotation_costs_equal_reference(n):
    plan, jplan = trot.plan_rotation(n), jrot.plan_rotation(n)
    assert (plan.m, plan.k, plan.kind) == (jplan.m, jplan.k, jplan.kind)
    assert trot.rotation_cost(plan) == jrot.rotation_cost(jplan)
    assert trot.rotation_area(plan) == jrot.rotation_area(jplan)
    assert trot.global_rotation_cost(n) == jrot.global_rotation_cost(n)
    assert trot.global_rotation_area(n) == jrot.global_rotation_area(n)


@pytest.mark.parametrize("n", [352, 768, 896, 1364])
def test_dense_rotation_matrices_equal_reference(n):
    plan = trot.plan_rotation(n)
    assert np.array_equal(trot.block_hadamard(plan.m, plan.k),
                          jrot.block_hadamard(plan.m, plan.k))
    r = trot.rotation_matrix(n)
    assert r.dtype == np.float64 and np.array_equal(r, jrot.rotation_matrix(n))


@pytest.mark.parametrize("n,depth", [(64, None), (1024, None), (896, 5), (344, 3)])
def test_fwht_matches_reference(n, depth):
    x = np.random.RandomState(n).randn(6, n).astype(np.float32)
    got = trot.fwht(torch.from_numpy(x), depth).numpy()
    want = np.asarray(jrot.fwht_jnp(jnp.asarray(x), depth))
    np.testing.assert_allclose(got, want, atol=1e-5)
    if depth is None:
        with pytest.raises(ValueError):
            trot.fwht(torch.zeros(2, n + 8))


def test_kurtosis_matches_reference():
    rng = np.random.RandomState(3)
    x = rng.randn(32, 3584).astype(np.float32)
    for ch in (5, 700, 2000, 3583):
        x[:, ch] *= 100.0
    xr = trot.local_rotate(torch.from_numpy(x), trot.plan_rotation(3584))
    for a in (x, xr.numpy()):
        for axis in (-1, 0):
            got = trot.kurtosis(torch.from_numpy(a), axis=axis).numpy()
            np.testing.assert_allclose(got, np.asarray(jrot.kurtosis(jnp.asarray(a), axis)),
                                       rtol=1e-5)
    assert float(trot.kurtosis(xr).mean()) < float(trot.kurtosis(torch.from_numpy(x)).mean()) / 20


# ---------------------------------------------------------------------------
# BVQ helpers
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("cfg", [dict(), dict(vec_dim=8, codebook_size=64, block_cols=32),
                                 dict(vec_dim=4, codebook_size=16, block_cols=64,
                                      codebook_bits=3)])
@pytest.mark.parametrize("k,n", [(256, 64), (4096, 11008), (768, 768)])
def test_bits_per_weight_equals_reference(cfg, k, n):
    assert tbvq.bits_per_weight(tbvq.BVQConfig(**cfg), k, n) == \
        jbvq.bits_per_weight(jbvq.BVQConfig(**cfg), k, n)


def test_bvq_matmul_ref_matches_reference():
    cfg = jbvq.BVQConfig(vec_dim=8, codebook_size=16, block_cols=32, kmeans_iters=4,
                         qat_steps=0)
    w = np.random.RandomState(0).randn(128, 64).astype(np.float32)
    jw = jbvq.bvq_compress(jnp.asarray(w), cfg, jax.random.PRNGKey(0))
    tw = tbvq.BVQWeight(*(torch.from_numpy(np.asarray(a).copy())
                          for a in (jw.codebooks, jw.scales, jw.indices)), jw.shape, jw.vec_dim)
    x = np.random.RandomState(1).randn(5, 128).astype(np.float32)
    got = tbvq.bvq_matmul_ref(torch.from_numpy(x), tw).numpy()
    np.testing.assert_allclose(got, np.asarray(jbvq.bvq_matmul_ref(jnp.asarray(x), jw)),
                               atol=1e-5, rtol=1e-5)


# ---------------------------------------------------------------------------
# The offline-quantized linear layer
# ---------------------------------------------------------------------------


def _snap_act(monkeypatch, x):
    """The port's activation quantizer with its int8 codes snapped to the
    reference's for the same input where a rounding flip made them differ
    (checked: one step apart, x/s within FLIP_EPS of a .5 boundary)."""
    want = np.asarray(jquant.quantize_act_int8(jnp.asarray(x))[0])
    flips, quantize = [], tquant.quantize_act_int8

    def snap(a, axis=-1):
        xq, s = quantize(a, axis)
        ref = torch.from_numpy(want.reshape(xq.shape).copy())
        off = xq != ref
        ratio = (a.float() / s)[off]
        assert torch.all((xq[off].int() - ref[off].int()).abs() == 1), "not a one-step flip"
        assert torch.all(((ratio.abs() % 1) - 0.5).abs() < FLIP_EPS), ratio
        flips.append(int(off.sum()))
        return torch.where(off, ref, xq), s

    monkeypatch.setattr(tquant, "quantize_act_int8", snap)
    return flips


@pytest.mark.parametrize("rotate", [False, True])
@pytest.mark.parametrize("k,n", [(896, 128), (344, 96), (3584, 64)])
def test_quantized_linear_matches_reference(monkeypatch, k, n, rotate):
    rng = np.random.RandomState(k + n)
    x = rng.randn(2, 16, k).astype(np.float32)
    x[..., [3, k // 2]] *= 60.0
    w = (rng.randn(k, n) * 0.05).astype(np.float32)
    if rotate:  # the quickstart's LRU arm: x @ R against R^T w
        plan = trot.plan_rotation(k)
        x = trot.local_rotate(torch.from_numpy(x), plan).numpy()
        w = trot.rotate_weight_in(torch.from_numpy(w), plan).numpy()
    jql = jquant.quantize_linear_weights(jnp.asarray(w))
    tql = tquant.quantize_linear_weights(torch.from_numpy(w))
    assert np.array_equal(tql.wq.numpy(), np.asarray(jql.wq))
    np.testing.assert_allclose(tql.sw.numpy(), np.asarray(jql.sw), rtol=1e-6)
    assert tql.bits == jql.bits == 4 and tql.packed is not None
    carried = tquant.QuantizedLinear.from_reference(jql, device="cpu")
    assert torch.equal(carried.wq, tql.wq) and torch.equal(carried.packed, tql.packed)
    flips = _snap_act(monkeypatch, x)
    got = tquant.quantized_linear_apply(torch.from_numpy(x), carried)
    want = np.asarray(jquant.quantized_linear_apply(jnp.asarray(x), jql))
    assert got.dtype == torch.float32 and got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)
    print(f"int8 activation flips snapped: {flips}")
    ref_sqnr = tquant.sqnr_db(torch.from_numpy(x @ w), got)
    assert ref_sqnr == pytest.approx(float(jquant.sqnr_db(jnp.asarray(x @ w), want)), rel=1e-5)


def test_div_scalar_is_true_division():
    a = np.random.RandomState(0).rand(4096).astype(np.float32) * 100
    for value in (127, 7, 127.0):
        got = tquant.div_scalar(torch.from_numpy(a), value).numpy()
        assert np.array_equal(got, a / np.float32(value))
    assert tquant.div_scalar(torch.ones(3, dtype=torch.bfloat16), 7).dtype == torch.bfloat16


def test_quantized_linear_apply_keeps_dtype_and_plain_matmul():
    rng = np.random.RandomState(7)
    w = torch.from_numpy((rng.randn(64, 32) * 0.1).astype(np.float32))
    ql = tquant.quantize_linear_weights(w)
    x = torch.from_numpy(rng.randn(3, 64).astype(np.float32))
    y = tquant.quantized_linear_apply(x.to(torch.bfloat16), ql)
    assert y.dtype == torch.bfloat16
    xq, sx = tquant.quantize_act_int8(x)
    want = (xq.double() @ ql.wq.double()).int().float() * sx * ql.sw
    assert torch.equal(tquant.w4a8_matmul_ref(xq, sx, ql.wq, ql.sw), want)
    odd = tquant.quantize_linear_weights(w[:63])
    assert odd.packed is None  # odd K: the plain version only


# ---------------------------------------------------------------------------
# The Markov toy LM through the speculative generators
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def markov():
    """(JAX target / draft tables, the port's copies) from the reference's
    key split; the port's target table made by its own generator."""
    kt, kd = jax.random.split(jax.random.PRNGKey(0))
    tp = jtoy.random_transition_logits(kt, 24, sharpness=1.5)
    dp = tp + 1.2 * jax.random.normal(kd, (24, 24))
    return (tp, dp), tuple(torch.from_numpy(np.asarray(a).copy()) for a in (tp, dp))


@pytest.mark.parametrize("vocab,sharpness,seed", [(24, 1.5, 0), (64, 2.0, 1), (7, 1.0, 5)])
def test_random_transition_logits_bitwise(vocab, sharpness, seed):
    got = ttoy.random_transition_logits(prng.PRNGKey(seed), vocab, sharpness)
    want = np.asarray(jtoy.random_transition_logits(jax.random.PRNGKey(seed), vocab,
                                                     sharpness))
    assert got.dtype == np.float32 and np.array_equal(got.view(np.uint32),
                                                      want.view(np.uint32))


@pytest.mark.parametrize("seed", [0, 3, 2**31 - 1])
def test_normal_draws_bitwise(seed):
    """The draws under the toy LM's tables: XLA's CPU log1p reproduced,
    every value equal bit for bit."""
    for shape in [(24, 24), (64, 64), (7, 1000)]:
        got = prng.normal(prng.PRNGKey(seed), shape)
        want = np.asarray(jax.random.normal(jax.random.PRNGKey(seed), shape))
        assert np.array_equal(got.view(np.uint32), want.view(np.uint32))


def test_markov_greedy_decode_equals_reference(markov):
    (tp, _), (ttp, _) = markov
    assert ttoy.markov_greedy_decode(ttp, 5, 40).tolist() == \
        np.asarray(jtoy.markov_greedy_decode(tp, 5, 40)).tolist()


@pytest.mark.parametrize("temperature", [0.0, 0.8])
@pytest.mark.parametrize("draft_len", [1, 4, 7])
def test_markov_sd_generate_equals_reference(markov, draft_len, temperature):
    (tp, dp), (ttp, tdp) = markov
    cfg = dict(draft_len=draft_len, temperature=temperature, max_tokens=40)
    want, jst = jsd.sd_generate(jax.random.PRNGKey(1), jtoy.make_markov_lm(512), tp,
                                jtoy.make_markov_lm(512), dp, jnp.asarray([[3, 5]], jnp.int32),
                                jsd.SDConfig(**cfg))
    lm = ttoy.make_markov_lm(512, device="cpu")
    got, st = tsd.sd_generate(prng.PRNGKey(1), lm, ttp, lm, tdp,
                              torch.tensor([[3, 5]], dtype=torch.int32), tsd.SDConfig(**cfg))
    assert got.tolist() == np.asarray(want).tolist()
    assert (st.emitted, st.rounds, st.drafted, st.accepted) == tuple(
        int(v) for v in (jst.emitted, jst.rounds, jst.drafted, jst.accepted))
    if temperature == 0.0:
        assert got.tolist() == ttoy.markov_greedy_decode(ttp, 5, 40).tolist()


@pytest.mark.parametrize("temperature", [0.0, 0.8])
@pytest.mark.parametrize("short_dl,long_dl", [(2, 4), (4, 8), (1, 2)])
def test_markov_apsd_generate_equals_reference(markov, short_dl, long_dl, temperature):
    (tp, dp), (ttp, tdp) = markov
    cfg = dict(short_dl=short_dl, long_dl=long_dl, temperature=temperature, max_tokens=40)
    want, jst = japsd.apsd_generate(jax.random.PRNGKey(2), jtoy.make_markov_lm(512), tp,
                                    jtoy.make_markov_lm(512), dp,
                                    jnp.asarray([[3, 5]], jnp.int32), japsd.APSDConfig(**cfg))
    lm = ttoy.make_markov_lm(512, device="cpu")
    got, st = tapsd.apsd_generate(prng.PRNGKey(2), lm, ttp, lm, tdp,
                                  torch.tensor([[3, 5]], dtype=torch.int32),
                                  tapsd.APSDConfig(**cfg))
    assert got.tolist() == np.asarray(want).tolist()
    assert st.records == tuple(tuple(int(v) for v in r) for r in jst.records)
    if temperature == 0.0:
        assert got.tolist() == ttoy.markov_greedy_decode(ttp, 5, 40).tolist()

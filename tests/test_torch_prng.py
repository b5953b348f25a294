"""The port's numpy threefry (repro_torch/core/prng.py) against jax.random
on the same seeds: key data, split and fold_in, raw bits and float32
uniforms must be equal bit for bit; Gumbel values within 8 ulp; categorical
draws equal, except where the test shows an ulp-level tie.

The ulp of a Gumbel value g is taken at max(|g|, 1): g = -log(-log(u))
cancels near g = 0, where the inner -log(u) is near 1 and carries the
ulp of 1.0, so a last-bit difference of the inner log (numpy's and XLA's
log differ by up to a few ulp) is an absolute error of that size there."""
import numpy as np
import pytest

pytest.importorskip("jax")
import jax  # noqa: E402

from repro_torch.core import prng  # noqa: E402

SEEDS = [0, 1, 42, 2**31 - 1, -7]
SHAPES = [(), (1,), (5,), (3, 4), (32000,)]
TINY = float(np.finfo(np.float32).tiny)
ULPS = 8


def _ulps(a, b):
    """|a - b| in ulps of max(|a|, |b|, 1) (float32)."""
    scale = np.maximum(np.maximum(np.abs(a), np.abs(b)), np.float32(1.0)).astype(np.float32)
    return np.abs(a.astype(np.float64) - b.astype(np.float64)) / np.spacing(scale)


@pytest.mark.parametrize("seed", SEEDS + [2**40 + 5, -(2**40)])
def test_prng_key_data(seed):
    np.testing.assert_array_equal(prng.PRNGKey(seed), np.asarray(jax.random.PRNGKey(seed)))
    assert prng.PRNGKey(seed).dtype == np.uint32


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("n", [2, 3, 7])
def test_split(seed, n):
    want = np.asarray(jax.random.split(jax.random.PRNGKey(seed), n))
    np.testing.assert_array_equal(prng.split(prng.PRNGKey(seed), n), want)


@pytest.mark.parametrize("seed", SEEDS)
def test_fold_in_nested(seed):
    """fold_in with data 0, 1 and 2^31, nested three deep in every order,
    and after a split (the engine's key streams fold a stream id, a round
    and a position into the seed key)."""
    jk, pk = jax.random.PRNGKey(seed), prng.PRNGKey(seed)
    for a in (0, 1, 2**31):
        for b in (0, 1, 2**31):
            for c in (0, 1, 2**31):
                want = jax.random.fold_in(jax.random.fold_in(jax.random.fold_in(jk, a), b), c)
                got = prng.fold_in(prng.fold_in(prng.fold_in(pk, a), b), c)
                np.testing.assert_array_equal(got, np.asarray(want))
    want = jax.random.fold_in(jax.random.split(jk)[1], 5)
    np.testing.assert_array_equal(prng.fold_in(prng.split(pk)[1], 5), np.asarray(want))


def test_fold_in_refuses_what_jax_refuses():
    with pytest.raises(OverflowError):
        prng.fold_in(prng.PRNGKey(0), -1)
    with pytest.raises(OverflowError):
        prng.fold_in(prng.PRNGKey(0), 2**32)


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_random_bits_and_uniform_bitwise(seed, shape):
    jk = jax.random.fold_in(jax.random.PRNGKey(seed), 3)
    pk = prng.fold_in(prng.PRNGKey(seed), 3)
    bits = prng.random_bits(pk, shape)
    want = np.asarray(jax.random.bits(jk, shape, dtype=np.uint32))
    assert bits.shape == want.shape and bits.dtype == np.uint32
    np.testing.assert_array_equal(bits, want)
    for lo, hi in ((0.0, 1.0), (TINY, 1.0), (-2.0, 3.0)):
        got = prng.uniform(pk, shape, lo, hi)
        want = np.asarray(jax.random.uniform(jk, shape, minval=lo, maxval=hi))
        assert got.shape == want.shape and got.dtype == np.float32
        np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_gumbel_within_8_ulp(seed, shape):
    jk, pk = jax.random.PRNGKey(seed), prng.PRNGKey(seed)
    got = prng.gumbel(pk, shape)
    want = np.asarray(jax.random.gumbel(jk, shape))
    assert got.shape == want.shape and got.dtype == np.float32
    assert float(_ulps(got, want).max(initial=0.0)) <= ULPS


def _filtered(lg, rng):
    """Top-k then nucleus filtering of one row, as the host samplers do it
    (so the row holds -inf entries)."""
    from repro_torch.core.speculative import _top_k_filter_host, _top_p_filter_host

    lg = _top_k_filter_host(lg, int(rng.choice([5, 50, 500]))) / np.float32(0.8)
    return _top_p_filter_host(lg, float(rng.choice([0.5, 0.9])))


@pytest.mark.parametrize("filtered", [False, True], ids=["random", "top-k-top-p"])
def test_categorical_draws(filtered):
    """300 keys at V = 32000: every draw equals jax.random.categorical's,
    unless the top two perturbed scores (ours) lie within 8 ulp, which the
    test then shows."""
    rng = np.random.RandomState(11 + filtered)
    base = jax.random.PRNGKey(123)
    excused = 0
    for i in range(300):
        lg = (rng.randn(32000) * 3.0).astype(np.float32)
        if filtered:
            lg = _filtered(lg, rng)
            assert np.isneginf(lg).any()
        jk = jax.random.fold_in(base, i)
        pk = prng.fold_in(prng.PRNGKey(123), i)
        want = int(jax.random.categorical(jk, lg))
        got = prng.categorical(pk, lg)
        if got != want:
            scores = prng.gumbel(pk, lg.shape) + lg
            top2 = np.sort(scores)[-2:]
            assert float(_ulps(top2[:1], top2[1:])[0]) <= ULPS, (i, got, want, top2)
            excused += 1
    assert excused <= 3  # ulp-level ties are rare

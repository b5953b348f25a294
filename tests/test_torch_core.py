"""Port core numerics against the JAX reference: int4 packing, W4A8
quantizers, LRU rotation plans and applies, BVQ decode and compression.

Inputs come from seeded numpy and go through both packages."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")  # the reference side of every test here

import jax
import jax.numpy as jnp

from repro.core import bvq as jbvq
from repro.core import quantization as jq
from repro.core import rotation as jrot
from repro_torch.core import bvq as tbvq
from repro_torch.core import quantization as tq
from repro_torch.core import rotation as trot


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.mark.parametrize("axis", [0, 1])
def test_pack_unpack_int4_bit_exact(axis):
    rng = np.random.RandomState(0)
    q = rng.randint(-8, 8, (64, 48)).astype(np.int8)
    want = np.asarray(jq.pack_int4(jnp.asarray(q), axis=axis))
    got = tq.pack_int4(_t(q), axis=axis).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(tq.unpack_int4(_t(got), axis=axis).numpy(), q)
    np.testing.assert_array_equal(
        tq.unpack_int4(_t(got), axis=axis).numpy(),
        np.asarray(jq.unpack_int4(jnp.asarray(want), axis=axis)),
    )


def test_quantize_act_int8_bit_exact():
    rng = np.random.RandomState(1)
    x = (rng.randn(32, 96) * rng.rand(32, 1) * 5).astype(np.float32)
    # values sitting exactly on .5 quantization boundaries: round half to even
    x[0, :4] = np.float32(127.0) * np.array([1.0, 0.5 / 127, 1.5 / 127, 2.5 / 127], np.float32)
    jq_, js = jq.quantize_act_int8(jnp.asarray(x))
    q_, s = tq.quantize_act_int8(_t(x))
    np.testing.assert_array_equal(q_.numpy(), np.asarray(jq_))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))


@pytest.mark.parametrize("axis", [0, (0, 1)])
def test_quantize_weight_int_bit_exact(axis):
    rng = np.random.RandomState(2)
    w = rng.randn(64, 40).astype(np.float32)
    jq_, js = jq.quantize_weight_int(jnp.asarray(w), bits=4, axis=axis)
    q_, s = tq.quantize_weight_int(_t(w), bits=4, axis=axis)
    np.testing.assert_array_equal(q_.numpy(), np.asarray(jq_))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))


@pytest.mark.parametrize("n", [64, 128, 344, 768, 3072, 4096, 11008])
def test_plan_rotation_matches_reference(n):
    want = jrot.plan_rotation(n)
    got = trot.plan_rotation(n)
    assert (got.n, got.m, got.k, got.kind) == (want.n, want.m, want.k, want.kind)


# exact (896, 768), tiled (4864), two_block (344, 200)
@pytest.mark.parametrize("n", [896, 768, 4864, 344, 200])
def test_rotations_match_reference(n):
    plan_j, plan_t = jrot.plan_rotation(n), trot.plan_rotation(n)
    rng = np.random.RandomState(3)
    x = rng.randn(5, n).astype(np.float32)
    w = rng.randn(n, 24).astype(np.float32)
    np.testing.assert_allclose(
        trot.local_rotate(_t(x), plan_t).numpy(),
        np.asarray(jrot.local_rotate(jnp.asarray(x), plan_j)), atol=2e-4,
    )
    np.testing.assert_allclose(
        trot.local_rotate_transpose(_t(x), plan_t).numpy(),
        np.asarray(jrot.local_rotate_transpose(jnp.asarray(x), plan_j)), atol=2e-4,
    )
    np.testing.assert_allclose(
        trot.rotate_weight_in(_t(w), plan_t).numpy(),
        np.asarray(jrot.rotate_weight_in(jnp.asarray(w), plan_j)), atol=2e-4,
    )


def _jax_bvq(w, cfg, seed=0):
    return jbvq.bvq_compress(jnp.asarray(w), cfg, jax.random.PRNGKey(seed))


def _carried(bw):
    return tbvq.BVQWeight(
        codebooks=_t(np.asarray(bw.codebooks)),
        scales=_t(np.asarray(bw.scales)),
        indices=_t(np.asarray(bw.indices)),
        shape=tuple(bw.shape),
        vec_dim=bw.vec_dim,
    )


def test_bvq_reconstruct_exact_on_carried_weights():
    rng = np.random.RandomState(4)
    cfg = jbvq.BVQConfig(vec_dim=4, codebook_size=16, block_cols=16, kmeans_iters=4, qat_steps=0)
    bw = _jax_bvq(rng.randn(64, 48).astype(np.float32), cfg)
    got = tbvq.bvq_reconstruct(_carried(bw)).numpy()
    np.testing.assert_array_equal(got, np.asarray(jbvq.bvq_reconstruct(bw)))


def test_bvq_compress_sqnr_within_1db_of_reference():
    rng = np.random.RandomState(5)
    w = rng.randn(128, 64).astype(np.float32)
    jcfg = jbvq.BVQConfig(vec_dim=4, codebook_size=64, block_cols=32, kmeans_iters=8, qat_steps=0)
    tcfg = tbvq.BVQConfig(vec_dim=4, codebook_size=64, block_cols=32, kmeans_iters=8, qat_steps=0)
    j_sqnr = float(jq.sqnr_db(jnp.asarray(w), jbvq.bvq_reconstruct(_jax_bvq(w, jcfg))))
    bw = tbvq.bvq_compress(_t(w), tcfg, torch.Generator().manual_seed(0))
    assert bw.indices.dtype == torch.int32 and bw.codebooks.dtype == torch.int8
    assert tuple(bw.indices.shape) == (2, 32, 32) and tuple(bw.scales.shape) == (2, 1, 1)
    t_sqnr = tq.sqnr_db(_t(w), tbvq.bvq_reconstruct(bw))
    assert abs(t_sqnr - j_sqnr) < 1.0, (t_sqnr, j_sqnr)

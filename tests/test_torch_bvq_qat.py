"""BVQ quantization-aware refinement in the port against the JAX package:
the straight-through fake quantizers (values and gradients against
``jax.grad``), ``_qat_refine`` fed the reference's own per-block Gumbel
draws, and the reference's BVQ unit cases (``tests/test_bvq.py``) with
``qat_steps=20`` run through the port.

Tolerances: fake-quant values and gradients exactly (one rounding rule,
one division); refined centroids within 1e-4 of the reference's; hard
assignments equal except at a row whose final logits' top-2 margin is at
most 1e-4 (there float32 rounding in either package may pick the other
entry)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")  # the reference side of every test here

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import bvq as jbvq  # noqa: E402
from repro.core import quantization as jq  # noqa: E402
from repro_torch.core import bvq as tbvq  # noqa: E402
from repro_torch.core import quantization as tq  # noqa: E402
from repro_torch.kernels import ref as kref  # noqa: E402

CENT_ATOL = 1e-4
MARGIN = 1e-4
# the reference's tests/test_bvq.py configuration
CFG = dict(vec_dim=4, codebook_size=32, block_cols=16, kmeans_iters=8, qat_steps=20)


def _w(shape, seed):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


@pytest.mark.parametrize("bits,axis", [(4, 0), (4, 1), (3, (0, 1)), (8, 0)])
def test_fake_quant_weight_values_and_ste_grad(bits, axis):
    w = _w((32, 16), 4) * 3.0
    up = _w((32, 16), 5)
    want = np.asarray(jq.fake_quant_weight(jnp.asarray(w), bits=bits, axis=axis))
    want_g = np.asarray(jax.grad(
        lambda x: jnp.sum(jq.fake_quant_weight(x, bits=bits, axis=axis) * up))(jnp.asarray(w)))
    wt = torch.tensor(w, requires_grad=True)
    got = tq.fake_quant_weight(wt, bits=bits, axis=axis)
    (g,) = torch.autograd.grad((got * torch.tensor(up)).sum(), wt)
    np.testing.assert_array_equal(got.detach().numpy(), want)
    np.testing.assert_array_equal(g.numpy(), want_g)
    np.testing.assert_array_equal(g.numpy(), up)  # straight through


@pytest.mark.parametrize("axis", [-1, 0])
def test_fake_quant_act_values_and_ste_grad(axis):
    x = _w((8, 24), 6) * 2.0
    want = np.asarray(jq.fake_quant_act(jnp.asarray(x), axis=axis))
    want_g = np.asarray(jax.grad(lambda v: jnp.sum(jq.fake_quant_act(v, axis=axis) ** 2))(
        jnp.asarray(x)))
    xt = torch.tensor(x, requires_grad=True)
    got = tq.fake_quant_act(xt, axis=axis)
    (g,) = torch.autograd.grad((got ** 2).sum(), xt)
    np.testing.assert_array_equal(got.detach().numpy(), want)
    np.testing.assert_allclose(g.numpy(), want_g, rtol=1e-6, atol=0)


def test_fake_quant_rounds_half_to_even():
    """torch.round and jnp.round both round .5 to the even integer."""
    w = np.array([[0.5, 1.5, 2.5, -0.5, -2.5, 7.0]], np.float32).T  # scale 1 at bits=4
    got = tq.fake_quant_weight(torch.tensor(w), bits=4, axis=0).numpy()
    want = np.asarray(jq.fake_quant_weight(jnp.asarray(w), bits=4, axis=0))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got[:, 0], [0.0, 2.0, 2.0, -0.0, -2.0, 7.0])


def _blocks(w, cfg):
    """(K, N) -> (nb, V, v), the compressor's block layout."""
    k, n = w.shape
    nb, rows = n // cfg.block_cols, k // cfg.vec_dim
    wb = w.reshape(rows, cfg.vec_dim, nb, cfg.block_cols).transpose(2, 0, 3, 1)
    return wb.reshape(nb, rows * cfg.block_cols, cfg.vec_dim)


@pytest.mark.parametrize("seed", [0, 1])
def test_qat_refine_matches_reference_on_its_noise(seed):
    """Three blocks of a K=32, N=96 weight (block_cols=32, C=16, 8 steps):
    both packages start from the reference's k-means centroids and draw
    step i's noise from the reference's key stream (bvq.py: split, then
    gumbel per step), so the refinement must follow it."""
    cfg_kw = dict(vec_dim=4, codebook_size=16, block_cols=32, kmeans_iters=6, qat_steps=8)
    jcfg, tcfg = jbvq.BVQConfig(**cfg_kw), tbvq.BVQConfig(**cfg_kw)
    vecs = _blocks(_w((32, 96), 10 + seed), jcfg)  # (3, 256, 4)
    nb = vecs.shape[0]
    keys = jax.random.split(jax.random.PRNGKey(seed), nb)
    cents, noise_keys = [], []
    for b in range(nb):
        k1, k2 = jax.random.split(keys[b])
        cents.append(np.asarray(jbvq.kmeans(jnp.asarray(vecs[b]), 16, 6, k1)[0]))
        noise_keys.append(k2)
    cents = np.stack(cents)
    want_cb, want_assign = jax.vmap(lambda v, c, k: jbvq._qat_refine(v, c, jcfg, k))(
        jnp.asarray(vecs), jnp.asarray(cents), jnp.stack(noise_keys))
    # the reference's per-step draws, block by block
    noise = np.zeros((cfg_kw["qat_steps"], nb, vecs.shape[1], 16), np.float32)
    for b, key in enumerate(noise_keys):
        for i in range(cfg_kw["qat_steps"]):
            key, sub = jax.random.split(key)
            noise[i, b] = np.asarray(jax.random.gumbel(sub, (vecs.shape[1], 16), jnp.float32))
    got_cb, got_assign, logits = tbvq._qat_refine(
        torch.tensor(vecs), torch.tensor(cents), tcfg, noise=torch.tensor(noise))
    np.testing.assert_allclose(got_cb.numpy(), np.asarray(want_cb), rtol=0, atol=CENT_ATOL)
    top2 = torch.topk(logits, 2, dim=-1).values
    near_tie = (top2[..., 0] - top2[..., 1]).numpy() <= MARGIN
    differ = got_assign.numpy() != np.asarray(want_assign)
    assert not np.any(differ & ~near_tie), int(np.sum(differ & ~near_tie))
    assert np.mean(differ) < 0.01


# -- the reference's tests/test_bvq.py cases, through the port ---------------


def test_kmeans_converges_on_clustered_data():
    rng = np.random.RandomState(0)
    centers = rng.randn(8, 4).astype(np.float32) * 5.0
    pts = centers[rng.randint(0, 8, 512)] + 0.01 * rng.randn(512, 4).astype(np.float32)
    cent, assign = tbvq.kmeans(torch.tensor(pts)[None], 8, 20, torch.Generator().manual_seed(3))
    recon = tbvq._rows(cent, assign)[0].numpy()
    assert np.mean((recon - pts) ** 2) / np.mean(pts ** 2) < 1e-3


def test_compress_reconstruct_shapes_and_error():
    w = _w((64, 32), 0)
    bw = tbvq.bvq_compress(torch.tensor(w), tbvq.BVQConfig(**CFG), torch.Generator().manual_seed(0))
    assert tuple(bw.codebooks.shape) == (2, 32, 4)
    assert tuple(bw.indices.shape) == (2, 16, 16)
    assert int(bw.indices.max()) < 32 and int(bw.indices.min()) >= 0
    wr = tbvq.bvq_reconstruct(bw).numpy()
    assert wr.shape == (64, 32)
    assert np.mean((wr - w) ** 2) / np.mean(w ** 2) < 0.5
    # the reference's compressor on the same weight reaches the same band
    jw = np.asarray(jbvq.bvq_reconstruct(jbvq.bvq_compress(
        jnp.asarray(w), jbvq.BVQConfig(**CFG), jax.random.PRNGKey(0))))
    assert np.mean((jw - w) ** 2) / np.mean(w ** 2) < 0.5


def test_structured_weights_compress_well():
    rng = np.random.RandomState(1)
    basis = rng.randn(8, 4).astype(np.float32)
    rows = basis[rng.randint(0, 8, size=16 * 16)].reshape(16, 16, 4)
    w = rows.transpose(0, 2, 1).reshape(64, 16)
    cfg = tbvq.BVQConfig(vec_dim=4, codebook_size=16, block_cols=16, kmeans_iters=12,
                         qat_steps=0)
    bw = tbvq.bvq_compress(torch.tensor(w), cfg, torch.Generator().manual_seed(0))
    wr = tbvq.bvq_reconstruct(bw).numpy()
    assert np.mean((wr - w) ** 2) / np.mean(w ** 2) < 2e-2


def test_bvq_matmul_matches_reconstruct():
    w, x = _w((64, 32), 2), _w((5, 64), 7)
    bw = tbvq.bvq_compress(torch.tensor(w), tbvq.BVQConfig(**CFG), torch.Generator().manual_seed(1))
    cb = tbvq.dequant_codebooks(bw)
    y = kref.bvq_matmul_ref2(torch.tensor(x), cb, bw.indices)
    ref = x @ tbvq.bvq_reconstruct(bw).numpy()
    np.testing.assert_allclose(y.numpy(), ref, rtol=1e-4, atol=1e-4)


def test_fake_quant_has_gradients():
    w = torch.tensor(_w((32, 16), 4), requires_grad=True)
    (g,) = torch.autograd.grad((tq.fake_quant_weight(w, bits=4) ** 2).sum(), w)
    assert bool(torch.isfinite(g).all()) and float(g.abs().sum()) > 0.0

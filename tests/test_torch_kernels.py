"""Port kernels: each plain version against the JAX Pallas kernel (interpret
mode on the CPU) at the reference tests' tolerances, and — on a card only
(``cuda`` marker) — each CUDA kernel against its plain version.

Inputs come from seeded numpy and go through both packages."""
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import bvq as tbvq
from repro_torch.core import quantization as tq
from repro_torch.core import rotation as trot
from repro_torch.kernels import ops, ref
from repro_torch.kernels.bvq_matmul import bvq_matmul
from repro_torch.kernels.fwht import block_rotate
from repro_torch.kernels.paged_attn import paged_attention
from repro_torch.kernels.w4a8_matmul import w4a8_matmul


def _t(a, device="cpu"):
    return torch.from_numpy(np.array(a)).to(device)


@pytest.fixture
def jx():
    """The JAX reference (Pallas kernels in interpret mode), imported only
    by the CPU parity tests: a GPU machine without JAX still runs the card
    tests of this file."""
    pytest.importorskip("jax")
    import jax.numpy as jnp

    from repro.core import bvq
    from repro.kernels.bvq_matmul import bvq_matmul_pallas
    from repro.kernels.fwht import block_rotate_pallas
    from repro.kernels.paged_attn import paged_decode_attention_pallas
    from repro.kernels.w4a8_matmul import w4a8_matmul_pallas

    return types.SimpleNamespace(
        jnp=jnp, bvq=bvq, bvq_matmul=bvq_matmul_pallas,
        block_rotate=block_rotate_pallas, paged=paged_decode_attention_pallas,
        w4a8=w4a8_matmul_pallas,
    )


@pytest.fixture
def cuda():
    """The card, or a skip: decided here, inside the test, never at import."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernels have no CPU mode)")
    return torch.device("cuda")


# ---------------------------------------------------------------------------
# Inputs shared by the CPU parity tests and the card tests
# ---------------------------------------------------------------------------


def _w4a8_inputs(m, k, n, seed=4):
    rng = np.random.RandomState(seed)
    xq = rng.randint(-127, 128, (m, k)).astype(np.int8)
    wq = rng.randint(-7, 8, (k, n)).astype(np.int8)
    wp = tq.pack_int4(torch.from_numpy(wq), axis=0).numpy()
    sx = rng.rand(m, 1).astype(np.float32)
    sw = rng.rand(1, n).astype(np.float32)
    return xq, wq, wp, sx, sw


def _bvq_inputs(m, k, n, vec, cbs, bc, seed=7):
    """x, the BVQWeight fields (numpy), dequantized codebooks and indices."""
    rng = np.random.RandomState(seed)
    cfg = tbvq.BVQConfig(vec_dim=vec, codebook_size=cbs, block_cols=bc, kmeans_iters=4,
                         qat_steps=0)
    bw = tbvq.bvq_compress(torch.from_numpy(rng.randn(k, n).astype(np.float32)), cfg,
                           torch.Generator().manual_seed(0))
    x = rng.randn(m, k).astype(np.float32)
    return x, bw, tbvq.dequant_codebooks(bw).numpy(), bw.indices.numpy()


def _paged_inputs(b, w, kvs, g, hd, ps, mp, n_pages, lengths, seed=11):
    """Pools of random values, distinct pages per row, and GARBAGE (any
    in-range id) in every table slot a row does not own."""
    rng = np.random.RandomState(seed)
    shape5 = (b, w, kvs, g, hd)
    q = rng.randn(*shape5).astype(np.float32)
    k_pool = rng.randn(n_pages, ps, kvs, hd).astype(np.float32)
    v_pool = rng.randn(n_pages, ps, kvs, hd).astype(np.float32)
    perm = rng.permutation(n_pages)
    table = rng.randint(0, n_pages, (b, mp)).astype(np.int32)
    used = 0
    for i, ln in enumerate(lengths):
        own = -(-ln // ps)
        table[i, :own] = perm[used:used + own]
        used += own
    return q, k_pool, v_pool, table, np.asarray(lengths, np.int32)


# ---------------------------------------------------------------------------
# Plain versions vs the Pallas kernels (CPU)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize(
    "m,k,nb,tokens",
    [(4, 6, 2, 8), (8, 6, 4, 5), (12, 3, 3, 7), (20, 6, 1, 5), (28, 5, 1, 16), (32, 6, 1, 4)],
)
@pytest.mark.parametrize("transpose", [False, True])
def test_block_rotate_plain_matches_pallas(jx, m, k, nb, tokens, transpose):
    n = (m << k) * nb
    x = np.random.RandomState(0).randn(tokens, n).astype(np.float32)
    want = np.asarray(jx.block_rotate(jx.jnp.asarray(x), m, k, transpose=transpose))
    got = block_rotate(_t(x), m, k, transpose=transpose).numpy()
    np.testing.assert_allclose(got, want, atol=2e-4)


def test_block_rotate_plain_matches_pallas_bf16(jx):
    x = np.random.RandomState(1).randn(8, 512).astype(np.float32)
    want = np.asarray(jx.block_rotate(jx.jnp.asarray(x, jx.jnp.bfloat16), 8, 6), np.float32)
    got = block_rotate(_t(x).to(torch.bfloat16), 8, 6).float().numpy()
    np.testing.assert_allclose(got, want, atol=5e-2, rtol=5e-2)


@pytest.mark.parametrize(
    "m,k,n", [(8, 64, 32), (128, 512, 256), (4, 256, 128), (96, 768, 384), (1, 128, 64)]
)
def test_w4a8_plain_matches_pallas(jx, m, k, n):
    xq, _, wp, sx, sw = _w4a8_inputs(m, k, n)
    want = np.asarray(jx.w4a8(*(jx.jnp.asarray(a) for a in (xq, wp, sx, sw))))
    got = w4a8_matmul(_t(xq), _t(wp), _t(sx), _t(sw)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6)


def test_w4a8_plain_integer_exact():
    """With unit scales the product is bit-exact against int64 numpy."""
    xq, wq, wp, _, _ = _w4a8_inputs(16, 256, 64, seed=5)
    got = w4a8_matmul(_t(xq), _t(wp), torch.ones(16, 1), torch.ones(1, 64)).numpy()
    assert np.array_equal(got.astype(np.int64), xq.astype(np.int64) @ wq.astype(np.int64))


@pytest.mark.parametrize(
    "mk,nn,vec,cbs,bc",
    [((8, 64), 48, 4, 32, 16), ((32, 128), 128, 8, 64, 32), ((1, 256), 64, 8, 16, 64),
     ((16, 96), 96, 4, 16, 48)],
)
def test_bvq_plain_matches_pallas(jx, mk, nn, vec, cbs, bc):
    m, k = mk
    x, bw, cb, idx = _bvq_inputs(m, k, nn, vec, cbs, bc)
    jbw = jx.bvq.BVQWeight(*(jx.jnp.asarray(t.numpy()) for t in
                             (bw.codebooks, bw.scales, bw.indices)), bw.shape, bw.vec_dim)
    want = np.asarray(jx.bvq_matmul(jx.jnp.asarray(x), jbw))
    got = bvq_matmul(_t(x), _t(cb), _t(idx)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("window", [1, 4])
@pytest.mark.parametrize("group", [1, 2])
def test_paged_attention_plain_matches_pallas(jx, window, group):
    # row 1 has length 0 (finite garbage output); row 3's length is < W
    # when W = 4, so its early window queries see nothing either
    lengths = [37, 0, 16, 3 if window == 4 else 1]
    q, kp, vp, table, lens = _paged_inputs(4, window, 2, group, 16, 8, 6, 24, lengths)
    q_in = q if window > 1 else q[:, 0]
    want = np.asarray(jx.paged(*(jx.jnp.asarray(a) for a in (q_in, kp, vp, table, lens))))
    got = paged_attention(_t(q_in), _t(kp), _t(vp), _t(table), _t(lens)).numpy()
    assert np.all(np.isfinite(got))
    np.testing.assert_allclose(got, want, atol=2e-5)


def test_lru_rotate_plans_roundtrip():
    for n in (344, 4864, 896):  # two_block, tiled, exact
        plan = trot.plan_rotation(n)
        x = _t(np.random.RandomState(3).randn(6, n).astype(np.float32))
        y = ops.lru_rotate(x, plan)
        np.testing.assert_allclose(y.numpy(), trot.local_rotate(x, plan).numpy(), atol=2e-4)
        np.testing.assert_allclose(ops.lru_rotate_transpose(y, plan).numpy(), x.numpy(),
                                   atol=2e-4)


# ---------------------------------------------------------------------------
# CUDA kernels vs their plain versions (on the card only)
# ---------------------------------------------------------------------------


@pytest.mark.cuda
@pytest.mark.parametrize("m,k,n", [(1, 4096, 4096), (4, 11008, 4096), (32, 4096, 11008),
                                   (128, 128, 344), (7, 256, 64)])
def test_cuda_w4a8_matches_plain(cuda, m, k, n):
    xq, wq, wp, sx, sw = _w4a8_inputs(m, k, n)
    args = [_t(a, cuda) for a in (xq, wp, sx, sw)]
    got = w4a8_matmul(*args)
    torch.cuda.synchronize()
    want = ref.w4a8_matmul_ref2(*args)
    torch.testing.assert_close(got, want, rtol=1e-6, atol=0)
    ones = w4a8_matmul(args[0], args[1], torch.ones_like(args[2]), torch.ones_like(args[3]))
    exact = xq.astype(np.int64) @ wq.astype(np.int64)
    assert np.array_equal(ones.cpu().numpy().astype(np.int64), exact)


@pytest.mark.cuda
@pytest.mark.parametrize("m,k,nb,tokens", [(4, 6, 43, 32), (12, 3, 3, 7), (28, 6, 8, 4),
                                           (20, 6, 1, 5), (64, 6, 1, 3)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_block_rotate_matches_plain(cuda, m, k, nb, tokens, dtype):
    dt = getattr(torch, dtype)
    n = (m << k) * nb
    x = _t(np.random.RandomState(0).randn(tokens, n).astype(np.float32), cuda).to(dt)
    for tr in (False, True):
        got = block_rotate(x, m, k, transpose=tr).float()
        want = ref.block_rotate_ref(x, m, k, transpose=tr).float()
        tol = 2e-4 if dt == torch.float32 else 5e-2
        torch.testing.assert_close(got, want, atol=tol, rtol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("mk,nn,vec,cbs,bc", [((8, 64), 48, 4, 32, 16), ((4, 768), 3072, 4, 64, 32),
                                              ((33, 256), 64, 8, 16, 64)])
def test_cuda_bvq_matches_plain(cuda, mk, nn, vec, cbs, bc):
    m, k = mk
    x, _, cb, idx = _bvq_inputs(m, k, nn, vec, cbs, bc)
    args = (_t(x, cuda), _t(cb, cuda), _t(idx, cuda))
    torch.testing.assert_close(bvq_matmul(*args), ref.bvq_matmul_ref2(*args),
                               rtol=1e-4, atol=1e-4)
    xb = args[0].to(torch.bfloat16)
    torch.testing.assert_close(bvq_matmul(xb, *args[1:]), ref.bvq_matmul_ref2(xb, *args[1:]),
                               rtol=1e-4, atol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("window", [1, 4])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_paged_attention_matches_plain(cuda, window, dtype):
    lengths = [37, 0, 16, 3 if window == 4 else 1]
    q, kp, vp, table, lens = _paged_inputs(4, window, 4, 1, 128, 16, 6, 30, lengths)
    dt = getattr(torch, dtype)
    args = (_t(q, cuda), _t(kp, cuda).to(dt), _t(vp, cuda).to(dt), _t(table, cuda),
            _t(lens, cuda))
    got = paged_attention(*args)
    assert bool(torch.isfinite(got).all())
    torch.testing.assert_close(got, ref.paged_attn_ref(*args), atol=2e-5, rtol=1e-5)

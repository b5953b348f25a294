"""The matmul kernels' layouts and launch plans, on the CPU: the W4A8
weight reorder (``prepack``) against the reference packing and the JAX
Pallas kernel (interpret mode), and the tile/split plans of both matmul
wrappers covering every K and N exactly once."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import quantization as tq
from repro_torch.kernels import bvq_matmul as bvq_mod
from repro_torch.kernels import w4a8_matmul as w4a8_mod
from repro_torch.kernels.w4a8_matmul import prepack, unprepack, w4a8_matmul

H100_SMS = 132


def _w4a8_inputs(m, k, n, seed=4):
    rng = np.random.RandomState(seed)
    xq = rng.randint(-127, 128, (m, k)).astype(np.int8)
    wq = rng.randint(-8, 8, (k, n)).astype(np.int8)  # the full int4 range
    wp = tq.pack_int4(torch.from_numpy(wq), axis=0)
    sx = rng.rand(m, 1).astype(np.float32)
    sw = rng.rand(1, n).astype(np.float32)
    return torch.from_numpy(xq), torch.from_numpy(wq), wp, torch.from_numpy(sx), \
        torch.from_numpy(sw)


@pytest.mark.parametrize("k,n", [(128, 64), (344, 344), (256, 128), (512, 256), (4, 16),
                                 (1024, 48), (64, 8)])
def test_prepack_roundtrip_bitwise(k, n):
    _, _, wp, _, _ = _w4a8_inputs(1, k, n)
    wpp = prepack(wp)
    assert wpp.dtype == torch.int8
    assert wpp.shape == (-(-n // 16), 2 * -(-k // 128), 512)
    assert torch.equal(unprepack(wpp, k, n), wp)


def test_prepack_same_bytes_at_aligned_shapes():
    """K a multiple of 128 and N of 16: the reorder keeps K*N/2 bytes, and
    a lane's 16 bytes are the documented (channel, K) pairs."""
    k, n = 256, 32
    _, wq, wp, _, _ = _w4a8_inputs(1, k, n)
    wpp = prepack(wp)
    assert wpp.numel() == k * n // 2
    i, j, g, t = 1, 3, 5, 2  # channel tile, K chunk, lane 4g+t
    lane = wpp[i, j, 16 * (4 * g + t):16 * (4 * g + t + 1)].to(torch.int32)
    ks = 64 * j + 16 * t + torch.arange(16)
    lo, hi = (lane << 28) >> 28, lane >> 4
    assert torch.equal(lo.to(torch.int8), wq[ks, 16 * i + g])
    assert torch.equal(hi.to(torch.int8), wq[ks, 16 * i + g + 8])


@pytest.mark.parametrize("m,k,n", [(1, 128, 64), (7, 344, 344), (72, 256, 128), (128, 512, 256)])
def test_w4a8_prepacked_plain_matches_pallas(m, k, n):
    pytest.importorskip("jax")
    import jax.numpy as jnp

    from repro.kernels.w4a8_matmul import w4a8_matmul_pallas

    xq, _, wp, sx, sw = _w4a8_inputs(m, k, n)
    want = np.asarray(w4a8_matmul_pallas(*(jnp.asarray(a.numpy()) for a in (xq, wp, sx, sw))))
    got = w4a8_matmul(xq, prepack(wp), sx, sw).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6)


@pytest.mark.parametrize("m,k,n", [(16, 256, 64), (7, 344, 344)])
def test_w4a8_prepacked_plain_integer_exact(m, k, n):
    xq, wq, wp, _, _ = _w4a8_inputs(m, k, n, seed=5)
    got = w4a8_matmul(xq, prepack(wp), torch.ones(m, 1), torch.ones(1, n)).numpy()
    exact = xq.numpy().astype(np.int64) @ wq.numpy().astype(np.int64)
    assert np.array_equal(got.astype(np.int64), exact)


def _check_split(p, k_stages):
    """The K splits are consecutive, non-empty, and cover every stage once."""
    covered = []
    for z in range(p.ksplit):
        lo, hi = z * p.stages_per_split, min(k_stages, (z + 1) * p.stages_per_split)
        assert lo < hi, p
        covered += list(range(lo, hi))
    assert covered == list(range(k_stages)), p


W4A8_SHAPES = [(m, k, n) for m in (1, 7, 8, 32, 72, 128, 200, 256)
               for k, n in ((128, 64), (344, 344), (4096, 4096), (4096, 11008),
                            (11008, 4096), (4096, 32000), (256, 344))]


@pytest.mark.parametrize("m,k,n", W4A8_SHAPES)
def test_w4a8_plan_covers_k_n_and_m_once(m, k, n):
    p = w4a8_mod.plan(m, k, n, H100_SMS)
    assert p.k_stages * 128 >= k > (p.k_stages - 1) * 128  # K=344: 3 stages, tail zero
    _check_split(p, p.k_stages)
    n16 = -(-n // 16)  # 16-channel tiles, 4 to a CTA; the last CTA holds >= 1
    assert 4 * (p.ctas - 1) < n16 <= 4 * p.ctas
    assert p.passes == -(-m // 128)  # the weight is read once per 128 tokens
    assert 8 * p.mt >= min(m, 128) and p.mt in (1, 2, 4, 8, 16)
    assert p.mt == 1 or 4 * p.mt < min(m, 128)  # the smallest tile count that fits
    assert p.ksplit <= 4


def test_w4a8_plan_splits_only_to_fill_the_card():
    wide = w4a8_mod.plan(32, 4096, 32000, H100_SMS)
    assert wide.ksplit == 1 and wide.ctas == 500
    narrow = w4a8_mod.plan(32, 4096, 4096, H100_SMS)
    assert narrow.ksplit > 1 and narrow.ctas * narrow.ksplit >= H100_SMS
    assert w4a8_mod.plan(7, 344, 344, H100_SMS).ksplit == 1  # too short to split


BVQ_SHAPES = [(m, k, n, v, bc) for m in (1, 8, 33, 72, 128, 300)
              for k, n, v, bc in ((768, 3072, 4, 32), (3072, 768, 4, 32), (768, 768, 4, 32),
                                  (64, 48, 4, 16), (256, 64, 8, 64), (64, 128, 4, 32),
                                  (96, 96, 4, 48))]


@pytest.mark.parametrize("m,k,n,v,bc", BVQ_SHAPES)
def test_bvq_plan_covers_k_n_and_m_once(m, k, n, v, bc):
    p = bvq_mod.plan(m, k, n, H100_SMS)
    assert p.k_stages * 32 >= k > (p.k_stages - 1) * 32
    _check_split(p, p.k_stages)
    assert p.ctas * 64 >= n > (p.ctas - 1) * 64
    assert p.passes == -(-m // 128)
    assert 8 * p.mt >= min(m, 128) and p.mt in (1, 2, 4, 8, 16)
    # a 64-channel tile touches at most 4 codebook blocks (the kernel's room)
    for c in range(p.ctas):
        lo, hi = 64 * c, min(n, 64 * c + 64) - 1
        assert hi // bc - lo // bc + 1 <= 4


@pytest.mark.parametrize("m", [8, 72])
@pytest.mark.parametrize("k,n", [(768, 3072), (3072, 768), (768, 768)])
def test_bvq_plan_fills_the_card_at_draft_shapes(m, k, n):
    p = bvq_mod.plan(m, k, n, H100_SMS)
    assert p.ctas * p.passes * p.ksplit >= H100_SMS, p

"""The port's attention kernels beyond the fp causal body: the int8 and
tree-masked bodies of the paged kernel and the dense int8 decode kernel.

Each plain version (kernels/ref.py) is held against the JAX Pallas kernel in
interpret mode at the reference tests' own tolerance, atol 2e-5 in f32
(tests/test_paged_attn.py, tests/test_decode_attn_kernel.py use the same
inputs' scale); ``kv_quantize`` is held bit for bit against the reference's
``_kv_quantize``.  On a card only (``cuda`` marker) each CUDA body is held
against its plain version, and the int8 decode kernel must ignore a
poisoned cache tail bit for bit.  Inputs come from seeded numpy."""
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core.speculative import tree_ancestor_mask
from repro_torch.kernels import _lib, ref
from repro_torch.kernels.decode_attn import decode_attention_int8
from repro_torch.kernels.paged_attn import paged_attention
from repro_torch.models.layers import kv_quantize
from repro_torch.serving.paged_cache import kv_quantize_np

ATOL = 2e-5


def _t(a, device="cpu"):
    return torch.from_numpy(np.array(a)).to(device)


@pytest.fixture
def jx():
    """The JAX reference, imported only by the CPU parity tests: a GPU
    machine without JAX still runs the card tests of this file."""
    pytest.importorskip("jax")
    import jax.numpy as jnp

    from repro.kernels.decode_attn import decode_attention_int8_pallas
    from repro.kernels.paged_attn import paged_decode_attention_pallas
    from repro.models.layers import _kv_quantize

    return types.SimpleNamespace(jnp=jnp, paged=paged_decode_attention_pallas,
                                 decode=decode_attention_int8_pallas, kv_quantize=_kv_quantize)


@pytest.fixture
def cuda():
    """The card, or a skip: decided here, inside the test, never at import."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernels have no CPU mode)")
    return torch.device("cuda")


def _random_parents(rng, n):
    """A drafting-order topology: node i's parent is the root (-1) or any
    earlier node, so draws range over chains, stars and ragged trees."""
    return [int(rng.randint(-1, i)) for i in range(n)]


def _paged_case(seed, b, w, kvs, g, hd, ps, mp, lengths, quantized, tree):
    """(q, k_pool, v_pool, table, lengths, k_scale, v_scale, tree_mask) as
    numpy: distinct shuffled pages per row, garbage ids in the slots a row
    does not own, int8 pools quantized by the engine's storage rule, and
    per-row ancestor masks of random topologies with ragged node counts
    (self-only padding rows).  ``w == 0`` asks for a 4-D q."""
    rng = np.random.RandomState(seed)
    n_pages = b * mp + 2
    q = rng.randn(b, max(w, 1), kvs, g, hd).astype(np.float32)
    if w == 0:
        q = q[:, 0]
    kp = rng.randn(n_pages, ps, kvs, hd).astype(np.float32)
    vp = rng.randn(n_pages, ps, kvs, hd).astype(np.float32)
    perm = rng.permutation(n_pages)
    table = rng.randint(0, n_pages, (b, mp)).astype(np.int32)
    used = 0
    for i, ln in enumerate(lengths):
        own = -(-ln // ps)
        table[i, :own] = perm[used:used + own]
        used += own
    ks = vs = tm = None
    if quantized:
        kp, ks = kv_quantize_np(kp)
        vp, vs = kv_quantize_np(vp)
    if tree:
        tm = np.stack([tree_ancestor_mask(_random_parents(rng, rng.randint(0, w)), w)
                       for _ in range(b)])
    return q, kp, vp, table, np.asarray(lengths, np.int32), ks, vs, tm


PAGED_CASES = [
    # (seed, b, w, kvs, g, hd, ps, mp, lengths); w == 0 is the 4-D decode q
    (30, 3, 0, 2, 2, 32, 8, 4, [5, 29, 17]),
    (31, 2, 3, 2, 2, 32, 8, 4, [9, 30]),
    (32, 3, 5, 2, 1, 48, 8, 5, [7, 17, 40]),
    (33, 2, 5, 1, 4, 16, 4, 6, [5, 23]),
]


BODIES = {"int8": (True, False), "tree": (False, True), "int8_tree": (True, True)}
# a tree mask needs a window: the 4-D q goes with the int8 body only
PAGED_PARAMS = [pytest.param(case, *flags, id=f"{body}-w{case[2]}-seed{case[0]}")
                for case in PAGED_CASES for body, flags in BODIES.items()
                if case[2] or not flags[1]]


@pytest.mark.parametrize("case,quantized,tree", PAGED_PARAMS)
def test_paged_plain_matches_pallas(jx, case, quantized, tree):
    seed, b, w, kvs, g, hd, ps, mp, lengths = case
    args = _paged_case(seed, b, w, kvs, g, hd, ps, mp, lengths, quantized, tree)
    q, kp, vp, table, lens, ks, vs, tm = args
    opt = lambda a, f: None if a is None else f(a)  # noqa: E731
    want = jx.paged(jx.jnp.asarray(q), jx.jnp.asarray(kp), jx.jnp.asarray(vp),
                    jx.jnp.asarray(table), jx.jnp.asarray(lens),
                    k_scale=opt(ks, jx.jnp.asarray), v_scale=opt(vs, jx.jnp.asarray),
                    tree_mask=opt(tm, jx.jnp.asarray))
    got = paged_attention(_t(q), _t(kp), _t(vp), _t(table), _t(lens),
                          k_scale=opt(ks, _t), v_scale=opt(vs, _t), tree_mask=opt(tm, _t))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


def test_paged_wrapper_refuses_bad_combinations():
    q, kp, vp, table, lens, ks, vs, tm = _paged_case(34, 2, 3, 2, 1, 16, 4, 4, [5, 9],
                                                     True, True)
    with pytest.raises(ValueError, match="both"):
        paged_attention(_t(q), _t(kp), _t(vp), _t(table), _t(lens), k_scale=_t(ks))
    with pytest.raises(ValueError, match="5-D"):
        paged_attention(_t(q[:, 0]), _t(kp), _t(vp), _t(table), _t(lens), k_scale=_t(ks),
                        v_scale=_t(vs), tree_mask=_t(tm))


def _decode_case(b, s, kvs, g, hd, seed=0):
    rng = np.random.RandomState(seed)
    q = rng.randn(b, kvs, g, hd).astype(np.float32)
    kq, ks = kv_quantize_np(rng.randn(b, s, kvs, hd).astype(np.float32))
    vq, vs = kv_quantize_np(rng.randn(b, s, kvs, hd).astype(np.float32))
    return q, kq, ks[..., 0], vq, vs[..., 0]


DECODE_SHAPES = [  # (b, s, kvs, g, hd, block_s): tests/test_decode_attn_kernel.py:30-33
    (2, 64, 4, 2, 32, 16),
    (1, 128, 2, 4, 64, 32),
    (4, 32, 1, 8, 128, 32),
    (2, 64, 4, 2, 32, 64),
]


@pytest.mark.parametrize("shape", DECODE_SHAPES, ids=lambda c: "x".join(map(str, c)))
@pytest.mark.parametrize("length", [1, 17, None])
def test_decode_int8_plain_matches_pallas(jx, shape, length):
    b, s, kvs, g, hd, block_s = shape
    q, kq, ks, vq, vs = _decode_case(b, s, kvs, g, hd)
    ln = np.int32(s if length is None else min(length, s))
    want = jx.decode(*(jx.jnp.asarray(a) for a in (q, kq, ks, vq, vs, ln)), block_s=block_s)
    got = decode_attention_int8(*(_t(a) for a in (q, kq, ks, vq, vs, ln)), block_s=block_s)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_kv_quantize_bit_exact(jx, dtype):
    """Values and scales equal the reference's bit for bit, on ordinary
    rows, a zero row (the 1e-8 floor) and exact .5 ties (half to even)."""
    rng = np.random.RandomState(5)
    x = rng.randn(3, 7, 4, 32).astype(np.float32) * 3.0
    x[0, 0, 0] = 0.0
    x[1, 1, 1, :4] = [127.0, 0.5, -1.5, 2.5]  # scale 1: ties at .5, 1.5, 2.5
    x[1, 1, 1, 4:] = 0.25
    jdt = getattr(jx.jnp, dtype)
    want_q, want_s = jx.kv_quantize(jx.jnp.asarray(x, jdt))
    got_q, got_s = kv_quantize(_t(x).to(getattr(torch, dtype)))
    np.testing.assert_array_equal(got_q.numpy(), np.asarray(want_q))
    np.testing.assert_array_equal(got_s.numpy(), np.asarray(want_s))


# ---------------------------------------------------------------------------
# CUDA kernels against their plain versions (card only)
# ---------------------------------------------------------------------------


@pytest.mark.cuda
@pytest.mark.parametrize("body,w", [(body, w) for body in BODIES for w in (0, 4, 9)
                                    if w or not BODIES[body][1]])
def test_cuda_paged_bodies_match_plain(cuda, body, w):
    quantized, tree = BODIES[body]
    name = "paged_attention_" + body
    lengths = [37, 0, 16, 9 if w else 1]
    args = _paged_case(40 + w, 4, w, 4, 1, 128, 16, 6, lengths, quantized, tree)
    q, kp, vp, table, lens, ks, vs, tm = (None if a is None else _t(a, cuda) for a in args)
    if not quantized:
        kp, vp = kp.to(torch.bfloat16), vp.to(torch.bfloat16)
    kw = dict(k_scale=ks, v_scale=vs, tree_mask=tm)
    before = _lib.launches[name]
    got = paged_attention(q, kp, vp, table, lens, **kw)
    torch.cuda.synchronize()
    assert _lib.launches[name] == before + 1
    assert bool(torch.isfinite(got).all())
    torch.testing.assert_close(got, ref.paged_attn_ref(q, kp, vp, table, lens, **kw),
                               atol=ATOL, rtol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("body", ["tree", "int8_tree"])
def test_cuda_tree_page_walk_matches_plain_for_any_mask(cuda, body):
    """The kernel reads only the pages below len unless a query row sees no
    position, and then every page: random 0/1 masks (not ancestor masks)
    over lengths below, at and above W, where each case decides its walk
    from its own mask rows."""
    quantized = BODIES[body][0]
    w, lengths = 4, [0, 2, 3, 4, 4, 5, 37]
    q, kp, vp, table, lens, ks, vs, _ = _paged_case(60, len(lengths), w, 2, 2, 64, 8, 6,
                                                    lengths, quantized, False)
    tm = (np.random.RandomState(61).rand(len(lengths), w, w) < 0.3).astype(np.float32)
    tm[1, 0] = 0.0  # len 2: query row 0 sees nothing, so this block walks every page
    tm[2, :, 1] = 1.0  # len 3: every row sees position 0, one page suffices
    tm[4] = np.eye(w, dtype=np.float32)  # an idle slot: self-only at len == W
    args = [None if a is None else _t(a, cuda) for a in (q, kp, vp, table, lens, ks, vs, tm)]
    q, kp, vp, table, lens, ks, vs, tm = args
    if not quantized:
        kp, vp = kp.to(torch.bfloat16), vp.to(torch.bfloat16)
    kw = dict(k_scale=ks, v_scale=vs, tree_mask=tm)
    got = paged_attention(q, kp, vp, table, lens, **kw)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, ref.paged_attn_ref(q, kp, vp, table, lens, **kw),
                               atol=ATOL, rtol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", DECODE_SHAPES, ids=lambda c: "x".join(map(str, c)))
@pytest.mark.parametrize("length", [0, 1, 17, None])
def test_cuda_decode_int8_matches_plain(cuda, shape, length):
    b, s, kvs, g, hd, block_s = shape
    args = [_t(a, cuda) for a in _decode_case(b, s, kvs, g, hd)]
    ln = torch.tensor(s if length is None else min(length, s), dtype=torch.int32, device=cuda)
    got = decode_attention_int8(*args, ln, block_s=block_s)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(got).all())
    torch.testing.assert_close(got, ref.decode_attn_int8_ref(*args, ln), atol=ATOL, rtol=1e-5)


@pytest.mark.cuda
def test_cuda_decode_int8_ignores_poisoned_tail(cuda):
    """Positions past `length` contribute exact zeros: poisoning the tail
    (K at 127, V scales at 1e6) leaves the output bitwise unchanged."""
    q, kq, ks, vq, vs = (_t(a, cuda) for a in _decode_case(1, 64, 2, 2, 32))
    ln = torch.tensor(20, dtype=torch.int32, device=cuda)
    base = decode_attention_int8(q, kq, ks, vq, vs, ln, block_s=16)
    kq2, vs2 = kq.clone(), vs.clone()
    kq2[:, 20:] = 127
    vs2[:, 20:] = 1e6
    poisoned = decode_attention_int8(q, kq2, ks, vq, vs2, ln, block_s=16)
    torch.cuda.synchronize()
    assert torch.equal(base, poisoned)

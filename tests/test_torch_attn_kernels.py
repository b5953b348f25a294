"""The port's attention kernels beyond the fp causal body: the int8 and
tree-masked bodies of the paged kernel and the dense int8 decode kernel.

Each plain version (kernels/ref.py) is held against the JAX Pallas kernel in
interpret mode at the reference tests' own tolerance, atol 2e-5 in f32
(tests/test_paged_attn.py, tests/test_decode_attn_kernel.py use the same
inputs' scale); ``kv_quantize`` is held bit for bit against the reference's
``_kv_quantize``.  On a card only (``cuda`` marker) each CUDA body is held
against its plain version, a second call must give the same bits, and
both kernels must ignore a poisoned cache tail bit for bit.  Inputs come
from seeded numpy."""
import importlib.util
import pathlib
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core.speculative import tree_ancestor_mask
from repro_torch.kernels import _lib, ref
from repro_torch.kernels.decode_attn import decode_attention_int8
from repro_torch.kernels.paged_attn import paged_attention
from repro_torch.models.layers import kv_quantize
from repro_torch.serving.api import EngineConfig
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


@pytest.mark.parametrize("pairs,positions,want", [
    (256, 176, 1),  # target verify: 8 rows x 32 heads, 11 pages of 16
    (96, 192, 1),  # draft tree: 8 rows x 12 heads, 12 pages
    (128, 4096, 2),  # K7 / long context: 4 x 32 pairs over 4096 positions
    (4, 4096, 16),  # few pairs: at least 256 positions a split
])
def test_attn_splits_from_static_shapes(pairs, positions, want):
    """The attention kernels' split count: one block per (row, head) on the
    engine's paths (one launch, no workspace), one wave of 2 blocks per SM
    of a 132-SM card on long walks, never under 256 positions a split."""
    assert _lib.attn_splits(132, pairs, positions) == want


@pytest.mark.parametrize("cfg,window", [
    (dict(draft_len=31), 32),
    (dict(draft_len=32), 33),
    (dict(spec_mode="tree", tree_budget=31, draft_len=40), 32),
    (dict(spec_mode="tree", tree_budget=32), 33),
])
def test_engine_config_holds_windows_to_the_kernel(cfg, window):
    """The paged kernel keeps ceil(W / 32) mask words per query row in
    shared memory sized at launch, so no verify window (draft_len + 1, or
    tree_budget + 1 for a tree) is refused: windows on either side of one
    32-bit word are accepted, on every device."""
    assert EngineConfig(**cfg).spec_window + 1 == window


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


# card geometries: (id, hd, g, ps, mp, lengths, q dtype); the 4th length is
# replaced by 1 for the 4-D q.  Rows whose pages span several warps (and, at
# 256 pages, several blocks), length 0, hd in {16, 48, 64, 128}, G in {1, 4}.
PAGED_GEOMETRIES = [
    ("hd128", 128, 1, 16, 6, [37, 0, 16, 9], "float32"),
    ("hd16-g4", 16, 4, 4, 40, [150, 3, 0, 77], "float32"),
    ("hd48-ps12", 48, 1, 12, 14, [150, 60, 1, 9], "bfloat16"),
    ("hd64-g4", 64, 4, 16, 12, [190, 9, 100, 33], "bfloat16"),
    ("long-256-pages", 128, 1, 16, 256, [4096, 4095, 257, 9], "bfloat16"),
]
CARD_BODIES = {"fp": (False, False), **BODIES}


@pytest.mark.cuda
@pytest.mark.parametrize("geometry", PAGED_GEOMETRIES, ids=lambda c: c[0])
@pytest.mark.parametrize("body,w", [(body, w) for body in CARD_BODIES for w in (0, 4, 9)
                                    if w or not CARD_BODIES[body][1]])
def test_cuda_paged_bodies_match_plain(cuda, body, w, geometry):
    """Each body against its plain version, and a second call bitwise
    equal to the first."""
    _, hd, g, ps, mp, lengths, q_dtype = geometry
    quantized, tree = CARD_BODIES[body]
    name = "paged_attention" + ("" if body == "fp" else "_" + body)
    lengths = lengths[:3] + [lengths[3] if w else 1]
    args = _paged_case(40 + w, 4, w, 4, g, hd, ps, mp, lengths, quantized, tree)
    q, kp, vp, table, lens, ks, vs, tm = (None if a is None else _t(a, cuda) for a in args)
    q = q.to(getattr(torch, q_dtype))
    if not quantized:
        kp, vp = kp.to(torch.bfloat16), vp.to(torch.bfloat16)
    kw = dict(k_scale=ks, v_scale=vs, tree_mask=tm)
    before = _lib.launches[name]
    got = paged_attention(q, kp, vp, table, lens, **kw)
    again = paged_attention(q, kp, vp, table, lens, **kw)
    torch.cuda.synchronize()
    assert _lib.launches[name] == before + 2
    assert bool(torch.isfinite(got).all())
    assert torch.equal(got, again)
    torch.testing.assert_close(got, ref.paged_attn_ref(q, kp, vp, table, lens, **kw),
                               atol=ATOL, rtol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("pool", ["bfloat16", "int8"])
def test_cuda_paged_row_does_not_depend_on_the_window(cuda, pool):
    """A query row's output depends on the positions it sees, not on the
    window around it: the first row of a causal W=4 window, of a W=9 tree
    window whose first row sees only its own slot, a W=1 decode step, and
    the same rows of windows wider than one 32-bit mask word (causal W=40,
    tree W=70), all over the same positions, give the same bits.  (The engine's tree
    rounds then equal its chain rounds wherever they score the same
    prefix.)"""
    rng = np.random.RandomState(80)
    b, kvs, hd, ps, mp, lengths = 3, 2, 128, 16, 20, np.array([163, 40, 11])
    kp = rng.randn(b * mp, ps, kvs, hd).astype(np.float32)
    vp = rng.randn(b * mp, ps, kvs, hd).astype(np.float32)
    kw = {}
    if pool == "int8":
        (kp, ks), (vp, vs) = kv_quantize_np(kp), kv_quantize_np(vp)
        kw = dict(k_scale=_t(ks, cuda), v_scale=_t(vs, cuda))
        kp, vp = _t(kp, cuda), _t(vp, cuda)
    else:
        kp, vp = _t(kp, cuda).bfloat16(), _t(vp, cuda).bfloat16()
    table = _t(rng.permutation(b * mp).reshape(b, mp).astype(np.int32), cuda)
    q0 = rng.randn(b, kvs, 1, hd).astype(np.float32)

    def first_row(w, shift, tree_mask=None):
        q = rng.randn(b, w, kvs, 1, hd).astype(np.float32)
        q[:, 0] = q0
        lens = _t((lengths + shift).astype(np.int32), cuda)
        out = paged_attention(_t(q, cuda).bfloat16(), kp, vp, table, lens, tree_mask=tree_mask,
                              **kw)
        return out[:, 0]

    def self_only(w):
        return torch.eye(w, device=cuda).expand(b, w, w).contiguous()

    chain = first_row(4, 0)
    torch.cuda.synchronize()
    assert torch.equal(chain, first_row(9, 5, self_only(9)))
    assert torch.equal(chain, first_row(1, -3))
    # windows of several mask words a row: the row still keeps its bits
    assert torch.equal(chain, first_row(40, 36))
    assert torch.equal(chain, first_row(70, 66, self_only(70)))



@pytest.mark.cuda
@pytest.mark.parametrize("w", [33, 64, 129])
@pytest.mark.parametrize("body", list(CARD_BODIES))
def test_cuda_paged_wide_windows_match_plain(cuda, body, w):
    """Windows wider than one 32-bit mask word (2, 2 and 5 words a row) at
    the target's head dim: each body against its plain version, and a
    second call bitwise equal.  Rows longer than the window, exactly the
    window, and shorter (a causal row 0 that sees nothing: every page is
    walked); G = 2 so a block's rows span window rows."""
    quantized, tree = CARD_BODIES[body]
    name = "paged_attention" + ("" if body == "fp" else "_" + body)
    lengths = [w + 150, w, w + 1, w // 2]
    ps = 16
    mp = -(-lengths[0] // ps) + 1
    args = _paged_case(90 + w, 4, w, 2, 2, 128, ps, mp, lengths, quantized, tree)
    q, kp, vp, table, lens, ks, vs, tm = (None if a is None else _t(a, cuda) for a in args)
    q = q.to(torch.bfloat16)
    if not quantized:
        kp, vp = kp.to(torch.bfloat16), vp.to(torch.bfloat16)
    kw = dict(k_scale=ks, v_scale=vs, tree_mask=tm)
    before = _lib.launches[name]
    got = paged_attention(q, kp, vp, table, lens, **kw)
    again = paged_attention(q, kp, vp, table, lens, **kw)
    torch.cuda.synchronize()
    assert _lib.launches[name] == before + 2
    assert bool(torch.isfinite(got).all())
    assert torch.equal(got, again)
    torch.testing.assert_close(got, ref.paged_attn_ref(q, kp, vp, table, lens, **kw),
                               atol=ATOL, rtol=1e-5)

def _chip_smoke():
    """The repo's chip_smoke.py as a module (for its tail-poisoning helper)."""
    path = pathlib.Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.mark.cuda
@pytest.mark.parametrize("body", list(CARD_BODIES))
def test_cuda_paged_ignores_poisoned_tail(cuda, body):
    """Slots past a row's length inside its last page never reach the
    output: poisoned (bf16 pools 1e6; int8 K at 127, V scales at 1e6), the
    result is bitwise unchanged.  Rows of 40, 4001 and 9 tokens (ps 16;
    the 4001-token row splits over blocks)."""
    quantized, tree = CARD_BODIES[body]
    w, lengths = 4, [40, 4001, 9]
    q, kp, vp, table, lens, ks, vs, tm = (
        None if a is None else _t(a, cuda)
        for a in _paged_case(70, 3, w, 2, 2, 64, 16, 256, lengths, quantized, tree))
    if not quantized:
        kp, vp = kp.to(torch.bfloat16), vp.to(torch.bfloat16)
    base = paged_attention(q, kp, vp, table, lens, k_scale=ks, v_scale=vs, tree_mask=tm)
    kp2, vp2, vs2 = _chip_smoke()._poison_tails(kp, vp, vs, table, lengths, w, 16)
    poisoned = paged_attention(q, kp2, vp2, table, lens, k_scale=ks, v_scale=vs2, tree_mask=tm)
    torch.cuda.synchronize()
    assert torch.equal(base, poisoned)


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


# and on the card: S = 4096 (16 splits of 256 positions for 4 (b, head)
# pairs), hd 16, G up to 8
CARD_DECODE_SHAPES = DECODE_SHAPES + [
    (2, 4096, 2, 1, 128, 512),
    (1, 4096, 1, 4, 64, 512),
    (1, 256, 2, 8, 16, 256),
]


@pytest.mark.cuda
@pytest.mark.parametrize("shape", CARD_DECODE_SHAPES, ids=lambda c: "x".join(map(str, c)))
@pytest.mark.parametrize("length", [0, 1, 17, 255, 256, 257, 4095, None])
def test_cuda_decode_int8_matches_plain(cuda, shape, length):
    """Against the plain version at lengths on either side of split and
    block-iteration boundaries, and a second call bitwise equal."""
    b, s, kvs, g, hd, block_s = shape
    args = [_t(a, cuda) for a in _decode_case(b, s, kvs, g, hd)]
    args[0] = args[0].to(torch.bfloat16) if g == 4 else args[0]  # q in either dtype
    ln = torch.tensor(s if length is None else min(length, s), dtype=torch.int32, device=cuda)
    got = decode_attention_int8(*args, ln, block_s=block_s)
    again = decode_attention_int8(*args, ln, block_s=block_s)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(got).all())
    assert torch.equal(got, again)
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

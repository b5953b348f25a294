"""The public configurations' new shapes and ops on the card, and their
row bits on both devices.

- Row bits independent of the row count (as tests/test_torch_rows.py does
  for the paper pair's ops) for the ops this slice adds to the forwards:
  Qwen3's per-head qk-norm, the squared-ReLU MLP and the MoE dense
  combine (router, top-k, expert products, gated sum).  The CPU cases run
  anywhere at reduced widths; the ``cuda`` cases at the full widths
  (Qwen3-8B heads, Nemotron-4-15B's MLP, Moonlight's 64 experts).
- ``cuda``: the kernels at the shapes only these configurations give:
  paged attention at G = 4 and 6 (fp, int8, tree, a long walk), the
  Qwen3-8B R2 plan (n = 12288, m = 12), w4a8 at the 151,936- and
  163,840-channel heads and K = 12288, bvq at K = 12288 and 4096; each
  against its plain version with the reference tests' tolerances, and
  bitwise on a repeat.

Run on the card with ``PYTHONPATH=src python -m pytest -m cuda
tests/test_torch_families_cuda.py``."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import configs
from repro_torch.core import bvq, rotation
from repro_torch.core import quantization as q
from repro_torch.kernels import ref
from repro_torch.kernels.bvq_matmul import bvq_matmul
from repro_torch.kernels.fwht import rotate_plan
from repro_torch.kernels.paged_attn import paged_attention
from repro_torch.kernels.w4a8_matmul import prepack, w4a8_matmul
from repro_torch.models import layers as L

ROWS = (1, 3, 4, 8, 24, 56, 160)
QWEN3 = configs.get_config("qwen3-8b")
NEMOTRON = configs.get_config("nemotron-4-15b")
MOONLIGHT = configs.get_config("moonshot-v1-16b-a3b")


@pytest.fixture
def one_thread():
    """One intra-op torch thread for the CPU cases: their ops are small, and
    with several test workers at once more threads only contend."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def cuda():
    """The card, or a skip: decided here, inside the test, never at import."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernels have no CPU mode)")
    return torch.device("cuda")


def _randn(dev, shape, seed, scale=1.0, dtype=torch.bfloat16):
    a = np.random.RandomState(seed).randn(*shape).astype(np.float32) * scale
    return torch.from_numpy(a).to(dev).to(dtype)


def _op(name, dev, full):
    """(per-row input shape, op over (rows, ...) inputs): at the config's
    full width on the card, reduced on the CPU."""
    if name == "qk_head_norm":
        h, hd = (QWEN3.n_heads, QWEN3.hd) if full else (4, 32)
        g = 1.0 + 0.01 * _randn(dev, (hd,), 1)
        return (h, hd), lambda x: L.qk_head_norm(x, g)
    if name == "squared_relu_mlp":
        cfg = NEMOTRON if full else dataclasses.replace(NEMOTRON, d_model=256, d_ff=512)
        p = {"w_up": _randn(dev, (cfg.d_model, cfg.d_ff), 2, cfg.d_model ** -0.5),
             "w_down": _randn(dev, (cfg.d_ff, cfg.d_model), 3, cfg.d_ff ** -0.5)}
        return (cfg.d_model,), lambda x: L.mlp_apply(p, x[None], cfg)[0]
    cfg = MOONLIGHT if full else dataclasses.replace(MOONLIGHT, d_model=128, d_ff=64,
                                                     n_experts=8, top_k=2)
    d, f, e = cfg.d_model, cfg.d_ff, cfg.n_experts
    p = {"router": _randn(dev, (d, e), 4, d ** -0.5, torch.float32),
         "w_gate": _randn(dev, (e, d, f), 5, d ** -0.5),
         "w_up": _randn(dev, (e, d, f), 6, d ** -0.5),
         "w_down": _randn(dev, (e, f, d), 7, f ** -0.5)}
    return (d,), lambda x: L.moe_apply_dense(p, x[None], cfg)[0]


def _check_rows(dev, name, full):
    """One call over 160 rows against calls of M rows each: the same bits."""
    shape, op = _op(name, dev, full)
    x = _randn(dev, (ROWS[-1],) + shape, 0)
    whole = op(x)
    bad = [m for m in ROWS if not torch.equal(
        torch.cat([op(x[j:j + m]) for j in range(0, ROWS[-1], m)]), whole)]
    assert not bad, f"{name}: rows differ from the same rows among {ROWS[-1]} at M = {bad}"


NAMES = ["qk_head_norm", "squared_relu_mlp", "moe_dense_combine"]


@pytest.mark.parametrize("name", NAMES)
def test_rows_independent_of_row_count_cpu(one_thread, name):
    _check_rows("cpu", name, full=False)


@pytest.mark.cuda
@pytest.mark.parametrize("name", NAMES)
def test_rows_independent_of_row_count_cuda(cuda, name):
    _check_rows(cuda, name, full=True)


# (body, window): a tree mask needs a window, so the tree bodies start at W = 4
GQA_CASES = [(body, w) for body in ("fp", "int8", "tree", "int8_tree") for w in (1, 4, 9)
             if "tree" not in body or w > 1]


@pytest.mark.cuda
@pytest.mark.parametrize("group", [4, 6])
@pytest.mark.parametrize("body,w", GQA_CASES)
def test_cuda_paged_attention_gqa(cuda, group, body, w):
    """8 kv heads of G = 4 (Qwen3-8B) or 6 (Nemotron-4-15B), hd = 128:
    atol 2e-5 against the plain version, bitwise on a repeat, and row 0
    of the window bitwise equal to the one-token step."""
    from repro_torch.core.speculative import tree_ancestor_mask
    from repro_torch.models.layers import kv_quantize

    b, kvs, hd, ps, mp = 4, 8, 128, 16, 12
    lengths = [w + 150, w + 33, w, w + 7]
    g = torch.Generator(device=cuda).manual_seed(0)
    qt = torch.randn((b, w, kvs, group, hd), generator=g, device=cuda).to(torch.bfloat16)
    kp = torch.randn((b * mp + 1, ps, kvs, hd), generator=g, device=cuda).to(torch.bfloat16)
    vp = torch.randn((b * mp + 1, ps, kvs, hd), generator=g, device=cuda).to(torch.bfloat16)
    kw = {}
    if "int8" in body:
        (kp, ks), (vp, vs) = kv_quantize(kp), kv_quantize(vp)
        kw.update(k_scale=ks, v_scale=vs)
    if "tree" in body:
        rng = np.random.RandomState(1)
        kw["tree_mask"] = torch.as_tensor(np.stack([tree_ancestor_mask(
            [int(rng.randint(-1, i)) for i in range(w - 1)], w) for _ in range(b)]), device=cuda)
    table = torch.randperm(b * mp, generator=g, device=cuda).reshape(b, mp).to(torch.int32)
    lens = torch.as_tensor(lengths, dtype=torch.int32, device=cuda)
    got = paged_attention(qt, kp, vp, table, lens, **kw)
    torch.cuda.synchronize()
    want = ref.paged_attn_ref(qt, kp, vp, table, lens, **kw)
    torch.testing.assert_close(got, want, atol=2e-5, rtol=0)
    assert torch.equal(got, paged_attention(qt, kp, vp, table, lens, **kw))
    step = paged_attention(qt[:, :1], kp, vp, table, torch.clamp(lens - (w - 1), min=0),
                           k_scale=kw.get("k_scale"), v_scale=kw.get("v_scale"))
    assert torch.equal(got[:, :1], step)


@pytest.mark.cuda
@pytest.mark.parametrize("group", [4, 6])
def test_cuda_paged_attention_gqa_long_walk(cuda, group):
    """One 4096-token row (the long-walk layout: a query row a block)."""
    b, w, kvs, hd, ps, mp = 2, 4, 8, 128, 16, 256
    g = torch.Generator(device=cuda).manual_seed(2)
    qt = torch.randn((b, w, kvs, group, hd), generator=g, device=cuda).to(torch.bfloat16)
    kp = torch.randn((b * mp, ps, kvs, hd), generator=g, device=cuda).to(torch.bfloat16)
    vp = torch.randn((b * mp, ps, kvs, hd), generator=g, device=cuda).to(torch.bfloat16)
    table = torch.randperm(b * mp, generator=g, device=cuda).reshape(b, mp).to(torch.int32)
    lens = torch.tensor([4096, 1500], dtype=torch.int32, device=cuda)
    got = paged_attention(qt, kp, vp, table, lens)
    torch.testing.assert_close(got, ref.paged_attn_ref(qt, kp, vp, table, lens), atol=2e-5,
                               rtol=0)
    assert torch.equal(got, paged_attention(qt, kp, vp, table, lens))


@pytest.mark.cuda
@pytest.mark.parametrize("tokens", [1, 7, 32, 72, 128])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_qwen3_r2_plan(cuda, tokens, dtype):
    """The Qwen3-8B d_ff plan (n = 12288, m = 12, k = 6, tiled): the plain
    version's tolerances (2e-4 f32, 5e-2 bf16), bitwise repeats, and rows
    independent of the call's row count."""
    plan = rotation.plan_rotation(QWEN3.d_ff)
    assert (plan.m, plan.k, plan.kind) == (12, 6, "tiled")
    dt = getattr(torch, dtype)
    x = _randn(cuda, (tokens, plan.n), 8, dtype=dt)
    got = rotate_plan(x, plan)
    tol = 2e-4 if dt == torch.float32 else 5e-2
    torch.testing.assert_close(got.float(), ref.rotate_plan_ref(x, plan).float(), atol=tol,
                               rtol=tol)
    assert torch.equal(got, rotate_plan(x, plan))
    assert torch.equal(got[-1:], rotate_plan(x[-1:], plan))


@pytest.mark.cuda
@pytest.mark.parametrize("k,n", [(4096, 151936), (2048, 163840), (12288, 4096), (4096, 1024)])
def test_cuda_w4a8_public_widths(cuda, k, n):
    """Bit-exact against the plain version (float64 integer product) at
    1, 32 and 128 tokens: heads whose widths are not multiples of 256 and
    Qwen3-8B's w_down."""
    g = torch.Generator(device=cuda).manual_seed(3)
    w = torch.randn((k, n), generator=g, device=cuda) * 0.02
    wq, sw = q.quantize_weight_int(w, bits=4, axis=0)
    wp = q.pack_int4(wq, axis=0)
    wpp = prepack(wp)
    for m in (1, 32, 128):
        xq, sx = q.quantize_act_int8(torch.randn((m, k), generator=g, device=cuda))
        got = w4a8_matmul(xq, wpp, sx, sw)
        assert torch.equal(got, ref.w4a8_matmul_ref2(xq, wp, sx, sw))
        assert torch.equal(got, w4a8_matmul(xq, wpp, sx, sw))


@pytest.mark.cuda
@pytest.mark.parametrize("m", [8, 72])
@pytest.mark.parametrize("k,n", [(4096, 4096), (4096, 1024), (4096, 12288), (12288, 4096)])
def test_cuda_bvq_qwen3_draft_shapes(cuda, m, k, n):
    """The Qwen3-8B-width draft's weights, compressed with the pair's BVQ
    settings: 1e-4 against the plain version, bitwise on a repeat."""
    from repro_torch.launch.serve import PAIR_BVQ

    g = torch.Generator(device=cuda).manual_seed(4)
    bw = bvq.bvq_compress(torch.randn((k, n), generator=g, device=cuda) * 0.02, PAIR_BVQ, g)
    cb, idx = bvq.dequant_codebooks(bw), bw.indices
    x = torch.randn((m, k), generator=g, device=cuda).to(torch.bfloat16)
    got = bvq_matmul(x, cb, idx)
    torch.testing.assert_close(got, ref.bvq_matmul_ref2(x, cb, idx), rtol=1e-4, atol=1e-4)
    assert torch.equal(got, bvq_matmul(x, cb, idx))

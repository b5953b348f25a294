"""K8, the prefill flash-attention kernel (kernels/prefill_attn.py,
csrc/prefill_attn.cu), against its plain version
(models/layers.flash_attention_plain).

On the CPU: ``flash_attention`` keeps the plain version for CPU, meta,
float32 and autograd-recorded calls and counts no launch, and the wrapper
refuses CPU tensors (no fallback).  On a card only (``cuda`` marker): the
kernel against the plain version at the serving cells' shapes (GQA 32/8
and 48/8 at hd 128 over a 4,112-slot dense cache, prompts of 1-3,071
rows, a 15-row tail extend at q_offset 1,008), the paper pair's draft
(12 heads, hd 64), non-causal attention over 1,500 keys, every head dim
the kernel takes, B = 3, fp16, strided cache views; a cache poisoned with
NaN past q_offset + Sq leaves the output bit for bit; a second call gives
the same bits; one launch per call and per attention layer of a prefill.

Tolerance: the two compute the same function at the same precision and
differ only in the order of the sums (the plain version rescales once per
1,024-key chunk, the kernel once per 64-key tile, so P meets its rounding
to the model dtype at another running max).  Each output element is
rounded to the model dtype once at the end, so they may part by a last
bit or two of a row's largest value.  The limit is scaled per row (one
query row of one head, ``_row_ulp``), never by the call's largest output:
causal row 0 is v[0] itself, several times the size of a row over 1k or
3k keys, and a limit set there would be as large as the values of the
long rows.  Each element of the kernel stays within 2 units in the last
place of its row's largest plain output, and each row's largest error
against a float64 evaluation of the same function stays within twice the
plain version's plus one such unit.  ``test_planted_faults_fail_the_check``
shows on the CPU, at the 3,071-row cell shape, that K8's algorithm in
torch passes these limits and that a variant with bf16 softmax
statistics, a bf16 accumulator, an unrescaled normaliser or the last key
tile dropped fails them."""
import dataclasses
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_smoke
from repro_torch.kernels import _lib
from repro_torch.kernels.prefill_attn import HEAD_DIMS, prefill_attention
from repro_torch.models import layers as L
from repro_torch.models import lm

S_CELL = 4112  # the serving cells' dense prefill cache: the traffic's max model length


@pytest.fixture
def cuda():
    """The card, or a skip: decided here, inside the test, never at import."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernels have no CPU mode)")
    return torch.device("cuda")


def _x(shape, seed, dtype=torch.bfloat16, device="cpu"):
    a = np.random.RandomState(seed).randn(*shape).astype(np.float32)
    return torch.from_numpy(a).to(device).to(dtype)


def _qkv(b, sq, skv, h, hkv, hd, dtype=torch.bfloat16, device="cpu", seed=0):
    return (_x((b, sq, h, hd), seed, dtype, device), _x((b, skv, hkv, hd), seed + 1, dtype, device),
            _x((b, skv, hkv, hd), seed + 2, dtype, device))


def _truth(q, k, v, causal, q_offset):
    """The same function in float64: q * 1/sqrt(hd) rounded to q's dtype
    (as both versions round it), exact softmax and products; in blocks of
    512 rows, so a 3,071-row call holds no full score matrix."""
    b, sq, h, hd = q.shape
    if causal:  # no row sees a key at or past q_offset + Sq
        k, v = k[:, :q_offset + sq], v[:, :q_offset + sq]
    skv, hkv = k.shape[1], k.shape[2]
    qs = (q.float() * (1.0 / np.sqrt(hd))).to(q.dtype).double()
    kf = k.double().repeat_interleave(h // hkv, dim=2)
    vf = v.double().repeat_interleave(h // hkv, dim=2)
    outs = []
    for i in range(0, sq, 512):
        s = torch.einsum("bqhd,bkhd->bhqk", qs[:, i:i + 512], kf)
        if causal:
            pos = q_offset + torch.arange(i, min(i + 512, sq), device=q.device)
            s = s.masked_fill(torch.arange(skv, device=q.device)[None, :] > pos[:, None],
                              -np.inf)
        outs.append(torch.einsum("bhqk,bkhd->bqhd", torch.softmax(s, -1), vf))
    return torch.cat(outs, dim=1)


def _row_ulp(x: torch.Tensor) -> torch.Tensor:
    """A unit in the last place of the model dtype at the largest |x| of
    each query row of each head: (B, Sq, H, 1), float64."""
    mant = {torch.bfloat16: 7, torch.float16: 10}[x.dtype]
    top = x.double().abs().amax(-1, keepdim=True)
    return torch.where(top > 0, torch.exp2(torch.floor(torch.log2(top)) - mant),
                       torch.zeros_like(top))


def _check(got, want, truth):
    """The tolerance of this file's docstring: ``got`` against the plain
    version's ``want`` element by element, and both rows' largest errors
    against ``truth``."""
    assert got.shape == want.shape and got.dtype == want.dtype
    ulp = _row_ulp(want)
    diff = (got.double() - want.double()).abs()
    far = diff > 2 * ulp
    assert not far.any(), (f"kernel - plain past 2 row ulps at {int(far.sum())} elements, "
                           f"up to {float((diff / ulp.clamp_min(1e-300)).max()):.2f} ulps")
    err_k = (got.double() - truth).abs().amax(-1, keepdim=True)
    err_p = (want.double() - truth).abs().amax(-1, keepdim=True)
    bad = err_k > 2 * err_p + ulp
    assert not bad.any(), (f"kernel error past twice the plain version's + 1 row ulp in "
                           f"{int(bad.sum())} rows, up to {float(err_k.max())}")


def _against_plain(q, k, v, causal, q_offset=0):
    """Runs K8 and the plain version on the same inputs and checks the
    tolerance of this file's docstring; returns the kernel's output."""
    got = prefill_attention(q, k, v, causal, q_offset)
    _check(got, L.flash_attention_plain(q, k, v, causal, q_offset), _truth(q, k, v, causal, q_offset))
    assert torch.equal(got, prefill_attention(q, k, v, causal, q_offset)), "repeat differs"
    return got


def _k8_in_torch(q, k, v, causal, q_offset=0, plant=None):
    """K8's algorithm in torch: 64-key tiles at absolute key positions,
    float32 softmax statistics and accumulator, P rounded to the model dtype
    before the PV product, acc / max(l, 1e-30).  ``plant`` puts in one
    fault: ``bf16_stats`` (the running max and sum rounded to the model
    dtype), ``bf16_acc`` (the accumulator rounded to it after each tile),
    ``unrescaled_l`` (the sum not rescaled when the max moves),
    ``dropped_last_tile`` (the key loop stops one tile short)."""
    b, sq, h, hd = q.shape
    g, dt = h // k.shape[2], q.dtype
    n = q_offset + sq if causal else k.shape[1]
    qs = (q.float() * (1.0 / math.sqrt(hd))).to(dt).float().transpose(1, 2)
    kf, vf = (t[:, :n].float().repeat_interleave(g, dim=2).transpose(1, 2) for t in (k, v))
    pos = q_offset + torch.arange(sq)
    m = torch.full((b, h, sq, 1), -math.inf)
    l = torch.zeros((b, h, sq, 1))
    acc = torch.zeros((b, h, sq, hd))
    stat = (lambda t: t.to(dt).float()) if plant == "bf16_stats" else (lambda t: t)
    tiles = range(0, n, 64)
    if plant == "dropped_last_tile":
        tiles = tiles[:-1]
    for t0 in tiles:
        s = qs @ kf[:, :, t0:t0 + 64].transpose(-1, -2)
        if causal:
            keys = torch.arange(t0, min(t0 + 64, n))
            s = s.masked_fill(keys[None, :] > pos[:, None], -math.inf)
        m_new = stat(torch.maximum(m, s.amax(-1, keepdim=True)))
        alpha = torch.exp(m - m_new)
        p = torch.exp(s - m_new)
        l = stat((l if plant == "unrescaled_l" else l * alpha) + p.sum(-1, keepdim=True))
        acc = acc * alpha + p.to(dt).float() @ vf[:, :, t0:t0 + 64]
        if plant == "bf16_acc":
            acc = acc.to(dt).float()
        m = m_new
    return (acc / l.clamp_min(1e-30)).transpose(1, 2).to(dt)


# ---------------------------------------------------------------------------
# CPU: the routes that keep the plain version
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16, torch.float32])
def test_cpu_calls_keep_the_plain_version(dtype):
    q, k, v = _qkv(2, 9, 40, 4, 2, 16, dtype)
    _lib.launches.clear()
    got = L.flash_attention(q, k, v, causal=True, q_offset=31)
    assert torch.equal(got, L.flash_attention_plain(q, k, v, True, 31))
    assert not L._k8_takes(q, k, v) and _lib.launches["prefill_attention"] == 0


def test_meta_calls_keep_the_plain_version():
    """The dry-run's shape-only trace: the plain version's products, no
    launch, the kernel's output shape."""
    q, k, v = (torch.empty(s, dtype=torch.bfloat16, device="meta")
               for s in ((1, 300, 32, 128), (1, S_CELL, 8, 128), (1, S_CELL, 8, 128)))
    _lib.launches.clear()
    out = L.flash_attention(q, k, v, causal=True)
    assert out.shape == (1, 300, 32, 128) and out.device.type == "meta"
    assert not L._k8_takes(q, k, v) and _lib.launches["prefill_attention"] == 0


def test_cpu_autograd_keeps_the_plain_version():
    q, k, v = (t.requires_grad_() for t in _qkv(1, 5, 5, 4, 2, 16, torch.float32))
    _lib.launches.clear()
    L.flash_attention(q, k, v, causal=True).sum().backward()
    assert all(t.grad is not None and torch.isfinite(t.grad).all() for t in (q, k, v))
    assert _lib.launches["prefill_attention"] == 0


def test_wrapper_refuses_cpu_tensors():
    """No fallback: a CPU tensor handed to the wrapper raises."""
    with pytest.raises(ValueError, match="CUDA"):
        prefill_attention(*_qkv(1, 4, 4, 2, 2, 16), causal=True)


def test_head_dims_cover_the_configs():
    """Every head dim of the port's configurations has a kernel instance."""
    from repro_torch.configs import ARCH_IDS, get_config
    hds = {get_config(a).hd for a in ARCH_IDS} | {get_smoke(a).hd for a in ARCH_IDS}
    assert hds <= set(HEAD_DIMS), hds - set(HEAD_DIMS)


@pytest.fixture(scope="module")
def cell_3071():
    """The longest prompt of the cells' traffic, 3,071 rows into the
    4,112-slot dense cache at hd 128 (4 q heads on 1 kv head, Qwen3-8B's
    group), with the plain version's output and the float64 truth."""
    q, k, v = _qkv(1, 3071, S_CELL, 4, 1, 128, seed=3071)
    k[:, 3071:] = 0
    v[:, 3071:] = 0
    return (q, k, v), L.flash_attention_plain(q, k, v, True), _truth(q, k, v, True, 0)


def test_k8_algorithm_in_torch_passes_the_check(cell_3071):
    """Summing in K8's order, and nothing else, stays inside the limits."""
    (q, k, v), want, truth = cell_3071
    _check(_k8_in_torch(q, k, v, True), want, truth)


@pytest.mark.parametrize("plant", ["bf16_stats", "bf16_acc", "unrescaled_l",
                                   "dropped_last_tile"])
def test_planted_faults_fail_the_check(cell_3071, plant):
    """Each fault of K8's algorithm fails the per-row limits at the
    3,071-row shape."""
    (q, k, v), want, truth = cell_3071
    with pytest.raises(AssertionError, match="kernel"):
        _check(_k8_in_torch(q, k, v, True, plant=plant), want, truth)


# ---------------------------------------------------------------------------
# Card: the kernel against the plain version
# ---------------------------------------------------------------------------

CELL_SHAPES = {"qwen3-8b": (32, 8), "nemotron-4-15b": (48, 8)}  # target and draft alike


@pytest.mark.cuda
@pytest.mark.parametrize("rows", [1, 7, 127, 128, 129, 1020, 3071])
@pytest.mark.parametrize("model", sorted(CELL_SHAPES))
def test_cell_prefill_matches_plain(cuda, model, rows):
    """A prompt's prefill into the cells' (1, 4,112, 8, 128) dense cache:
    the keys past the prompt hold zeros, as a fresh cache does."""
    h, hkv = CELL_SHAPES[model]
    q, k, v = _qkv(1, rows, S_CELL, h, hkv, 128, device=cuda, seed=rows)
    k[:, rows:] = 0
    v[:, rows:] = 0
    _against_plain(q, k, v, causal=True)


@pytest.mark.cuda
@pytest.mark.parametrize("model", sorted(CELL_SHAPES))
def test_tail_extend_matches_plain_and_the_full_prefill(cuda, model):
    """A prefix hit's 15-row tail extend at q_offset 1,008: within the
    tolerance of the plain version, and bit for bit the same rows of the
    full 1,023-row prefill."""
    h, hkv = CELL_SHAPES[model]
    q, k, v = _qkv(1, 1023, S_CELL, h, hkv, 128, device=cuda, seed=3)
    tail = _against_plain(q[:, 1008:], k, v, causal=True, q_offset=1008)
    full = prefill_attention(q, k, v, causal=True)
    assert torch.equal(tail, full[:, 1008:])


@pytest.mark.cuda
def test_draft_shape_matches_plain(cuda):
    """The paper pair's draft: 12 heads of 64, G = 1, a 256-slot cache."""
    _against_plain(*_qkv(1, 77, 256, 12, 12, 64, device=cuda, seed=5), causal=True)


@pytest.mark.cuda
@pytest.mark.parametrize("sq", [1500, 37])
def test_non_causal_matches_plain(cuda, sq):
    """Whisper's encoder self-attention (1,500 frames) and cross-attention
    (37 decoder rows onto them): 20 heads of 64, every key seen."""
    _against_plain(*_qkv(1, sq, 1500, 20, 20, 64, device=cuda, seed=sq), causal=False)


@pytest.mark.cuda
@pytest.mark.parametrize("hd,h,hkv", [(16, 4, 2), (32, 4, 4), (64, 14, 2), (112, 32, 32),
                                      (128, 128, 8)])
def test_head_dims_match_plain(cuda, hd, h, hkv):
    """Every head dim the kernel takes, at G = 2, 1, 7, 1 and 16."""
    _against_plain(*_qkv(1, 200, 333, h, hkv, hd, device=cuda, seed=hd), causal=True,
                   q_offset=133)


@pytest.mark.cuda
def test_batch_of_three_matches_plain(cuda):
    _against_plain(*_qkv(3, 70, 500, 32, 8, 128, device=cuda, seed=9), causal=True, q_offset=90)


@pytest.mark.cuda
def test_fp16_matches_plain(cuda):
    _against_plain(*_qkv(2, 300, 700, 32, 8, 128, torch.float16, cuda, seed=11), causal=True,
                   q_offset=400)


@pytest.mark.cuda
def test_strided_views_read_in_place(cuda):
    """K / V as a layer of a (L, B, S, Hkv, hd) cache and as a slice of its
    kv heads (a rank's heads under tensor parallelism): the same bits as
    contiguous copies."""
    q = _x((2, 150, 8, 128), 1, device=cuda)
    kc = _x((3, 2, 512, 8, 128), 2, device=cuda)
    vc = _x((3, 2, 512, 8, 128), 3, device=cuda)
    k, v = kc[1][:, :, 2:6], vc[1][:, :, 2:6]
    got = prefill_attention(q, k, v, causal=True, q_offset=200)
    assert torch.equal(got, prefill_attention(q, k.contiguous(), v.contiguous(), True, 200))
    _against_plain(q, k, v, causal=True, q_offset=200)


@pytest.mark.cuda
def test_poisoned_cache_past_the_rows_is_never_read(cuda):
    """NaN in every slot at or past q_offset + Sq changes no bit."""
    q, k, v = _qkv(1, 100, S_CELL, 32, 8, 128, device=cuda, seed=13)
    clean = prefill_attention(q, k, v, causal=True, q_offset=900)
    k[:, 1000:] = float("nan")
    v[:, 1000:] = float("nan")
    assert torch.equal(prefill_attention(q, k, v, causal=True, q_offset=900), clean)


@pytest.mark.cuda
def test_one_launch_per_call(cuda):
    q, k, v = _qkv(1, 1020, S_CELL, 32, 8, 128, device=cuda)
    _lib.launches.clear()
    L.flash_attention(q, k, v, causal=True)
    assert _lib.launches["prefill_attention"] == 1


@pytest.mark.cuda
def test_one_launch_per_layer_of_a_prefill(cuda):
    """A bf16 prefill over a dense cache launches K8 once per attention
    layer; the one-token step after it launches none (dense decode)."""
    cfg = dataclasses.replace(get_smoke("qwen3-8b"), dtype="bfloat16")
    params = lm.init_lm(torch.Generator(device=cuda).manual_seed(0), cfg, cuda)
    cache = lm.init_cache(cfg, 1, 64, cuda)
    tokens = torch.randint(0, cfg.vocab, (1, 37), device=cuda)
    _lib.launches.clear()
    with torch.no_grad():
        _, cache = lm.apply_lm(params, cfg, tokens, cache)
        assert _lib.launches["prefill_attention"] == cfg.n_layers
        lm.apply_lm(params, cfg, tokens[:, :1], cache)
    assert _lib.launches["prefill_attention"] == cfg.n_layers


@pytest.mark.cuda
def test_card_float32_and_autograd_keep_the_plain_version(cuda):
    q, k, v = _qkv(1, 20, 20, 4, 2, 16, torch.float32, cuda)
    _lib.launches.clear()
    assert torch.equal(L.flash_attention(q, k, v, causal=True),
                       L.flash_attention_plain(q, k, v, True))
    qb, kb, vb = (t.to(torch.bfloat16).requires_grad_() for t in (q, k, v))
    L.flash_attention(qb, kb, vb, causal=True).float().sum().backward()
    assert qb.grad is not None and _lib.launches["prefill_attention"] == 0

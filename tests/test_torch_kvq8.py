"""The dense int8 KV cache (``ModelConfig.kv_quant``) of the port against the
JAX package: ``lm.init_cache`` holds int8 K / V beside float32
per-(token, head) scales, and ``lm.apply_lm`` writes codes and scales as
the reference's ``_kv_quantize`` does and attends as its
``_decode_attention`` does.

Tolerances (float32 smoke config of ``tests/test_launch.py``): after a
prefill of 8 tokens and 3 decode steps the cache's int8 codes equal the
reference's exactly and its scales within 2e-6 relative (the keys' and
values' float32 projections sum in another order, so a row's absolute
maximum moves by a few ulp: observed 9); the logits within 1e-5.  The
reference's own consistency bound holds too: int8 KV moves the prefill's
and the decode step's logits by less than 0.08 from the float cache-free
forward (``test_launch.py``).

The one-token step over an int8 cache runs K7 (``kernels.decode_attn``)
on the card and the reference's math on the CPU, which rounds the dots'
operands (the scaled query, the softmax weights times the V scale) to
bfloat16 even in a float32 model; K7 keeps float32.  On the same cache the
two differ by at most ``BF16_GAP`` = 1e-2 of the output's largest
magnitude (two bfloat16 roundings of 2^-9 relative each, of the query and
of the scaled softmax weights; observed <= 2.9e-3); the CPU route itself equals the
reference's ``_decode_attention`` within 1e-6."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

import jax
import jax.numpy as jnp

from repro.models import layers as jL
from repro.models import lm as jlm
from repro.models.common import Family as JFamily, ModelConfig as JModelConfig
from repro_torch.kernels.decode_attn import decode_attention_int8
from repro_torch.models import convert, layers as L, lm
from repro_torch.models.common import Family, ModelConfig

FIELDS = dict(name="t", n_layers=2, d_model=64, n_heads=4, n_kv=2, d_ff=128, vocab=97,
              dtype="float32", kv_quant=True)
ATOL = 1e-5
CONSISTENCY = 0.08  # the reference's bound (tests/test_launch.py)
BF16_GAP = 1e-2
SCALE_RTOL = 2e-6
PREFILL, STEPS, S_MAX = 8, 3, 32


@pytest.fixture(scope="module")
def run():
    jcfg = JModelConfig(family=JFamily.DENSE, **FIELDS)
    tcfg = ModelConfig(family=Family.DENSE, **FIELDS)
    key = jax.random.PRNGKey(0)
    params, _ = jlm.init_lm(key, jcfg, tp=1)
    toks = np.asarray(jax.random.randint(key, (2, PREFILL + STEPS), 0, FIELDS["vocab"]))
    jcache = jlm.init_cache(jcfg, 2, S_MAX, tp=1)
    fwd = jax.jit(lambda p, t, c: jlm.apply_lm(p, jcfg, None, t, cache=c))
    jlogits = []
    lg, jcache = fwd(params, jnp.asarray(toks[:, :PREFILL]), jcache)
    jlogits.append(np.asarray(lg))
    for i in range(STEPS):
        lg, jcache = fwd(params, jnp.asarray(toks[:, PREFILL + i:PREFILL + i + 1]), jcache)
        jlogits.append(np.asarray(lg))
    jfull = np.asarray(jlm.apply_lm(params, jcfg, None, jnp.asarray(toks))[0])

    tparams = convert.params_from_numpy(jax.tree.map(np.asarray, params), tcfg, "cpu")
    tcache = lm.init_cache(tcfg, 2, S_MAX, "cpu")
    tt = torch.as_tensor(np.array(toks))
    tlogits = []
    with torch.no_grad():
        lg, tcache = lm.apply_lm(tparams, tcfg, tt[:, :PREFILL], cache=tcache)
        tlogits.append(lg.numpy())
        for i in range(STEPS):
            lg, tcache = lm.apply_lm(tparams, tcfg, tt[:, PREFILL + i:PREFILL + i + 1],
                                     cache=tcache)
            tlogits.append(lg.numpy())
        tfull = lm.apply_lm(tparams, tcfg, tt)[0].numpy()
    return {"jcache": jcache, "tcache": tcache, "jlogits": jlogits, "tlogits": tlogits,
            "jfull": jfull, "tfull": tfull}


def test_cache_is_int8_with_scales():
    cfg = ModelConfig(family=Family.DENSE, **FIELDS)
    cache = lm.init_cache(cfg, 2, S_MAX, "cpu")
    attn = cache["attn"]
    assert attn["k"].dtype == attn["v"].dtype == torch.int8
    assert attn["k"].shape == (2, 2, S_MAX, 2, 16)
    assert attn["k_scale"].dtype == torch.float32 and attn["k_scale"].shape == (2, 2, S_MAX, 2, 1)
    jcfg = JModelConfig(family=JFamily.DENSE, **FIELDS)
    jcache = jax.eval_shape(lambda: jlm.init_cache(jcfg, 2, S_MAX, tp=1))
    for name in ("k", "v", "k_scale", "v_scale"):
        assert tuple(jcache["attn"][name].shape) == tuple(attn[name].shape)
        assert str(jcache["attn"][name].dtype) == str(attn[name].dtype).split(".")[-1]


def test_codes_and_scales_equal_the_reference(run):
    n = PREFILL + STEPS
    for name in ("k", "v"):
        got = run["tcache"]["attn"][name][:, :, :n].numpy()
        want = np.asarray(run["jcache"]["attn"][name])[:, :, :n]
        np.testing.assert_array_equal(got, want)
    for name in ("k_scale", "v_scale"):
        got = run["tcache"]["attn"][name][:, :, :n].numpy()
        want = np.asarray(run["jcache"]["attn"][name])[:, :, :n]
        np.testing.assert_allclose(got, want, rtol=SCALE_RTOL, atol=0)
    assert int(run["tcache"]["length"]) == n == int(run["jcache"]["length"])


@pytest.mark.parametrize("step", range(STEPS + 1), ids=lambda i: "prefill" if i == 0 else
                         f"decode{i}")
def test_logits_match_the_reference(run, step):
    np.testing.assert_allclose(run["tlogits"][step], run["jlogits"][step], atol=ATOL, rtol=0)


def test_reference_consistency_bound(run):
    """``test_launch.test_kv_quant_decode_consistency`` on the port: the
    int8 cache's prefill and decode logits within 0.08 of the float
    cache-free forward."""
    full = run["tfull"]
    assert float(np.abs(full[:, PREFILL - 1] - run["tlogits"][0][:, -1]).max()) < CONSISTENCY
    for i in range(STEPS):
        pos = PREFILL + i
        assert float(np.abs(full[:, pos] - run["tlogits"][i + 1][:, 0]).max()) < CONSISTENCY
    np.testing.assert_allclose(run["tfull"], run["jfull"], atol=ATOL, rtol=0)


@pytest.mark.parametrize("length", [1, 37, 64])
def test_k7_plain_version_within_the_bf16_gap(length):
    """K7's plain version (float32, what the card computes) against the
    CPU route (``layers.decode_attention``: the reference's bfloat16 dots),
    and the CPU route against the JAX ``_decode_attention``."""
    g = torch.Generator().manual_seed(length)
    b, s, kvs, grp, hd = 2, 64, 2, 4, 32
    q = torch.randn((b, 1, kvs * grp, hd), generator=g)
    kf = torch.randn((b, s, kvs, hd), generator=g)
    vf = torch.randn((b, s, kvs, hd), generator=g)
    (kq, ks), (vq, vs) = L.kv_quantize(kf), L.kv_quantize(vf)
    cpu = L.decode_attention(q, kq, vq, length, ks, vs)
    k7 = decode_attention_int8(q.reshape(b, kvs, grp, hd), kq, ks[..., 0], vq, vs[..., 0],
                               torch.tensor([length], dtype=torch.int32))
    k7 = k7.reshape(b, 1, kvs * grp, hd)
    scale = float(k7.abs().max())
    gap = float((cpu - k7).abs().max())
    assert gap <= BF16_GAP * scale, (gap, scale)
    want = jL._decode_attention(jnp.asarray(q.numpy()), jnp.asarray(kq.numpy()),
                                jnp.asarray(vq.numpy()), jnp.asarray(length, jnp.int32),
                                k_scale=jnp.asarray(ks.numpy()), v_scale=jnp.asarray(vs.numpy()))
    np.testing.assert_allclose(cpu.numpy(), np.asarray(want), atol=1e-6, rtol=0)

"""The SSM and hybrid families in the port against the JAX package: the SSD
scan (``ssd_chunked``) at several chunk sizes, ``mamba_apply`` with and
without a carried state and conv tail, ``mamba_decode``, and the mamba2 /
zamba2 smoke configs' logits and greedy tokens through prefill, cached
extend and decode, with float32 weights made by the JAX package and
carried across with ``params_from_numpy``.

Tolerance: both sides compute the SSD in float32; XLA and torch round its
``cumsum`` / ``exp`` / einsum sums differently in the last bits, and the
intra-chunk term sums up to ``chunk`` products, so outputs of O(1-10) are
held to atol 1e-4 (rtol 1e-4), and states to the same.  Greedy tokens
must be equal token for token."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

import jax
import jax.numpy as jnp
from test_torch_models import one_thread  # noqa: F401

from repro import configs as jconfigs
from repro.models import lm as jlm
from repro.models import ssm as jS
from repro_torch import configs as tconfigs
from repro_torch.core.tree import tree_map
from repro_torch.models import common as tcommon
from repro_torch.models import lm as tlm
from repro_torch.models import ssm as tS
from repro_torch.serving import quantized_lm as tqlm

pytestmark = pytest.mark.usefixtures("one_thread")
ATOL = 1e-4
ARCHS = ["mamba2-1.3b", "zamba2-7b"]


def _np(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.fixture(scope="module")
def models():
    """{arch: (JAX cfg, port cfg, JAX params, port params)}, each built on
    first use."""
    cache = {}

    def get(arch):
        if arch not in cache:
            jcfg, tcfg = jconfigs.get_smoke(arch), tconfigs.get_smoke(arch)
            params = jax.jit(lambda k: jlm.init_lm(k, jcfg, tp=1)[0])(jax.random.PRNGKey(2))
            cache[arch] = (jcfg, tcfg, params,
                           tqlm.params_from_numpy(_np(params), tcfg, "bf16", "cpu"))
        return cache[arch]

    return get


def _ssd_inputs(seed, b=2, s=32, h=3, p=8, n=4):
    rng = np.random.RandomState(seed)
    return (rng.randn(b, s, h, p).astype(np.float32),
            (-np.abs(rng.randn(b, s, h)) * 0.3).astype(np.float32),
            rng.randn(b, s, h, n).astype(np.float32),
            rng.randn(b, s, h, n).astype(np.float32),
            rng.randn(b, h, p, n).astype(np.float32))


@pytest.mark.parametrize("chunk", [1, 4, 8, 16, 32])
@pytest.mark.parametrize("with_state", [False, True])
def test_ssd_chunked_matches(chunk, with_state):
    x, da, bm, cm, st = _ssd_inputs(chunk)
    init = st if with_state else None
    jy, jst = jax.jit(jS.ssd_chunked, static_argnums=4)(
        *map(jnp.asarray, (x, da, bm, cm)), chunk, None if init is None else jnp.asarray(init))
    ty, tst = tS.ssd_chunked(*map(torch.from_numpy, (x, da, bm, cm)), chunk,
                             None if init is None else torch.from_numpy(init))
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), atol=ATOL, rtol=ATOL)
    np.testing.assert_allclose(tst.numpy(), np.asarray(jst), atol=ATOL, rtol=ATOL)
    assert ty.dtype == torch.float32 and tst.dtype == torch.float32


def test_ssd_chunk_invariance():
    """The port's SSD does not depend on the chunk size (the reference's
    ``test_ssd_chunk_invariance``)."""
    x, da, bm, cm, _ = _ssd_inputs(1)
    args = tuple(map(torch.from_numpy, (x, da, bm, cm)))
    y8, st8 = tS.ssd_chunked(*args, 8)
    for chunk in (16, 32):
        y, st = tS.ssd_chunked(*args, chunk)
        np.testing.assert_allclose(y.numpy(), y8.numpy(), atol=ATOL)
        np.testing.assert_allclose(st.numpy(), st8.numpy(), atol=ATOL)


def test_segsum_masks_before_exp():
    a = torch.tensor([[-1.0, -2.0, -3.0, -4.0]])
    out = tS._segsum(a)
    want = np.asarray(jS._segsum(jnp.asarray(a.numpy())))
    np.testing.assert_array_equal(np.isinf(out.numpy()), np.isinf(want))
    np.testing.assert_allclose(out.numpy()[np.isfinite(want)], want[np.isfinite(want)])
    assert torch.isfinite(torch.exp(out)).all()


@pytest.mark.parametrize("s,carried", [(16, False), (21, False), (7, True), (40, True)])
def test_mamba_apply_matches(models, s, carried):
    """Full-sequence SSD blocks, S a chunk multiple or zero-padded to one,
    fresh or carrying the previous window's state and conv tail."""
    jcfg, tcfg, jp, tp = models("mamba2-1.3b")
    rng = np.random.RandomState(s)
    x = rng.randn(2, s, jcfg.d_model).astype(np.float32)
    jm, tm = jax.tree.map(lambda a: a[0], jp["layers"]["mamba"]), tp["layers"][0]["mamba"]
    st = conv = None
    if carried:
        st = rng.randn(2, jcfg.ssm_heads, jcfg.ssm_headdim, jcfg.ssm_state).astype(np.float32)
        conv = rng.randn(2, jcfg.ssm_conv - 1,
                         jcfg.d_inner + 2 * jcfg.ssm_groups * jcfg.ssm_state).astype(np.float32)
    jy, jst, jtail = jax.jit(jS.mamba_apply, static_argnums=2)(
        jm, jnp.asarray(x), jcfg, None if st is None else jnp.asarray(st),
        None if conv is None else jnp.asarray(conv))
    ty, tst, ttail = tS.mamba_apply(tm, torch.from_numpy(x), tcfg,
                                    None if st is None else torch.from_numpy(st),
                                    None if conv is None else torch.from_numpy(conv))
    for got, want in ((ty, jy), (tst, jst), (ttail, jtail)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=ATOL)


def test_mamba_decode_matches(models):
    """Eight recurrent steps from a random state, each against the
    reference's, and the last against one chunked pass over the same
    tokens from the same state."""
    jcfg, tcfg, jp, tp = models("mamba2-1.3b")
    rng = np.random.RandomState(5)
    jm, tm = jax.tree.map(lambda a: a[0], jp["layers"]["mamba"]), tp["layers"][0]["mamba"]
    base = tS.init_ssm_cache(tcfg, 2, torch.float32, "cpu")
    tc = {"state": torch.from_numpy(rng.randn(*base["state"].shape).astype(np.float32)),
          "conv": torch.from_numpy(rng.randn(*base["conv"].shape).astype(np.float32))}
    jc = {k: jnp.asarray(v.numpy()) for k, v in tc.items()}
    xs = rng.randn(2, 8, jcfg.d_model).astype(np.float32)
    c0 = dict(tc)
    ys = []
    jdecode = jax.jit(jS.mamba_decode, static_argnums=2)
    for t in range(8):
        jy, jc = jdecode(jm, jnp.asarray(xs[:, t:t + 1]), jcfg, jc)
        ty, tc = tS.mamba_decode(tm, torch.from_numpy(xs[:, t:t + 1]), tcfg, tc)
        np.testing.assert_allclose(ty.numpy(), np.asarray(jy), atol=ATOL, rtol=ATOL)
        for k in tc:
            np.testing.assert_allclose(tc[k].numpy(), np.asarray(jc[k]), atol=ATOL, rtol=ATOL)
        ys.append(ty)
    full, st, tail = tS.mamba_apply(tm, torch.from_numpy(xs), tcfg, c0["state"], c0["conv"])
    np.testing.assert_allclose(full.numpy(), torch.cat(ys, 1).numpy(), atol=ATOL, rtol=ATOL)
    np.testing.assert_allclose(st.numpy(), tc["state"].numpy(), atol=ATOL, rtol=ATOL)
    np.testing.assert_allclose(tail.numpy(), tc["conv"].numpy(), atol=ATOL, rtol=ATOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_logits_match(models, arch):
    jcfg, tcfg, jp, tp = models(arch)
    toks = np.random.RandomState(0).randint(0, jcfg.vocab, (2, 24)).astype(np.int32)
    want, _ = jax.jit(lambda p, t: jlm.apply_lm(p, jcfg, None, t))(jp, jnp.asarray(toks))
    got, cache = tlm.apply_lm(tp, tcfg, torch.from_numpy(toks))
    assert cache is None and got.shape == (2, 24, tcfg.vocab_padded)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=ATOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_cached_greedy_matches(models, arch):
    """Prefill 8 tokens, extend 3 (the reference's test_decode_matches_full_
    forward), then 8 greedy one-token steps: every logit row against the
    JAX package's and the full forward's, tokens equal token for token."""
    jcfg, tcfg, jp, tp = models(arch)
    toks = np.random.RandomState(1).randint(0, jcfg.vocab, (2, 11)).astype(np.int32)
    jc, tc = jlm.init_cache(jcfg, 2, 32, tp=1), tlm.init_cache(tcfg, 2, 32, "cpu")
    japply = jax.jit(lambda p, t, c: jlm.apply_lm(p, jcfg, None, t, cache=c))
    got, want = [], []
    for lo, hi in ((0, 8), (8, 11)):
        jl, jc = japply(jp, jnp.asarray(toks[:, lo:hi]), jc)
        tl, tc = tlm.apply_lm(tp, tcfg, torch.from_numpy(toks[:, lo:hi]), cache=tc)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL, rtol=ATOL)
    assert tc["length"] == 11
    jt, tt = jnp.argmax(jl[:, -1], -1), torch.argmax(tl[:, -1], -1)
    for _ in range(8):
        want.append(np.asarray(jt))
        got.append(tt.numpy())
        jl, jc = japply(jp, jt[:, None].astype(jnp.int32), jc)
        tl, tc = tlm.apply_lm(tp, tcfg, tt[:, None].to(torch.int32), cache=tc)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL, rtol=ATOL)
        jt, tt = jnp.argmax(jl[:, -1], -1), torch.argmax(tl[:, -1], -1)
    np.testing.assert_array_equal(np.stack(got, 1), np.stack(want, 1))
    seq = np.concatenate([toks, np.stack(got, 1)], 1).astype(np.int32)
    full, _ = tlm.apply_lm(tp, tcfg, torch.from_numpy(seq))
    assert (torch.argmax(full[:, 10:-1], -1).numpy() == np.stack(got, 1)).all()


def test_hybrid_shared_block_is_one_tensor_set(models):
    """zamba2's shared attention block is one set of tensors, applied after
    each group with its own cache entry: a loss's gradient reaches it once,
    summed over the applications (held against the JAX package's in
    tests/test_torch_train.py), and the hybrid's tree holds ng groups of
    attn_every blocks and the tail."""
    _, tcfg, _, tp = models("zamba2-7b")
    ng, rem = tlm.hybrid_groups(tcfg)
    assert (len(tp["layers"]), len(tp["layers"][0]), len(tp["tail"])) == \
        (ng, tcfg.attn_every, rem)
    assert tlm.init_cache(tcfg, 1, 8, "cpu")["attn"]["k"].shape[0] == ng
    toks = torch.from_numpy(np.random.RandomState(3).randint(0, tcfg.vocab, (2, 13)))
    wq = tp["shared_attn"]["attn"]["wq"].detach().requires_grad_()
    shared = dict(tp["shared_attn"], attn=dict(tp["shared_attn"]["attn"], wq=wq))
    seen = []
    wq.register_hook(lambda g: seen.append(g))
    loss = tlm.loss_fn(dict(tp, shared_attn=shared), tcfg, toks)
    (g,) = torch.autograd.grad(loss, [wq])
    assert len(seen) == 1 and torch.equal(seen[0], g) and g.abs().max() > 0


def test_paged_cache_refused_for_recurrent_families(models):
    for arch in ARCHS:
        _, tcfg, _, tp = models(arch)
        with pytest.raises(NotImplementedError, match=tcfg.family.value):
            tlm.apply_lm(tp, tcfg, torch.zeros((1, 2), dtype=torch.int32),
                         cache={"page_table": torch.zeros((1, 1), dtype=torch.int32),
                                "lengths": torch.zeros(1, dtype=torch.int32)})


def test_remat_policy_dots_is_full_remat(models):
    """Both remat policies give the no-remat loss and gradients bit for bit."""
    _, tcfg, _, tp = models("zamba2-7b")
    toks = torch.from_numpy(np.random.RandomState(4).randint(0, tcfg.vocab, (2, 9)))
    leaves = [tp["embed"]["head"], tp["layers"][0][0]["mamba"]["w_in"],
              tp["shared_attn"]["mlp"]["w_up"]]
    results = []
    for cfg in (dataclasses.replace(tcfg, remat=False), tcfg,
                dataclasses.replace(tcfg, remat_policy="dots")):
        ls = [t.detach().requires_grad_() for t in leaves]
        p = dict(tp, embed=dict(tp["embed"], head=ls[0]))
        p["layers"] = [[dict(tp["layers"][0][0], mamba=dict(tp["layers"][0][0]["mamba"],
                                                              w_in=ls[1]))]
                       + tp["layers"][0][1:]] + tp["layers"][1:]
        p["shared_attn"] = dict(tp["shared_attn"], mlp=dict(tp["shared_attn"]["mlp"],
                                                            w_up=ls[2]))
        loss = tlm.loss_fn(p, cfg, toks)
        results.append((loss.detach(), torch.autograd.grad(loss, ls)))
    for loss, grads in results[1:]:
        assert torch.equal(loss, results[0][0])
        assert all(torch.equal(a, b) for a, b in zip(grads, results[0][1]))


@pytest.mark.parametrize("arch", ["mamba2-1.3b", "zamba2-7b", "whisper-large-v3"])
def test_bf16_decode_within_bf16_rounding(arch):
    """In bf16 a cached decode step and a full forward round the same
    float32 function to bf16 in other orders, so their logits differ.  The
    decode must stay as close to the float32 forward of the same weights
    (cast) over the same tokens as the bf16 forward is, within a factor 2
    (chip_smoke.py's BF16_DECODE_FACTOR).  A decode that loses its state
    or a cache entry fails it; smaller faults are left to the float32
    parity tests above."""
    cfg = dataclasses.replace(tconfigs.get_smoke(arch), dtype="bfloat16")
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    params = tlm.init_lm(torch.Generator().manual_seed(5), cfg, "cpu")
    prompts = torch.from_numpy(np.random.RandomState(6).randint(0, cfg.vocab, (2, 16))).int()
    frames = None
    if cfg.family is tcommon.Family.AUDIO:
        frames = torch.randn((2, cfg.n_audio_frames, cfg.d_model),
                             generator=torch.Generator().manual_seed(7)).to(torch.bfloat16)
    kw = {} if frames is None else {"frames": frames}
    with torch.no_grad():
        cache = tlm.init_cache(cfg, 2, 32, "cpu")
        logits, cache = tlm.apply_lm(params, cfg, prompts, cache=cache, **kw)
        steps = [logits[:, -1]]
        for _ in range(11):
            tok = torch.argmax(steps[-1], -1).int()[:, None]
            logits, cache = tlm.apply_lm(params, cfg, tok, cache=cache)
            steps.append(logits[:, -1])
        toks = torch.stack([torch.argmax(s, -1).int() for s in steps[:-1]], 1)
        seq = torch.cat([prompts, toks], 1)
        p32 = tree_map(lambda t: t.float(), params)
        kw32 = {} if frames is None else {"frames": frames.float()}
        full = tlm.apply_lm(params, cfg, seq, **kw)[0][:, 15:, :cfg.vocab].float()
        full32 = tlm.apply_lm(p32, cfg32, seq, **kw32)[0][:, 15:, :cfg.vocab]
    dec = torch.stack(steps, 1)[..., :cfg.vocab].float()
    assert dec.shape == full32.shape
    dec_err = (dec - full32).abs().flatten(1).max(1).values
    fwd_err = (full - full32).abs().flatten(1).max(1).values
    assert (fwd_err > 0).all() and (dec_err <= 2 * fwd_err).all(), (dec_err, fwd_err)
    assert full32.abs().max() > 20 * fwd_err.max()

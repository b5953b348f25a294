"""Whisper in the port against the JAX package: the encoder, the decoder's
logits with and without a cache, greedy tokens through prefill (which
writes the cross K/V) and cached decode (which reads it), and the loss,
with float32 weights made by the JAX package and carried across with
``params_from_numpy``.

Tolerance: both sides compute in float32 (summation order only), so
encoder states and logits are held to atol 1e-4; greedy tokens must be
equal token for token."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

import jax
import jax.numpy as jnp
from test_torch_models import one_thread  # noqa: F401

from repro import configs as jconfigs
from repro.models import whisper as jW
from repro.models.common import Family, ModelConfig
from repro_torch import configs as tconfigs
from repro_torch.models import common as tcommon
from repro_torch.models import lm as tlm
from repro_torch.models import whisper as tW
from repro_torch.serving import quantized_lm as tqlm

pytestmark = pytest.mark.usefixtures("one_thread")
ATOL = 1e-4
# the reference's test_whisper_decode_consistency config (vocab 101, 24 frames)
DECODE_KW = dict(name="w", n_layers=2, n_encoder_layers=2, d_model=64, n_heads=4, n_kv=4,
                 d_ff=128, vocab=101, act="gelu", n_audio_frames=24, dtype="float32")


@pytest.fixture(scope="module")
def models():
    """{name: (JAX cfg, port cfg, JAX params, port params)}: the whisper
    smoke config and the reference's decode-test config."""
    out = {}
    for name, jcfg, tcfg in (
        ("smoke", jconfigs.get_smoke("whisper-large-v3"), tconfigs.get_smoke("whisper-large-v3")),
        ("decode", ModelConfig(family=Family.AUDIO, **DECODE_KW),
         tcommon.ModelConfig(family=tcommon.Family.AUDIO, **DECODE_KW)),
    ):
        params = jax.jit(lambda k: jW.init_whisper(k, jcfg, tp=1)[0])(jax.random.PRNGKey(4))
        out[name] = (jcfg, tcfg, params,
                     tqlm.params_from_numpy(jax.tree.map(np.asarray, params), tcfg, "bf16", "cpu"))
    return out


def _inputs(cfg, seed, s):
    rng = np.random.RandomState(seed)
    return (rng.randint(0, cfg.vocab, (2, s)).astype(np.int32),
            rng.randn(2, cfg.n_audio_frames, cfg.d_model).astype(np.float32))


def test_encode_matches(models):
    jcfg, tcfg, jp, tp = models["smoke"]
    _, frames = _inputs(jcfg, 0, 1)
    want = jax.jit(lambda p, f: jW.encode(p, jcfg, None, f))(jp, jnp.asarray(frames))
    got = tW.encode(tp, tcfg, torch.from_numpy(frames))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=ATOL)


@pytest.mark.parametrize("name", ["smoke", "decode"])
def test_forward_logits_match(models, name):
    jcfg, tcfg, jp, tp = models[name]
    toks, frames = _inputs(jcfg, 1, 12)
    want, _ = jax.jit(lambda p, t, f: jW.apply_whisper(p, jcfg, None, t, frames=f))(
        jp, jnp.asarray(toks), jnp.asarray(frames))
    got, cache = tlm.apply_lm(tp, tcfg, torch.from_numpy(toks), frames=torch.from_numpy(frames))
    assert cache is None and got.shape == (2, 12, tcfg.vocab_padded)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=ATOL)


@pytest.mark.parametrize("name", ["smoke", "decode"])
def test_cached_greedy_matches(models, name):
    """The reference's test_whisper_decode_consistency through both
    packages: prefill 8 tokens with the frames, then 8 greedy steps without
    them (the cached cross K/V); logits against the JAX package's at every
    step and against the full forward, tokens equal token for token."""
    jcfg, tcfg, jp, tp = models[name]
    toks, frames = _inputs(jcfg, 2, 8)
    jc = jW.init_whisper_cache(jcfg, 2, 32, tp=1)
    tc = tlm.init_cache(tcfg, 2, 32, "cpu")
    jprefill = jax.jit(lambda p, t, f, c: jW.apply_whisper(p, jcfg, None, t, frames=f, cache=c))
    jstep = jax.jit(lambda p, t, c: jW.apply_whisper(p, jcfg, None, t, cache=c))
    jl, jc = jprefill(jp, jnp.asarray(toks), jnp.asarray(frames), jc)
    tl, tc = tW.apply_whisper(tp, tcfg, torch.from_numpy(toks), frames=torch.from_numpy(frames),
                              cache=tc)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL, rtol=ATOL)
    np.testing.assert_allclose(tc["xk"].numpy(), np.asarray(jc["xk"]), atol=ATOL, rtol=ATOL)
    got, want = [], []
    jt, tt = jnp.argmax(jl[:, -1], -1), torch.argmax(tl[:, -1], -1)
    for _ in range(8):
        want.append(np.asarray(jt))
        got.append(tt.numpy())
        jl, jc = jstep(jp, jt[:, None].astype(jnp.int32), jc)
        tl, tc = tW.apply_whisper(tp, tcfg, tt[:, None].to(torch.int32), cache=tc)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL, rtol=ATOL)
        jt, tt = jnp.argmax(jl[:, -1], -1), torch.argmax(tl[:, -1], -1)
    assert tc["length"] == 16
    np.testing.assert_array_equal(np.stack(got, 1), np.stack(want, 1))
    seq = np.concatenate([toks, np.stack(got, 1)], 1)
    full, _ = tW.apply_whisper(tp, tcfg, torch.from_numpy(seq), frames=torch.from_numpy(frames))
    np.testing.assert_array_equal(torch.argmax(full[:, 7:-1], -1).numpy(), np.stack(got, 1))


def test_loss_matches(models):
    jcfg, tcfg, jp, tp = models["decode"]
    toks, frames = _inputs(jcfg, 3, 10)
    want = jax.jit(lambda p, t, f: jW.whisper_loss_fn(p, jcfg, None, t, f))(
        jp, jnp.asarray(toks), jnp.asarray(frames))
    got = tW.whisper_loss_fn(tp, tcfg, torch.from_numpy(toks), torch.from_numpy(frames))
    assert abs(float(got) - float(want)) < ATOL
    assert float(tlm.loss_fn(tp, tcfg, torch.from_numpy(toks),
                             frames=torch.from_numpy(frames))) == float(got)

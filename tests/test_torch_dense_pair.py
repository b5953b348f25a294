"""The dense pair in the port (``lm.apply_lm``, ``ServingModel(mode=
"bf16")``, ``build_pair(quantize=False)``) against the JAX package, on the
smoke pair's float32 weights carried across with params_from_numpy.

- forward: ``apply_lm`` logits (and the cache rows it writes) equal to
  the reference's ``apply_lm`` (its plain paged path, paged_impl="gather")
  to atol 1e-4 on O(1) logits: no cache, a dense-cache prefill then a
  4-token extend, a one-token and a 4-token paged window over fp pools,
  and int8 pools, tree windows, and both, at seeds 1-2.  Both sides
  compute in float32 with no quantized activation, so nothing but
  summation order separates them;
- engine: the port's dense-pair Engine equal to the JAX Engine token for
  token under chain, tree, int8 KV and WDOS (adaptive, staggered)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")  # the reference side of every test here

import jax.numpy as jnp
from test_torch_models import one_thread, to_numpy_tree  # noqa: F401
from test_torch_tree_int8 import _map, _window_cache

from repro.configs.paper_pair import TLM_SMOKE as J_TLM
from repro.launch.serve import build_pair as jax_build_pair
from repro.models import lm as jlm
from repro.serving import Engine as JaxEngine
from repro.serving import EngineConfig as JaxEngineConfig
from repro.serving import SamplingParams as JaxSamplingParams
from repro_torch.configs.paper_pair import DLM_SMOKE, TLM_SMOKE
from repro_torch.launch.serve import build_pair
from repro_torch.models import lm as tlm
from repro_torch.serving import quantized_lm as tqlm
from repro_torch.serving.engine import Engine, EngineConfig, SamplingParams, ServingModel

pytestmark = pytest.mark.usefixtures("one_thread")
S_MAX = 128
MAX_TOKENS = 10
ATOL = 1e-4


@pytest.fixture(scope="module")
def pairs():
    """(JAX dense pair, port dense pair on the CPU, weights carried across)."""
    jt, jd = jax_build_pair(seed=0, s_max=S_MAX, quantize=False)
    tt, td = (ServingModel(cfg, tqlm.params_from_numpy(to_numpy_tree(m.params), cfg, "bf16",
                                                       "cpu"),
                           mode="bf16", s_max=S_MAX, device="cpu")
              for m, cfg in ((jt, TLM_SMOKE), (jd, DLM_SMOKE)))
    return (jt, jd), (tt, td)


def _tokens(b, s, seed):
    return np.random.RandomState(seed).randint(0, 512, (b, s)).astype(np.int32)


def test_build_pair_dense_serves_bf16_mode():
    target, draft = build_pair(seed=0, s_max=64, quantize=False, device="cpu")
    assert (target.mode, draft.mode) == ("bf16", "bf16")
    assert target.params["layers"][0]["attn"]["wq"].shape == (128, 4, 32)
    logits, _ = target._apply(target.params, torch.zeros((1, 3), dtype=torch.int32), None)
    assert logits.shape == (1, 3, TLM_SMOKE.vocab_padded)


def test_prefill_and_extend_match(pairs):
    """No cache, then a dense-cache prefill of 8 tokens and a 4-token
    extend: logits and the cache rows written."""
    (jt, _), (tt, _) = pairs
    toks = _tokens(2, 12, seed=0)
    want, _ = jlm.apply_lm(jt.params, J_TLM, None, jnp.asarray(toks))
    got, _ = tlm.apply_lm(tt.params, TLM_SMOKE, torch.from_numpy(toks))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)

    jc = jlm.init_cache(J_TLM, 2, S_MAX)
    tc = tlm.init_cache(TLM_SMOKE, 2, S_MAX, "cpu")
    for lo, hi in ((0, 8), (8, 12)):
        want, jc = jlm.apply_lm(jt.params, J_TLM, None, jnp.asarray(toks[:, lo:hi]), cache=jc)
        got, tc = tlm.apply_lm(tt.params, TLM_SMOKE, torch.from_numpy(toks[:, lo:hi]), cache=tc)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)
        assert int(tc["length"]) == int(jc["length"]) == hi
    np.testing.assert_allclose(tc["attn"]["k"][:, :, :12].numpy(),
                               np.asarray(jc["attn"]["k"])[:, :, :12], atol=ATOL)


@pytest.mark.parametrize("seed", [1, 2])
@pytest.mark.parametrize("width,quantized,tree", [
    (1, False, False), (4, False, False), (4, True, False), (4, False, True), (4, True, True),
], ids=["decode", "window", "int8", "tree", "int8_tree"])
def test_paged_forward_matches(pairs, width, quantized, tree, seed):
    (jt, _), (tt, _) = pairs
    cache = _window_cache(TLM_SMOKE, quantized, tree, seed, w=width)
    toks = _tokens(4, width, seed=3)
    want, jc = jlm.apply_lm(jt.params, J_TLM, None, jnp.asarray(toks),
                            cache=_map(cache, jnp.asarray), paged_impl="gather")
    tcache = _map(cache, lambda a: torch.from_numpy(np.array(a)))
    got, tc = tlm.apply_lm(tt.params, TLM_SMOKE, torch.from_numpy(toks), cache=tcache)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)
    np.testing.assert_array_equal(tc["lengths"].numpy(), np.asarray(jc["lengths"]))
    # the window's rows landed in the same pool slots (int8: the same codes
    # but at a rounding flip, where the two differ by one step)
    k_got, k_want = tcache["attn"]["k"].numpy(), np.asarray(jc["attn"]["k"])
    if quantized:
        assert np.abs(k_got.astype(np.int32) - k_want.astype(np.int32)).max() <= 1
        assert np.mean(k_got != k_want) < 1e-3
    else:
        np.testing.assert_allclose(k_got, k_want, atol=ATOL)


def _prompts(n, seed):
    rng = np.random.RandomState(seed)
    return [rng.randint(0, 512, size=rng.randint(3, 12)).astype(np.int32) for _ in range(n)]


def _staggered(eng, prompts, sps):
    rids = []
    for p, sp in zip(prompts, sps):
        rids.append(eng.add_request(p, sp))
        eng.step()
    while eng.has_unfinished():
        eng.step()
    return [np.asarray(eng.output_tokens(r)).tolist() for r in rids]


@pytest.mark.parametrize("cfg", [
    dict(),
    dict(spec_mode="tree", tree_budget=6, spec_branches=2),
    dict(kv_quant="int8"),
    dict(adaptive=True, par_mode="wdos"),
], ids=["chain", "tree", "int8", "wdos"])
def test_engine_tokens_match_jax_engine(pairs, cfg):
    (jt, jd), (tt, td) = pairs
    prompts = _prompts(3, seed=5)
    jsp = [JaxSamplingParams(max_tokens=MAX_TOKENS)] * len(prompts)
    tsp = [SamplingParams(max_tokens=MAX_TOKENS)] * len(prompts)
    jeng = JaxEngine(jt, jd, JaxEngineConfig(max_batch=3, **cfg))
    teng = Engine(tt, td, EngineConfig(max_batch=3, **cfg), device="cpu")
    assert _staggered(teng, prompts, tsp) == _staggered(jeng, prompts, jsp)
    for st in teng.pool_stats():
        assert st.used_pages == 0
    summary = teng.summary()
    if cfg.get("par_mode") == "wdos":
        assert summary["fused"]["slots"] == jeng.summary()["fused"]["slots"]
    if cfg.get("spec_mode") == "tree":
        assert summary["tree"]["nodes"] > 0

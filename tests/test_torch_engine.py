"""The port's Engine against the JAX Engine on the quantized smoke pair
(W4A8 target, BVQ draft), weights carried across: greedy tokens must match
token for token at batch 1 and with 4 requests at max_batch=4.  Also page
return on abort, the refusal of what the port does not carry yet and the
pool-sizing checks.
int8 KV and tree speculation are held in tests/test_torch_tree_int8.py,
sampled requests and stop strings in tests/test_torch_sampled_engine.py."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")  # the reference side of every test here

from repro.core import bvq as jbvq
from repro.launch.serve import build_pair as jax_build_pair
from repro.serving import Engine as JaxEngine
from repro.serving import EngineConfig as JaxEngineConfig
from repro.serving import SamplingParams as JaxSamplingParams
from repro_torch.configs.paper_pair import DLM_SMOKE, TLM_SMOKE
from repro_torch.serving import quantized_lm as tqlm
from repro_torch.serving.engine import Engine, EngineConfig, SamplingParams, ServingModel

S_MAX = 128
MAX_TOKENS = 20


def to_numpy_tree(tree):
    """JAX pytree -> nested dicts of numpy arrays (BVQWeight as its fields)."""
    if isinstance(tree, jbvq.BVQWeight):
        return {"codebooks": np.asarray(tree.codebooks), "scales": np.asarray(tree.scales),
                "indices": np.asarray(tree.indices), "shape": tuple(tree.shape),
                "vec_dim": tree.vec_dim}
    if isinstance(tree, dict):
        return {k: to_numpy_tree(v) for k, v in tree.items()}
    return np.asarray(tree)


@pytest.fixture(scope="module")
def pairs():
    """(JAX pair, port pair on the CPU) built once: the JAX build_pair takes
    tens of seconds here."""
    jt, jd = jax_build_pair(seed=0, s_max=S_MAX, quantize=True)
    tt = ServingModel(TLM_SMOKE, tqlm.params_from_numpy(to_numpy_tree(jt.params), TLM_SMOKE,
                                                       "w4a8", "cpu"),
                      mode="w4a8", s_max=S_MAX, device="cpu")
    td = ServingModel(DLM_SMOKE, tqlm.params_from_numpy(to_numpy_tree(jd.params), DLM_SMOKE,
                                                       "bvq", "cpu"),
                      mode="bvq", s_max=S_MAX, device="cpu")
    return (jt, jd), (tt, td)


def _prompts(n, seed):
    rng = np.random.RandomState(seed)
    return [rng.randint(0, 512, size=rng.randint(3, 12)).astype(np.int32) for _ in range(n)]


def _both(pairs, prompts, max_batch):
    (jt, jd), (tt, td) = pairs
    want, _ = JaxEngine(jt, jd, JaxEngineConfig(max_batch=max_batch)).run(
        prompts, JaxSamplingParams(max_tokens=MAX_TOKENS))
    got, summary = Engine(tt, td, EngineConfig(max_batch=max_batch), device="cpu").run(
        prompts, SamplingParams(max_tokens=MAX_TOKENS))
    return [np.asarray(w).tolist() for w in want], [g.tolist() for g in got], summary


def test_greedy_tokens_match_jax_engine_batch1(pairs):
    want, got, summary = _both(pairs, _prompts(1, seed=0), max_batch=1)
    assert got == want
    assert len(got[0]) == MAX_TOKENS and summary["requests"] == 1


def test_greedy_tokens_match_jax_engine_four_requests(pairs):
    want, got, summary = _both(pairs, _prompts(4, seed=1), max_batch=4)
    assert got == want
    assert summary["requests"] == 4 and summary["rounds"] > 0


def test_abort_returns_pages(pairs):
    _, (tt, td) = pairs
    eng = Engine(tt, td, EngineConfig(max_batch=2), device="cpu")
    rids = [eng.add_request(p, SamplingParams(max_tokens=MAX_TOKENS)) for p in _prompts(3, 2)]
    eng.step()  # admits two, the third waits in the queue
    assert eng.num_active() == 2 and eng.queue_depth() == 1
    t_stats, d_stats = eng.pool_stats()
    assert t_stats.used_pages > 0 and d_stats.used_pages > 0
    assert eng.abort(rids[0]) and eng.abort(rids[2])
    assert not eng.abort(rids[0])  # already finished
    eng.run()
    for st in eng.pool_stats():
        assert st.used_pages == 0 and st.reserved_pages == 0
        assert st.available_pages == st.num_pages
    assert eng.request(rids[0]).finish_reason == "abort"
    assert len(eng.output_tokens(rids[1])) == MAX_TOKENS


@pytest.mark.parametrize("cfg", [dict(profile_every_n=2)], ids=["profile_every_n"])
def test_unported_settings_raise(pairs, cfg):
    """The EngineConfig features the port does not carry yet are refused at
    construction (the prefix cache is served: tests/test_torch_prefix_cache.py)."""
    _, (tt, td) = pairs
    assert EngineConfig(**cfg).unported() == [f"{k}={v!r}" for k, v in cfg.items()]
    with pytest.raises(NotImplementedError):
        Engine(tt, td, EngineConfig(**cfg), device="cpu")


def test_num_pages_and_pool_bytes_exclusive():
    """A pool is sized by a page count or by a byte budget, never both; a
    budget must be positive (the reference's checks)."""
    with pytest.raises(ValueError):
        EngineConfig(num_pages=64, pool_bytes=1 << 20)
    with pytest.raises(ValueError):
        EngineConfig(pool_bytes=0)

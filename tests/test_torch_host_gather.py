"""The port's legacy host-gather loop (``serving/host_gather.py``, reached
through ``serve_batch(kv_path="host")``) against the JAX package's frozen
loop on the same weights, the port's ``Engine.summary()`` schema against
the reference's, and the port's ``repro_torch.serving`` public surface.

Greedy tokens must equal the JAX host loop's token for token, with fewer
batch slots than requests, on the quantized smoke pair (W4A8 target, BVQ
draft) and on the dense pair (also the target drafting for itself under
``adaptive=True``, so windows are accepted and the APSD controllers reach
their long windows); the summaries must be equal in every field but the
copy seconds, which are the host's clock.  A bfloat16 pair (host
pools of a dtype numpy lacks) is held to the port's paged path.
Tolerance: none."""
import dataclasses
import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")  # the reference side of every test here

import jax  # noqa: E402
from test_torch_models import one_thread, to_numpy_tree  # noqa: E402,F401

import repro.serving as jserving  # noqa: E402
from repro.launch.serve import build_pair as jax_build_pair  # noqa: E402
from repro.serving import engine as jengine  # noqa: E402
from repro.serving.batcher import BatchConfig as JaxBatchConfig  # noqa: E402
import repro_torch.serving as tserving  # noqa: E402
from repro_torch.configs.paper_pair import DLM_SMOKE, TLM_SMOKE  # noqa: E402
from repro_torch.core import prng  # noqa: E402
from repro_torch.serving import api as tapi  # noqa: E402
from repro_torch.serving import engine as tengine  # noqa: E402
from repro_torch.serving import quantized_lm as tqlm  # noqa: E402
from repro_torch.serving.batcher import BatchConfig  # noqa: E402
from repro_torch.serving.engine import Engine, EngineConfig, SamplingParams, ServingModel  # noqa: E402

pytestmark = [pytest.mark.usefixtures("one_thread"),
              pytest.mark.filterwarnings("ignore::DeprecationWarning")]
S_MAX = 128
TIMING = {"kv_copy_s", "table_upload_s"}


def _carry(jm, cfg, mode):
    return ServingModel(cfg, tqlm.params_from_numpy(to_numpy_tree(jm.params), cfg, mode, "cpu"),
                        mode=mode, s_max=S_MAX, device="cpu")


@pytest.fixture(scope="module")
def quantized():
    """(JAX quantized smoke pair, the port's, weights carried across)."""
    jt, jd = jax_build_pair(seed=0, s_max=S_MAX, quantize=True)
    return (jt, jd), (_carry(jt, TLM_SMOKE, "w4a8"), _carry(jd, DLM_SMOKE, "bvq"))


@pytest.fixture(scope="module")
def dense():
    """(JAX dense smoke pair, the port's, weights carried across)."""
    jt, jd = jax_build_pair(seed=0, s_max=S_MAX, quantize=False)
    return (jt, jd), (_carry(jt, TLM_SMOKE, "bf16"), _carry(jd, DLM_SMOKE, "bf16"))


def _prompts(n, seed):
    rng = np.random.RandomState(seed)
    return [rng.randint(0, 512, size=rng.randint(3, 12)).astype(np.int32) for _ in range(n)]


def _plain(summary):
    """A summary as plain values: each package's PoolStats as a dict."""
    return {k: dataclasses.asdict(v) if dataclasses.is_dataclass(v) else v
            for k, v in summary.items()}


def _both_host(jpair, tpair, prompts, **cfg):
    """The JAX host loop and the port's on the same prompts: (want, got,
    JAX summary, port summary, the port's sinks)."""
    cfg = dict(cfg, kv_path="host")
    want, jsum = jengine.serve_batch(jax.random.PRNGKey(0), *jpair, prompts,
                                     JaxBatchConfig(**cfg))
    sinks = [[] for _ in prompts]
    got, tsum = tengine.serve_batch(prng.PRNGKey(0), *tpair, prompts, BatchConfig(**cfg),
                                    sinks=[s.append for s in sinks])
    return ([np.asarray(w).tolist() for w in want], [g.tolist() for g in got],
            _plain(jsum), _plain(tsum), sinks)


def _assert_host_run(want, got, jsum, tsum, sinks, n):
    assert got == want
    assert sinks == got
    assert tsum["kv_path"] == jsum["kv_path"] == "host"
    assert tsum["kv_copy_s"] > 0.0 and tsum["requests"] == n
    assert set(tsum) == set(jsum)
    assert {k: v for k, v in tsum.items() if k not in TIMING} == \
        {k: v for k, v in jsum.items() if k not in TIMING}


@pytest.mark.parametrize("pair,self_draft,cfg", [
    ("quantized", False, dict(max_batch=2, page_size=8, max_tokens=12)),
    ("dense", True, dict(max_batch=2, page_size=8, max_tokens=10, adaptive=True)),
    ("dense", False, dict(max_batch=2, max_tokens=9, draft_len=2)),
], ids=["quantized", "dense_self_draft_adaptive", "dense"])
def test_host_loop_matches_jax(request, pair, self_draft, cfg):
    """Five requests through two slots: tokens, sinks and summary equal
    to the JAX host loop's, tokens and rounds equal to the port's paged
    path.  The self-draft accepts every window (the APSD controllers then
    run their long windows)."""
    (jt, jd), (tt, td) = request.getfixturevalue(pair)
    jpair, tpair = ((jt, jt), (tt, tt)) if self_draft else ((jt, jd), (tt, td))
    prompts = _prompts(5, seed=1)
    want, got, jsum, tsum, sinks = _both_host(jpair, tpair, prompts, **cfg)
    _assert_host_run(want, got, jsum, tsum, sinks, len(prompts))
    if self_draft:
        assert tsum["acceptance_rate"] == 1.0
    paged, psum = tengine.serve_batch(prng.PRNGKey(0), *tpair, prompts, BatchConfig(**cfg))
    assert [p.tolist() for p in paged] == got
    assert (psum["rounds"], psum["emitted"]) == (tsum["rounds"], tsum["emitted"])


def test_host_loop_bfloat16_pools(dense):
    """A bfloat16 pair: the host pools hold torch bfloat16 pages, and the
    loop's tokens equal the port's paged path on the same weights."""
    _, (tt, td) = dense

    def bf16(m):
        cfg = dataclasses.replace(m.cfg, dtype="bfloat16")
        params = jax.tree_util.tree_map(
            lambda a: a.to(torch.bfloat16) if a.is_floating_point() else a, m.params)
        return ServingModel(cfg, params, mode="bf16", s_max=S_MAX, device="cpu")

    pair = bf16(tt), bf16(td)
    prompts = _prompts(3, seed=3)
    cfg = dict(max_batch=2, max_tokens=8)
    got, summary = tengine.serve_batch(prng.PRNGKey(0), *pair, prompts,
                                       BatchConfig(kv_path="host", **cfg))
    want, _ = tengine.serve_batch(prng.PRNGKey(0), *pair, prompts, BatchConfig(**cfg))
    assert [g.tolist() for g in got] == [w.tolist() for w in want]
    assert summary["target_pool"].kv_bytes_by_kind == {"bfloat16": 0}
    assert summary["kv_copy_s"] > 0.0


def test_host_loop_empty_batch_and_checks(dense):
    (jt, jd), (tt, td) = dense
    got, summary = tengine.serve_batch(prng.PRNGKey(0), tt, td, [], BatchConfig(kv_path="host"))
    _, jsum = jengine.serve_batch(jax.random.PRNGKey(0), jt, jd, [],
                                  JaxBatchConfig(kv_path="host"))
    assert got == [] and summary == jsum and summary["kv_path"] == "host"
    long_prompt = [np.arange(S_MAX, dtype=np.int32)]
    with pytest.raises(ValueError, match="s_max"):
        tengine.serve_batch(prng.PRNGKey(0), tt, td, long_prompt, BatchConfig(kv_path="host"))
    with pytest.raises(NotImplementedError):
        tengine.serve_batch(prng.PRNGKey(0), tt, td, _prompts(1, 0),
                            BatchConfig(kv_path="host", temperature=0.5))


def test_serve_batch_host_shim_warns_once(dense):
    _, (tt, td) = dense
    prompts = _prompts(2, seed=4)
    tapi._DEPRECATION_EMITTED.discard("serve_batch_host")
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        outs = [tengine.serve_batch_host(prng.PRNGKey(0), tt, td, prompts,
                                         BatchConfig(max_batch=2, max_tokens=5))[0]
                for _ in range(2)]
    shim = [w for w in caught if "serve_batch_host" in str(w.message)]
    assert len(shim) == 1 and issubclass(shim[0].category, DeprecationWarning)
    assert [o.tolist() for o in outs[0]] == [o.tolist() for o in outs[1]]
    via, _ = tengine.serve_batch(prng.PRNGKey(0), tt, td, prompts,
                                 BatchConfig(max_batch=2, max_tokens=5, kv_path="host"))
    assert [o.tolist() for o in via] == [o.tolist() for o in outs[0]]


# ---------------------------------------------------------------------------
# Engine.summary() schema and the public surface
# ---------------------------------------------------------------------------


def test_engine_summary_matches_reference(dense):
    """Every key both packages' summaries share holds the same value (the
    seconds aside); the port's extra keys are its own."""
    (jt, jd), (tt, td) = dense
    prompts = _prompts(3, seed=5)
    _, jsum = jserving.Engine(jt, jd, jserving.EngineConfig(max_batch=2)).run(
        prompts, jserving.SamplingParams(max_tokens=6))
    _, tsum = Engine(tt, td, EngineConfig(max_batch=2), device="cpu").run(
        prompts, SamplingParams(max_tokens=6))
    jsum, tsum = _plain(jsum), _plain(tsum)
    assert set(jsum) <= set(tsum)
    assert set(tsum) - set(jsum) == {"spec_mode", "tree", "host_copies"}
    shared = set(jsum) - TIMING
    assert {k: tsum[k] for k in shared} == {k: jsum[k] for k in shared}
    assert tsum["kv_copy_s"] == jsum["kv_copy_s"] == 0.0
    assert all(isinstance(v, float) for v in tsum["kv_bytes_per_token"].values())
    for cfg, jcfg in ((BatchConfig(), JaxBatchConfig()),
                      (BatchConfig(kv_path="host"), JaxBatchConfig(kv_path="host")),
                      (EngineConfig(par_mode="wdos"), jserving.EngineConfig(par_mode="wdos"))):
        assert tengine._empty_summary(cfg) == jengine._empty_summary(jcfg)


def test_serving_public_surface_matches_reference():
    assert tserving.__all__ == jserving.__all__
    for name in tserving.__all__:
        assert getattr(tserving, name) is not None, name
    assert tserving.serve_batch_host is tengine.serve_batch_host
    assert tengine._greedy_accept_host is tengine.speculative_accept_greedy_host

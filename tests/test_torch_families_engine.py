"""The port's Engine against the JAX Engine, token for token, serving the
repo's bf16 decoder configurations (``ServingModel(mode="bf16")`` over
``lm.apply_lm``): ``moonshot-smoke`` (MoE, top-2 of 8 experts, dense
combine) chain greedy and chain with sampled requests, and
``nemotron-smoke`` (squared-ReLU MLP, GQA 4/2) chain greedy.  The target
is the smoke config with weights made by the JAX package and carried
across; the draft is the same config cut to its first layer (the
target's own first-layer weights), so some proposals are accepted.  The
W4A8 / BVQ pair on ``qwen3-smoke`` is held to the JAX Engine in
tests/test_torch_families_quant.py, which builds that pair once.

Rule: tokens equal, every row whole.  XLA and torch may round a router
logit apart in the last bit, so a router near-tie could part a row from
the reference (tests/test_torch_families.py excludes such rows by token
and layer); the batched engine gives no per-row record to hold such an
exclusion to, and at the seeds used here no row parts, so none is
excused.  The smallest router margin of the port's run is printed."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")  # the reference side of every test here

import jax
from test_torch_models import one_thread, to_numpy_tree  # noqa: F401

from repro import configs as jconfigs
from repro.models import lm as jlm
from repro.serving import Engine as JaxEngine
from repro.serving import EngineConfig as JaxEngineConfig
from repro.serving import SamplingParams as JaxSamplingParams
from repro.serving.engine import ServingModel as JaxServingModel
from repro_torch import configs as tconfigs
from repro_torch.models import layers as tL
from repro_torch.serving import quantized_lm as tqlm
from repro_torch.serving.engine import Engine, EngineConfig, SamplingParams, ServingModel

pytestmark = pytest.mark.usefixtures("one_thread")
S_MAX = 96
MAX_TOKENS = 10


def build_bf16_pairs(arch, seed, s_max, jax_model_cls, port_model_cls):
    """(JAX pair, port pair): the smoke config's target and its 1-layer
    cut as the draft, the JAX package's weights carried to the port."""
    jcfg, tcfg = jconfigs.get_smoke(arch), tconfigs.get_smoke(arch)
    jdcfg = dataclasses.replace(jcfg, n_layers=1, name=jcfg.name + "-draft")
    tdcfg = dataclasses.replace(tcfg, n_layers=1, name=tcfg.name + "-draft")
    params, _ = jlm.init_lm(jax.random.PRNGKey(seed), jcfg, tp=1)
    dparams = dict(params, layers=jax.tree.map(lambda a: a[:1], params["layers"]))
    jax_pair = (jax_model_cls(cfg=jcfg, params=params, mode="bf16", s_max=s_max),
                jax_model_cls(cfg=jdcfg, params=dparams, mode="bf16", s_max=s_max))
    port_pair = tuple(
        port_model_cls(cfg, tqlm.params_from_numpy(to_numpy_tree(p), cfg, "bf16", "cpu"),
                       mode="bf16", s_max=s_max, device="cpu")
        for cfg, p in ((tcfg, params), (tdcfg, dparams)))
    return jax_pair, port_pair


@pytest.fixture(scope="module")
def pairs():
    cache = {}

    def get(arch):
        if arch not in cache:
            cache[arch] = build_bf16_pairs(arch, 5, S_MAX, JaxServingModel, ServingModel)
        return cache[arch]

    return get


def _prompts(n, vocab, seed):
    rng = np.random.RandomState(seed)
    return [rng.randint(0, vocab, size=rng.randint(3, 12)).astype(np.int32) for _ in range(n)]


class _RouterMargins:
    """The smallest k-th vs (k+1)-th router logit margin each port forward
    inside the context saw (patched ``layers.moe_apply``)."""

    def __init__(self, monkeypatch):
        self.min = np.inf
        orig = tL.moe_apply

        def record(p, x, cfg):
            logits = torch.sort(x.reshape(-1, x.shape[-1]).float() @ p["router"], dim=-1,
                                descending=True).values
            margin = logits[:, cfg.top_k - 1] - logits[:, cfg.top_k]
            self.min = min(self.min, float(margin.min()))
            return orig(p, x, cfg)

        monkeypatch.setattr(tL, "moe_apply", record)


@pytest.mark.parametrize("arch,sampled", [("moonshot-v1-16b-a3b", False),
                                          ("moonshot-v1-16b-a3b", True),
                                          ("nemotron-4-15b", False)],
                         ids=["moonshot-chain", "moonshot-sampled", "nemotron-chain"])
def test_engine_tokens_match_jax_engine(pairs, monkeypatch, arch, sampled):
    (jt, jd), (tt, td) = pairs(arch)
    margins = _RouterMargins(monkeypatch)
    prompts = _prompts(3, tt.cfg.vocab, seed=6)
    sp = [dict(max_tokens=MAX_TOKENS, temperature=0.8, top_k=50, top_p=0.95, seed=i)
          if sampled and i != 1 else dict(max_tokens=MAX_TOKENS) for i in range(len(prompts))]
    want, _ = JaxEngine(jt, jd, JaxEngineConfig(max_batch=3)).run(
        prompts, [JaxSamplingParams(**s) for s in sp])
    got, summary = Engine(tt, td, EngineConfig(max_batch=3), device="cpu").run(
        prompts, [SamplingParams(**s) for s in sp])
    print(f"{arch}: smallest router margin {margins.min}, acceptance "
          f"{summary['acceptance_rate']}")
    assert [g.tolist() for g in got] == [np.asarray(w).tolist() for w in want]
    assert summary["acceptance_rate"] > 0

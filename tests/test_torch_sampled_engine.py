"""Sampled requests, stop strings, the single-request generators and wide
verify windows in the port, against the JAX package on the quantized smoke
pair (W4A8 target, BVQ draft) carried across with params_from_numpy.

- engine: chain fp, chain int8 and tree over mixed KV, each with 2 greedy
  and 2 sampled requests (distinct seeds, top_k and top_p), token for
  token equal to the JAX Engine; a sampled request's tokens do not depend
  on its batch;
- stop strings: one stop; two stops, one spanning two tokens, the earlier
  match winning; a stop spanning three tokens; a stop on the budget's last
  token: outputs, finish reasons, sink and take_delta streams equal to
  what the JAX Engine outputs, and every page returned;
- ``sd_generate`` and ``apsd_generate``, greedy and sampled: tokens and
  stats equal to the reference's;
- windows wider than 32 tokens (draft_len=40; tree_budget=40): greedy
  tokens equal to the JAX Engine's.

Tolerance: none, streams must be equal token for token.  The port's keys
and uniforms are the reference's bit for bit (tests/test_torch_prng.py);
its logits may differ per row by up to ~1e-2 where a norm's last bit moves
a dynamic int8 activation across a .5 boundary (ROADMAP.md, Queue 3), and
its categorical draws may differ at an ulp-level tie of the perturbed
scores, but no decision of these seeds lies that close to its boundary, so
no divergence is excused."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")  # the reference side of every test here

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from test_torch_models import one_thread, to_numpy_tree  # noqa: E402,F401

from repro.core import apsd as japsd  # noqa: E402
from repro.core import speculative as jspec  # noqa: E402
from repro.launch.serve import build_pair as jax_build_pair  # noqa: E402
from repro.serving import Engine as JaxEngine  # noqa: E402
from repro.serving import EngineConfig as JaxEngineConfig  # noqa: E402
from repro.serving import SamplingParams as JaxSamplingParams  # noqa: E402
from repro.serving import engine as jengine  # noqa: E402
from repro_torch.configs.paper_pair import DLM_SMOKE, TLM_SMOKE  # noqa: E402
from repro_torch.core import apsd as tapsd  # noqa: E402
from repro_torch.core import prng  # noqa: E402
from repro_torch.core import speculative as tspec  # noqa: E402
from repro_torch.serving import engine as tengine  # noqa: E402
from repro_torch.serving import quantized_lm as tqlm  # noqa: E402
from repro_torch.serving.engine import Engine, EngineConfig, SamplingParams, ServingModel  # noqa: E402

pytestmark = pytest.mark.usefixtures("one_thread")
S_MAX = 128
MAX_TOKENS = 24


@pytest.fixture(scope="module")
def pairs():
    """(JAX pair, port pair on the CPU) built once."""
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


def _mixed_params(cls, kinds, max_tokens=MAX_TOKENS):
    """Requests 0 and 2 greedy, 1 and 3 sampled with their own seed, top_k
    and top_p; ``kinds`` pins each request's KV storage."""
    return [
        cls(max_tokens=max_tokens, kv_quant=kinds[0]),
        cls(max_tokens=max_tokens, temperature=0.8, top_k=50, top_p=0.95, seed=11,
            kv_quant=kinds[1]),
        cls(max_tokens=max_tokens, kv_quant=kinds[2]),
        cls(max_tokens=max_tokens, temperature=1.2, top_k=0, top_p=0.9, seed=29,
            kv_quant=kinds[3]),
    ]


def _run_both(pairs, cfg, prompts, jax_sps, port_sps):
    (jt, jd), (tt, td) = pairs
    want, _ = JaxEngine(jt, jd, JaxEngineConfig(**cfg)).run(prompts, jax_sps)
    got, summary = Engine(tt, td, EngineConfig(**cfg), device="cpu").run(prompts, port_sps)
    return [np.asarray(w).tolist() for w in want], [g.tolist() for g in got], summary


ENGINES = {
    "chain-fp": (dict(max_batch=4), [None] * 4),
    "chain-int8": (dict(max_batch=4, kv_quant="int8"), [None] * 4),
    "tree-mixed": (dict(max_batch=4, kv_quant="mixed", spec_mode="tree"),
                   ["none", "int8", "int8", "none"]),
}


@pytest.mark.parametrize("engine", list(ENGINES))
def test_sampled_tokens_match_jax_engine(pairs, engine):
    cfg, kinds = ENGINES[engine]
    prompts = _prompts(4, seed=5)
    want, got, summary = _run_both(pairs, cfg, prompts, _mixed_params(JaxSamplingParams, kinds),
                                   _mixed_params(SamplingParams, kinds))
    assert got == want
    assert summary["requests"] == 4 and all(len(g) == MAX_TOKENS for g in got)
    _, (tt, td) = pairs
    # sampling did sample: a sampled row differs from its greedy decode
    greedy, _ = Engine(tt, td, EngineConfig(**cfg), device="cpu").run(
        prompts, [SamplingParams(max_tokens=MAX_TOKENS, kv_quant=k) for k in kinds])
    assert got[1] != greedy[1].tolist() or got[3] != greedy[3].tolist()
    assert got[0] == greedy[0].tolist() and got[2] == greedy[2].tolist()
    # a sampled request's tokens do not depend on its batch: alone, the same
    alone, _ = Engine(tt, td, EngineConfig(**dict(cfg, max_batch=1)), device="cpu").run(
        [prompts[3]], _mixed_params(SamplingParams, kinds)[3])
    assert alone[0].tolist() == got[3]


def _stop_runs(engine, cls, prompts, base):
    """Four requests with stop strings made from the greedy outputs
    ``base`` (default_detokenize renders token t as "t "): one stop; two
    stops, the earlier match wins; a stop on the budget's last token; and
    a stop spanning three tokens.  Returns, per request, (output, finish
    reason, tokens seen by the sink, tokens of the per-step deltas)."""
    stops = [
        (f"{base[0][5]} ",),
        (f"{base[1][9]} {base[1][10]}", f"{base[1][3]} "),
        (f"{base[2][-1]} ",),
        (f"{base[3][2]} {base[3][3]} {base[3][4]}",),
    ]
    sinks = [[] for _ in prompts]
    rids = [engine.add_request(p, cls(max_tokens=len(base[i]), stop=stops[i]),
                               sink=sinks[i].append) for i, p in enumerate(prompts)]
    deltas = {r: [] for r in rids}
    while engine.has_unfinished():
        for out in engine.step():
            deltas[out.request_id] += out.new_token_ids
    return [(np.asarray(engine.output_tokens(r)).tolist(), engine.request(r).finish_reason,
             sinks[i], deltas[r]) for i, r in enumerate(rids)]


def test_stop_strings_match_jax_engine(pairs):
    (jt, jd), (tt, td) = pairs
    prompts = _prompts(4, seed=5)
    base, _ = JaxEngine(jt, jd, JaxEngineConfig(max_batch=4)).run(
        prompts, JaxSamplingParams(max_tokens=16))
    base = [np.asarray(b).tolist() for b in base]
    want = _stop_runs(JaxEngine(jt, jd, JaxEngineConfig(max_batch=4)), JaxSamplingParams,
                      prompts, base)
    eng = Engine(tt, td, EngineConfig(max_batch=4), device="cpu")
    got = _stop_runs(eng, SamplingParams, prompts, base)
    assert got == want
    for out, reason, sink, delta in got:
        assert reason == "stop" and sink == out and delta == out
    assert len(got[2][0]) == 15  # the budget's last token matched: cut before it
    for st in eng.pool_stats():
        assert st.used_pages == 0 and st.reserved_pages == 0


@pytest.mark.parametrize("temperature", [0.0, 0.8], ids=["greedy", "sampled"])
def test_sd_and_apsd_generate_match_reference(pairs, temperature):
    (jt, jd), (tt, td) = pairs
    ji_t, ji_d = jengine.make_interface(jt), jengine.make_interface(jd)
    ti_t, ti_d = tengine.make_interface(tt), tengine.make_interface(td)
    prompt = _prompts(1, seed=5)[0][None]
    want, want_stats = jspec.sd_generate(
        jax.random.PRNGKey(3), ji_t, jt.params, ji_d, jd.params, jnp.asarray(prompt),
        jspec.SDConfig(draft_len=3, temperature=temperature, max_tokens=20))
    got, stats = tspec.sd_generate(
        prng.PRNGKey(3), ti_t, tt.params, ti_d, td.params, torch.as_tensor(prompt),
        tspec.SDConfig(draft_len=3, temperature=temperature, max_tokens=20))
    assert got.tolist() == np.asarray(want).tolist()
    assert tuple(stats) == tuple(int(x) for x in want_stats)
    want, want_stats = japsd.apsd_generate(
        jax.random.PRNGKey(3), ji_t, jt.params, ji_d, jd.params, jnp.asarray(prompt),
        japsd.APSDConfig(temperature=temperature, max_tokens=20))
    got, stats = tapsd.apsd_generate(
        prng.PRNGKey(3), ti_t, tt.params, ti_d, td.params, torch.as_tensor(prompt),
        tapsd.APSDConfig(temperature=temperature, max_tokens=20))
    assert got.tolist() == np.asarray(want).tolist()
    assert tuple(stats) == tuple(want_stats)


def test_dense_interface_rewind(pairs):
    _, (tt, _) = pairs
    iface = tengine.make_interface(tt)
    _, cache = iface.prefill(tt.params, torch.as_tensor(_prompts(1, seed=5)[0][None]))
    n = cache["length"]
    assert iface.rewind(cache, 2)["length"] == n - 2 and cache["length"] == n
    with pytest.raises(ValueError):
        iface.rewind(cache, n + 1)
    with pytest.raises(ValueError):
        iface.rewind(cache, -1)


@pytest.mark.parametrize("cfg", [dict(draft_len=40), dict(spec_mode="tree", tree_budget=40)],
                         ids=["draft_len=40", "tree_budget=40"])
def test_wide_windows_match_jax_engine(pairs, cfg):
    """Verify windows of 41 tokens, past the 32 of one mask word (8
    tokens a request: each round drafts 40 positions, so a few rounds
    cover it)."""
    cfg = dict(cfg, max_batch=4)
    sp = dict(max_tokens=8)
    want, got, _ = _run_both(pairs, cfg, _prompts(4, seed=5), JaxSamplingParams(**sp),
                             SamplingParams(**sp))
    assert got == want


@pytest.mark.parametrize("case", ["greedy-chain", "sampled-chain", "sampled-tree"])
def test_host_copies_per_round(pairs, case):
    """Device-to-host copies per round (``host_copies`` in the summary): an
    all-greedy chain round brings its draft tokens and its verify logits;
    a chain round in which any row samples brings each draft step's logits
    (draft_len of them) and the verify logits; a tree round brings each
    level's window logits (draft_len levels) and the verify logits."""
    _, (tt, td) = pairs
    sampled = SamplingParams(max_tokens=8, temperature=0.8, seed=1)
    greedy = SamplingParams(max_tokens=8)
    cfg, sps, per_round = {
        "greedy-chain": (dict(max_batch=2), [greedy, greedy], 2),
        "sampled-chain": (dict(max_batch=2), [sampled, sampled], 4),
        "sampled-tree": (dict(max_batch=2, spec_mode="tree"), [sampled, sampled], 4),
    }[case]
    _, summary = Engine(tt, td, EngineConfig(**cfg), device="cpu").run(_prompts(2, seed=6), sps)
    assert summary["rounds"] > 0
    assert summary["host_copies"] == per_round * summary["rounds"]

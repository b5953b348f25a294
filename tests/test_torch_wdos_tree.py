"""Fused WDOS rounds over mixed KV stores and under tree speculation, and
stop strings under WDOS, in the port against the JAX Engine on the
quantized smoke pair, with the staggered workload and the poisoned masked
rows of tests/test_torch_wdos.py:

- ``par_mode="wdos"`` chain over ``kv_quant="mixed"`` (requests 1 and 3 on
  int8 KV), adaptive, greedy;
- ``par_mode="wdos"``, ``spec_mode="tree"``: adaptive over mixed KV with
  requests 0 and 2 sampled, and greedy over fp KV with the target drafting
  for itself;
- stop strings under WDOS: outputs, finish reasons, sink and delta
  streams and returned pages equal to the JAX Engine's.

Each engine case holds the port to the JAX Engine on tokens, ``rounds``,
``steps``, the integer ``fused`` fields and every request's history, and a
WDOS engine's tokens to the port's own two-phase tokens, in strictly fewer
rounds.  Tolerance: none."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")  # the reference side of every test here

from test_torch_wdos import (  # noqa: E402
    check_wdos_against_off,
    drive_staggered,
    one_thread,  # noqa: F401  (the module's fixtures)
    pairs,  # noqa: F401
    poison_masked,
    run_both,
    sampling,
    staggered_prompts,
)

from repro.serving import Engine as JaxEngine  # noqa: E402
from repro.serving import EngineConfig as JaxEngineConfig  # noqa: E402
from repro.serving import SamplingParams as JaxSamplingParams  # noqa: E402
from repro_torch.serving.engine import Engine, EngineConfig, SamplingParams  # noqa: E402

pytestmark = pytest.mark.usefixtures("one_thread")
KINDS = ["none", "int8", "none", "int8"]
WDOS_TREE = dict(adaptive=True, par_mode="wdos", spec_mode="tree")
CASES = {  # (config, sampled requests, KV kinds, self-draft)
    "wdos-mixed-chain": (dict(adaptive=True, par_mode="wdos", kv_quant="mixed"), (), KINDS,
                         False),
    "wdos-mixed-tree-sampled": (dict(WDOS_TREE, kv_quant="mixed"), (0, 2), KINDS, False),
    "wdos-tree-selfdraft-greedy": (WDOS_TREE, (), None, True),
}


@pytest.mark.parametrize("case", list(CASES))
def test_engine_matches_jax(pairs, case):  # noqa: F811
    cfg, sampled, kinds, self_draft = CASES[case]
    want, got = run_both(pairs, cfg, sampled, kinds, self_draft)
    assert got == want
    assert all(len(h) > 0 for h in got["history"])
    if cfg.get("par_mode") == "wdos":
        check_wdos_against_off(pairs, cfg, got, sampled, kinds, self_draft)
        # a self-drafted tree spends its node budget in a few levels, so
        # every row's cycle is as long and the rows stay in phase (as the
        # reference's do: fused_slots equal above)
        assert self_draft or got["fused"]["fused_slots"] > 0


def _stop_run(eng, cls, prompts, base):
    """The staggered workload with stop strings made from the outputs
    ``base`` (default_detokenize renders token t as "t "): one stop; two
    stops, the earlier match winning; a stop on the budget's last token; a
    stop spanning three tokens.  Per request (output, finish reason, sink
    tokens, delta tokens), and the pages in use after."""
    stops = [
        (f"{base[0][5]} ",),
        (f"{base[1][9]} {base[1][10]}", f"{base[1][3]} "),
        (f"{base[2][-1]} ",),
        (f"{base[3][2]} {base[3][3]} {base[3][4]}",),
    ]
    sinks = [[] for _ in prompts]
    deltas = {}

    def step():
        for out in eng.step():
            deltas.setdefault(out.request_id, []).extend(out.new_token_ids)

    rids = []
    for i, p in enumerate(prompts):
        rids.append(eng.add_request(p, cls(max_tokens=len(base[i]), stop=stops[i]),
                                    sink=sinks[i].append))
        step()
    while eng.has_unfinished():
        step()
    return ([(np.asarray(eng.output_tokens(r)).tolist(), eng.request(r).finish_reason,
              sinks[i], deltas.get(r, [])) for i, r in enumerate(rids)],
            [st.used_pages for st in eng.pool_stats()])


def test_stop_strings_under_wdos_match_jax(pairs):  # noqa: F811
    (jt, jd), (tt, td) = pairs
    cfg = dict(max_batch=4, page_size=8, adaptive=True, par_mode="wdos")
    prompts = staggered_prompts()
    base = drive_staggered(JaxEngine(jt, jd, JaxEngineConfig(**cfg)), prompts,
                           sampling(JaxSamplingParams))["tokens"]
    want = _stop_run(JaxEngine(jt, jd, JaxEngineConfig(**cfg)), JaxSamplingParams, prompts, base)
    got = _stop_run(poison_masked(Engine(tt, td, EngineConfig(**cfg), device="cpu")),
                    SamplingParams, prompts, base)
    assert got == want
    outs, used = got
    for out, reason, sink, delta in outs:
        assert reason == "stop" and sink == out and delta == out
    assert used == [0, 0]

"""The port's observability layer against the JAX package.

- unit cases: the reference's ``Tracer`` / ``validate_chrome_trace`` cases
  (tests/test_observability.py) and ``FlightRecorder`` cases
  (tests/test_flight_recorder.py), each run through both packages'
  modules (parametrised by package);
- engine: the port's Engine against the JAX Engine on the dense smoke
  target (weights carried across) drafting for itself through a head
  perturbed by noise (0.3 of the head's std): acceptance near 0.2, so
  rounds accept and tree rounds compact.  Staggered arrivals (one request per
  ``step()``), each with a ``Tracer`` and ``profile_every_n=1``, in chain,
  tree, mixed KV + tree and WDOS (adaptive) rounds.  Equal: the tokens;
  every counter and gauge series the JAX registry holds and every
  histogram's observation counts (values of the time-measured families —
  ``*seconds*`` — and of the ``slow_round`` anomaly are clock readings,
  so only their series are held); the tracer's event sequence as (track,
  name, cat, ph) with its integer and string args (times and the cost
  stamps' float args left out); the flight records round by round, all
  but ``wall_s`` / ``t`` / ``anomalies``; ``profile_summary()``'s programs
  and call counts.  Tokens also equal a port run with tracing and
  profiling off;
- the cost stamp: positive, and equal to its documented formula; the
  profiler charges every call its own count (the target's and the
  draft's prefills share one name).

Tolerance: none (integers and strings compared exactly; the WDOS model's
makespans, pure float arithmetic in both, to 1e-9 relative)."""
import dataclasses
import importlib
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")  # the reference side of every test here

import jax.numpy as jnp  # noqa: E402
from test_torch_models import one_thread, to_numpy_tree  # noqa: E402,F401

from repro.launch.serve import build_pair as jax_build_pair  # noqa: E402
from repro.serving import Engine as JaxEngine  # noqa: E402
from repro.serving import EngineConfig as JaxEngineConfig  # noqa: E402
from repro.serving import SamplingParams as JaxSamplingParams  # noqa: E402
from repro.serving.tracing import Tracer as JaxTracer  # noqa: E402
from repro_torch.configs.paper_pair import TLM_SMOKE  # noqa: E402
from repro_torch.core import costs  # noqa: E402
from repro_torch.launch import serve as tserve  # noqa: E402
from repro_torch.serving import quantized_lm as tqlm  # noqa: E402
from repro_torch.serving.engine import Engine, EngineConfig, SamplingParams, ServingModel  # noqa: E402
from repro_torch.serving.tracing import Tracer, validate_chrome_trace  # noqa: E402

PKGS = ("repro", "repro_torch")
S_MAX = 128
MAX_TOKENS = 10


def _mod(pkg, name):
    return importlib.import_module(f"{pkg}.serving.{name}")


# ---------------------------------------------------------------------------
# Tracer + Chrome-trace export (the reference's cases, both packages)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("pkg", PKGS)
def test_tracer_chrome_trace_schema(pkg, tmp_path):
    tr = _mod(pkg, "tracing")
    t = tr.Tracer(jsonl_path=str(tmp_path / "events.jsonl"))
    t.instant("engine", "submit", cat="lifecycle", rid=0)
    with t.span("engine", "step#1", cat="step"):
        t.rec("row0", "draft", t.now(), t.now() + 0.001, cat="draft", rid=0)
    t.close()
    trace = t.to_chrome_trace()
    assert tr.validate_chrome_trace(trace) == []
    evs = trace["traceEvents"]
    meta = [e for e in evs if e["ph"] == "M"]
    assert [e["args"]["name"] for e in meta] == ["engine", "row0"]
    assert all(e["dur"] >= 1 for e in evs if e["ph"] == "X")
    assert all(e.get("s") == "t" for e in evs if e["ph"] == "i")
    assert any(e.get("args", {}).get("rid") == 0 for e in evs)
    lines = (tmp_path / "events.jsonl").read_text().splitlines()
    assert len(lines) == len(t.events())
    assert all(json.loads(ln)["name"] for ln in lines)
    t.export(str(tmp_path / "trace.json"))
    assert tr.validate_chrome_trace(json.loads((tmp_path / "trace.json").read_text())) == []


@pytest.mark.parametrize("pkg", PKGS)
def test_null_tracer_is_inert(pkg):
    null = _mod(pkg, "tracing").NULL_TRACER
    assert not null.enabled
    null.instant("x", "y")
    null.rec("x", "y", 0.0, 1.0)
    with null.span("x", "y"):
        pass
    assert null.events() == []
    with pytest.raises(RuntimeError):
        null.export("/dev/null")


@pytest.mark.parametrize("pkg", PKGS)
def test_validate_chrome_trace_flags_problems(pkg):
    v = _mod(pkg, "tracing").validate_chrome_trace
    assert v({}) != []
    assert v({"traceEvents": "nope"}) != []
    bad = {"traceEvents": [{"ph": "X", "name": "a", "pid": 0, "tid": 0, "ts": 1}]}
    assert any("dur" in p for p in v(bad))
    assert v({"traceEvents": [{"ph": "Z", "name": "a", "pid": 0, "tid": 0}]}) != []


def _one_track_trace(track, spans):
    evs = [{"ph": "M", "name": "thread_name", "pid": 1, "tid": 1, "args": {"name": track}}]
    evs += [{"ph": "X", "name": f"s{i}", "pid": 1, "tid": 1, "ts": ts, "dur": dur, "cat": "t"}
            for i, (ts, dur) in enumerate(spans)]
    return {"traceEvents": evs}


@pytest.mark.parametrize("pkg", PKGS)
def test_validator_track_rules(pkg):
    v = _mod(pkg, "tracing").validate_chrome_trace
    bad = {"traceEvents": [{"ph": "X", "name": "a", "pid": 1, "tid": 7, "ts": 0, "dur": 5}]}
    assert any("thread_name" in p for p in v(bad))
    assert v(_one_track_trace("engine", [(0, 5)])) == []
    overlapping = [(0, 10), (5, 10)]
    assert any("overlap" in p for p in v(_one_track_trace("device", overlapping)))
    assert v(_one_track_trace("engine", overlapping)) == []
    assert v(_one_track_trace("device", [(0, 10), (10, 4), (15, 2)])) == []


# ---------------------------------------------------------------------------
# FlightRecorder (the reference's cases, both packages)
# ---------------------------------------------------------------------------


def _round(wall_s=0.01, drafted=4, accepted=3, admitted=0, queued=0, active=2,
           free_target=10, free_draft=10, **kw):
    rec = {
        "round": kw.pop("round_idx", 0), "mode": "two_phase", "rows": active,
        "wall_s": wall_s, "drafted": drafted, "accepted": accepted, "admitted": admitted,
        "queued": queued, "active": active,
        "free_pages": {"target": free_target, "draft": free_draft}, "t": 0.0,
    }
    rec.update(kw)
    return rec


def _warm(fr, n=20, **kw):
    fired = []
    for _ in range(n):
        fired += fr.record(_round(**kw))
    return fired


@pytest.fixture(params=PKGS)
def fmod(request):
    """(FlightRecorder, MetricsRegistry, ANOMALY_KINDS) of one package."""
    fl = _mod(request.param, "flight_recorder")
    return fl.FlightRecorder, _mod(request.param, "observability").MetricsRegistry, fl.ANOMALY_KINDS


def test_flight_disabled_ring_and_episodes(fmod):
    FR, MR, _ = fmod
    fr = FR(0)
    assert not fr.enabled and fr.record(_round()) == []
    assert fr.snapshot()["rounds_recorded"] == 0
    fr = FR(8)
    for i in range(30):
        fr.record(_round(round_idx=i))
    snap = fr.snapshot()
    assert snap["rounds_recorded"] == 30
    assert [r["seq"] for r in snap["ring"]] == list(range(22, 30))
    m = MR()
    fr = FR(64, metrics=m)
    assert _warm(fr, 20) == []
    assert fr.record(_round(wall_s=0.1)) == ["slow_round"]
    assert fr.record(_round(wall_s=0.1)) == []
    assert fr.record(_round()) == []
    assert fr.record(_round(wall_s=0.1)) == ["slow_round"]
    assert m.value("anomalies_total", kind="slow_round") == 2
    fr = FR(64)
    for i in range(10):
        assert fr.record(_round(wall_s=1.0 if i == 3 else 0.01)) == []


def test_flight_acceptance_pool_and_stall(fmod):
    FR, _, _ = fmod
    fr = FR(64)
    _warm(fr, 20)
    fired = []
    for _ in range(8):
        fired += fr.record(_round(accepted=0))
    assert fired == ["acceptance_collapse"]
    for _ in range(8):
        assert fr.record(_round()) == []
    fr = FR(64)
    assert fr.record(_round(free_target=0)) == []
    assert fr.record(_round(queued=2, free_target=0)) == ["pool_exhausted"]
    assert fr.record(_round(queued=2, free_target=0)) == []
    assert fr.record(_round(queued=0)) == []
    assert fr.record(_round(queued=1, free_draft=0)) == ["pool_exhausted"]
    fr = FR(64, stall_rounds=4)
    for _ in range(3):
        assert fr.record(_round(queued=1, admitted=0)) == []
    fr.record(_round(queued=1, admitted=1))
    for _ in range(3):
        assert fr.record(_round(queued=1, admitted=0)) == []
    assert fr.record(_round(queued=1, admitted=0)) == ["admission_stall"]
    assert fr.record(_round(queued=1, admitted=0)) == []


def test_flight_postmortems_and_dumps(fmod, tmp_path):
    FR, MR, kinds = fmod
    m = MR()
    fr = FR(16, metrics=m, dump_dir=str(tmp_path))
    _warm(fr, 20)
    fr.record(_round(wall_s=0.5))
    snap = fr.snapshot()
    pm = snap["postmortems"][0]
    assert pm["kind"] == "slow_round" and pm["record"]["anomalies"] == ["slow_round"]
    assert pm["fired_at_round"] == pm["record"]["seq"] == 20
    assert json.loads(json.dumps(snap))["anomalies"]["slow_round"] == 1
    files = list(tmp_path.glob("flight_slow_round_*.json"))
    assert len(files) == 1 and json.loads(files[0].read_text())["kind"] == "slow_round"
    out = tmp_path / "manual.json"
    snap = FR(8).dump(str(out), reason="operator")
    assert snap["reason"] == "operator" and snap["dumped_to"] == str(out)
    FR(8, metrics=m)
    text = m.render()
    for kind in kinds:
        assert f'serving_anomalies_total{{kind="{kind}"}}' in text


# ---------------------------------------------------------------------------
# The port's Engine against the JAX Engine, instrumented
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def pairs():
    """(JAX pair, the port's on the CPU, weights carried across): the dense
    smoke target, and as the draft the target with its head perturbed by
    Gaussian noise of 0.3 times the head's std (seed 0)."""
    jt, _ = jax_build_pair(seed=0, s_max=S_MAX, quantize=False)
    params = to_numpy_tree(jt.params)
    head = params["embed"]["head"]
    noisy = head + 0.3 * head.std() * np.random.RandomState(0).randn(*head.shape).astype(np.float32)
    dparams = dict(params, embed=dict(params["embed"], head=noisy))
    jd = dataclasses.replace(jt, params=dict(jt.params, embed=dict(jt.params["embed"],
                                                                   head=jnp.asarray(noisy))))
    tt, td = (ServingModel(TLM_SMOKE, tqlm.params_from_numpy(p, TLM_SMOKE, "bf16", "cpu"),
                           mode="bf16", s_max=S_MAX, device="cpu") for p in (params, dparams))
    return (jt, jd), (tt, td)


def _prompts(n=3, seed=5):
    rng = np.random.RandomState(seed)
    return [rng.randint(0, 512, size=rng.randint(3, 12)).astype(np.int32) for _ in range(n)]


def _drive(eng, prompts, sps):
    """Admit one request per ``step()``, then drain; the tokens."""
    rids = []
    for p, sp in zip(prompts, sps):
        rids.append(eng.add_request(p, sp))
        eng.step()
    while eng.has_unfinished():
        eng.step()
    return [np.asarray(eng.output_tokens(r)).tolist() for r in rids]


def _is_time(name):
    return "seconds" in name


def _series(eng):
    """{family: {labels: value}} of the registry; histograms as counts."""
    out = {}
    for name, fam in eng.metrics.snapshot().items():
        out[name] = {k: (v["count"] if isinstance(v, dict) else v)
                     for k, v in fam["series"].items()}
    return out


def _events(tracer):
    """(track, name, cat, ph, {int / str args}) per event, in order."""
    return [(e["track"], e["name"], e["cat"], e["ph"],
             {k: v for k, v in e["args"].items() if isinstance(v, (int, str))})
            for e in tracer.events()]


def _records(eng):
    return [{k: v for k, v in r.items() if k not in ("wall_s", "t", "anomalies")}
            for r in eng.flight_snapshot()["ring"]]


CASES = {
    "chain": dict(),
    "tree": dict(spec_mode="tree", tree_budget=6, spec_branches=2),
    "mixed_tree": dict(spec_mode="tree", tree_budget=6, spec_branches=2, kv_quant="mixed"),
    "wdos": dict(adaptive=True, par_mode="wdos"),
}


@pytest.mark.usefixtures("one_thread")
@pytest.mark.parametrize("case", list(CASES))
def test_instrumented_engine_matches_jax_engine(pairs, case):
    (jt, jd), (tt, td) = pairs
    cfg = dict(max_batch=3, page_size=8, profile_every_n=1, **CASES[case])
    prompts = _prompts()
    kinds = ["int8" if i % 2 else "none" for i in range(3)] if "kv_quant" in cfg else [None] * 3
    jtr, ttr = JaxTracer(), Tracer()
    jeng = JaxEngine(jt, jd, JaxEngineConfig(**cfg), trace=jtr)
    eng = Engine(tt, td, EngineConfig(**cfg), device="cpu", trace=ttr)
    want = _drive(jeng, prompts, [JaxSamplingParams(max_tokens=MAX_TOKENS, kv_quant=k)
                                  for k in kinds])
    got = _drive(eng, prompts, [SamplingParams(max_tokens=MAX_TOKENS, kv_quant=k) for k in kinds])
    assert got == want
    plain = Engine(tt, td, EngineConfig(**dict(cfg, profile_every_n=0)), device="cpu")
    assert _drive(plain, prompts, [SamplingParams(max_tokens=MAX_TOKENS, kv_quant=k)
                                   for k in kinds]) == got

    # metrics: every JAX family and series, values where they are counts
    js, ts = _series(jeng), _series(eng)
    assert set(js) <= set(ts), set(js) - set(ts)
    for name, series in js.items():
        assert set(ts[name]) == set(series), name
        for key, v in series.items():
            if _is_time(name) or (name.endswith("anomalies_total") and "slow_round" in key):
                continue
            assert ts[name][key] == pytest.approx(v, rel=1e-9, abs=0), (name, key)
    assert ts["serving_tokens_emitted_total"][""] == 3 * MAX_TOKENS
    assert ts["serving_ttft_seconds"][""] == 3
    assert ts["serving_tokens_accepted_total"][""] > 0
    if "tree" in case:
        assert ts["serving_tree_compactions_total"][""] > 0

    # tracer: the same events in the same order, and a valid trace
    assert _events(ttr) == _events(jtr)
    assert validate_chrome_trace(ttr.to_chrome_trace()) == []

    # flight recorder: one record per round, the same counts
    assert _records(eng) == _records(jeng)
    assert len(_records(eng)) == eng.summary()["steps"]

    # profiler: the same programs, called as often
    jp, tp = jeng.profile_summary(), eng.profile_summary()
    assert {k: v["calls"] for k, v in tp.items()} == {k: v["calls"] for k, v in jp.items()}
    assert all(v["wall_s"] > 0 and v["flops"] >= 0 and v["bytes"] > 0 for v in tp.values())
    expected = {"chain": {"prefill", "draft", "verify"},
                "tree": {"prefill", "tree_draft", "tree_verify", "compaction"},
                "mixed_tree": {"prefill", "tree_draft", "tree_verify", "compaction"},
                "wdos": {"prefill", "fused_wdos", "draft_slot"}}[case]
    assert expected <= set(tp)
    device = {e[1] for e in _events(ttr) if e[0] == "device"}
    assert device == set(tp)


def test_cost_stamp_matches_its_formula(pairs):
    """``program_cost`` equals 2 · P_lin · rows + 4 · L · H · hd · keys
    FLOPs and the weights (less the embedding table) plus the gathered
    embedding rows plus the KV bytes read and written."""
    _, (tt, _) = pairs
    eng = Engine(tt, pairs[1][1], EngineConfig(max_batch=2, page_size=8), device="cpu")
    store = eng._t_stores["none"]
    cfg = tt.cfg
    lengths = np.array([5, 0], np.int32)
    got = costs.window_cost(tt, store, lengths, 3)
    rows, keys = 2 * 3, 3 * 5 + 2 * (1 + 2 + 3)
    p_lin = cfg.n_layers * (cfg.d_model * (cfg.n_heads + 2 * cfg.n_kv) * cfg.hd
                            + cfg.n_heads * cfg.hd * cfg.d_model + 3 * cfg.d_model * cfg.d_ff) \
        + cfg.d_model * cfg.vocab_padded
    assert got["flops"] == 2 * p_lin * rows + 4 * cfg.n_layers * cfg.n_heads * cfg.hd * keys
    table = tt.params["embed"]["tok"]
    weights = sum(p.numel() * p.element_size() for p in _leaves(tt.params)) \
        - table.numel() * table.element_size()
    per_token = sum(a[0, 0, 0].numel() * a.element_size() for a in store.values())
    kv = (5 + 2 * 3 + 2 * 3) * cfg.n_layers * per_token
    assert got["bytes"] == weights + rows * cfg.d_model * table.element_size() + kv
    assert got["flops"] > 0 and got["bytes"] > 0


def test_profile_summary_charges_each_call_its_own_count():
    """One request's prefill runs the target and then the draft under the
    name ``prefill``: the summary's bytes and FLOPs are the mean of the two
    prefills' own counts, and the device track's spans carry each call's
    count, so their sum is ``bytes * calls``."""
    tt, td = tserve.build_pair(seed=0, s_max=S_MAX, quantize=False, device="cpu")
    tracer = Tracer()
    eng = Engine(tt, td, EngineConfig(max_batch=2, page_size=8, profile_every_n=1),
                 device="cpu", trace=tracer)
    prompt = _prompts(1)[0]
    eng.add_request(prompt, SamplingParams(max_tokens=3))
    eng.step()
    want = [costs.prefill_cost(m, eng._t_stores["none"] if m is tt else eng._d_stores["none"],
                               prompt.shape[0], 0) for m in (tt, td)]
    assert want[0]["bytes"] > 2 * want[1]["bytes"]  # the target's weights dominate
    got = eng.profile_summary()["prefill"]
    assert got["calls"] == 2
    for key in ("flops", "bytes"):
        assert got[key] == (want[0][key] + want[1][key]) / 2, key
        spans = [e["args"][key] for e in tracer.events()
                 if e["track"] == "device" and e["name"] == "prefill"]
        assert spans == [want[0][key], want[1][key]], key


def _leaves(tree):
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _leaves(v)]
    return []

"""The engine's profiler ranges (``serving/tracing.region``) on the CPU,
with the port's dense smoke pair: under ``torch.profiler`` the exported
trace holds every range by name, each prefill's rows and request id, one
verify copy a two-phase round, each range inside the engine call it
belongs to; with the profiler off no range is opened; the tokens are the
same either way."""
from __future__ import annotations

import json

import numpy as np
import pytest
import torch

from repro_torch.launch.serve import build_pair
from repro_torch.serving import tracing
from repro_torch.serving.engine import Engine, EngineConfig, SamplingParams

S_MAX = 64
CASES = {
    "chain": dict(),
    "tree": dict(spec_mode="tree", tree_budget=6, spec_branches=2),
    "wdos": dict(adaptive=True, par_mode="wdos"),
    "prefix": dict(prefix_cache=True),
}
TWO_PHASE = ("chain", "tree", "prefix")
# the engine call each range belongs to, as the test wraps it
CALLS = {"_admit": "call.admit", "_to_host": "call.to_host", "_load_tables": "call.tables",
         "_table_devs": "call.tables", "_chain_round": "call.round", "_tree_round": "call.round",
         "_fused_round": "call.round", "_fused_tree_round": "call.round"}
OWNER = {"engine.prefill.target": "call.admit", "engine.prefill.draft": "call.admit",
         tracing.COPY_VERIFY: "call.to_host", tracing.COPY_DRAFT: "call.to_host",
         tracing.ACCEPT: "call.round", tracing.TABLES: "call.tables"}


@pytest.fixture(scope="module")
def pair():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield build_pair(seed=0, s_max=S_MAX, quantize=False, device="cpu")
    torch.set_num_threads(n)


def _prompts():
    """Three prompts that share a 20-token head (two full pages of 8 for
    the prefix cache), then tails of their own."""
    rng = np.random.RandomState(5)
    head = rng.randint(0, 512, size=20)
    return [np.concatenate([head, rng.randint(0, 512, size=n)]).astype(np.int32)
            for n in (3, 9, 5)]


def _drive(pair, case):
    """Admit one request a step, then drain: (tokens, the rows each
    request's prefill runs (prompt - 1 - prefix-cache match) by request
    id, rounds)."""
    eng = Engine(*pair, EngineConfig(max_batch=2, page_size=8, max_model_len=S_MAX,
                                     **CASES[case]), device="cpu")
    rows = {}
    admit = eng._batcher.admit

    def recording():
        admitted = admit()
        for _, req in admitted:
            m = req.prefix_match.tokens_matched if req.prefix_match is not None else 0
            rows[req.rid] = req.prompt.shape[0] - 1 - m
        return admitted
    eng._batcher.admit = recording
    rids, rounds = [], 0
    for p in _prompts():
        rids.append(eng.add_request(p, SamplingParams(max_tokens=6)))
        rounds += bool(eng.step())
    while eng.has_unfinished():
        rounds += bool(eng.step())
    return [eng.output_tokens(r).tolist() for r in rids], rows, rounds


def _wrap(monkeypatch):
    for meth, name in CALLS.items():
        fn = getattr(Engine, meth)

        def wrapped(*a, _fn=fn, _name=name, **kw):
            with torch.profiler.record_function(_name):
                return _fn(*a, **kw)
        monkeypatch.setattr(Engine, meth, wrapped)


def _traced(pair, case, monkeypatch, tmp_path):
    _wrap(monkeypatch)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        out = _drive(pair, case)
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = [e for e in json.loads(path.read_text())["traceEvents"]
              if e.get("ph") == "X" and e.get("cat") == "user_annotation"]
    return out, [(e["name"], float(e["ts"]), float(e["ts"]) + float(e["dur"])) for e in events]


def _named(spans, name):
    return [s for s in spans if s[0] == name]


def _inside(span, outer):
    return any(o[1] <= span[1] and span[2] <= o[2] for o in outer)


@pytest.mark.parametrize("case", list(CASES))
def test_ranges_in_the_exported_trace(pair, case, monkeypatch, tmp_path):
    (_, expected, rounds), spans = _traced(pair, case, monkeypatch, tmp_path)
    names = {s[0] for s in spans}
    assert {"engine.prefill.target", "engine.prefill.draft", tracing.COPY_VERIFY,
            tracing.COPY_DRAFT, tracing.ACCEPT, tracing.TABLES} <= names
    if case == "prefix":  # the later prompts hit the cached head
        assert sum(expected.values()) < sum(len(p) - 1 for p in _prompts())
    # each prefill carries its rows and request id, in a note inside it
    for role, rng in tracing.PREFILL_RANGES.items():
        notes = [s for s in spans if s[0].startswith(f"{tracing.ARGS_PREFIX}{rng} ")]
        got = {}
        for note in notes:
            assert _inside(note, _named(spans, rng))
            args = dict(kv.split("=") for kv in note[0].split(" ")[1:])
            got[int(args["rid"])] = int(args["rows"])
        assert got == expected, role
        assert len(_named(spans, rng)) == len(expected)
    if case in TWO_PHASE:
        assert len(_named(spans, tracing.COPY_VERIFY)) == rounds
    # every range sits inside the engine call it belongs to
    for name, owner in OWNER.items():
        for s in _named(spans, name):
            assert _inside(s, _named(spans, owner)), (name, s)
    assert len(_named(spans, "call.to_host")) == (len(_named(spans, tracing.COPY_VERIFY))
                                                   + len(_named(spans, tracing.COPY_DRAFT)))


@pytest.mark.parametrize("case", list(CASES))
def test_profiler_off_opens_no_range_and_tokens_match(pair, case, monkeypatch, tmp_path):
    opened = []
    record_function = torch.profiler.record_function

    def counting(name, *a, **kw):
        opened.append(name)
        return record_function(name, *a, **kw)
    monkeypatch.setattr(torch.profiler, "record_function", counting)
    assert not tracing.profiling()
    off, *_ = _drive(pair, case)
    assert opened == []
    with tracing.region(tracing.ACCEPT, rows=3):
        pass
    assert opened == []
    monkeypatch.undo()
    (on, *_), spans = _traced(pair, case, monkeypatch, tmp_path)
    assert spans and on == off

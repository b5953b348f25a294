"""The port's serving front end against the JAX package: the BPE tokenizer
and the HTTP client helpers (both packages' copies), ``AsyncEngine``,
``CompletionServer``, the ``launch.serve`` CLI and the deprecated
``serve_sd`` / ``serve_apsd`` / ``serve_batch`` wrappers (``serve_batch``
also through the legacy host-gather loop, ``kv_path="host"``).

The engine cases run the dense smoke pair (weights carried across from the
JAX ``build_pair(quantize=False)``), and one async case the port's own
quantized smoke pair (W4A8 target, BVQ draft) under WDOS rounds.  Tokens
through the async layer and through HTTP must equal the port's solo
``Engine.run`` of the same request, which equals the JAX Engine's: the
front end changes when work runs, never what it computes.  Stop strings
through HTTP are held to the JAX Engine's output for the same request
(the reference's own stop-string test fails against it, so the port is
held to what the reference computes).  Tolerance: none."""
import asyncio
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")  # the reference side of every test here

import jax  # noqa: E402
from test_torch_models import one_thread, to_numpy_tree  # noqa: E402,F401

from repro.core.apsd import APSDConfig as JaxAPSDConfig  # noqa: E402
from repro.core.speculative import SDConfig as JaxSDConfig  # noqa: E402
from repro.launch.serve import build_pair as jax_build_pair  # noqa: E402
from repro.serving import Engine as JaxEngine  # noqa: E402
from repro.serving import EngineConfig as JaxEngineConfig  # noqa: E402
from repro.serving import SamplingParams as JaxSamplingParams  # noqa: E402
from repro.serving import async_engine as jasync  # noqa: E402
from repro.serving import engine as jengine  # noqa: E402
from repro.serving import http_client as jhc  # noqa: E402
from repro.serving import server as jserver  # noqa: E402
from repro.serving import tokenizer as jtok  # noqa: E402
from repro.serving.batcher import BatchConfig as JaxBatchConfig  # noqa: E402
from repro_torch.configs.paper_pair import DLM_SMOKE, TLM_SMOKE  # noqa: E402
from repro_torch.core import prng  # noqa: E402
from repro_torch.core.apsd import APSDConfig  # noqa: E402
from repro_torch.core.speculative import SDConfig  # noqa: E402
from repro_torch.launch import serve as tserve  # noqa: E402
from repro_torch.serving import engine as tengine  # noqa: E402
from repro_torch.serving import http_client as hc  # noqa: E402
from repro_torch.serving import quantized_lm as tqlm  # noqa: E402
from repro_torch.serving import tokenizer as ttok  # noqa: E402
from repro_torch.serving.async_engine import AsyncEngine, QueueFullError  # noqa: E402
from repro_torch.serving.batcher import BatchConfig  # noqa: E402
from repro_torch.serving.engine import Engine, EngineConfig, SamplingParams, ServingModel  # noqa: E402
from repro_torch.serving.server import CompletionServer  # noqa: E402

pytestmark = pytest.mark.usefixtures("one_thread")
S_MAX = 128


@pytest.fixture(scope="module")
def pairs():
    """(JAX dense smoke pair, the port's on the CPU, weights carried across)."""
    jt, jd = jax_build_pair(seed=0, s_max=S_MAX, quantize=False)
    tt, td = (ServingModel(cfg, tqlm.params_from_numpy(to_numpy_tree(m.params), cfg, "bf16",
                                                       "cpu"),
                           mode="bf16", s_max=S_MAX, device="cpu")
              for m, cfg in ((jt, TLM_SMOKE), (jd, DLM_SMOKE)))
    return (jt, jd), (tt, td)


@pytest.fixture(scope="module")
def qpair():
    """The port's quantized smoke pair (W4A8 target, BVQ draft) on the CPU."""
    return tserve.build_pair(seed=0, s_max=S_MAX, quantize=True, device="cpu")


def _prompts(n, seed=0):
    rng = np.random.RandomState(seed)
    return [rng.randint(0, 512, size=rng.randint(3, 7)).astype(np.int32) for _ in range(n)]


def _ref(pair, prompt, sp):
    """The port's solo synchronous run of one request."""
    eng = Engine(*pair, EngineConfig(max_batch=1, page_size=8), device="cpu")
    outs, _ = eng.run([np.asarray(prompt, np.int32)], sp)
    return [int(t) for t in outs[0]]


def _jax_ref(pair, prompt, sp):
    eng = JaxEngine(*pair, JaxEngineConfig(max_batch=1, page_size=8))
    outs, _ = eng.run([np.asarray(prompt, np.int32)], sp)
    return [int(t) for t in outs[0]]


# ---------------------------------------------------------------------------
# Tokenizer and HTTP client helpers: the port's copies equal the reference's
# ---------------------------------------------------------------------------


def test_tokenizer_matches_reference(tmp_path):
    ours, theirs = ttok.BPETokenizer.trained(), jtok.BPETokenizer.trained()
    assert ours.pieces == theirs.pieces and ours.merges == theirs.merges
    assert ours.vocab_size == theirs.vocab_size <= 512
    for text in ("the quick brown fox — déjà vu", ttok.DEFAULT_CORPUS[:300], "日 a b"):
        try:
            want = theirs.encode(text)
        except ValueError:
            with pytest.raises(ValueError):
                ours.encode(text)
            continue
        assert ours.encode(text) == want
        assert ours.decode(want) == theirs.decode(want) == text
    assert [ours.piece(i) for i in (0, 7, 300, 600, 10**6)] == \
        [theirs.piece(i) for i in (0, 7, 300, 600, 10**6)]
    ours.save(str(tmp_path / "vocab.json"))
    again = jtok.BPETokenizer.load(str(tmp_path / "vocab.json"))
    assert again.pieces == ours.pieces and again.merges == ours.merges


def test_http_client_helpers_match_reference():
    for method, path, payload in (("GET", "/healthz", None),
                                  ("POST", "/v1/completions", {"prompt": [1, 2], "stream": True})):
        assert hc.format_request(method, path, payload) == jhc.format_request(method, path,
                                                                              payload)
    body = (b'data: {"index": 0, "token": 5}\n\ndata: {"index": 1, "token": 9}\n\n'
            b"data: [DONE]\n\n")
    assert hc.parse_sse(body) == jhc.parse_sse(body) == [{"index": 0, "token": 5},
                                                          {"index": 1, "token": 9}]
    for bad in (b"data: [DONE]\n", b'nodata: {}\n\ndata: [DONE]\n\n'):
        with pytest.raises(Exception):
            jhc.parse_sse(bad)
        with pytest.raises(Exception):
            hc.parse_sse(bad)


# ---------------------------------------------------------------------------
# AsyncEngine
# ---------------------------------------------------------------------------


async def _consume(aeng, prompt, sp, delay=0.0):
    if delay:
        await asyncio.sleep(delay)
    toks, final = [], None
    async for out in aeng.generate(prompt, sp):
        toks.extend(int(t) for t in out.new_token_ids)
        assert out.token_ids == toks  # cumulative == the deltas concatenated
        final = out
    assert final is not None and final.finished
    return toks, final.outputs[0].finish_reason


def test_async_staggered_matches_engine_run_and_jax(pairs):
    """Four coroutines submit at staggered times, greedy and sampled: each
    stream equals its solo ``Engine.run``, which equals the JAX Engine's."""
    (jt, jd), tpair = pairs
    prompts = _prompts(4, seed=1)
    kw = [dict(max_tokens=10), dict(temperature=0.8, seed=7, max_tokens=10),
          dict(max_tokens=8), dict(temperature=0.9, top_p=0.8, seed=11, max_tokens=8)]
    refs = [_ref(tpair, p, SamplingParams(**k)) for p, k in zip(prompts, kw)]
    assert refs == [_jax_ref((jt, jd), p, JaxSamplingParams(**k)) for p, k in zip(prompts, kw)]

    async def scenario():
        eng = Engine(*tpair, EngineConfig(max_batch=2, page_size=8), device="cpu")
        async with AsyncEngine(eng, max_queued=8) as aeng:
            return await asyncio.gather(*[
                _consume(aeng, prompts[i], SamplingParams(**kw[i]), delay=0.05 * i)
                for i in range(4)])

    for i, (toks, reason) in enumerate(asyncio.run(scenario())):
        assert toks == refs[i], f"request {i} diverged"
        assert reason == "length"


def test_async_quantized_pair_under_wdos(qpair):
    prompts = _prompts(3, seed=2)
    sps = [SamplingParams(max_tokens=6), SamplingParams(temperature=0.7, seed=3, max_tokens=6),
           SamplingParams(max_tokens=6)]
    refs = [_ref(qpair, p, sp) for p, sp in zip(prompts, sps)]

    async def scenario():
        eng = Engine(*qpair, EngineConfig(max_batch=3, page_size=8, par_mode="wdos"),
                     device="cpu")
        async with AsyncEngine(eng, max_queued=4) as aeng:
            return await asyncio.gather(*[_consume(aeng, prompts[i], sps[i], delay=0.04 * i)
                                          for i in range(3)])

    assert [t for t, _ in asyncio.run(scenario())] == refs


def test_async_cancel_and_abort_free_pages(pairs):
    tpair = pairs[1]
    p_victim, p_survivor = _prompts(2, seed=3)
    sp_survivor = SamplingParams(max_tokens=10)
    ref = _ref(tpair, p_survivor, sp_survivor)

    async def scenario():
        eng = Engine(*tpair, EngineConfig(max_batch=2, page_size=8, max_model_len=128),
                     device="cpu")
        async with AsyncEngine(eng, max_queued=4) as aeng:
            got_first = asyncio.get_running_loop().create_future()

            async def victim():
                async for out in aeng.generate(p_victim, SamplingParams(max_tokens=100)):
                    if not got_first.done():
                        got_first.set_result(out.request_id)

            vtask = asyncio.ensure_future(victim())
            survivor = asyncio.ensure_future(_consume(aeng, p_survivor, sp_survivor))
            await got_first
            vtask.cancel()  # mid-stream
            with pytest.raises(asyncio.CancelledError):
                await vtask
            toks, _ = await survivor
            assert toks == ref
            # abort by id ends a stream too
            seen, first = [], asyncio.get_running_loop().create_future()

            async def consume():
                async for out in aeng.generate(p_victim, SamplingParams(max_tokens=100)):
                    seen.extend(out.new_token_ids)
                    if not first.done():
                        first.set_result(out.request_id)

            task = asyncio.ensure_future(consume())
            await aeng.abort(await first)
            await asyncio.wait_for(task, timeout=30)
            assert 0 < len(seen) < 100
            for _ in range(200):
                st = aeng.stats()
                if st["target_pool"]["used_pages"] == 0 and st["active"] == 0 \
                        and not eng._requests:
                    break
                await asyncio.sleep(0.02)
            return aeng.stats(), len(eng._requests)

    st, retained = asyncio.run(scenario())
    for pool in ("target_pool", "draft_pool"):
        assert st[pool]["used_pages"] == 0 and st[pool]["reserved_pages"] == 0, st[pool]
    assert st["active"] == 0 and st["queued"] == 0
    assert retained == 0  # finished requests are released, not retained


def test_async_backpressure_and_no_phantom_permit(pairs):
    """max_queued=1, one request decoding and one QUEUED: ``wait=False``
    raises QueueFullError; a waiter parked behind the gate and cancelled
    withdraws without minting a permit (the gate stays full); a
    ``wait=True`` submit parks and completes."""
    tpair = pairs[1]
    prompts = _prompts(5, seed=6)

    async def scenario():
        eng = Engine(*tpair, EngineConfig(max_batch=1, page_size=8), device="cpu")
        async with AsyncEngine(eng, max_queued=1) as aeng:
            a = asyncio.ensure_future(_consume(aeng, prompts[0], SamplingParams(max_tokens=30)))
            for _ in range(500):
                if aeng.stats()["active"] == 1 and aeng.queue_depth() == 0:
                    break
                await asyncio.sleep(0.01)
            b = asyncio.ensure_future(_consume(aeng, prompts[1], SamplingParams(max_tokens=4)))
            for _ in range(500):
                if aeng.queue_depth() == 1:
                    break
                await asyncio.sleep(0.01)
            assert aeng.queue_depth() == 1

            async def fail_fast(p):
                async for _ in aeng.generate(p, SamplingParams(max_tokens=4), wait=False):
                    pass

            with pytest.raises(QueueFullError):
                await fail_fast(prompts[2])
            parked = asyncio.ensure_future(_consume(aeng, prompts[3], SamplingParams(max_tokens=4)))
            await asyncio.sleep(0.05)
            parked.cancel()
            with pytest.raises(asyncio.CancelledError):
                await parked
            assert aeng.queue_depth() == 1  # no phantom permit
            with pytest.raises(QueueFullError):
                await fail_fast(prompts[3])
            c = asyncio.ensure_future(_consume(aeng, prompts[4], SamplingParams(max_tokens=4)))
            await asyncio.gather(a, b, c)
            return aeng.queue_depth(), aeng.stats()

    depth, st = asyncio.run(scenario())
    assert depth == 0 and st["finished_requests"] >= 3
    assert st["target_pool"]["used_pages"] == 0
    with pytest.raises(ValueError, match="max_queued"):
        AsyncEngine(Engine(*tpair, EngineConfig(max_batch=1), device="cpu"), max_queued=0)


# ---------------------------------------------------------------------------
# CompletionServer
# ---------------------------------------------------------------------------


def _serve(engine, server_cls, async_cls, fn, max_queued=8):
    async def scenario():
        server = server_cls(async_cls(engine, max_queued=max_queued))
        await server.start(port=0)
        task = asyncio.ensure_future(server.serve_forever())
        try:
            return await fn(server.port)
        finally:
            task.cancel()
            try:
                await task
            except asyncio.CancelledError:
                pass
            await server.stop()

    return asyncio.run(scenario())


def _port_server(tpair, fn, max_queued=8, **cfg):
    eng = Engine(*tpair, EngineConfig(**dict(dict(max_batch=2, page_size=8, max_model_len=128),
                                             **cfg)), device="cpu")
    return _serve(eng, CompletionServer, AsyncEngine, fn, max_queued)


def _sse_chunks(body):
    events = [e for e in body.decode().split("\n\n") if e.strip()]
    assert all(e.startswith("data: ") and "\n" not in e for e in events)
    assert events[-1] == "data: [DONE]"
    return [json.loads(e[len("data: "):]) for e in events[:-1]]


def test_server_sse_json_and_stop_strings(pairs):
    """SSE framing and tokens, a JSON completion, and stop strings (whole
    and streamed) equal to the JAX Engine's output for the same request."""
    jpair, tpair = pairs
    p1, p2, p3 = _prompts(3, seed=1)
    ref1 = _ref(tpair, p1, SamplingParams(max_tokens=10))
    ref2 = _ref(tpair, p2, SamplingParams(max_tokens=8))
    ref3 = _jax_ref(jpair, p3, JaxSamplingParams(max_tokens=10))
    stop = f"{ref3[4]} "
    want_stop = _jax_ref(jpair, p3, JaxSamplingParams(max_tokens=10, stop=(stop,)))
    jreq = JaxEngine(*jpair, JaxEngineConfig(max_batch=1, page_size=8))
    jreq.run([p3], JaxSamplingParams(max_tokens=10, stop=(stop,)))
    want_reason = jreq.request(0).finish_reason

    async def fn(port):
        status, head, body = await hc.request(port, "POST", "/v1/completions",
                                              {"prompt": p1.tolist(), "max_tokens": 10,
                                               "stream": True})
        assert status == 200 and "text/event-stream" in head
        chunks = _sse_chunks(body)
        assert [c["index"] for c in chunks] == list(range(len(chunks)))
        assert [c["token"] for c in chunks] == ref1
        assert [c["finish_reason"] for c in chunks][-1] == "length"
        assert chunks[0]["text"] == f"{ref1[0]} "
        status, _, body = await hc.request(port, "POST", "/v1/completions",
                                           {"prompt": p2.tolist(), "max_tokens": 8})
        obj = json.loads(body)
        assert status == 200 and obj["token_ids"] == ref2 and obj["finish_reason"] == "length"
        assert obj["usage"] == {"prompt_tokens": len(p2), "completion_tokens": len(ref2)}
        assert obj["text"] == "".join(f"{t} " for t in ref2)
        status, _, body = await hc.request(port, "POST", "/v1/completions",
                                           {"prompt": p3.tolist(), "max_tokens": 10,
                                            "stop": stop})
        obj = json.loads(body)
        assert status == 200 and obj["token_ids"] == want_stop
        assert obj["finish_reason"] == want_reason
        status, _, body = await hc.request(port, "POST", "/v1/completions",
                                           {"prompt": p3.tolist(), "max_tokens": 10,
                                            "stop": [stop], "stream": True})
        chunks = _sse_chunks(body)
        assert [c["token"] for c in chunks if c["token"] is not None] == want_stop
        assert chunks[-1]["finish_reason"] == want_reason

    _port_server(tpair, fn)


def test_server_routes_stats_and_metrics_match_reference(pairs):
    """/healthz, /stats, /metrics and /debug/flight answer 200 after a
    completion, with the /stats keys and /metrics families of the
    reference server (the port adds ``host_copies_total``); 404, 405 and
    400 on bad routes and requests."""
    jpair, tpair = pairs
    prompt = _prompts(1, seed=6)[0].tolist()

    async def scrape(port):
        status, _, _ = await hc.request(port, "POST", "/v1/completions",
                                        {"prompt": prompt, "max_tokens": 6})
        assert status == 200
        out = {}
        for path in ("/healthz", "/stats", "/metrics", "/debug/flight"):
            status, _, body = await hc.request(port, "GET", path)
            assert status == 200, path
            out[path] = body.decode()
        for method, path, payload, code in (
            ("GET", "/nope", None, 404),
            ("GET", "/v1/completions", None, 405),
            ("POST", "/v1/completions", {"prompt": "not token ids"}, 400),
            ("POST", "/v1/completions", {"prompt": prompt, "temperature": -1.0}, 400),
            ("POST", "/v1/completions", {"prompt": prompt, "max_tokens": 100000}, 400),
        ):
            status, _, _ = await hc.request(port, method, path, payload)
            assert status == code, (method, path)
        reader, writer = await asyncio.open_connection("127.0.0.1", port)
        writer.write(b"POST /v1/completions HTTP/1.1\r\nHost: t\r\nContent-Length: abc\r\n\r\n")
        await writer.drain()
        raw = await reader.read()
        writer.close()
        assert b" 400 " in raw.partition(b"\r\n\r\n")[0].splitlines()[0]
        return out

    ours = _port_server(tpair, scrape)
    theirs = _serve(JaxEngine(*jpair, JaxEngineConfig(max_batch=2, page_size=8,
                                                      max_model_len=128)),
                    jserver.CompletionServer, jasync.AsyncEngine, scrape)
    assert json.loads(ours["/healthz"]) == {"status": "ok"}
    assert set(json.loads(ours["/stats"])) == set(json.loads(theirs["/stats"]))

    def families(text):
        return {ln.split()[2] for ln in text.splitlines() if ln.startswith("# TYPE")}

    assert families(ours["/metrics"]) - {"serving_host_copies_total"} == \
        families(theirs["/metrics"])
    flight = json.loads(ours["/debug/flight"])
    assert flight["rounds_recorded"] > 0
    assert set(flight) == set(json.loads(theirs["/debug/flight"]))


def test_server_disconnect_and_429(pairs):
    tpair = pairs[1]
    p_victim, p_survivor, *hogs = _prompts(6, seed=5)
    ref = _ref(tpair, p_survivor, SamplingParams(max_tokens=10))

    async def fn(port):
        reader, writer = await hc.open_request(port, "POST", "/v1/completions",
                                               {"prompt": p_victim.tolist(), "max_tokens": 100,
                                                "stream": True})
        await hc.read_head(reader)
        await reader.readuntil(b"\n\n")  # the first token chunk is out
        writer.close()  # disconnect mid-generation
        status, _, body = await hc.request(port, "POST", "/v1/completions",
                                           {"prompt": p_survivor.tolist(), "max_tokens": 10})
        assert status == 200 and json.loads(body)["token_ids"] == ref
        st = {}
        for _ in range(200):
            _, _, sbody = await hc.request(port, "GET", "/stats")
            st = json.loads(sbody)
            if st["target_pool"]["used_pages"] == 0 and st["active"] == 0:
                break
            await asyncio.sleep(0.02)
        assert st["target_pool"]["used_pages"] == 0 and st["draft_pool"]["used_pages"] == 0
        # saturate: 2 decode slots + the 1-deep queue, then fail fast
        streams = [asyncio.ensure_future(hc.request(
            port, "POST", "/v1/completions",
            {"prompt": hogs[i].tolist(), "max_tokens": 40, "seed": i, "stream": True}))
            for i in range(3)]
        got_429 = False
        for _ in range(200):
            status, _, _ = await hc.request(port, "POST", "/v1/completions",
                                            {"prompt": hogs[3].tolist(), "max_tokens": 4,
                                             "wait": False})
            if status == 429:
                got_429 = True
                break
            await asyncio.sleep(0.02)
        results = await asyncio.gather(*streams)
        assert got_429 and all(s == 200 for s, _, _ in results)
        _, _, body = await hc.request(port, "GET", "/metrics")
        assert "serving_http_429_total 1" in body.decode()

    _port_server(tpair, fn, max_queued=1)


# ---------------------------------------------------------------------------
# The CLI and the deprecated wrappers
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mode", ["ad", "sd", "apsd"])
def test_launch_serve_main_checks(qpair, monkeypatch, capsys, mode):
    """``launch.serve.main`` on the CPU for each mode, ``--check`` holding
    the speculative modes to the target's own greedy decode (the pair is
    built once for the module: ``build_pair`` is what main calls)."""
    monkeypatch.setattr(tserve, "build_pair", lambda quantize, device: qpair)
    assert tserve.main(["--device", "cpu", "--mode", mode, "--check", "--tokens", "12"]) == 0
    out = capsys.readouterr().out
    assert f"mode={mode} tokens=12" in out
    if mode != "ad":
        assert "LOSSLESS" in out


@pytest.mark.filterwarnings("ignore::DeprecationWarning")
def test_deprecated_wrappers_match_jax(pairs):
    (jt, jd), (tt, td) = pairs
    prompt = _prompts(1, seed=8)[0]
    jkey, tkey = jax.random.PRNGKey(3), prng.PRNGKey(3)
    assert tengine._seed_from_key(tkey) == jengine._seed_from_key(jkey)
    want, jst = jengine.serve_sd(jkey, jt, jd, prompt[None],
                                 JaxSDConfig(draft_len=3, temperature=0.0, max_tokens=9))
    got, st = tengine.serve_sd(tkey, tt, td, prompt[None],
                               SDConfig(draft_len=3, temperature=0.0, max_tokens=9))
    assert got.tolist() == np.asarray(want).tolist()
    assert (st.emitted, st.rounds, st.drafted, st.accepted) == \
        tuple(int(x) for x in (jst.emitted, jst.rounds, jst.drafted, jst.accepted))
    want, jst = jengine.serve_apsd(jkey, jt, jd, prompt[None],
                                   JaxAPSDConfig(short_dl=2, long_dl=5, temperature=0.0,
                                                 max_tokens=9))
    got, st = tengine.serve_apsd(tkey, tt, td, prompt[None],
                                 APSDConfig(short_dl=2, long_dl=5, temperature=0.0, max_tokens=9))
    assert got.tolist() == np.asarray(want).tolist()
    assert st.records == jst.records and st.par_rounds == jst.par_rounds
    prompts = _prompts(3, seed=9)
    sinks = [[] for _ in prompts]
    want, _ = jengine.serve_batch(jkey, jt, jd, prompts,
                                  JaxBatchConfig(max_batch=2, page_size=8, max_tokens=7))
    got, summary = tengine.serve_batch(tkey, tt, td, prompts,
                                       BatchConfig(max_batch=2, page_size=8, max_tokens=7),
                                       sinks=[s.append for s in sinks])
    assert [g.tolist() for g in got] == [np.asarray(w).tolist() for w in want]
    assert sinks == [g.tolist() for g in got] and summary["requests"] == 3
    assert tengine.serve_batch(tkey, tt, td, [], BatchConfig())[0] == []
    want, _ = jengine.serve_batch(jkey, jt, jd, prompts,
                                  JaxBatchConfig(max_batch=2, page_size=8, max_tokens=7,
                                                 kv_path="host"))
    got, summary = tengine.serve_batch(tkey, tt, td, prompts,
                                       BatchConfig(max_batch=2, page_size=8, max_tokens=7,
                                                   kv_path="host"))
    assert [g.tolist() for g in got] == [np.asarray(w).tolist() for w in want]
    assert summary["kv_path"] == "host" and summary["requests"] == 3


# ---------------------------------------------------------------------------
# API defaults held to the reference
# ---------------------------------------------------------------------------


def test_serving_model_default_mode_matches_reference(pairs):
    """``ServingModel(cfg, params)`` picks the bf16 forward in both
    packages, and the port's then emits the JAX model's greedy tokens."""
    import dataclasses

    field = {f.name: f.default for f in dataclasses.fields(jengine.ServingModel)}["mode"]
    assert field == "bf16"
    assert {f.name: f.default for f in dataclasses.fields(ServingModel)}["mode"] == field
    (jt, jd), (tt, td) = pairs
    model = ServingModel(TLM_SMOKE, tt.params, s_max=S_MAX, device="cpu")
    assert model.mode == jengine.ServingModel(jt.cfg, jt.params).mode == "bf16"
    sp, prompt = SamplingParams(max_tokens=6), _prompts(1, seed=9)[0]
    assert _ref((model, td), prompt, sp) == _jax_ref((jt, jd), prompt, JaxSamplingParams(
        max_tokens=6))


@pytest.mark.parametrize("impl", [None, "auto", "gather", "pallas", "triton", "GATHER"])
def test_paged_attn_impl_matches_reference(pairs, impl):
    """``EngineConfig.paged_attn_impl`` takes the reference's values: both
    packages resolve each the same way on every backend, both build an
    Engine for a valid value and both raise ValueError at the Engine for
    an invalid one."""
    from repro.serving.api import resolve_paged_attn_impl as jresolve
    from repro_torch.serving.api import resolve_paged_attn_impl as tresolve

    for backend in ("tpu", "gpu", "cpu"):
        try:
            want = jresolve(impl, backend)
        except ValueError:
            with pytest.raises(ValueError, match="paged_attn_impl"):
                tresolve(impl, backend)
        else:
            assert tresolve(impl, backend) == want
    (jt, jd), (tt, td) = pairs
    jcfg, tcfg = JaxEngineConfig(paged_attn_impl=impl), EngineConfig(paged_attn_impl=impl)
    assert tcfg.paged_attn_impl == jcfg.paged_attn_impl == impl
    valid = impl in (None, "auto", "gather", "pallas")
    for build in (lambda: JaxEngine(jt, jd, jcfg), lambda: Engine(tt, td, tcfg, device="cpu")):
        if valid:
            build()
        else:
            with pytest.raises(ValueError, match="paged_attn_impl"):
                build()

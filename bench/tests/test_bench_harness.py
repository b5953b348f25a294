"""CPU tests of the harness's arithmetic, generator, trace reading, frozen
counts and its check for JAX: no card, no JAX, no JAX package."""
from __future__ import annotations

import json
import sys

import numpy as np
import pytest

import bench_testkit as kit  # noqa: F401  (puts bench/ on the path)
from benchkit import cli, drive, readings, trace
from benchkit.spec import load
from benchkit.traffic import Traffic
from roofline import counts


def _mix(name):
    return json.loads((kit.BENCH / "traffic" / f"{name}.json").read_text())


def test_every_seed_sends_the_same_sizes_in_the_same_order():
    mix = _mix("azure-conv")
    a, b, a2 = Traffic(mix, 5, 151936), Traffic(mix, 2**31 + 11, 151936), Traffic(mix, 5, 151936)
    run, grid = mix["start"]["running"], mix["grid"]
    sizes = lambda t: ([(len(p), o) for p, o in (t.request(k, cut=k) for k in range(run))]  # noqa: E731
                       + [t.sizes(k) for k in range(run, 3 * grid)])
    assert sizes(a) == sizes(b)
    # each cycle of the grid deals its quantiles once, shuffled
    for i in (0, 1):
        cycle = [a.sizes(k)[i] for k in range(grid)]
        assert sorted(cycle) == sorted(a.sizes(k)[i] for k in range(grid, 2 * grid)) != cycle
    # the start's outputs are cut to spread fractions of their own lengths
    cuts = sorted(a.request(k, cut=k)[1] / a.sizes(k)[1] for k in range(run))
    assert max(cuts) <= 1.0 and min(cuts) < 0.1
    assert np.array_equal(a.arrivals(50), b.arrivals(50))
    pa, oa = a.request(40)
    pa2, oa2 = a2.request(40)
    pb, _ = b.request(40)
    assert np.array_equal(pa, pa2) and oa == oa2
    assert not np.array_equal(pa, pb)
    assert pa.dtype == np.int32 and 0 <= pa.min() and pa.max() < 151936


def test_arrivals_deal_the_grids_gaps():
    mix = dict(json.loads((kit.DATA / "traffic" / "smoke-open.json").read_text()), rate_per_s=2.0,
               grid=64)
    t = Traffic(mix, 1, 1000)
    n = mix["grid"]
    gaps = np.diff(t.arrivals(2 * n), prepend=0.0)
    assert np.allclose(sorted(gaps[:n]), sorted(gaps[n:])) and not np.allclose(gaps[:n], gaps[n:])
    assert abs(np.mean(gaps[:n]) - 1 / 2.0) < 0.05  # the grid's mean gap is 1 / rate


def _record():
    rec = drive.Record(t0=10.0, t1=12.0)
    # request 0: first token at 9.5 (before the window), then 3 tokens at 10.5, 1 at 11.5
    # request 1: first token at 10.2, then 2 tokens at 11.2, 1 token at 12.5 (after the window)
    rec.emits = [(0, 9.5, 1), (1, 10.2, 1), (0, 10.5, 3), (1, 11.2, 2), (0, 11.5, 1), (1, 12.5, 1)]
    rec.rounds = [(9.3, 9.5, 2), (10.0, 10.2, 2), (10.3, 10.5, 2), (11.0, 11.2, 2), (11.3, 11.5, 1),
                  (12.3, 12.5, 1)]
    rec.counters0 = {"tokens_drafted_total": 100.0, "tokens_accepted_total": 5.0}
    rec.counters1 = {"tokens_drafted_total": 300.0, "tokens_accepted_total": 25.0}
    rec.reqs = {
        0: drive.Req(k=0, rid=0, prompt_len=4, max_tokens=8, submit=9.0, first=10.4),
        1: drive.Req(k=1, rid=1, prompt_len=4, max_tokens=8, submit=10.5, first=None),
        2: drive.Req(k=2, rid=2, prompt_len=4, max_tokens=8, submit=11.8, first=12.9),
        3: drive.Req(k=3, rid=3, prompt_len=4, max_tokens=8, submit=9.0, first=9.1),
    }
    return rec


def _run(rec, **kw):
    cfg = load(kit.BENCH / "configs" / "qwen3-8b-w4a8.json", kit.BENCH)
    return readings.Run(cfg=cfg, mix={}, rec=rec, setup_s=1.5, **kw)


def test_end_to_end_arithmetic():
    man = cli.Manifest(kit.ROOT)
    run = _run(_record())
    # tokens inside (10, 12]: 1 + 3 + 2 + 1 = 7 over 2 s
    assert man.reader("tokens_per_s")(run) == pytest.approx(3.5)
    # gaps: (10.5-9.5)/3 x3, (11.2-10.2)/2 x2, (11.5-10.5)/1 x1; p95 by nearest rank of 6
    assert sorted(run.itl_samples()) == pytest.approx([1 / 3] * 3 + [0.5] * 2 + [1.0])
    assert man.reader("itl_p95_ms")(run) == pytest.approx(1000.0)
    assert readings.nearest_rank([3, 1, 2, 4], 50) == 2
    assert man.reader("setup_s")(run) == 1.5
    assert man.reader("accept_rate")(run) == pytest.approx(0.1)
    # rounds inside the window: 4, of 2, 2, 2, 1 rows
    assert man.reader("round_ms")(run) == pytest.approx(500.0)
    assert man.reader("rows_per_round")(run) == pytest.approx(1.75)


def _trace():
    ev = [
        {"ph": "X", "cat": "user_annotation", "name": "bench.window", "ts": 0.0, "dur": 1000.0},
        {"ph": "X", "cat": "user_annotation", "name": "engine.admit", "ts": 0.0, "dur": 300.0},
        {"ph": "X", "cat": "user_annotation", "name": "dispatch.verify", "ts": 400.0, "dur": 500.0},
        {"ph": "X", "cat": "kernel", "name": "void w4a8_mma_kernel<16, 2>(Args)", "ts": 100.0,
         "dur": 100.0},
        {"ph": "X", "cat": "kernel", "name": "void paged_attn_kernel<4>(fd::Args, int)",
         "ts": 150.0, "dur": 100.0},
        {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy DtoH (Device -> Pageable)", "ts": 600.0,
         "dur": 100.0},
        {"ph": "X", "cat": "kernel", "name": "outside", "ts": 1500.0, "dur": 100.0},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts": 90.0, "dur": 1.0},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts": 140.0, "dur": 1.0},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaMemcpyAsync", "ts": 590.0, "dur": 1.0},
    ]
    return {"traceEvents": ev}


def test_trace_summary_idle_share_and_gaps():
    s = trace.summarize(_trace())
    assert s["window_s"] == pytest.approx(1e-3)
    assert s["busy_s"] == pytest.approx(250e-6)  # [100, 250] and [600, 700]
    assert s["launches"] == 2
    assert dict(s["device_ops"])["w4a8_mma_kernel"] == pytest.approx(1e-4)
    # gaps [0, 100] (middle under engine.admit), [250, 600] and [700, 1000]
    # (middles under dispatch.verify)
    gaps = dict(s["idle_gaps"])
    assert gaps["engine.admit"] == pytest.approx(100e-6)
    assert gaps["dispatch.verify"] == pytest.approx(650e-6)
    hooks = type("H", (), {"t_start": 0.0, "t_stop": 1.0})()
    run = _run(_record(), hooks=hooks, summary=s)
    man = cli.Manifest(kit.ROOT)
    assert man.reader("device_idle_pct")(run) == pytest.approx(75.0)


def test_roofline_share_on_known_shapes():
    m, k, n = 96, 4096, 12288
    bound = counts.lower_bound_s(counts.k1_ops(m, k, n), counts.k1_bytes(m, k, n),
                                 counts.PEAKS["int8_ops"])
    # K1 at M = 96 is bound by its bytes: the packed weight dominates
    assert bound == pytest.approx(counts.k1_bytes(m, k, n) / 3.35e12)
    hooks = type("H", (), {"k1": [(m, k, n)] * 4, "t_start": 0.0, "t_stop": 1.0})()
    summary = {"kernel_s": {"void w4a8_mma_kernel<16>(x)": 8 * bound, "other": 1.0}}
    run = _run(_record(), hooks=hooks, summary=summary)
    assert cli.Manifest(kit.ROOT).reader("k1_w4a8_roofline")(run) == pytest.approx(50.0)
    # paged attention: one row of 10 valid positions, a 3-wide window
    lens = [10]
    assert counts.attn_ops(lens, 3, 32, 128) == 4 * 32 * 128 * (8 + 9 + 10)
    assert counts.attn_bytes(lens, 3, 32, 8, 128, 2, 2, False, 81) == (
        3 * 32 * 128 * 2 + 2 * 10 * 8 * 128 * 2 + 4 * 81 + 4 + 4 * 3 * 32 * 128)


def test_k1_count_is_the_programs_at_todays_shapes():
    from repro_torch.core.costs import w4a8_bytes
    for m in (1, 32, 96, 1023):
        for k, n in ((4096, 4096), (4096, 1024), (4096, 12288), (12288, 4096), (4096, 151936)):
            assert counts.k1_bytes(m, k, n) == w4a8_bytes(m, k, n)


def test_forbidden_modules_compares_whole_top_level_names():
    assert cli.forbidden_modules(["repro_torch.serving", "jaxlibrary", "torch", "numpy.linalg"]) == []
    assert cli.forbidden_modules(["repro_torch", "repro.serving.engine", "jax.numpy", "jaxlib",
                                  "flax.linen"]) == ["flax", "jax", "jaxlib", "repro"]


def test_harness_imports_no_jax(tmp_path):
    import subprocess
    code = ("import sys; sys.path[:0] = [%r, %r]; "
            "import pathlib, benchkit.cli, benchkit.drive, benchkit.trace, "
            "benchkit.check, benchkit.spec, reference.lm_ref, roofline.counts; "
            "benchkit.spec.load(pathlib.Path(%r), pathlib.Path(%r)); "
            "import repro_torch.serving.engine, repro_torch.serving.quantized_lm; "
            "print(benchkit.cli.forbidden_modules())"
            % (str(kit.BENCH), str(kit.ROOT / "src"), str(kit.BENCH / "configs" / "qwen3-8b-w4a8.json"),
               str(kit.BENCH)))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd=tmp_path, check=True)
    assert out.stdout.strip() == "[]"


def test_manifest_is_well_formed():
    man = cli.Manifest(kit.ROOT)
    d = man.data
    names = [c["name"] for c in d["workloads"]]
    assert len(set(names)) == len(names)
    for cell in d["workloads"]:
        cfg = man.config(cell)
        assert cfg.check and all(v is not None for v in cfg.check.values())
        assert callable(cfg.family.pair) and callable(cfg.family.target_logits)
        mix = man.traffic(cell)
        assert mix["rate_per_s"] > 0 and mix["start"]["running"] <= mix["engine"]["max_batch"]
        e2e = [m["name"] for m in man.metrics(cell, False)]
        assert "setup_s" in e2e and len(e2e) >= 2
        assert man.metrics(cell, True)
        for m in man.metrics(cell, False) + man.metrics(cell, True):
            assert callable(man.reader(m["name"]))

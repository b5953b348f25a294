"""CPU tests of the readers of the program's own ranges (benchkit/ranges.py
and the four metrics that read them) on a hand-made trace in the
profiler's export format: runtime calls and device operations joined by
``correlation``."""
from __future__ import annotations

import pytest

import bench_testkit as kit  # noqa: F401  (puts bench/ on the path)
from benchkit import cli, drive, ranges, readings, trace

READERS = ("prefill_ms_per_ktok", "prefill_launches_per_ktok", "prefill_busy_pct",
           "verify_copy_ms")


def _x(cat, name, ts, dur, corr=None):
    e = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


def _ann(name, ts, dur):
    return _x("user_annotation", name, ts, dur)


def _launch(ts, corr, api="cudaLaunchKernel"):
    return _x("cuda_runtime", api, ts, 2.0, corr)


def _trace(with_ranges=True):
    ev = [_ann("bench.window", 1000.0, 10000.0),
          _ann("engine.admit", 1900.0, 2200.0),
          # kernels and copies of no range of the program's
          _launch(1100.0, 90), _x("kernel", "void k<1>(A)", 1150.0, 50.0, 90),
          _launch(6000.0, 50, "cudaMemcpyAsync"),
          _x("gpu_memcpy", "Memcpy DtoH (Device -> Pageable)", 6000.0, 500.0, 50)]
    if not with_ranges:
        return {"traceEvents": ev}
    ev += [
        # a prefill that starts before the window: not counted
        _ann("engine.prefill.target", 500.0, 400.0),
        _ann("args.engine.prefill.target rows=100 rid=1", 501.0, 0.0),
        _launch(600.0, 1), _x("kernel", "void k<1>(A)", 700.0, 100.0, 1),
        # the target's prefill of request 7: its last kernel and a copy end
        # after the range, at 3500
        _ann("engine.prefill.target", 2000.0, 1000.0),
        _ann("args.engine.prefill.target rows=1000 rid=7", 2000.5, 0.0),
        _launch(2100.0, 10), _x("kernel", "void gemm<2>(B)", 2200.0, 300.0, 10),
        _launch(2900.0, 11), _x("kernel", "void gemm<2>(B)", 2950.0, 450.0, 11),
        _launch(2950.0, 12, "cudaMemcpyAsync"),
        _x("gpu_memcpy", "Memcpy HtoD (Pageable -> Device)", 3400.0, 100.0, 12),
        # the draft's prefill of the same request, inside its range
        _ann("engine.prefill.draft", 3600.0, 400.0),
        _ann("args.engine.prefill.draft rows=1000 rid=7", 3600.5, 0.0),
        _launch(3700.0, 20), _x("kernel", "void k<1>(A)", 3800.0, 100.0, 20),
        # two verify copies, a sync inside one, and a draft copy
        _ann("host.copy.verify", 5000.0, 300.0),
        _launch(5010.0, 30, "cudaMemcpyAsync"),
        _x("gpu_memcpy", "Memcpy DtoH (Device -> Pageable)", 5100.0, 150.0, 30),
        _launch(5020.0, 31, "cudaStreamSynchronize"),
        _ann("host.copy.verify", 8000.0, 300.0),
        _launch(8010.0, 40, "cudaMemcpyAsync"),
        _x("gpu_memcpy", "Memcpy DtoH (Device -> Pageable)", 8050.0, 250.0, 40),
        _ann("host.copy.draft", 7000.0, 100.0),
        _launch(7010.0, 60, "cudaMemcpyAsync"),
        _x("gpu_memcpy", "Memcpy DtoH (Device -> Pageable)", 7020.0, 30.0, 60),
    ]
    return {"traceEvents": ev}


def _run(tr):
    rec = drive.Record(t0=0.0, t1=1.0)
    rec.rounds = [(1.0, 1.5, 32), (1.5, 2.0, 32), (2.0, 3.5, 32)]
    hooks = type("H", (), {"t_start": 1.0, "t_stop": 2.5, "trace": tr})()
    return readings.Run(cfg=None, mix={}, rec=rec, setup_s=0.0, hooks=hooks,
                        summary=trace.summarize(tr))


def test_ranges_carry_rows_launches_and_device_ops():
    rs = ranges.find(_trace(), ranges.PREFILLS)
    assert [(r.name, r.t0, r.end, r.launches) for r in rs] == [
        ("engine.prefill.target", 2000.0, 3500.0, 2), ("engine.prefill.draft", 3600.0, 4000.0, 1)]
    assert [r.args for r in rs] == [{"rows": 1000, "rid": 7}] * 2
    assert ranges.prefill_rows(rs) == 1000
    assert ranges.busy_us(rs) == pytest.approx(300.0 + 450.0 + 100.0 + 100.0)
    assert ranges.parse_args("args.engine.prefill.draft rows=12 rid=3") == (
        "engine.prefill.draft", {"rows": 12, "rid": 3})
    # the breakdown names the prefill for the gap inside it, [2500, 2950]
    assert dict(trace.summarize(_trace())["idle_gaps"])["engine.prefill.target"] == (
        pytest.approx(450e-6))


@pytest.mark.parametrize("name,value", [
    # walls 1500 + 400 us over 1,000 target rows
    ("prefill_ms_per_ktok", 1.9),
    # three kernel launches (the copy's call is no launch) over 1,000 rows
    ("prefill_launches_per_ktok", 3.0),
    # 950 us of device operations over [2000, 3500] and [3600, 4000]
    ("prefill_busy_pct", 50.0),
    # 150 + 250 us of copies over the two rounds inside [1.0, 2.5]
    ("verify_copy_ms", 0.2),
])
def test_reader_on_a_hand_made_trace(name, value):
    assert cli.Manifest(kit.ROOT).reader(name)(_run(_trace())) == pytest.approx(value)


@pytest.mark.parametrize("name", READERS)
def test_reader_finds_nothing_without_the_programs_ranges(name):
    read = cli.Manifest(kit.ROOT).reader(name)
    assert read(_run(_trace(with_ranges=False))) is None
    untraced = readings.Run(cfg=None, mix={}, rec=drive.Record(), setup_s=0.0)
    assert read(untraced) is None

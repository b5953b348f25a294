"""One run of one cell::

    python3 bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Finds the cell in ``BENCHMARK.json``, its configuration in the file the
manifest names (and through it the family module ``families/<family>.py``
that builds the pair and holds its reference), its traffic in
``traffic/<mix>.json`` and each of its metrics' reader in
``metrics/<metric>.py``; builds the program's pair and Engine from
weights made from the seed, warms up, measures for ``--seconds`` (and
with ``--trace 1`` traces a few seconds after the window), compares a
sample of the served tokens and of the draft's proposals with the
reference, and prints one JSON line.  It exits with a code other than 0, and prints no
result, without a CUDA device (or fewer than the cell asks for), where
the manifest or a file it names is missing, or where a module of JAX or
of the JAX package was loaded.
"""
from __future__ import annotations

import argparse
import gc
import importlib.util
import json
import pathlib
import sys
import time
from typing import List

from benchkit import spec as spec_mod

BENCH_DIR = pathlib.Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


class Manifest:
    """``BENCHMARK.json`` and the files it names, found by name."""

    def __init__(self, root: pathlib.Path, bench_dir: pathlib.Path = BENCH_DIR):
        self.root, self.dir = pathlib.Path(root), pathlib.Path(bench_dir)
        self.data = json.loads((self.root / "BENCHMARK.json").read_text())

    def cell(self, name: str) -> dict:
        for w in self.data["workloads"]:
            if w["name"] == name:
                return w
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")

    def config(self, cell: dict) -> spec_mod.ConfigFile:
        for c in self.data["configs"]:
            if c["name"] == cell["config"]:
                return spec_mod.load(self.root / c["file"], self.dir)
        raise KeyError(f"no config {cell['config']!r} in BENCHMARK.json")

    def traffic(self, cell: dict) -> dict:
        return json.loads((self.dir / "traffic" / f"{cell['traffic']}.json").read_text())

    def metrics(self, cell: dict, trace: bool) -> List[dict]:
        """The cell's end-to-end metrics (trace 0) or per-layer ones (trace 1)."""
        group = self.data["per_layer" if trace else "end_to_end"]
        return [m for m in group if cell["name"] in m.get("workloads", [cell["name"]])]

    def reader(self, name: str):
        path = self.dir / "metrics" / f"{name}.py"
        spec = importlib.util.spec_from_file_location(f"bench_metric_{name.replace('.', '_')}",
                                                      path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod.read


def forbidden_modules(names=None) -> List[str]:
    """Loaded modules (``names``: by default ``sys.modules``) whose
    top-level name is JAX's or the JAX package's."""
    names = list(sys.modules) if names is None else names
    return sorted({m.split(".")[0] for m in names} & set(FORBIDDEN))


def build_engine(target, draft, engine_settings: dict, max_model_len: int, device):
    from repro_torch.serving.api import EngineConfig
    from repro_torch.serving.engine import Engine
    ecfg = EngineConfig(max_model_len=max_model_len, **engine_settings)
    return Engine(target, draft, ecfg, device=device)


def spec_window(engine_settings: dict) -> int:
    """The speculation window admission reserves (the engine's max_dl)."""
    from repro_torch.serving.api import EngineConfig
    return EngineConfig(**engine_settings).spec_window


def _free() -> None:
    import torch
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


def run_cell(man: Manifest, cell: dict, seed: int, seconds: float, trace: bool, device,
             t_start: float, control: bool = False, compare: bool = True) -> dict:
    """One run; returns the result's fields (``checks`` last).  The
    calibration (``calibrate.py``) adds the control's readings
    (``control``) or skips the comparison (``compare=False``)."""
    import torch

    from benchkit import check, drive
    from benchkit.readings import Run
    from benchkit.trace import Hooks, summarize
    from benchkit.traffic import Traffic

    cfg = man.config(cell)
    fam = cfg.family
    mix = man.traffic(cell)
    engine_settings = dict(mix["engine"])
    traffic = Traffic(mix, seed, cfg.vocab)
    mml = traffic.max_model_len(spec_window(engine_settings),
                                int(engine_settings.get("page_size", 16)))
    target, draft = fam.pair(cfg.model, seed, mml, device)
    eng = build_engine(target, draft, engine_settings, mml, device)
    loop = drive.LoadLoop(eng, traffic)
    hooks = Hooks(device) if trace else None
    loop.run(seconds, tail_s=float(mix.get("trace_seconds", 3.0)) if trace else 0.0, hooks=hooks)
    rec = loop.rec
    drive.report_steps(rec)
    n_check = int(mix.get("check_requests", 4))
    if sum(r.finished is not None for r in rec.reqs.values()) < n_check:
        loop.drain_finished(n_check)
    loop.close()
    summary = summarize(hooks.trace) if trace else None
    run = Run(cfg=cfg, mix=mix, rec=rec, setup_s=rec.t0 - t_start, hooks=hooks, summary=summary)
    metrics = {}
    for m in man.metrics(cell, trace):
        value = man.reader(m["name"])(run)
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    is_cuda = torch.device(device).type == "cuda"
    dev = {"platform": "gpu" if is_cuda else "cpu",
           "kind": torch.cuda.get_device_name(torch.device(device)) if is_cuda else "cpu",
           "count": 1,
           "memory_peak_bytes": int(torch.cuda.max_memory_allocated(device)) if is_cuda else 0}
    if trace:
        dev["busy_s"], dev["window_s"] = summary["busy_s"], summary["window_s"]
    live = [r for r in rec.reqs.values() if r.first is not None and r.first <= rec.t1
            and (r.finished is None or r.finished > rec.t0)]
    attempted = len(live)
    failed = sum(1 for r in live if r.finished is not None and r.reason not in ("length", "stop"))
    picks = check.sample(rec.reqs, seed, n_check)
    seqs = [(eng.request(rid).prompt.copy(), eng.output_tokens(rid).numpy().copy())
            for rid in picks]
    props = [list(loop.proposals.by_rid.get(rid, [])) for rid in picks]
    kept = fam.keep(cfg.model, target, draft)
    del loop, eng, target, draft, hooks, run
    _free()
    t_ref = time.perf_counter()
    readings = {}
    if seqs and compare:
        readings.update(check.target_gaps(cfg, seed, seqs, device, control=control))
        readings.update(check.draft_gaps(cfg, seed, kept, seqs, props, device, control=control))
    del kept
    print(f"timing: set-up {rec.t0 - t_start:.3f} s, window {rec.window_s:.3f} s, "
          f"comparison {time.perf_counter() - t_ref:.3f} s", file=sys.stderr)
    checks = {name: {"value": readings.get(name), "limit": limit}
              for name, limit in cfg.check.items()}
    correct = (bool(seqs) and bool(checks) and failed == 0
               and all(None not in (c["value"], c["limit"]) and c["value"] <= c["limit"]
                       for c in checks.values()))
    result = {"correct": correct, "attempted": attempted, "failed": failed,
              "metrics": metrics, "device": dev}
    if trace:
        result["breakdown"] = {"device_ops": summary["device_ops"],
                               "idle_gaps": summary["idle_gaps"]}
    result["readings"] = readings
    result["checks"] = checks
    return result


def main(argv: List[str], root: pathlib.Path, t_start: float) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    man = Manifest(root)
    cell = man.cell(args.workload)
    import torch
    if not torch.cuda.is_available() or torch.cuda.device_count() < int(cell["chips"]):
        print(f"needs {cell['chips']} CUDA device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 3
    torch.cuda.set_device(0)
    torch.set_num_threads(1)
    result = run_cell(man, cell, args.seed, args.seconds, bool(args.trace), "cuda:0", t_start)
    bad = forbidden_modules()
    if bad:
        print(f"modules of JAX or the JAX package were loaded: {bad}", file=sys.stderr)
        return 4
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0

"""Shared set-up of the harness's CPU tests: the benchmark's folder on the
path, and a scratch checkout whose manifest names smoke-sized cells made
of new files only (a config, a mix and a metric that the benchmark does
not have), as a later change would add them, and a family the benchmark
does not have: a new builder and reference, found by the config's
``family``."""
from __future__ import annotations

import json
import pathlib
import shutil
import sys

BENCH = pathlib.Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
for p in (str(BENCH), str(ROOT / "src")):
    if p not in sys.path:
        sys.path.insert(0, p)

DATA = BENCH / "tests" / "data"

NEW_METRIC = '''"""served_per_request (tokens/request): output tokens streamed in the
window over the requests that streamed them (a metric added as a file)."""


def read(run):
    emits = run.window_emits()
    rids = {rid for rid, _, _ in emits}
    return sum(k for _, _, k in emits) / len(rids) if rids else None
'''


def scratch_checkout(tmp: pathlib.Path) -> pathlib.Path:
    """A copy of the benchmark's folder plus new files, and a manifest
    that names the benchmark's metrics and the new cells, mix, family and
    metric."""
    bench = tmp / "bench"
    shutil.copytree(BENCH, bench, ignore=shutil.ignore_patterns("__pycache__", "tests"))
    before = {p.relative_to(bench): p.read_bytes() for p in bench.rglob("*") if p.is_file()}
    for sub in ("configs", "traffic", "families"):
        for f in (DATA / sub).iterdir():
            assert not (bench / sub / f.name).exists()
            shutil.copy(f, bench / sub / f.name)
    (bench / "metrics" / "served_per_request.py").write_text(NEW_METRIC)
    manifest = json.loads((ROOT / "BENCHMARK.json").read_text())
    configs = {"q": "qwen3-smoke-w4a8", "n": "nemotron-smoke-bf16", "s": "selfdraft-smoke-bf16"}
    manifest["configs"] += [{"name": c, "source": "smoke", "file": f"bench/configs/{c}.json",
                             "reduced": [], "why": "CPU test"} for c in configs.values()]
    cells = {f"{k}.open": c for k, c in configs.items()}
    manifest["workloads"] += [{"name": n, "config": c, "traffic": "smoke-open", "chips": 1,
                               "why": "CPU test"} for n, c in cells.items()]
    for m in manifest["end_to_end"] + manifest["per_layer"]:
        if "workloads" in m:
            m["workloads"] += list(cells)
    manifest["per_layer"].append({"name": "served_per_request", "unit": "tokens/request",
                                  "better": "higher", "source": "host_clock", "layer": "engine",
                                  "moves": "tokens_per_s", "workloads": ["q.open"]})
    (tmp / "BENCHMARK.json").write_text(json.dumps(manifest))
    after = {p.relative_to(bench): p.read_bytes() for p in bench.rglob("*") if p.is_file()}
    assert all(after[k] == v for k, v in before.items()), "an existing file was edited"
    return tmp

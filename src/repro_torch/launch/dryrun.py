"""Dry-run of every (arch x shape) cell on the production meshes, on meta
tensors (torch counterpart of repro/launch/dryrun.py):

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen3-8b --shape train_4k
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --both-meshes --out dryrun.json

Each cell is built by ``launch.steps.build_cell`` on the abstract mesh of
rank 0 (``launch.mesh.make_mesh("meta", 16, 16)``, or 2 x 16 x 16 with
``--multi-pod``) and its step runs once on meta tensors at the rank's
shard shapes: no device, no memory, no compiler.  What the run counts is
per device (rank 0's program):

* FLOPs: ``torch.utils.flop_counter.FlopCounterMode`` over every op, the
  backward of a train step included.  A kernel's plain version runs on
  meta (its FLOPs counted as the plain version does the work).  The
  card's row padding is not counted: on the card ``layers.linear``,
  ``flash_attention`` and ``moe_apply_dense`` pad their rows to blocks of
  ``ROW_BLOCK`` (128) so that a row's bits do not depend on the call's
  row count, and on meta they take the rows as they are, so a decode
  step of 4 rows is charged the products of 4 rows where the card
  computes 128 (up to 32x fewer FLOPs than the card does, the useful
  ones).
* Bytes: a ``TorchDispatchMode`` adds each op's input and output bytes
  (views move nothing and are skipped).  The count is unfused, an upper
  bound of what the device moves: every intermediate is charged as if it
  went to HBM and back.  A kernel call (K1, K2, K7) is charged the bytes
  the kernel itself moves (``core/costs.py``: packed int4 weights, the
  int8 cache with its scales), not its plain version's dequantized
  copies (``kernels._lib.plain``).
* Collectives: the meta mesh's ``comm`` log, by kind, with each call's
  axis size.
* Memory: argument and output bytes from the shard shapes; temp as the
  peak of the live op outputs during the step (tensors freed as their
  last reference goes, as on the card's caching allocator without its
  rounding).

Calibration is kept from the reference (``_cal_configs`` /
``_extrapolate``): the cell runs again at depth 1 and 2 and metric(L) = a
+ b L is extrapolated to the full depth.  The port traces every layer
(there is no scan whose body a compiler counts once), so for a
homogeneous stack the extrapolation equals the full trace; the record
keeps both (``raw``, ``corrected``).

The roofline charges the NVIDIA H100 SXM5 80GB datasheet: 989 TFLOP/s
dense bf16, 3.35 TB/s HBM3, 900 GB/s NVLink per GPU.  An axis of up to 8
ranks is one NVLink domain (one 8-GPU node); an axis wider than that
crosses nodes and is charged 50 GB/s per GPU (one 400 Gb/s NDR
InfiniBand link per GPU, the DGX H100 layout) for all of its bytes, a
lower bound of the time since a hierarchical collective would move part
of them over NVLink.  Ring factors per kind follow the reference's on an
axis of n ranks: 2 (n-1)/n for an all-reduce, (n-1)/n otherwise.

Not ported: the reference's ``parse_collectives`` reads the collectives
out of XLA's compiled HLO text; the port compiles nothing, so its
collectives are the ones the mesh's functions record as they run.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import sys
import time
import weakref
from typing import Any, Dict, Optional, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.core.tree import tree_leaves
from repro_torch.kernels import _lib

__all__ = ["PEAK_FLOPS", "HBM_BW", "NVLINK_BW", "NET_BW", "NVLINK_DOMAIN", "ring_factor",
           "KINDS", "measure_cell", "roofline_terms", "model_flops", "dryrun_cell", "main"]

# NVIDIA H100 SXM5 80GB datasheet (per GPU)
PEAK_FLOPS = 989e12  # dense bf16 tensor-core FLOP/s
HBM_BW = 3.35e12  # HBM3 bytes/s
NVLINK_BW = 900e9  # NVLink 4 bytes/s per GPU, within one 8-GPU node
NET_BW = 50e9  # bytes/s per GPU across nodes (one 400 Gb/s NDR InfiniBand link per GPU)
NVLINK_DOMAIN = 8  # GPUs per NVLink domain

# the mesh's collectives under the reference's (XLA's) names
KINDS = {"all_reduce": "all-reduce", "all_gather": "all-gather",
         "reduce_scatter": "reduce-scatter", "all_to_all": "all-to-all"}


def ring_factor(kind: str, n: int) -> float:
    """Bytes over the busiest link per byte of a collective on n ranks."""
    if n <= 1:
        return 0.0
    return (2.0 if kind == "all-reduce" else 1.0) * (n - 1) / n


def _nbytes(t) -> int:
    return t.numel() * t.element_size() if isinstance(t, torch.Tensor) else 0


class _Traffic(TorchDispatchMode):
    """Bytes of every op (inputs + outputs, views skipped) and the peak of
    the live op outputs; a kernel call on meta (``_lib.plain``) is charged
    its own bytes and its plain version's ops are skipped."""

    def __init__(self):
        super().__init__()
        self.bytes = 0
        self.kernel_bytes: Dict[str, float] = {}
        self.live = 0
        self.peak = 0
        self._skip = 0

    @contextlib.contextmanager
    def kernel(self, name: str, nbytes: float):
        """``_lib.charge``: a kernel call, charged ``nbytes``."""
        if self._skip == 0:
            self.bytes += nbytes
            self.kernel_bytes[name] = self.kernel_bytes.get(name, 0) + nbytes
        self._skip += 1
        try:
            yield
        finally:
            self._skip -= 1

    def _free(self, n: int) -> None:
        self.live -= n

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if func.is_view:
            return out
        outs = [t for t in tree_leaves(out) if isinstance(t, torch.Tensor)]
        if self._skip == 0:
            ins = tree_leaves((list(args), kwargs or {}))
            self.bytes += sum(_nbytes(t) for t in ins) + sum(_nbytes(t) for t in outs)
        for t in outs:
            n = _nbytes(t)
            self.live += n
            weakref.finalize(t, self._free, n)
        self.peak = max(self.peak, self.live)
        return out


def _collectives(log) -> Dict[str, Dict[str, Any]]:
    """Per kind: bytes, calls, and the roofline's link-time at its axis sizes."""
    out: Dict[str, Dict[str, Any]] = {}
    for name, _axes, n, nbytes in log:
        kind = KINDS[name]
        slot = out.setdefault(kind, {"bytes": 0.0, "count": 0, "link_s": 0.0})
        slot["bytes"] += float(nbytes)
        slot["count"] += 1
        bw = NVLINK_BW if n <= NVLINK_DOMAIN else NET_BW
        slot["link_s"] += nbytes * ring_factor(kind, n) / bw
    return out


def measure_cell(cfg, shape, mesh, want_memory: bool = True, quant: Optional[str] = None,
                 s_max: Optional[int] = None) -> Dict[str, Any]:
    """Build the cell on ``mesh`` (meta; a prefill cache ``s_max`` deep)
    and run its step once under the counters -> {kind, trace_s, flops,
    bytes, kernel_bytes, collectives[, memory]}."""
    from repro_torch.launch.steps import build_cell

    t0 = time.perf_counter()
    mesh.comm.clear()
    cell = build_cell(cfg, shape, mesh, quant=quant, s_max=s_max)
    args_bytes = sum(_nbytes(t) for t in tree_leaves(list(cell.args)))
    mesh.log = []
    traffic = _Traffic()
    _lib.charge = traffic.kernel
    try:
        with FlopCounterMode(display=False) as flops, traffic:
            out = cell.fn(*cell.args)
    finally:
        _lib.charge = None
        log, mesh.log = mesh.log, None
    rec = {"kind": cell.kind + (f"-{quant}" if quant else ""),
           "trace_s": round(time.perf_counter() - t0, 3),
           "flops": float(flops.get_total_flops()), "bytes": float(traffic.bytes),
           "kernel_bytes": traffic.kernel_bytes, "collectives": _collectives(log)}
    if want_memory:
        rec["memory"] = {"argument_bytes": args_bytes,
                         "output_bytes": sum(_nbytes(t) for t in tree_leaves(list(out))),
                         "temp_bytes": traffic.peak}
    return rec


def _cal_configs(cfg) -> Tuple[Any, Any, int]:
    """Two shallow configs + the full trip count for the linear
    extrapolation (weight shapes identical to the full config)."""
    from repro_torch.models.common import Family

    if cfg.family is Family.HYBRID:
        rem = cfg.n_layers % cfg.attn_every
        mk = lambda ng: dataclasses.replace(  # noqa: E731
            cfg, n_layers=cfg.attn_every * ng + rem, scan_layers=False)
        return mk(1), mk(2), cfg.n_layers // cfg.attn_every
    if cfg.family is Family.AUDIO:
        mk = lambda n: dataclasses.replace(  # noqa: E731
            cfg, n_layers=n, n_encoder_layers=n, scan_layers=False)
        return mk(1), mk(2), cfg.n_layers
    mk = lambda n: dataclasses.replace(cfg, n_layers=n, scan_layers=False)  # noqa: E731
    return mk(1), mk(2), cfg.n_layers


def _extrapolate(f1: Dict, f2: Dict, trips: int) -> Dict[str, Any]:
    """metric(T) = a + b T fitted on T = 1, 2 -> its value at T = trips."""

    def lin(v1, v2):
        b = v2 - v1
        return max(v1 - b + b * trips, 0.0)

    coll = {}
    for k in set(f1["collectives"]) | set(f2["collectives"]):
        c1 = f1["collectives"].get(k, {"bytes": 0.0, "count": 0, "link_s": 0.0})
        c2 = f2["collectives"].get(k, {"bytes": 0.0, "count": 0, "link_s": 0.0})
        coll[k] = {"bytes": lin(c1["bytes"], c2["bytes"]),
                   "count": int(round(lin(c1["count"], c2["count"]))),
                   "link_s": lin(c1["link_s"], c2["link_s"])}
    return {"flops": lin(f1["flops"], f2["flops"]), "bytes": lin(f1["bytes"], f2["bytes"]),
            "collectives": coll}


def roofline_terms(flops: float, bytes_: float, coll: Dict) -> Dict[str, float]:
    """The three roofline terms of one device's step against the H100 SXM5
    datasheet (module docstring)."""
    return {
        "t_compute": flops / PEAK_FLOPS,
        "t_memory": bytes_ / HBM_BW,
        "t_collective": sum(v["link_s"] for v in coll.values()),
        "flops_per_device": flops,
        "bytes_per_device": bytes_,
        "collective_bytes_per_device": sum(v["bytes"] for v in coll.values()),
    }


def model_flops(cfg, shape) -> float:
    """Analytic MODEL_FLOPS: 6 N D to train, 2 N_active D forward (whole
    cell; divide by the devices)."""
    from repro_torch.launch.steps import param_counts

    n_active = param_counts(cfg)["active"]
    if shape.kind == "train":
        return 6.0 * n_active * shape.global_batch * shape.seq_len
    if shape.kind == "prefill":
        return 2.0 * n_active * shape.global_batch * shape.seq_len
    return 2.0 * n_active * shape.global_batch


def _finish(rec: Dict[str, Any], corr: Dict[str, Any], cfg, shape, n_chips: int) -> None:
    rec["corrected"] = corr
    rec["roofline"] = roofline_terms(corr["flops"], corr["bytes"], corr["collectives"])
    mf = model_flops(cfg, shape) / n_chips
    rec["roofline"]["model_flops_per_device"] = mf
    rec["roofline"]["useful_flops_ratio"] = mf / corr["flops"] if corr["flops"] else 0.0
    terms = {k: rec["roofline"][f"t_{k}"] for k in ("compute", "memory", "collective")}
    rec["roofline"]["bottleneck"] = max(terms, key=terms.get)


def dryrun_cell(arch: str, shape_name: str, multi_pod: bool = False,
                calibrate: bool = True) -> Dict[str, Any]:
    """One cell's record on the meta production mesh."""
    from repro_torch.configs import get_config, shape_applicable
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models.common import SHAPES

    if not shape_applicable(arch, shape_name):
        return {"arch": arch, "shape": shape_name, "status": "skipped",
                "reason": "long_500k needs sub-quadratic attention"}
    cfg = get_config(arch)
    shape = SHAPES[shape_name]
    mesh = make_mesh("meta", 16, 16, 2 if multi_pod else None)
    full = measure_cell(cfg, shape, mesh, True)
    rec: Dict[str, Any] = {
        "arch": arch, "shape": shape_name, "mesh": dict(mesh.shape), "n_chips": mesh.size,
        "status": "ok", "kind": full["kind"], "trace_s": full["trace_s"],
        "memory": full["memory"], "kernel_bytes": full["kernel_bytes"],
        "raw": {k: full[k] for k in ("flops", "bytes", "collectives")}}
    if calibrate:
        c1, c2, trips = _cal_configs(cfg)
        corr = _extrapolate(measure_cell(c1, shape, mesh, False),
                            measure_cell(c2, shape, mesh, False), trips)
    else:
        corr = rec["raw"]
    _finish(rec, corr, cfg, shape, mesh.size)
    return rec


def _print(rec: Dict[str, Any]) -> None:
    if rec["status"] == "ok":
        r = rec["roofline"]
        print(f"    kind={rec['kind']} trace={rec['trace_s']}s "
              f"flops/dev={r['flops_per_device']:.3e} bytes/dev={r['bytes_per_device']:.3e} "
              f"coll/dev={r['collective_bytes_per_device']:.3e}B\n"
              f"    t_comp={r['t_compute'] * 1e3:.2f}ms t_mem={r['t_memory'] * 1e3:.2f}ms "
              f"t_coll={r['t_collective'] * 1e3:.2f}ms bottleneck={r['bottleneck']} "
              f"useful={r['useful_flops_ratio']:.2f}", flush=True)
    elif rec["status"] == "skipped":
        print(f"    skipped: {rec['reason']}", flush=True)
    else:
        print(f"    FAILED: {rec.get('error')}", flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--no-calibrate", action="store_true")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)

    from repro_torch.configs import cells

    if args.all:
        todo = cells()
    else:
        if not (args.arch and args.shape):
            ap.error("--arch and --shape, or --all")
        todo = [(args.arch, args.shape)]
    meshes = [False, True] if args.both_meshes else [args.multi_pod]
    records = []
    t0 = time.perf_counter()
    for arch, shape in todo:
        for mp in meshes:
            print(f"=== {arch} x {shape} x {'2x16x16' if mp else '16x16'}", flush=True)
            try:
                rec = dryrun_cell(arch, shape, multi_pod=mp, calibrate=not args.no_calibrate)
            except Exception as e:  # a failing cell is a bug: surface it
                rec = {"arch": arch, "shape": shape, "multi_pod": mp, "status": "FAILED",
                       "error": f"{type(e).__name__}: {e}"}
            records.append(rec)
            if args.out:  # progress after every cell
                with open(args.out, "w") as f:
                    json.dump(records, f, indent=1)
            _print(rec)
    failed = [r for r in records if r["status"] == "FAILED"]
    print(f"done: {len(records)} cells, {len(failed)} failed, "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())

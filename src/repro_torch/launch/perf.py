"""Perf-iteration harness over the dry-run (torch counterpart of
repro/launch/perf.py): trace a cell under config variants on the meta
production mesh and diff the roofline terms.

    python -m repro_torch.launch.perf --arch deepseek-67b --shape decode_32k \\
        --variant baseline --variant kvq8 --variant w4a8 --variant w4a8+kvq8
    python -m repro_torch.launch.perf --arch llama3-405b --shape train_4k \\
        --set seq_shard=False

Named variants:
  baseline       the dry-run configuration as-is
  kvq8           INT8 KV cache with per-token-per-head scales
  w4a8           W4A8 weights + LRU rotation (serving path; decode, dense)
  w4a8+kvq8      both
  nosp           seq_shard=False (replicated residual, Megatron-SP off)
  noremat        remat=False
  nofsdp         fsdp=False
  capacity1      MoE capacity_factor=1.0

The W4A8 cells (``build_quantized_decode_cell``) run the port's W4A8
forwards on the rank's prepacked shard (FSDP-cut where the config says
so); on meta K1, K2 and K7 are charged their own bytes
(``launch/dryrun.py``).  Every number is the dry-run's: per device,
against the H100 SXM5 datasheet constants."""
from __future__ import annotations

import argparse
import dataclasses
import json
import sys
from typing import Any, Dict

__all__ = ["NAMED_VARIANTS", "build_quantized_decode_cell", "measure_variant", "main"]

NAMED_VARIANTS: Dict[str, Dict[str, Any]] = {
    "baseline": {},
    "kvq8": {"kv_quant": True},
    "w4a8": {"__quant__": "w4a8"},
    "w4a8+kvq8": {"__quant__": "w4a8", "kv_quant": True},
    "w4a8+kvq8+nofsdp": {"__quant__": "w4a8", "kv_quant": True, "fsdp": False},
    "nosp": {"seq_shard": False},
    "noremat": {"remat": False},
    "nofsdp": {"fsdp": False},
    "capacity1": {"capacity_factor": 1.0},
}


def build_quantized_decode_cell(cfg, shape, mesh, seed: int = 0):
    """The W4A8 serving cell (the dense family's W4A8 + LRU target, the
    MoE family's W4A8 MoE) of a decode (B, 1) or prefill (B, S) shape on
    this rank of ``mesh``: ``launch.steps.build_cell(..., quant="w4a8")``."""
    from repro_torch.launch.steps import build_cell

    return build_cell(cfg, shape, mesh, seed=seed, quant="w4a8")


def measure_variant(arch: str, shape_name: str, overrides: Dict[str, Any],
                    multi_pod: bool = False) -> Dict[str, Any]:
    """One variant of a cell: the dry-run's full trace (memory) and its
    depth-1 / depth-2 calibration, extrapolated, and the roofline terms."""
    from repro_torch.configs import get_config
    from repro_torch.launch.dryrun import _cal_configs, _extrapolate, measure_cell, roofline_terms
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models.common import SHAPES

    overrides = dict(overrides)
    quant = overrides.pop("__quant__", None)
    cfg = dataclasses.replace(get_config(arch), **overrides)
    shape = SHAPES[shape_name]
    mesh = make_mesh("meta", 16, 16, 2 if multi_pod else None)
    full = measure_cell(cfg, shape, mesh, True, quant)
    c1, c2, trips = _cal_configs(cfg)
    corr = _extrapolate(measure_cell(c1, shape, mesh, False, quant),
                        measure_cell(c2, shape, mesh, False, quant), trips)
    return {"arch": arch, "shape": shape_name, "overrides": overrides, "quant": quant,
            "memory": full["memory"], "kernel_bytes": full["kernel_bytes"], "corrected": corr,
            "roofline": roofline_terms(corr["flops"], corr["bytes"], corr["collectives"])}


def _parse_set(items) -> Dict[str, Any]:
    ov: Dict[str, Any] = {}
    for kv in items:
        k, val = kv.split("=", 1)
        v: Any = {"True": True, "False": False}.get(val, val)
        if isinstance(v, str):
            for cast in (int, float):
                try:
                    v = cast(val)
                    break
                except ValueError:
                    pass
        ov[k] = v
    return ov


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", required=True)
    ap.add_argument("--variant", action="append", default=[])
    ap.add_argument("--set", action="append", default=[], help="field=value config override")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)

    variants = [(v, dict(NAMED_VARIANTS[v])) for v in args.variant]
    if args.set:
        variants.append(("custom:" + ",".join(args.set), _parse_set(args.set)))
    if not variants:
        variants = [("baseline", {})]
    results, base = [], None
    for name, ov in variants:
        print(f"=== {args.arch} x {args.shape} [{name}]", flush=True)
        rec = measure_variant(args.arch, args.shape, ov, multi_pod=args.multi_pod)
        rec["variant"] = name
        results.append(rec)
        r = rec["roofline"]
        line = (f"    t_comp={r['t_compute'] * 1e3:.2f}ms t_mem={r['t_memory'] * 1e3:.2f}ms "
                f"t_coll={r['t_collective'] * 1e3:.2f}ms "
                f"args={rec['memory']['argument_bytes']}")
        if base is None:
            base = r
        else:
            line += (f"  | vs baseline: comp x{r['t_compute'] / max(base['t_compute'], 1e-12):.3f}"
                     f" mem x{r['t_memory'] / max(base['t_memory'], 1e-12):.3f}"
                     f" coll x{r['t_collective'] / max(base['t_collective'], 1e-12):.3f}")
        print(line, flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(results, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())

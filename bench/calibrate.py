"""Calibration runs of one cell, many seeds in one process (the CUDA
context and the kernels are paid once for all)::

    python3 bench/calibrate.py --workload <cell> --seeds 1,2,3 --seconds 10 \
        [--no-compare] [--out cal.jsonl]

Each seed's run is a normal run (``benchkit.cli.run_cell``) plus the
control's readings (the reference one precision step lower in the
program's place, at the same prompts, served tokens and draft proposals):
the program's readings over a dozen seeds set a limit's lower end, the
control's its upper end.  Where the draft is BVQ, a planted fault reads
the draft's operand numbers once more: the program's compression of the
draft's first layer with its k-means stopped after the initialisation
(``kmeans_skipped_lloyd_gain``, ``kmeans_skipped_weight_err``).
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import pathlib  # noqa: E402
import sys  # noqa: E402

BENCH = pathlib.Path(__file__).resolve().parent
ROOT = BENCH.parent
sys.path[:0] = [str(BENCH), str(ROOT / "src")]

from benchkit import cli, weights  # noqa: E402


def kmeans_skipped(cfg, seed: int, device) -> dict:
    """The draft's operand numbers for its first layer compressed with
    ``kmeans_iters=0`` (the fault: the k-means never runs)."""
    from repro_torch.core import bvq as bvq_mod
    from reference import lm_ref
    m = cfg.model
    bcfg = bvq_mod.BVQConfig(**dict(m.bvq, kmeans_iters=0))
    gen = weights.generator(seed, "bvq", 0, device)
    lp = weights.layer(m.draft, seed, "draft", 0, device)
    gain = err = 0.0
    for w in list(lp["attn"].values()) + list(lp["mlp"].values()):
        if w.dim() < 2:
            continue
        w = w.reshape(-1, w.shape[-1]) if w.shape[0] != m.draft.d_model else w.reshape(w.shape[0], -1)
        bw = bvq_mod.bvq_compress(w.float(), bcfg, gen)
        cb = bvq_mod.dequant_codebooks(bw)
        dec = lm_ref.bvq_decode(cb, bw.indices)
        err = max(err, float((dec - w.float()).norm() / w.float().norm()))
        gain = max(gain, cfg.family.lloyd_gain(cb, bw.indices, w.float()))
    return {"kmeans_skipped_lloyd_gain": gain, "kmeans_skipped_weight_err": err}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--no-compare", action="store_true")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 3
    torch.set_num_threads(1)
    man = cli.Manifest(ROOT)
    cell = man.cell(args.workload)
    out = open(args.out, "a") if args.out else None
    t_start = T_START
    for seed in (int(s) for s in args.seeds.split(",")):
        torch.cuda.reset_peak_memory_stats()
        res = cli.run_cell(man, cell, seed, args.seconds, False, "cuda:0", t_start,
                           control=not args.no_compare, compare=not args.no_compare)
        cfg = man.config(cell)
        if not args.no_compare and getattr(cfg.model, "draft_mode", None) == "bvq":
            res["readings"].update(kmeans_skipped(cfg, seed, "cuda:0"))
        res.update(workload=args.workload, seed=seed, seconds=args.seconds)
        line = json.dumps(res)
        print(line, flush=True)
        if out:
            out.write(line + "\n")
            out.flush()
        t_start = time.perf_counter()
    return 0


if __name__ == "__main__":
    sys.exit(main())

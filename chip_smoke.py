"""Drive the PyTorch/CUDA port on one NVIDIA H100 and check it end to end.

    python3 chip_smoke.py             # every phase (what a GPU check runs)
    python3 chip_smoke.py --profile   # also profile a few rounds of ten paths
    python3 chip_smoke.py --mesh-only # the build and the mesh phases, no result line

Phases, in order (any failure exits non-zero before the final line):

1. Build: find nvcc and the card, compile src/repro_torch/kernels/csrc/*.cu
   for sm_90a into build/ (one nvcc per source, in parallel) and print the
   build seconds and each kernel's ptxas register / shared-memory report.
2. Kernels against their plain versions at the main path's full-width
   shapes: one JSON line per (kernel, shape) with the error, the stated
   tolerance, the kernel's and the plain version's times, one PyTorch
   library call's time as a yardstick, and the card's bound for the work
   (and, for every kernel, whether a second call is bitwise equal; for the
   LRU rotation, whether a row's bits are the same computed alone or among
   others; for the attention kernels, whether values past each row's
   length, poisoned, leave the output bitwise unchanged, and whether row 0
   of a window has the bits of the one-token step over the same
   positions).  The LRU rotation is timed as the plan-level R2 rotation
   (both stages of the target's tiled d_ff plan, one launch) at 1, 32, 72
   and 128 tokens, and as the single stage at 32.  Paged attention also
   runs windows wider than one 32-bit mask word (W = 33, 64, 129) at the
   target's shape, causal and tree, bf16 and int8.  The adaptive and WDOS
   paths' shapes run too: the R2 plan and w4a8 (four weight shapes, the
   head included) at M = 24 (a short_dl = 2 verify) and M = 56 (a WDOS
   verify at max_dl + 1 = 7), and paged attention at W = 3 and 7 (bf16,
   int8), the draft step and the tree verify with half the rows laid out
   as a fused slot's role mask leaves them (table all scratch, length the
   window): the other rows' bits must not change when the scratch page is
   poisoned.  The public configurations' shapes run last
   (``_family_kernel_cases``): paged attention at G = 4 and 6 (8 kv heads)
   and Moonlight's 16 heads, the Qwen3-8B R2 plan (m = 12) at 1, 32 and
   128 tokens, w4a8 at the 151,936- and 163,840-wide heads and K = 12288,
   bvq at the Qwen3-8B-width draft's weights.  Then K1 at Qwen3-8B's
   shard shapes for tp 2 and 4 (``_shard_kernel_cases``): column shards
   at N / tp, the head at vocab / tp, row shards (wo, w_down) at K / tp
   in the int32 epilogue (``w4a8_matmul_int32``: exact against the plain
   version) and scaled, at M = 4 and 256.
3. The main path at full width: the paper pair (LLaMA2-7B widths, W4A8 +
   LRU target with all 32 layers, built layer by layer; LLaMA-68M widths,
   BVQ draft) served by ``Engine`` at ``EngineConfig()`` defaults, 4 greedy
   requests with seeded 32-128-token prompts and max_tokens=32.  Launch
   counters are zeroed just before and read just after; every kernel of
   the path must have launched, and the LRU rotation once per layer of
   each target forward.  Speculative outputs are compared with a
   target-only greedy decode.
4. int8 path: the same pair and requests under ``EngineConfig(kv_quant=
   "int8")``; must launch the int8 paged body.  Its tokens are compared
   with the main path's (int8 KV changes the logits: reported, not gated).
5. Tree path: the same pair and requests under ``EngineConfig(kv_quant=
   "mixed", spec_mode="tree")`` with requests 1 and 3 pinned to int8 KV;
   must launch both tree bodies, and each row must equal the chain path of
   its kind (main path for fp rows, int8 path for int8 rows) except at a
   near-tie.
6. Sampled path: the main path's engine and requests with requests 0 and
   2 sampled (temperature 0.8, top-k 50, top-p 0.95, seed = request id):
   every main-path kernel launches (the rotation once per layer of each
   target forward), the greedy rows equal the main path's except at a
   near-tie, and a second engine gives identical tokens in every row.
7. Sampled tree path: every request sampled under the tree path's engine
   (requests 1 and 3 on int8 KV): both tree bodies launch, and a replay
   gives identical tokens.
8. Stop path: the main path's first request with a stop string made of
   two of its output tokens: the output is the main-path prefix before the
   match, finishes "stop", reaches the sink whole, and every page returns.
9. Adaptive path: the main path's greedy requests under
   ``EngineConfig(adaptive=True)`` (APSD short/long draft windows), one
   request admitted per step: every main-path kernel launches, and each
   row equals the main path's except at a near-tie.
10. WDOS path: ``EngineConfig(adaptive=True, par_mode="wdos")`` with the
   sampled path's requests, one admitted per step, after its two-phase
   twin (``adaptive=True``, same requests and arrivals) in the same call:
   every main-path kernel launches, some slot verifies one request while
   another drafts, each row equals the twin's (near-tie rule for greedy
   rows; for sampled rows, the first differing host decision taken from
   logit rows within NEAR_TIE), and a replay is identical.
11. WDOS tree path: the sampled tree path's engine with
   ``par_mode="wdos"``, one request admitted per step: both tree bodies
   launch, each row equals the sampled tree path's (decision rule), and a
   replay is identical.
12. Self-draft path: the paper target drafting for itself under
   ``adaptive=True``, greedy, one request admitted per step, two-phase and
   then WDOS: the controllers must reach PAR (a long_dl window in each
   run), the rotation runs once per layer of every forward, every proposal
   is accepted (acceptance 1.0: a row's bits do not depend on the row
   count), and each row equals the main path's except at a near-tie.
13. Prefix path: the pair under ``EngineConfig(prefix_cache=True)``, a
   160-token system prompt S: the donor S + 16 tokens alone, then nine
   followers at once (six S + a suffix, a fork S[:150] + 20 tokens, a full
   hit S[:130], a repeat of the donor), 32 tokens each, after its twin
   (the same arrivals, cache off): rows equal the twin's except at a
   near-tie, 9 hits, the tokens saved the workload implies, >= 2 copies
   on write, and every page the tree pinned after the donor bitwise
   unchanged after the followers.  Prefill wall per request (miss, tail
   hit, full hit) and the mirrors' copy bytes and ms, with and without.
14. Prefix mixed tree path: the same under ``kv_quant="mixed",
   spec_mode="tree"``, the donor once per kind, the followers alternating.
15. Byte budgets: ``pool_bytes`` at 4 and 1 GiB, pages per kind and the
   requests resident after one step with 16 queued, fp against int8.
16. QAT draft path: a dense LLaMA-68M-width draft compressed on the card
   with the pair's k-means settings and with the reference's QAT defaults
   (60 Gumbel-softmax steps): seconds and each linear's reconstruction
   MSE under both; the QAT draft then serves the main path's requests
   with the main target: bvq launches, rows equal the main path's except
   at a near-tie, acceptance printed.
17. Observed path: the main path's engine, then the WDOS path's
   (staggered, requests 0 and 2 sampled), each with a Tracer and
   ``profile_every_n=1``: rows bitwise equal to their unprofiled runs, the
   Chrome trace valid, the device track naming every program the path
   dispatched (prefill / draft / verify; prefill / fused_wdos /
   draft_slot), one flight record per round, and ``/metrics`` holding
   every family the JAX engine's registry renders.  Prints
   ``profile_summary()`` (calls, wall, FLOPs and bytes per call, achieved
   bytes/s against the card's memory rate).  A third profiled engine, two
   phases at a fixed draft length of the WDOS engine's long_dl, verifies
   the same (max_batch, 7) window a fused_wdos slot does: fused_wdos wall
   is printed against that verify plus draft_slot.  Last, the main path's
   tokens/s traced (profiling off) beside a plain run.
18. Server path: ``CompletionServer(AsyncEngine(Engine(pair,
   EngineConfig())))`` on 127.0.0.1: four concurrent completions (two SSE,
   one JSON, one sampled) equal to the main / sampled path's rows except
   at a near-tie; a stream that disconnects after 4 tokens and a saturated
   gate answering 429 return every page; /healthz, /stats, /metrics
   answer 200; w4a8, block_rotate, bvq and paged attention launch.  HTTP
   tokens/s and the TTFT / ITL means printed.  The engine is built on the
   index-less device "cuda", as the server CLI builds it.  Last, the CLI
   itself (``python -m repro_torch.serving.server --port 0``, its
   defaults: device cuda, the quantized smoke pair) in a child process:
   one streamed completion equals ``Engine.run`` of the same request, and
   /healthz answers 200; the process is stopped after.
19. Host path: the legacy host-gather loop (``serve_batch(..., BatchConfig(
   max_batch=4, max_tokens=32, kv_path="host"))``) over the main path's
   pair and requests: host pools, the whole (n_layers, 4, s_max, kv heads,
   hd) K and V buffers of each model uploaded and pulled back every round,
   one batched forward per draft step and per verify (the buffers read as
   a pool of one s_max-wide page per slot: the paged-attention kernel).
   Every main-path kernel launches, each row equals the main path's except
   at a near-tie, the sinks saw every token, ``kv_copy_s > 0``; prints
   tokens/s beside the main path's, rounds, copy ms and K/V bytes per
   round.
20. Quickstart path: examples/quickstart.py's steps through the port on
   the card: ``quantized_linear_apply`` (the W4A8 kernel) at M = 32 on
   (4096, 11008) and (11008, 4096), plain and LRU-rotated (the R2
   rotation kernel), each within rtol 1e-6 of the CPU plain version, with
   SQNR and kurtosis before / after; the draft's bits per weight; the
   Markov LM at vocab 64 through ``sd_generate`` / ``apsd_generate``
   (greedy equal to ``markov_greedy_decode``, sampled runs replay
   identically); ``fig6_table()`` inside ``PAPER_BANDS``.
21. Dense path: the bf16 pair at the paper's widths (``build_paper_pair(
   quantize=False)``, 6.7 B target parameters) at ``EngineConfig()``, the
   main path's prompts: paged attention launches, no matmul or rotation
   kernel does, and each row equals the target-only greedy decode through
   the paged path except at a near-tie (the dense-cache decode is
   compared and reported, as on the main path).  The pair is freed after
   it.
22. Qwen3 path: Qwen3-8B at full width and depth (36 layers, GQA 32/8,
   qk-norm, d_ff 12288, vocab 151,936) as a W4A8 + LRU target (R2 plan
   n = 12288, m = 12), built one layer at a time, with the same config cut
   to 2 layers as a BVQ draft: ``EngineConfig()`` (every main-path kernel
   launches, block_rotate once per layer of each target forward, rows
   equal the target-only paged greedy decode except at a near-tie), int8
   KV (reported against those rows), mixed KV + tree (both tree bodies;
   rows equal the chain rows of their kind except at a near-tie) and the
   target drafting for itself (``adaptive=True``: PAR, acceptance 1.0).
23. MoE path: ``moonshot-v1-16b-a3b`` as the repo defines it (48 layers,
   64 experts top-6, ~28 B parameters, ~56 GB in bf16) at full width and
   depth with a 2-layer draft, over paged KV at ``EngineConfig()``: paged
   attention launches and no quantized kernel does; rows equal the
   target-only paged greedy decode except at a near-tie of the top-2
   logits (no router excuse: one card, the same bits at any row count);
   a self-draft reaches PAR with acceptance 1.0; then the W4A8 MoE
   forward built from the same weights (the bf16 layers freed as they
   pack): a prefill and 16 greedy steps over a dense cache with the
   card's kernels and again with the plain versions on the card, both
   timed, tokens equal except at a near-tie (top-2, or the first
   differing expert selections of the row within ROUTER_NEAR_TIE in both
   runs), w4a8 launching only in the first.
24. Nemotron path: Nemotron-4-15B in bf16 (squared ReLU, GQA 48/8: G = 6,
   vocab 256,000, ~15.6 B parameters) at full width and depth with a
   2-layer draft, 2 requests x 16 tokens: paged attention launches, rows
   equal the target-only paged greedy decode except at a near-tie.
25. Card against CPU at smoke size: one smoke pair built on the CPU from a
   fixed seed, copied to the card; the same requests through the port on
   cuda (kernels) and on cpu (plain versions) with seven engines (greedy
   chain, greedy mixed-KV tree, sampled chain, sampled mixed-KV tree, a
   staggered adaptive WDOS chain with two sampled requests, and the prefix
   cache on the reference's prefix workload, fp chain and mixed-KV chain)
   and the legacy host-gather loop (two slots for the four requests)
   must give the same tokens, unless the first divergence is shown to be
   a near-tie: of the target's top-2 logits for a greedy row, or, for a
   sampled row, a host decision taken from logit rows that differ by at
   most NEAR_TIE between the devices; the prefix stats must be equal.
26. Families card against CPU: the smoke configs of phases 22-24
   (``qwen3-smoke`` W4A8 + BVQ in chain and mixed-KV tree engines,
   ``moonshot-smoke`` and ``nemotron-smoke`` bf16 chain), the same rule;
   a MoE row is also excused where card and CPU, replaying the row's
   common prefix, first select different experts only at router
   near-ties (k-th against (k+1)-th router logit within ROUTER_NEAR_TIE
   at that layer and token, in both runs).
27. Train path: ``launch.train.Trainer`` on mamba2-1.3b at full width,
   24 of its 48 layers (d 2048, bf16, float32 moments, remat), batch 4 x 512
   tokens, 8 steps with a checkpoint at step 4: losses and grad norms
   finite, parameters moved; step ms, tokens/s, peak GB and the model
   FLOPs over the bf16 peak; a fresh Trainer restores step 4 and its
   steps 5-7 give the first run's losses and grad norms bit for bit.
28. Draft train path: the paper's draft at LLaMA-68M widths trained 200
   steps on the synthetic stream (batch 32 x 256): the last loss below
   LOSS_DROP times the first; ms per step.
29. Elastic path: examples/train_and_recover.py's three phases through the
   port on mamba2-smoke (loss falls, a restart continues, an
   ElasticTrainer survives a lost node).
30. SSM families path: mamba2-1.3b, zamba2-7b and whisper-large-v3 at full
   width and depth, 2 x 16 greedy tokens through prefill and cached
   decode, in bf16 and then float32 (the same weights cast): float32
   tokens equal a full re-forward's argmax except at a near-tie; bf16
   decode logits within BF16_DECODE_FACTOR times the bf16 re-forward's
   distance from the float32 re-forward; card against CPU at smoke size.  Phases 27-30
   print their seconds.  Before them ``kvq8_path``: Qwen3-8B in bf16 with
   the dense int8 KV cache (``kv_quant``), every one-token step through K7,
   against its CPU twin (the reference's bfloat16 decode math).
31-34. The mesh (``MESH_PHASES``: the three serving paths share one
   (1, 2) world whose ranks run their jobs in turn after every one-device
   run; training and the elastic run share a (2, 2) world, the restore a
   (2, 1) one; the ranks share the card over gloo, after the kernels are
   built; every path prints each rank's backend and transport,
   collectives per decode step and peak memory, and frees everything): ``tp_path`` (Qwen3-8B W4A8 + LRU at full width
   and depth on (1, 2) against one device: prefill 4 x 64, 32 greedy
   steps; logits bit for bit, K1 scaled and int32 and K2 launched on
   every rank, K2 once per layer of each forward), ``tp_bf16_path``
   (Nemotron-4-15B bf16 on (1, 2), sequence sharding in the prefill;
   prefill logits within a bound, rows at bf16 near-ties: 2 ulps of the
   top logit), ``ep_path`` (the
   repo's Moonlight with ``moe_impl="a2a"`` on (1, 2), 32 experts a rank,
   nothing dropped: one bf16 layer against the dense combine, 8 layers in
   float32 against it end to end (prefill logits within a bound), one W4A8 layer against the dense combine
   on dequantized experts, and 8 W4A8 layers bit for bit the same function
   on one rank), ``mesh_train_path`` (LLaMA-68M widths on (2, 2) with
   ZeRO-1 and sequence sharding, 8 steps against one device, losses and
   grad norms within bounds; a checkpoint
   restored onto (1, 1) and (2, 1) bit for bit; an elastic run from 4
   ranks to 2).  The (1, 2) world also runs the launch cells
   (``launch.steps.build_cell`` prefill and decode cells, 4 x 64 prompts,
   16 decode steps teacher-forced on the one-device run's tokens):
   mamba2-1.3b, zamba2-7b and whisper-large-v3 in bf16 at full width
   (depth cut: ``CELLS``; every step's logits within a bound read on the
   card), and Qwen3-8B's ``w4a8+kvq8`` cell (K1, K2 and K7; bit for
   bit); then
   ``dryrun_path``: the dry-run's meta (1, 2) trace of those cells logs
   exactly the world's collectives (gated), its roofline step time beside
   the measured one, and a subset of the dry-run CLI's grid.
   ``--cpu-dry-run`` runs the mesh phases at smoke size on the CPU.

Each path prints its tokens/s, rounds, target forwards per emitted token,
device-to-host copies per round and, on a WDOS engine, its fused-slot
summary; ``--profile`` adds a torch.profiler breakdown (device busy share,
kernels, launches and copies, host time, launches per target forward) of
three rounds of the main, tree, sampled, sampled tree, WDOS, WDOS tree,
dense, Qwen3, MoE and Nemotron paths, and one step of each training path.

The last two lines are the kernels summary (JSON) and the result line
``{"ok": true, "device": {...}}``.  Weights are random, made from SEED.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import math
import os
import shutil
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

SEED = 0
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory
PEAK_OPS = {"int8": 1979e12, "bf16": 989e12, "f32": 67e12}  # dense, published
NEAR_TIE = 2e-2  # top-2 logit margin below which a card/CPU divergence is a tie:
# a last-bit difference can move one dynamic int8 activation across a .5
# boundary, which shifts a logit by up to ~1e-2 (tests/test_torch_models.py)
ROUTER_NEAR_TIE = 2e-2  # router k-th vs (k+1)-th logit margin below which a
# last-bit difference of the same size may pick another expert: held by
# (layer, token) where two runs first select different experts
# (``_expert_flips``), and only where two runs compute different bits (card
# against CPU, kernel against plain version); runs on one card get no excuse

KERNELS = {
    "w4a8_matmul": ("src/repro_torch/kernels/csrc/w4a8_matmul.cu",
                    "src/repro/kernels/w4a8_matmul.py:69"),
    "block_rotate": ("src/repro_torch/kernels/csrc/fwht.cu",
                     "src/repro/kernels/fwht.py:79"),
    "bvq_matmul": ("src/repro_torch/kernels/csrc/bvq_matmul.cu",
                   "src/repro/kernels/bvq_matmul.py:57"),
    "paged_attention": ("src/repro_torch/kernels/csrc/paged_attn.cu",
                        "src/repro/kernels/paged_attn.py:184"),
    "paged_attention_int8": ("src/repro_torch/kernels/csrc/paged_attn.cu",
                             "src/repro/kernels/paged_attn.py:158"),
    "paged_attention_tree": ("src/repro_torch/kernels/csrc/paged_attn.cu",
                             "src/repro/kernels/paged_attn.py:167"),
    "paged_attention_int8_tree": ("src/repro_torch/kernels/csrc/paged_attn.cu",
                                  "src/repro/kernels/paged_attn.py:175"),
    "decode_attention_int8": ("src/repro_torch/kernels/csrc/decode_attn.cu",
                              "src/repro/kernels/decode_attn.py:81"),
    # K1's int32 epilogue: the row-parallel shards' accumulators
    "w4a8_matmul_int32": ("src/repro_torch/kernels/csrc/w4a8_matmul.cu",
                          "src/repro/kernels/w4a8_matmul.py:69"),
    # K8: the reference's prefill attention is plain jnp (models/layers.py)
    "prefill_attention": ("src/repro_torch/kernels/csrc/prefill_attn.cu", "none"),
}
# the path whose run each kernel's launches are read from (counts zeroed
# just before that path, read just after)
PATH_OF = {"w4a8_matmul": "main_path", "block_rotate": "main_path", "bvq_matmul": "main_path",
           "paged_attention": "main_path", "paged_attention_int8": "int8_path",
           "paged_attention_tree": "tree_path", "paged_attention_int8_tree": "tree_path",
           "decode_attention_int8": "kvq8_path", "w4a8_matmul_int32": "tp_path",
           "prefill_attention": "main_path"}
# kernels no path launches (every kernel has its path)
NO_PATH = set()
# the CUDA symbols of the port's kernels, as the profiler names them
PORT_SYMBOLS = ("w4a8_mma_kernel", "bvq_mma_kernel", "block_rotate_kernel", "paged_attn_kernel",
                "decode_attn_int8_kernel", "prefill_attn_kernel")


def emit(**record) -> None:
    print(json.dumps(record), flush=True)


# ---------------------------------------------------------------------------
# Phase 1: build
# ---------------------------------------------------------------------------


def phase_build():
    from repro_torch.kernels import _lib

    nvcc = _lib.nvcc()
    ver = subprocess.run([nvcc, "--version"], capture_output=True, text=True, check=True)
    print(f"nvcc: {nvcc} :: {ver.stdout.strip().splitlines()[-1]}")
    path, report = _lib.build()
    print(f"built {path} in {report['seconds']:.1f} s")
    for src, text in report["ptxas"].items():
        for line in text.splitlines():
            if "Compiling entry" in line or "Used" in line or "spill" in line:
                print(f"  ptxas {src}: {line.strip()}")
    _lib.lib()


# ---------------------------------------------------------------------------
# Phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------


class Timer:
    """Median per-launch device time with a cold L2: a 64 MB buffer is read
    before every timed launch (the main path reads each weight once per
    forward, so it finds the L2 holding other, clean data too; a write
    would leave it dirty, and the write-backs would slow the timed
    launch).  A spin of ~0.2 ms on the card follows, so the host has
    queued the launch before the start event fires: the events then
    bracket device time, not the wrapper's host overhead."""

    SPIN_CYCLES = 400_000

    def __init__(self, device):
        self.scratch = torch.zeros(64 << 20, dtype=torch.uint8, device=device)

    def ms(self, fn, iters: int = 15) -> float:
        fn()
        torch.cuda.synchronize()
        pairs = []
        for _ in range(iters):
            self.scratch.sum()
            torch.cuda._sleep(self.SPIN_CYCLES)
            s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            s.record()
            fn()
            e.record()
            pairs.append((s, e))
        torch.cuda.synchronize()
        return float(np.median([s.elapsed_time(e) for s, e in pairs]))


def bound_ms(bytes_moved: float, ops: float, op_type: str):
    t_mem = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_OPS[op_type] * 1e3
    return (t_mem, "bytes") if t_mem >= t_ops else (t_ops, "operations")


def check_w4a8(dev, timer, g, m, k, n):
    from repro_torch.core import quantization as q
    from repro_torch.kernels import ref
    from repro_torch.kernels.w4a8_matmul import prepack, w4a8_matmul

    x = torch.randn((m, k), generator=g, device=dev)
    w = torch.randn((k, n), generator=g, device=dev) * 0.02
    xq, sx = q.quantize_act_int8(x)
    wq, sw = q.quantize_weight_int(w, bits=4, axis=0)
    wp = q.pack_int4(wq, axis=0)
    wpp = prepack(wp)  # the layout the model's weights are stored in
    got = w4a8_matmul(xq, wpp, sx, sw)
    want = ref.w4a8_matmul_ref2(xq, wp, sx, sw)
    err = max(float((got - want).abs().max()),
              float((w4a8_matmul(xq, wp, sx, sw) - want).abs().max()))  # reference layout
    tol = 1e-6 * float(want.abs().max())  # the reference test's rtol 1e-6
    w_deq = (wq.float() * sw).to(torch.bfloat16)
    xb = x.to(torch.bfloat16)
    bound, by = bound_ms(m * k + k * n / 2 + 4 * m + 4 * n + 4 * m * n, 2.0 * m * k * n, "int8")
    return dict(
        max_abs_err=err, tol=tol,
        repeat_bitwise_equal=bool(torch.equal(got, w4a8_matmul(xq, wpp, sx, sw))),
        kernel_ms=timer.ms(lambda: w4a8_matmul(xq, wpp, sx, sw)),
        plain_ms=timer.ms(lambda: ref.w4a8_matmul_ref2(xq, wp, sx, sw)),
        library_ms=timer.ms(lambda: torch.matmul(xb, w_deq)),
        bound_ms=bound, bound_by=by,
    )


def _rotation_stability(fn, x):
    """(repeat_bitwise_equal, rows_independent_of_M) of a rotation call:
    a second call gives the same bits, and rows of the call equal the same
    rows computed alone (first and last row) and in a 32-row prefix."""
    y = fn(x)
    tokens = x.shape[0]
    alone = all(torch.equal(y[i:i + 1], fn(x[i:i + 1])) for i in {0, tokens - 1})
    prefix = tokens <= 32 or torch.equal(y[:32], fn(x[:32]))
    return bool(torch.equal(y, fn(x))), bool(alone and prefix)


def _hb(m, k, dev):
    """kron(H_m, H_2^k) / sqrt(B) in bf16: one LRU block as a dense matrix."""
    from repro_torch.core import hadamard

    hb = np.kron(hadamard.hadamard_matrix(m), hadamard.hadamard_matrix(1 << k))
    return torch.as_tensor(hb / math.sqrt(m << k), dtype=torch.bfloat16, device=dev)


def check_block_rotate(dev, timer, g, tokens, n, m, k):
    """The single-stage entry (block_rotate_pallas's function)."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.fwht import block_rotate

    x = torch.randn((tokens, n), generator=g, device=dev).to(torch.bfloat16)
    got = block_rotate(x, m, k).float()
    want = ref.block_rotate_ref(x, m, k).float()
    b = m << k
    hb = _hb(m, k, dev)
    xv = x.view(tokens, n // b, b)
    repeat, rows = _rotation_stability(lambda t: block_rotate(t, m, k), x)
    # the kernel's arithmetic is float32 (CUDA cores)
    bound, by = bound_ms(2 * 2 * tokens * n + 2 * m * m, tokens * n * (k + 2 * m + 1), "f32")
    return dict(
        # bf16 tolerance of the reference test: the plain version rounds to
        # bf16 after every butterfly stage, the kernel once at the store
        max_abs_err=float((got - want).abs().max()), tol=5e-2,
        repeat_bitwise_equal=repeat, rows_independent_of_M=rows,
        kernel_ms=timer.ms(lambda: block_rotate(x, m, k)),
        plain_ms=timer.ms(lambda: ref.block_rotate_ref(x, m, k)),
        library_ms=timer.ms(lambda: torch.matmul(xv, hb)),
        bound_ms=bound, bound_by=by,
    )


def check_rotate_plan(dev, timer, g, tokens, n):
    """The plan-level entry on the target's online R2 rotation (ops.lru_rotate:
    both stages of a tiled plan in one launch).  Yardstick: the library
    composition of the same function, two batched torch.matmul by H_B and
    the two torch.roll, timed as one call sequence."""
    from repro_torch.core import rotation as rot
    from repro_torch.kernels import ref
    from repro_torch.kernels.fwht import rotate_plan

    plan = rot.plan_rotation(n)
    m, k, b = plan.m, plan.k, plan.block
    x = torch.randn((tokens, n), generator=g, device=dev).to(torch.bfloat16)
    got = rotate_plan(x, plan).float()
    want = ref.rotate_plan_ref(x, plan).float()
    hb = _hb(m, k, dev)

    def composition():
        y = torch.matmul(x.view(tokens, n // b, b), hb).view(tokens, n)
        y = torch.roll(y, -(b // 2), dims=-1)
        y = torch.matmul(y.view(tokens, n // b, b), hb).view(tokens, n)
        return torch.roll(y, b // 2, dims=-1)

    repeat, rows = _rotation_stability(lambda t: rotate_plan(t, plan), x)
    bound, by = bound_ms(2 * 2 * tokens * n + 2 * m * m,
                         plan.stages * tokens * n * (k + 2 * m + 1), "f32")
    err = (got - want).abs()
    return dict(
        # the reference test's bf16 tolerance, |err| <= tol + rtol * |want|:
        # the plain version rounds to bf16 after every butterfly of both
        # stages, the kernel once at the end of each stage
        max_abs_err=float(err.max()), tol=5e-2, rtol=5e-2,
        within_tol=bool((err <= 5e-2 + 5e-2 * want.abs()).all()),
        repeat_bitwise_equal=repeat, rows_independent_of_M=rows,
        kernel_ms=timer.ms(lambda: rotate_plan(x, plan)),
        plain_ms=timer.ms(lambda: ref.rotate_plan_ref(x, plan)),
        library_ms=timer.ms(composition),
        bound_ms=bound, bound_by=by,
    )


def check_bvq(dev, timer, g, m, k, n):
    from repro_torch.core import bvq
    from repro_torch.kernels import ref
    from repro_torch.kernels.bvq_matmul import bvq_matmul
    from repro_torch.launch.serve import PAIR_BVQ

    w = torch.randn((k, n), generator=g, device=dev) * 0.02
    bw = bvq.bvq_compress(w, PAIR_BVQ, g)
    cb, idx = bvq.dequant_codebooks(bw), bw.indices
    x = torch.randn((m, k), generator=g, device=dev).to(torch.bfloat16)
    got = bvq_matmul(x, cb, idx)
    want = ref.bvq_matmul_ref2(x, cb, idx)
    w_dense = bvq.reconstruct_dense(cb, idx).to(torch.bfloat16)
    bytes_moved = 2 * m * k + 4 * cb.numel() + 4 * idx.numel() + 4 * m * n
    bound, by = bound_ms(bytes_moved, 2.0 * m * k * n, "bf16")
    return dict(
        # same bf16 operands on both sides; f32 sums in another order
        max_abs_err=float((got - want).abs().max()),
        tol=1e-4 * (1.0 + float(want.abs().max())),
        repeat_bitwise_equal=bool(torch.equal(got, bvq_matmul(x, cb, idx))),
        kernel_ms=timer.ms(lambda: bvq_matmul(x, cb, idx)),
        plain_ms=timer.ms(lambda: ref.bvq_matmul_ref2(x, cb, idx)),
        library_ms=timer.ms(lambda: torch.matmul(x, w_dense)),
        bound_ms=bound, bound_by=by,
    )


def _random_tree_masks(g, b, w, active):
    """(B, W, W) ancestor masks of random (W-1)-node topologies for the
    first `active` rows (node i's parent: the root or an earlier node), and
    self-only rows for the rest, as the engine gives its idle slots."""
    from repro_torch.core.speculative import tree_ancestor_mask

    masks = np.tile(np.eye(w, dtype=np.float32), (b, 1, 1))
    for i in range(active):
        draws = torch.randint(0, 1 << 20, (w - 1,), generator=g, device=g.device).tolist()
        masks[i] = tree_ancestor_mask([r % (n + 1) - 1 for n, r in enumerate(draws)], w)
    return masks


def _row_sees(ln, w, mask=None):
    """Whether every query row of a window of length ``ln`` sees a position.
    Causal: row 0 sees position len - W.  Tree: a non-empty prefix is seen
    by every row, else row w sees the window slots rel >= W - len its mask
    marks."""
    if mask is None:
        return ln >= w
    return ln > w or (ln > 0 and bool((mask[:, w - ln:] > 0.5).any(axis=1).all()))


def _pages_walked(lengths, w, ps, mp, masks=None):
    """Pages the paged attention function must read, summed over rows: the
    pages holding positions < len, or every page of the row when one of its
    query rows sees no position (that row's output is then the mean over
    all of them, as in the reference)."""
    return sum(min(mp, -(-ln // ps)) if _row_sees(ln, w, None if masks is None else masks[i])
               else mp for i, ln in enumerate(lengths))


def _poison_tails(kp, vp, vs, table, lengths, w, ps, masks=None):
    """Copies of the pools (and of the V scales ``vs`` of int8 pools, else
    None) with every slot past a row's length inside the row's last page
    poisoned: 1e6 (int8 pools: K at 127, V scales at 1e6).  Rows where some
    query row sees nothing are left alone: they average over every slot,
    as the reference does."""
    kp2, vp2 = kp.clone(), vp.clone()
    vs2 = None if vs is None else vs.clone()
    for i, ln in enumerate(lengths):
        if (not _row_sees(ln, w, None if masks is None else masks[i]) or ln % ps == 0
                or ln >= table.shape[1] * ps):
            continue
        page = int(table[i, ln // ps])
        if vs is None:
            kp2[page, ln % ps:] = 1e6
            vp2[page, ln % ps:] = 1e6
        else:
            kp2[page, ln % ps:] = 127
            vs2[page, ln % ps:] = 1e6
    return kp2, vp2, vs2


def check_paged(dev, timer, g, b, w, kvs, hd, ps, mp, lengths, quantized=False, tree=False,
                masked=(), group=1):
    """``group`` query heads share each of the ``kvs`` kv heads (GQA: G =
    n_heads / n_kv).  ``masked`` rows are laid out as a role mask leaves
    them in a fused WDOS slot (``models/layers.forward_cache_ctx``): their
    whole table row the scratch page (the pool's last) and their length the
    window alone; the other rows' bits must not change when the scratch
    page is poisoned."""
    import torch.nn.functional as F
    from repro_torch.kernels import ref
    from repro_torch.kernels.paged_attn import paged_attention
    from repro_torch.models.layers import kv_quantize

    n_pages = b * mp + 1
    q = torch.randn((b, w, kvs, group, hd), generator=g, device=dev).to(torch.bfloat16)
    kp = torch.randn((n_pages, ps, kvs, hd), generator=g, device=dev).to(torch.bfloat16)
    vp = torch.randn((n_pages, ps, kvs, hd), generator=g, device=dev).to(torch.bfloat16)
    kw, masks = {}, None
    if quantized:
        (kp, ks), (vp, vs) = kv_quantize(kp), kv_quantize(vp)
        kw.update(k_scale=ks, v_scale=vs)
    if tree:
        masks = _random_tree_masks(g, b, w, sum(ln > w for ln in lengths))
        kw["tree_mask"] = torch.as_tensor(masks, device=dev)
    table = torch.randperm(n_pages - 1, generator=g, device=dev)[: b * mp]
    table = table.reshape(b, mp).to(torch.int32)
    for i in masked:
        assert lengths[i] == w, "a masked row's length is its window"
        table[i] = n_pages - 1
    lens = torch.as_tensor(lengths, dtype=torch.int32, device=dev)
    got = paged_attention(q, kp, vp, table, lens, **kw)
    isolated = True
    if masked:
        kp3, vp3 = kp.clone(), vp.clone()
        kp3[-1] = 127 if quantized else 1e6
        vp3[-1] = 127 if quantized else 1e6
        kw3 = kw
        if quantized:
            vs3 = vs.clone()
            vs3[-1] = 1e6
            kw3 = dict(kw, v_scale=vs3)
        live = [i for i in range(b) if i not in masked]
        isolated = bool(torch.equal(got[live], paged_attention(q, kp3, vp3, table, lens,
                                                               **kw3)[live]))
        del kp3, vp3
    want = ref.paged_attn_ref(q, kp, vp, table, lens, **kw)
    # row 0 of the window sees the positions a one-token step at length
    # len - W + 1 sees (tree rows: the prefix and slot 0), so its bits must
    # be that step's, whatever W and the mask
    lens1 = torch.clamp(lens - (w - 1), min=0)
    step = paged_attention(q[:, :1], kp, vp, table, lens1,
                           k_scale=kw.get("k_scale"), v_scale=kw.get("v_scale"))
    rows_w = bool(torch.equal(got[:, :1], step))
    kp2, vp2, vs2 = _poison_tails(kp, vp, vs if quantized else None, table, lengths, w, ps,
                                  masks)
    kw2 = dict(kw, v_scale=vs2) if quantized else kw
    poisoned = paged_attention(q, kp2, vp2, table, lens, **kw2)
    del kp2, vp2, vs2
    # library yardstick: SDPA over the gathered (dequantized) K/V, masked
    kd = ref.gather_pages_ref(kp, table).float()
    vd = ref.gather_pages_ref(vp, table).float()
    if quantized:
        kd = kd * ref.gather_pages_ref(ks, table)
        vd = vd * ref.gather_pages_ref(vs, table)
    # (B, KVS * G, S, hd): each kv head repeated for its G query heads
    kd = kd.to(torch.bfloat16).permute(0, 2, 1, 3).repeat_interleave(group, dim=1)
    vd = vd.to(torch.bfloat16).permute(0, 2, 1, 3).repeat_interleave(group, dim=1)
    qd = q.permute(0, 2, 3, 1, 4).reshape(b, kvs * group, w, hd)
    s = mp * ps
    pos = torch.arange(s, device=dev)
    base = lens[:, None].long() - w  # (B, 1): window start
    if tree:
        rel = pos[None, :] - base
        win = torch.gather(kw["tree_mask"].bool(), 2,
                           torch.clamp(rel, 0, w - 1)[:, None, :].expand(b, w, s))
        mask = (pos[None, None] < base[..., None]) | (((rel >= 0) & (rel < w))[:, None] & win)
    else:
        mask = pos[None, None] <= (base + torch.arange(w, device=dev)[None, :])[..., None]
    mask = mask[:, None]
    walked = _pages_walked(lengths, w, ps, mp, masks)
    slot_bytes = kvs * hd * (1 if quantized else 2) + (4 * kvs if quantized else 0)
    # q read in its own dtype, the output written in f32
    io_bytes = ((q.element_size() + 4) * q.numel() + 4 * table.numel() + 4 * b
                + (4 * b * w * w if tree else 0))
    bound, by = bound_ms(2 * walked * ps * slot_bytes + io_bytes,
                         4.0 * w * group * hd * kvs * walked * ps, "bf16")
    return dict(
        max_abs_err=float((got - want).abs().max()), tol=2e-5,
        repeat_bitwise_equal=bool(torch.equal(got, paged_attention(q, kp, vp, table, lens, **kw))),
        poisoned_tail_bitwise_equal=bool(torch.equal(got, poisoned)),
        rows_independent_of_W=rows_w, masked_rows_isolated=isolated,
        kernel_ms=timer.ms(lambda: paged_attention(q, kp, vp, table, lens, **kw)),
        plain_ms=timer.ms(lambda: ref.paged_attn_ref(q, kp, vp, table, lens, **kw)),
        library_ms=timer.ms(lambda: F.scaled_dot_product_attention(qd, kd, vd, attn_mask=mask)),
        bound_ms=bound, bound_by=by,
    )


def check_decode_int8(dev, timer, g, b, s, kvs, hd, length, group=1):
    """The dense int8 decode kernel (G = ``group`` query heads per kv head),
    and a bitwise check that a poisoned tail past `length` changes
    nothing."""
    import torch.nn.functional as F
    from repro_torch.kernels import ref
    from repro_torch.kernels.decode_attn import decode_attention_int8
    from repro_torch.models.layers import kv_quantize

    q = torch.randn((b, kvs, group, hd), generator=g, device=dev).to(torch.bfloat16)
    kq, ks = kv_quantize(torch.randn((b, s, kvs, hd), generator=g, device=dev))
    vq, vs = kv_quantize(torch.randn((b, s, kvs, hd), generator=g, device=dev))
    ks, vs = ks[..., 0].contiguous(), vs[..., 0].contiguous()
    ln = torch.tensor(length, dtype=torch.int32, device=dev)
    args = (q, kq, ks, vq, vs, ln)
    got = decode_attention_int8(*args)
    want = ref.decode_attn_int8_ref(*args)
    kq2, vs2 = kq.clone(), vs.clone()
    kq2[:, length:] = 127
    vs2[:, length:] = 1e6
    poisoned = decode_attention_int8(q, kq2, ks, vq, vs2, ln)
    kd = (kq.float() * ks[..., None]).to(torch.bfloat16).permute(0, 2, 1, 3)
    vd = (vq.float() * vs[..., None]).to(torch.bfloat16).permute(0, 2, 1, 3)
    qd = q if group == 1 else q.reshape(b, kvs * group, 1, hd)
    if group > 1:  # the library call's GQA: each kv head repeated to its group
        kd = kd.repeat_interleave(group, dim=1)
        vd = vd.repeat_interleave(group, dim=1)
    mask = (torch.arange(s, device=dev) < length)[None, None, None]
    n = min(length, s) if length > 0 else s
    bound, by = bound_ms(2 * b * n * kvs * (hd + 4) + (q.element_size() + 4) * q.numel() + 4,
                         4.0 * hd * kvs * group * b * n, "bf16")
    return dict(
        max_abs_err=float((got - want).abs().max()), tol=2e-5,
        repeat_bitwise_equal=bool(torch.equal(got, decode_attention_int8(*args))),
        poisoned_tail_bitwise_equal=bool(torch.equal(got, poisoned)),
        kernel_ms=timer.ms(lambda: decode_attention_int8(*args)),
        plain_ms=timer.ms(lambda: ref.decode_attn_int8_ref(*args)),
        library_ms=timer.ms(lambda: F.scaled_dot_product_attention(qd, kd, vd, attn_mask=mask)),
        bound_ms=bound, bound_by=by,
    )


def check_prefill(dev, timer, g, sq, s, h, kvs, hd, tail=15):
    """K8 (prefill flash attention) over a dense (1, s, kvs, hd) bf16 cache
    whose first ``sq`` slots the prompt wrote, against its plain version:
    each element within 2 bf16 units in the last place of its row's
    largest plain output (one query row of one head; only the order of the
    sums differs, and a limit set by the call's largest output, causal row
    0 = v[0], would be as large as the values of rows over 1k keys).
    ``max_abs_err`` and ``tol`` are the error and the limit at the element
    that comes nearest its limit, ``err_row_ulps`` the largest error in
    row units.  The last ``tail`` rows as a prefix hit's tail extend bit
    for bit equal to the full call's; the cache poisoned with NaN past the
    prompt changes no bit."""
    import torch.nn.functional as F
    from repro_torch.kernels.prefill_attn import prefill_attention
    from repro_torch.models.layers import flash_attention_plain

    q = torch.randn((1, sq, h, hd), generator=g, device=dev).to(torch.bfloat16)
    k = torch.zeros((1, s, kvs, hd), dtype=torch.bfloat16, device=dev)
    v = torch.zeros_like(k)
    k[:, :sq] = torch.randn((1, sq, kvs, hd), generator=g, device=dev).to(torch.bfloat16)
    v[:, :sq] = torch.randn((1, sq, kvs, hd), generator=g, device=dev).to(torch.bfloat16)
    got = prefill_attention(q, k, v, True)
    want = flash_attention_plain(q, k, v, True)
    top = want.float().abs().amax(-1, keepdim=True)
    row_ulp = torch.exp2(torch.floor(torch.log2(top.clamp_min(2.0 ** -126))) - 7)
    diff = (got.float() - want.float()).abs()
    worst = int((diff / row_ulp).argmax())
    ratio = float((diff / row_ulp).flatten()[worst])
    rows_m = bool(torch.equal(prefill_attention(q[:, sq - tail:], k, v, True, sq - tail),
                              got[:, sq - tail:]))
    kp, vp = k.clone(), v.clone()
    kp[:, sq:] = float("nan")
    vp[:, sq:] = float("nan")
    poisoned = prefill_attention(q, kp, vp, True)
    del kp, vp
    # library yardstick: SDPA over the prompt's keys, heads first, GQA
    ql, kl, vl = (t.transpose(1, 2) for t in (q, k[:, :sq], v[:, :sq]))
    pairs = sq * (sq + 1) / 2  # (row, key) pairs a causal prompt scores
    bound, by = bound_ms(2 * 2 * sq * h * hd + 2 * 2 * sq * kvs * hd, 4.0 * pairs * h * hd, "bf16")
    return dict(
        max_abs_err=float(diff.flatten()[worst]),
        tol=float(2 * row_ulp.expand_as(diff).flatten()[worst]), err_row_ulps=ratio,
        repeat_bitwise_equal=bool(torch.equal(got, prefill_attention(q, k, v, True))),
        rows_independent_of_M=rows_m,
        poisoned_tail_bitwise_equal=bool(torch.equal(got, poisoned)),
        kernel_ms=timer.ms(lambda: prefill_attention(q, k, v, True)),
        plain_ms=timer.ms(lambda: flash_attention_plain(q, k, v, True), iters=5),
        library_ms=timer.ms(lambda: F.scaled_dot_product_attention(ql, kl, vl, is_causal=True,
                                                                   enable_gqa=True)),
        bound_ms=bound, bound_by=by,
    )


def _family_kernel_cases(dev, timer, g, mb, win, tw, tlens, long_lens):
    """The shapes the public configurations' paths give the kernels:
    grouped-query paged attention (Qwen3-8B: 8 kv heads of G = 4;
    Nemotron-4-15B: 8 of G = 6; Moonlight as the repo defines it: 16 of
    G = 1; hd = 128), the Qwen3-8B R2 plan (n = 12288, m = 12, k = 6,
    tiled, B = 768), w4a8 at the Qwen3-8B and Moonlight widths (heads of
    151,936 and 163,840 channels, w_down K = 12288) and bvq at the
    Qwen3-8B-width draft's four weight shapes."""
    cases = []
    steps = [160, 97, 42, 126, 1, 1, 4, 85]
    verify = [163, 100, 45, 129, 4, 4, 7, 88]
    for kvs, group, model in ((8, 4, "Qwen3-8B"), (8, 6, "Nemotron-4-15B")):
        shape = f"KVS={kvs} G={group} hd=128 ps=16"
        cases += [
            ("paged_attention", f"{model} step B=8 W=1 {shape} bf16",
             lambda k=kvs, gr=group: check_paged(dev, timer, g, mb, 1, k, 128, 16, 11, steps,
                                                 group=gr)),
            ("paged_attention", f"{model} verify B=8 W=4 {shape} bf16",
             lambda k=kvs, gr=group: check_paged(dev, timer, g, mb, win, k, 128, 16, 11, verify,
                                                 group=gr)),
            ("paged_attention_int8", f"{model} verify B=8 W=4 {shape} int8",
             lambda k=kvs, gr=group: check_paged(dev, timer, g, mb, win, k, 128, 16, 11, verify,
                                                 quantized=True, group=gr)),
            ("paged_attention_tree", f"{model} tree verify B=8 W=9 {shape} bf16",
             lambda k=kvs, gr=group: check_paged(dev, timer, g, mb, tw, k, 128, 16, 12, tlens,
                                                 tree=True, group=gr)),
            ("paged_attention_int8_tree", f"{model} tree verify B=8 W=9 {shape} int8",
             lambda k=kvs, gr=group: check_paged(dev, timer, g, mb, tw, k, 128, 16, 12, tlens,
                                                 quantized=True, tree=True, group=gr)),
            ("paged_attention", f"{model} long walk B=4 W=4 {shape} bf16 lengths "
                                f"{'/'.join(map(str, long_lens))}",
             lambda k=kvs, gr=group: check_paged(dev, timer, g, 4, win, k, 128, 16, 256,
                                                 long_lens, group=gr)),
        ]
    cases += [
        ("paged_attention", "Moonlight step B=8 W=1 KVS=16 G=1 hd=128 ps=16 bf16",
         lambda: check_paged(dev, timer, g, mb, 1, 16, 128, 16, 11, steps)),
        ("paged_attention", "Moonlight verify B=8 W=4 KVS=16 G=1 hd=128 ps=16 bf16",
         lambda: check_paged(dev, timer, g, mb, win, 16, 128, 16, 11, verify)),
    ]
    cases += [
        ("block_rotate", f"Qwen3-8B R2 plan tokens={t} n=12288 tiled m=12 k=6 bf16 ({what})",
         lambda t=t: check_rotate_plan(dev, timer, g, t, 12288))
        for t, what in ((1, "one-token step"), (mb * win, "verify"),
                        (128, "prefill, 128-token prompt"))
    ]
    cases += [
        ("w4a8_matmul", f"M={mb * win} K={k} N={n} ({which}, verify)",
         lambda k=k, n=n: check_w4a8(dev, timer, g, mb * win, k, n))
        for k, n, which in ((4096, 1024, "Qwen3-8B wk/wv"),
                            (4096, 12288, "Qwen3-8B w_gate/w_up"),
                            (12288, 4096, "Qwen3-8B w_down"),
                            (4096, 151936, "Qwen3-8B head"),
                            (2048, 2048, "Moonlight wq/wk/wv/wo"),
                            (2048, 163840, "Moonlight head"))
    ]
    cases += [
        ("bvq_matmul", f"M={m} K={k} N={n} bf16 ({which}, Qwen3-8B-width draft {what})",
         lambda m=m, k=k, n=n: check_bvq(dev, timer, g, m, k, n))
        for m, what in ((mb, "step"), (mb * 9, "tree 8x9"))
        for k, n, which in ((4096, 4096, "wq/wo"), (4096, 1024, "wk/wv"),
                            (4096, 12288, "w_gate/w_up"), (12288, 4096, "w_down"))
    ]
    return cases


def phase_kernels(dev, seed):
    """Every (kernel, shape) the full-width main path gives each kernel;
    returns the representative record per kernel for the summary line."""
    timer = Timer(dev)
    g = torch.Generator(device=dev).manual_seed(seed)
    mb, win = 8, 4  # EngineConfig(): max_batch 8, verify window draft_len + 1
    # paged attention lengths: 6 active rows, 2 inactive rows holding only
    # the window (as the engine's idle slots do)
    # the plan-level R2 rotation first: its verify shape is block_rotate's
    # record in the summary line
    cases = [
        ("block_rotate", f"R2 plan tokens={t} n=11008 tiled m=4 k=6 bf16 ({what})",
         lambda t=t: check_rotate_plan(dev, timer, g, t, 11008))
        for t, what in ((mb * win, "verify"), (1, "one-token step"), (mb * 9, "tree verify 8x9"),
                        (128, "prefill, 128-token prompt"))
    ]
    cases += [
        ("w4a8_matmul", "M=32 K=4096 N=11008 (w_gate/w_up, verify)",
         lambda: check_w4a8(dev, timer, g, mb * win, 4096, 11008)),
        ("w4a8_matmul", "M=32 K=4096 N=4096 (wq/wk/wv/wo, verify)",
         lambda: check_w4a8(dev, timer, g, mb * win, 4096, 4096)),
        ("w4a8_matmul", "M=32 K=11008 N=4096 (w_down, verify)",
         lambda: check_w4a8(dev, timer, g, mb * win, 11008, 4096)),
        ("w4a8_matmul", "M=32 K=4096 N=32000 (head, verify)",
         lambda: check_w4a8(dev, timer, g, mb * win, 4096, 32000)),
        ("w4a8_matmul", "M=72 K=4096 N=11008 (w_gate/w_up, tree verify 8x9)",
         lambda: check_w4a8(dev, timer, g, mb * 9, 4096, 11008)),
        ("w4a8_matmul", "M=1 K=4096 N=11008 (w_gate/w_up, one-token step)",
         lambda: check_w4a8(dev, timer, g, 1, 4096, 11008)),
        ("w4a8_matmul", "M=128 K=4096 N=11008 (prefill, 128-token prompt)",
         lambda: check_w4a8(dev, timer, g, 128, 4096, 11008)),
        ("block_rotate", "single stage tokens=32 n=11008 m=4 k=6 bf16",
         lambda: check_block_rotate(dev, timer, g, mb * win, 11008, 4, 6)),
        ("bvq_matmul", "M=8 K=768 N=3072 bf16 (w_gate/w_up, draft step)",
         lambda: check_bvq(dev, timer, g, mb, 768, 3072)),
        ("bvq_matmul", "M=8 K=3072 N=768 bf16 (w_down, draft step)",
         lambda: check_bvq(dev, timer, g, mb, 3072, 768)),
        ("bvq_matmul", "M=8 K=768 N=768 bf16 (wq/wk/wv/wo, draft step)",
         lambda: check_bvq(dev, timer, g, mb, 768, 768)),
        ("bvq_matmul", "M=72 K=768 N=3072 bf16 (w_gate/w_up, tree draft 8x9)",
         lambda: check_bvq(dev, timer, g, mb * 9, 768, 3072)),
        ("bvq_matmul", "M=72 K=3072 N=768 bf16 (w_down, tree draft 8x9)",
         lambda: check_bvq(dev, timer, g, mb * 9, 3072, 768)),
        ("bvq_matmul", "M=72 K=768 N=768 bf16 (wq/wk/wv/wo, tree draft 8x9)",
         lambda: check_bvq(dev, timer, g, mb * 9, 768, 768)),
        ("paged_attention", "target verify B=8 W=4 KVS=32 hd=128 ps=16 bf16",
         lambda: check_paged(dev, timer, g, mb, win, 32, 128, 16, 11,
                             [163, 100, 45, 129, 4, 4, 7, 88])),
        ("paged_attention", "draft step B=8 W=1 KVS=12 hd=64 ps=16 bf16",
         lambda: check_paged(dev, timer, g, mb, 1, 12, 64, 16, 11,
                             [160, 97, 42, 126, 1, 1, 4, 85])),
        ("paged_attention_int8", "target verify B=8 W=4 KVS=32 hd=128 ps=16 int8",
         lambda: check_paged(dev, timer, g, mb, win, 32, 128, 16, 11,
                             [163, 100, 45, 129, 4, 4, 7, 88], quantized=True)),
        ("paged_attention_int8", "draft step B=8 W=1 KVS=12 hd=64 ps=16 int8",
         lambda: check_paged(dev, timer, g, mb, 1, 12, 64, 16, 11,
                             [160, 97, 42, 126, 1, 1, 4, 85], quantized=True)),
    ]
    # tree rounds: a W = tree_budget + 1 = 9 window, re-fed at the committed
    # length (4 active rows with random 8-node trees; idle rows self-only)
    tw, tlens = 9, [168, 105, 50, 134, 9, 9, 9, 9]
    for name, quantized in (("paged_attention_tree", False), ("paged_attention_int8_tree", True)):
        kind = "int8" if quantized else "bf16"
        cases += [
            (name, f"target verify B=8 W=9 KVS=32 hd=128 ps=16 {kind}",
             lambda q=quantized: check_paged(dev, timer, g, mb, tw, 32, 128, 16, 12, tlens,
                                             quantized=q, tree=True)),
            (name, f"draft B=8 W=9 KVS=12 hd=64 ps=16 {kind}",
             lambda q=quantized: check_paged(dev, timer, g, mb, tw, 12, 64, 16, 12, tlens,
                                             quantized=q, tree=True)),
        ]
    # windows wider than one 32-bit mask word a row (2, 2 and 5 words), at
    # the target's shape: 6 rows with a prefix, 2 holding only the window
    for ww in (33, 64, 129):
        wlens = [ww + d for d in (159, 96, 41, 125, 0, 0, 3, 84)]
        wmp = -(-max(wlens) // 16) + 1
        for name, quantized, tree in (("paged_attention", False, False),
                                      ("paged_attention_int8", True, False),
                                      ("paged_attention_tree", False, True),
                                      ("paged_attention_int8_tree", True, True)):
            cases.append((name, f"wide window B=8 W={ww} KVS=32 hd=128 ps=16 "
                                f"{'int8' if quantized else 'bf16'}{' tree' if tree else ''}",
                          lambda w_=ww, l_=wlens, m_=wmp, q_=quantized, t_=tree: check_paged(
                              dev, timer, g, mb, w_, 32, 128, 16, m_, l_, quantized=q_,
                              tree=t_)))
    # the adaptive and WDOS paths: the verify window of a short_dl = 2
    # two-phase round (W = 3, M = 24) and of every WDOS chain verify slot
    # (W = max_dl + 1 = 7, M = 56); a fused slot's role mask leaves the rows
    # on the other side on the scratch page at length W (rows 4-7 here; in
    # a tree slot the draft re-feeds W = 9 beside masked rows)
    for mw, what in ((3, "adaptive verify, short_dl 2"), (7, "WDOS verify, max_dl 6")):
        m = mb * mw
        cases += [
            ("block_rotate", f"R2 plan tokens={m} n=11008 tiled m=4 k=6 bf16 ({what})",
             lambda m=m: check_rotate_plan(dev, timer, g, m, 11008)),
        ] + [
            ("w4a8_matmul", f"M={m} K={k} N={n} ({which}, {what})",
             lambda m=m, k=k, n=n: check_w4a8(dev, timer, g, m, k, n))
            for k, n, which in ((4096, 11008, "w_gate/w_up"), (4096, 4096, "wq/wk/wv/wo"),
                                (11008, 4096, "w_down"), (4096, 32000, "head"))
        ]
        mlens = [mw + d for d in (159, 96, 41, 125)] + [mw] * 4
        for name, quantized in (("paged_attention", False), ("paged_attention_int8", True)):
            cases.append((name, f"{what}, rows 4-7 role-masked B=8 W={mw} KVS=32 hd=128 ps=16 "
                                f"{'int8' if quantized else 'bf16'}",
                          lambda mw=mw, ml=mlens, q=quantized: check_paged(
                              dev, timer, g, mb, mw, 32, 128, 16, 12, ml, quantized=q,
                              masked=range(4, 8))))
    cases.append(("paged_attention", "WDOS draft step, rows 4-7 role-masked B=8 W=1 KVS=12 "
                                     "hd=64 ps=16 bf16",
                   lambda: check_paged(dev, timer, g, mb, 1, 12, 64, 16, 11,
                                       [160, 97, 42, 126, 1, 1, 1, 1], masked=range(4, 8))))
    for name, quantized in (("paged_attention_tree", False), ("paged_attention_int8_tree", True)):
        cases.append((name, f"WDOS tree verify, rows 4-7 role-masked B=8 W=9 KVS=32 hd=128 "
                            f"ps=16 {'int8' if quantized else 'bf16'}",
                      lambda q=quantized: check_paged(dev, timer, g, mb, tw, 32, 128, 16, 12,
                                                      tlens[:4] + [tw] * 4, quantized=q,
                                                      tree=True, masked=range(4, 8))))
    # long context: one 4096-token row per pool kind beside K7's 4096 cache
    long_lens = [4096, 2900, 1500, 17]
    for name, quantized in (("paged_attention", False), ("paged_attention_int8", True)):
        kind = "int8" if quantized else "bf16"
        cases.append((name, f"long context B=4 W=1 KVS=32 hd=128 ps=16 {kind} "
                            f"lengths {'/'.join(map(str, long_lens))}",
                      lambda q=quantized: check_paged(dev, timer, g, 4, 1, 32, 128, 16, 256,
                                                      long_lens, quantized=q)))
    # K7 at the kvq8 path's shape first: its record is the summary line's
    cases.append(("decode_attention_int8",
                  f"Qwen3-8B kvq8 path B={TP_BATCH} S={KVQ8_S_MAX} KVS=8 G=4 hd=128 "
                  f"length={KVQ8_S_MAX - 1}",
                  lambda: check_decode_int8(dev, timer, g, TP_BATCH, KVQ8_S_MAX, 8, 128,
                                            KVQ8_S_MAX - 1, group=4)))
    for length in (4096, 1500, 17, 1):
        cases.append(("decode_attention_int8",
                      f"full LLaMA2-7B cache B=4 S=4096 KVS=32 G=1 hd=128 length={length}",
                      lambda n=length: check_decode_int8(dev, timer, g, 4, 4096, 32, 128, n)))
    # K8 at the serving cells' prefills: prompts of 1,020 (the traffic's
    # median) and 3,071 rows (its longest) into the 4,112-slot dense cache;
    # then the paper pair's main path (s_max 256, target 32 heads of 128,
    # draft 12 of 64)
    for model, h in (("Qwen3-8B", 32), ("Nemotron-4-15B", 48)):
        for sq in (1020, 3071):
            cases.append(("prefill_attention",
                          f"{model} prefill Sq={sq} H={h} KVS=8 hd=128 cache 4112 bf16",
                          lambda sq=sq, h=h: check_prefill(dev, timer, g, sq, 4112, h, 8, 128)))
    cases += [
        ("prefill_attention", "target prefill Sq=127 H=32 KVS=32 hd=128 cache 256 bf16",
         lambda: check_prefill(dev, timer, g, 127, 256, 32, 32, 128)),
        ("prefill_attention", "draft prefill Sq=127 H=12 KVS=12 hd=64 cache 256 bf16",
         lambda: check_prefill(dev, timer, g, 127, 256, 12, 12, 64)),
    ]
    cases += _family_kernel_cases(dev, timer, g, mb, win, tw, tlens, long_lens)
    cases += _shard_kernel_cases(dev, timer, g)
    summary, failed = {}, []
    for name, shape, run in cases:
        rec = run()
        torch.cuda.synchronize()
        emit(phase="kernel", kernel=name, shape=shape, **rec)
        summary.setdefault(name, dict(rec, shape=shape))
        if not rec.get("within_tol", rec["max_abs_err"] <= rec["tol"]):
            failed.append(f"{name} [{shape}]: err {rec['max_abs_err']} > tol {rec['tol']}")
        if not rec.get("repeat_bitwise_equal", True):
            failed.append(f"{name} [{shape}]: two calls on the same inputs differ")
        if not rec.get("rows_independent_of_M", True):
            failed.append(f"{name} [{shape}]: a row's bits depend on the call's rows")
        if not rec.get("rows_independent_of_W", True):
            failed.append(f"{name} [{shape}]: window row 0 differs from the one-token step")
        if not rec.get("masked_rows_isolated", True):
            failed.append(f"{name} [{shape}]: a poisoned scratch page changed an unmasked row")
        if not rec.get("poisoned_tail_bitwise_equal", True):
            failed.append(f"{name} [{shape}]: a poisoned tail past length changed the output")
    if failed:
        raise AssertionError("kernels disagree with their plain versions:\n" + "\n".join(failed))
    return summary


# ---------------------------------------------------------------------------
# Phases 3 and 4: the main path
# ---------------------------------------------------------------------------


def _prompts(n, lo, hi, vocab, seed):
    rng = np.random.RandomState(seed)
    return [rng.randint(0, vocab, size=rng.randint(lo, hi + 1)).astype(np.int32)
            for _ in range(n)]


def phase_main_path(dev, seed, report=None):
    from repro_torch.launch.serve import build_paper_pair, greedy_reference
    from repro_torch.serving.engine import Engine, EngineConfig, SamplingParams

    t0 = time.perf_counter()
    target, draft = build_paper_pair(seed=seed, s_max=256, device=dev)
    torch.cuda.synchronize()
    print(f"built paper pair in {time.perf_counter() - t0:.1f} s "
          f"(target layers {target.cfg.n_layers}, draft layers {draft.cfg.n_layers}; "
          f"depth cut: none)")
    prompts = _prompts(4, 32, 128, target.cfg.vocab, seed)
    sp = SamplingParams(max_tokens=32)
    outs, launches = _drive("main_path", Engine(target, draft, EngineConfig(), device=dev),
                            prompts, sp, dev, report=report)
    _check_rotations("main_path", launches, target.cfg.n_layers)
    # the target-only decode runs the dense-cache path, whose attention
    # takes bf16 operands (the reference's _decode_attention), while the
    # paged kernel computes in f32: at bf16 the two can part at a near-tie,
    # so each divergence is reported with the top-2 margin there
    same, divergences = 0, []
    for p, o in zip(prompts, outs):
        ref_toks, spec = greedy_reference(target, p, sp.max_tokens), o
        if ref_toks == spec:
            same += 1
        else:
            pos, margin = _first_divergence_margin(target, p, ref_toks, spec)
            divergences.append({"position": pos, "top2_margin": margin})
    emit(phase="main_path_check", equal_to_target_only_greedy=f"{same}/{len(outs)}",
         divergences=divergences)
    return launches, (target, draft, prompts), outs


def _check_rotations(phase, launches, n_layers):
    """Each target forward runs 7 linears a layer and the head through
    w4a8 and one R2 rotation a layer: one block_rotate launch each."""
    forwards = launches["w4a8_matmul"] / (7 * n_layers + 1)
    per_forward = launches["block_rotate"] / forwards
    emit(phase=f"{phase}_rotations", target_forwards=forwards,
         block_rotate_per_target_forward=per_forward)
    if per_forward != n_layers:
        raise AssertionError(f"{phase}: block_rotate {per_forward} launches per target forward, "
                             f"expected one per layer ({n_layers})")


class _HostClock:
    """Host seconds spent in the engine's device-to-host copies (each waits
    for the device first) and in its host decision rules (draft draws,
    tree levels, accept rules), timed by patching serving/engine.py for
    the runs inside the context.  A tree level's time includes the draws
    it makes."""

    NAMES = ("sample_token_host", "_sample_tree_level", "speculative_accept_greedy_host",
             "speculative_sample_host", "speculative_tree_accept_greedy_host",
             "speculative_tree_sample_host")

    def __enter__(self):
        from repro_torch.serving import engine as E

        self.seconds = {}
        self._saved = ([(E, n, getattr(E, n)) for n in self.NAMES]
                       + [(E.Engine, "_to_host", E.Engine._to_host)])
        for owner, name, f in self._saved:
            setattr(owner, name, self._timed(name, f))
        return self

    def _timed(self, name, f):
        def timed(*args, **kwargs):
            t0 = time.perf_counter()
            try:
                return f(*args, **kwargs)
            finally:
                self.seconds[name] = self.seconds.get(name, 0.0) + time.perf_counter() - t0
        return timed

    def __exit__(self, *exc):
        for owner, name, f in self._saved:
            setattr(owner, name, f)


class _ForwardCount:
    """Calls of the forwards (serving/engine.py's ``_FORWARDS``) whose model
    config is ``cfg``, counted by patching them for the runs inside the
    context: the target forwards of a run (prefills and, on a mixed-KV
    engine, one per store of each dispatch)."""

    def __init__(self, cfg):
        self.cfg, self.calls = cfg, 0

    def __enter__(self):
        from repro_torch.serving import engine as E

        self._saved = dict(E._FORWARDS)
        for mode, f in self._saved.items():
            E._FORWARDS[mode] = self._counted(f)
        return self

    def _counted(self, f):
        def counted(params, cfg, *args, **kwargs):
            self.calls += cfg is self.cfg
            return f(params, cfg, *args, **kwargs)
        return counted

    def __exit__(self, *exc):
        from repro_torch.serving import engine as E

        E._FORWARDS.update(self._saved)


def _run(eng, prompts, sps, stagger=False):
    """``eng.run(prompts, sps)``, or with ``stagger`` one request added per
    ``step()`` before the drain (the arrival pattern that puts requests'
    draft windows out of phase).  Returns (outputs, summary)."""
    if not stagger:
        return eng.run(prompts, sps)
    sps = sps if isinstance(sps, list) else [sps] * len(prompts)
    rids = []
    for p, sp in zip(prompts, sps):
        rids.append(eng.add_request(p, sp))
        eng.step()
    while eng.has_unfinished():
        eng.step()
    return [eng.output_tokens(r) for r in rids], eng.summary()


def _drive(phase, eng, prompts, sps, dev, needs=None, stagger=False, report=None):
    """Run one engine over the prompts (``_run``) with the launch counters
    zeroed just before and read just after; print the path's numbers
    (device-to-host copies per round, target forwards per emitted token
    and, on a WDOS engine, the fused-slot summary among them); fail unless
    every kernel of ``needs`` (default: those PATH_OF assigns to this path)
    launched and every request drained.  Host ms per round in the copies
    and decision rules (``_HostClock``) ride along.  Returns (token lists,
    launches); ``report``, a dict, receives the run's wall seconds and
    tokens/s."""
    from repro_torch.kernels import _lib

    torch.cuda.reset_peak_memory_stats(dev)
    _lib.launches.clear()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with _HostClock() as clock, _ForwardCount(eng.target.cfg) as fwd:
        outs, summary = _run(eng, prompts, sps, stagger)
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(_lib.launches)
    outs = [o.tolist() for o in outs]
    emitted = sum(len(o) for o in outs)
    if report is not None:
        report.update(wall_s=wall, tokens_per_s=emitted / wall)
    t_stats, d_stats = eng.pool_stats()
    t_forwards = fwd.calls
    emit(phase=phase, requests=len(outs), prompt_lens=[len(p) for p in prompts],
         staggered=stagger, adaptive=eng.cfg.adaptive, par_mode=summary["par_mode"],
         emitted=emitted, wall_s=wall, tokens_per_s=emitted / wall, rounds=summary["rounds"],
         steps=summary["steps"], target_forwards=t_forwards,
         target_forwards_per_token=t_forwards / max(emitted, 1), fused=summary.get("fused"),
         acceptance_rate=summary["acceptance_rate"], kv_quant=summary["kv_quant"],
         spec_mode=summary["spec_mode"], tree=summary["tree"],
         host_copies_per_round=summary["host_copies"] / max(summary["rounds"], 1),
         host_ms_per_round={k: v * 1e3 / max(summary["rounds"], 1)
                            for k, v in sorted(clock.seconds.items())},
         kv_bytes_per_token={"target": t_stats.bytes_per_token,
                             "draft": d_stats.bytes_per_token},
         kv_bytes_per_token_by_kind={"target": eng._t_pool.bytes_per_token_by_kind(),
                                     "draft": eng._d_pool.bytes_per_token_by_kind()},
         max_memory_allocated=torch.cuda.max_memory_allocated(dev), launches=launches)
    if needs is None:
        needs = [k for k, path in PATH_OF.items() if path == phase and k not in NO_PATH]
    missing = [k for k in needs if launches.get(k, 0) <= 0]
    if missing:
        raise AssertionError(f"{phase} did not launch {missing}")
    want = [sp.max_tokens for sp in (sps if isinstance(sps, list) else [sps] * len(prompts))]
    if [len(o) for o in outs] != want:
        raise AssertionError(f"{phase}: a request did not drain to max_tokens")
    return outs, launches


def _compare_rows(target, prompts, got, want, kinds):
    """Per row: equal, or the first divergence with the paged-path top-2
    margin there (of the row's own storage kind)."""
    rows = []
    for p, a, b, kind in zip(prompts, got, want, kinds):
        if a == b:
            rows.append({"equal": True})
            continue
        i, margin = _first_divergence_margin(target, p, a, b, kind)
        rows.append({"equal": False, "kv_quant": kind, "position": i, "top2_margin": margin})
    return rows


def phase_int8_path(dev, pair, fp_outs):
    """The main path's pair and requests with int8 paged KV."""
    from repro_torch.serving.engine import Engine, EngineConfig, SamplingParams

    target, draft, prompts = pair
    sp = SamplingParams(max_tokens=32)
    outs, launches = _drive("int8_path",
                            Engine(target, draft, EngineConfig(kv_quant="int8"), device=dev),
                            prompts, sp, dev)
    rows = _compare_rows(target, prompts, outs, fp_outs, ["none"] * len(prompts))
    emit(phase="int8_path_check", equal_to_fp_main_path=f"{sum(r['equal'] for r in rows)}"
         f"/{len(rows)}", rows=rows, gated=False)
    return launches, outs


def phase_tree_path(dev, pair, fp_outs, int8_outs):
    """The main path's pair and requests as greedy tree rounds over mixed
    KV stores, requests 1 and 3 pinned to int8: each row must equal the
    chain path of its kind, except at a near-tie (greedy tree commits only
    target-argmax tokens; only the order of the attention sums changes)."""
    from repro_torch.serving.engine import Engine, EngineConfig, SamplingParams

    target, draft, prompts = pair
    kinds = ["int8" if i % 2 else "none" for i in range(len(prompts))]
    sps = [SamplingParams(max_tokens=32, kv_quant=k) for k in kinds]
    eng = Engine(target, draft, EngineConfig(kv_quant="mixed", spec_mode="tree"), device=dev)
    outs, launches = _drive("tree_path", eng, prompts, sps, dev)
    want = [i8 if k == "int8" else fp for k, fp, i8 in zip(kinds, fp_outs, int8_outs)]
    rows = _compare_rows(target, prompts, outs, want, kinds)
    emit(phase="tree_path_check", equal_to_chain=f"{sum(r['equal'] for r in rows)}/{len(rows)}",
         rows=rows, near_tie=NEAR_TIE)
    bad = [r for r in rows if not r["equal"] and not _near_tie(r)]
    if bad:
        raise AssertionError(f"tree path differs from the chain path beyond a near-tie: {bad}")
    return launches


MAIN_KERNELS = [k for k, path in PATH_OF.items() if path == "main_path" and k not in NO_PATH]


def _sampled(seed, kv_quant=None):
    from repro_torch.serving.engine import SamplingParams

    return SamplingParams(max_tokens=32, temperature=0.8, top_k=50, top_p=0.95, seed=seed,
                          kv_quant=kv_quant)


def _replay_equal(phase, dev, pair, cfg, sps, outs, stagger=False):
    """A second engine on the same requests must give identical tokens in
    every row (the key streams make sampled rows reproducible)."""
    from repro_torch.serving.engine import Engine

    target, draft, prompts = pair
    again, _ = _run(Engine(target, draft, cfg, device=dev), prompts, sps, stagger)
    same = [a.tolist() == o for a, o in zip(again, outs)]
    emit(phase=f"{phase}_replay", identical=f"{sum(same)}/{len(same)}")
    if not all(same):
        raise AssertionError(f"{phase}: a second engine gave other tokens: rows {same}")


def phase_sampled_path(dev, pair, fp_outs):
    """The main path's pair and requests at EngineConfig() defaults with
    requests 0 and 2 sampled (temperature 0.8, top-k 50, top-p 0.95, seed
    = request id) and 1 and 3 greedy: every main-path kernel launches, the
    greedy rows equal the main path's except at a near-tie, and a replay
    gives identical tokens."""
    from repro_torch.serving.engine import Engine, EngineConfig, SamplingParams

    target, draft, prompts = pair
    sps = [_sampled(i) if i % 2 == 0 else SamplingParams(max_tokens=32)
           for i in range(len(prompts))]
    with _DecisionLog() as log:
        outs, launches = _drive("sampled_path",
                                Engine(target, draft, EngineConfig(), device=dev),
                                prompts, sps, dev, needs=MAIN_KERNELS)
    _check_rotations("sampled_path", launches, target.cfg.n_layers)
    greedy = [i for i in range(len(prompts)) if i % 2]
    rows = _compare_rows(target, [prompts[i] for i in greedy], [outs[i] for i in greedy],
                         [fp_outs[i] for i in greedy], ["none"] * len(greedy))
    emit(phase="sampled_path_check", greedy_rows_equal_to_main_path=
         f"{sum(r['equal'] for r in rows)}/{len(rows)}", rows=rows, near_tie=NEAR_TIE,
         sampled_rows_equal_to_main_path=sum(outs[i] == fp_outs[i] for i in (0, 2)))
    bad = [r for r in rows if not r["equal"] and not _near_tie(r)]
    if bad:
        raise AssertionError(f"sampled path: greedy rows differ from the main path beyond a "
                             f"near-tie: {bad}")
    _replay_equal("sampled_path", dev, pair, EngineConfig(), sps, outs)
    return sps, outs, log


def phase_sampled_tree_path(dev, pair):
    """Every request sampled under tree speculation over mixed KV stores,
    requests 1 and 3 pinned to int8: both tree bodies launch and a replay
    gives identical tokens."""
    from repro_torch.serving.engine import Engine, EngineConfig

    target, draft, prompts = pair
    cfg = EngineConfig(kv_quant="mixed", spec_mode="tree")
    sps = [_sampled(i, "int8" if i % 2 else "none") for i in range(len(prompts))]
    with _DecisionLog() as log:
        outs, _ = _drive("sampled_tree_path", Engine(target, draft, cfg, device=dev), prompts,
                         sps, dev, needs=["paged_attention_tree", "paged_attention_int8_tree"])
    _replay_equal("sampled_tree_path", dev, pair, cfg, sps, outs)
    return sps, outs, log


def _near_tie(row) -> bool:
    """A greedy row's first divergence is a near-tie: the target's top-2
    logit margin there is at most NEAR_TIE, or (MoE, two runs that compute
    different bits) the two runs' first expert selections that differ are
    router near-ties (``_expert_flips``)."""
    router = row.get("router")
    return row["top2_margin"] <= NEAR_TIE or (router is not None and router["near_tie"])


def _divergences(target, prompts, sps, got, want, log_got, log_want, kinds, routed=None):
    """The rows of two runs of the same requests that differ, each with
    whether it is excused as a near-tie: a greedy row's first divergence
    at a near-tie (``_near_tie``, the margins read from ``_compare_rows``
    of the row's storage kind; ``None``: the dense-cache logits), a sampled row's first
    differing host decision taken from logit rows within NEAR_TIE of each
    other (``_first_decision_flip``).  ``routed``: the (MoE) models that
    produced ``got`` and ``want``, whose router selections a greedy row is
    then also held by (``_router_flip``)."""
    out = []
    for rid, (p, sp, a, b, kind) in enumerate(zip(prompts, sps, got, want, kinds)):
        if a == b:
            continue
        if sp.greedy:
            row = _compare_rows(target, [p], [a], [b], [kind])[0]
            if routed is not None:
                row["router"] = _router_flip(routed, p, a, b)
            out.append(dict(row, request=rid, near_tie=_near_tie(row)))
        else:
            flip = _first_decision_flip(log_got, log_want, rid)
            out.append(dict(flip or {}, request=rid, near_tie=flip is not None
                            and flip["logit_max_abs_diff"] <= NEAR_TIE))
    return out


def _compare_decisions(phase, target, prompts, sps, got, want, log_got, log_want, kinds):
    """Fail unless every row of two runs is equal or a near-tie
    (``_divergences``)."""
    div = _divergences(target, prompts, sps, got, want, log_got, log_want, kinds)
    emit(phase=f"{phase}_check", equal=f"{len(prompts) - len(div)}/{len(prompts)}",
         divergences=div, near_tie=NEAR_TIE)
    bad = [r for r in div if not r["near_tie"]]
    if bad:
        raise AssertionError(f"{phase}: rows differ beyond a near-tie: {bad}")


def phase_adaptive_path(dev, pair, fp_outs):
    """The main path's pair and greedy requests under ``EngineConfig(
    adaptive=True)`` (APSD short/long draft windows), one request admitted
    per step: every main-path kernel launches (the rotation once per layer
    of each target forward), and each row equals the main path's except at
    a near-tie."""
    from repro_torch.serving.engine import Engine, EngineConfig, SamplingParams

    target, draft, prompts = pair
    sps = [SamplingParams(max_tokens=32)] * len(prompts)
    outs, launches = _drive("adaptive_path",
                            Engine(target, draft, EngineConfig(adaptive=True), device=dev),
                            prompts, sps, dev, needs=MAIN_KERNELS, stagger=True)
    _check_rotations("adaptive_path", launches, target.cfg.n_layers)
    _compare_decisions("adaptive_path", target, prompts, sps, outs, fp_outs, None, None,
                       ["none"] * len(prompts))


def phase_wdos_path(dev, pair):
    """Fused WDOS rounds at ``EngineConfig(adaptive=True, par_mode="wdos")``
    with requests 0 and 2 sampled as on the sampled path, one request
    admitted per step, against its two-phase twin (``adaptive=True``, the
    same requests and arrivals) run just before it in the same call: every
    main-path kernel launches, the rotation once per layer of each target
    forward; some slot verified one request while another drafted; each
    row equals the twin's (near-tie and decision-log rules); a replay is
    identical.  Both runs print tokens/s, rounds, target forwards per
    emitted token and device-to-host copies per round."""
    from repro_torch.serving.engine import Engine, EngineConfig, SamplingParams

    target, draft, prompts = pair
    sps = [_sampled(i) if i % 2 == 0 else SamplingParams(max_tokens=32)
           for i in range(len(prompts))]
    twin_cfg = EngineConfig(adaptive=True)
    cfg = EngineConfig(adaptive=True, par_mode="wdos")
    with _DecisionLog() as log_twin:
        twin, _ = _drive("wdos_path_two_phase", Engine(target, draft, twin_cfg, device=dev),
                         prompts, sps, dev, needs=MAIN_KERNELS, stagger=True)
    eng = Engine(target, draft, cfg, device=dev)
    with _DecisionLog() as log:
        outs, launches = _drive("wdos_path", eng, prompts, sps, dev, needs=MAIN_KERNELS,
                                stagger=True)
    _check_rotations("wdos_path", launches, target.cfg.n_layers)
    fused = eng.summary()["fused"]
    if fused["fused_slots"] <= 0:
        raise AssertionError(f"wdos path: no slot mixed verify and draft rows: {fused}")
    _compare_decisions("wdos_path", target, prompts, sps, outs, twin, log, log_twin,
                       ["none"] * len(prompts))
    _replay_equal("wdos_path", dev, pair, cfg, sps, outs, stagger=True)
    return sps, outs


def phase_wdos_tree_path(dev, pair, tree_sps, tree_outs, tree_log):
    """The sampled tree path's engine (mixed KV, tree, every request
    sampled, 1 and 3 on int8) with ``par_mode="wdos"``, one request
    admitted per step: both tree bodies launch, the rotation once per
    layer of each target forward, some slot verified one request while
    another drafted, each row equals the sampled tree path's (decision-log
    rule), and a replay is identical."""
    from repro_torch.serving.engine import Engine, EngineConfig

    target, draft, prompts = pair
    cfg = EngineConfig(kv_quant="mixed", spec_mode="tree", par_mode="wdos")
    eng = Engine(target, draft, cfg, device=dev)
    with _DecisionLog() as log:
        outs, launches = _drive("wdos_tree_path", eng, prompts, tree_sps, dev,
                                needs=["paged_attention_tree", "paged_attention_int8_tree"],
                                stagger=True)
    _check_rotations("wdos_tree_path", launches, target.cfg.n_layers)
    fused = eng.summary()["fused"]
    if fused["fused_slots"] <= 0:
        raise AssertionError(f"wdos tree path: no slot mixed verify and draft rows: {fused}")
    _compare_decisions("wdos_tree_path", target, prompts, tree_sps, outs, tree_outs, log,
                       tree_log, [sp.kv_quant for sp in tree_sps])
    _replay_equal("wdos_tree_path", dev, pair, cfg, tree_sps, outs, stagger=True)
    return cfg


def phase_self_draft_path(dev, pair, fp_outs):
    """The paper target drafting for itself under ``adaptive=True``, greedy,
    one request admitted per step, two-phase and then ``par_mode="wdos"``
    in the same call.  The random-weight draft is never accepted, so only
    a self-draft moves the APSD controllers to PAR: some round of each run
    must draft a long_dl window (the verify at M = 8 * (long_dl + 1)).  The
    rotation runs once per layer of every forward (the draft's forwards
    are target forwards here); each row equals the main path's except at a
    near-tie.  Both runs print tokens/s, rounds, forwards per emitted token
    and copies per round."""
    from repro_torch.serving.engine import EngineConfig

    target, _, prompts = pair
    needs = ["w4a8_matmul", "block_rotate", "paged_attention"]
    for phase, cfg in (("self_draft_path_two_phase", EngineConfig(adaptive=True)),
                       ("self_draft_wdos_path", EngineConfig(adaptive=True, par_mode="wdos"))):
        _self_draft(phase, dev, target, prompts, fp_outs, cfg, needs, rotations=True)


def _self_draft(phase, dev, target, prompts, want, cfg, needs, rotations, max_tokens=32):
    """``target`` drafting for itself under ``cfg`` (adaptive), greedy, one
    request admitted per step: some controller must reach PAR (a long_dl
    window), every proposal must be accepted, and each row must equal
    ``want`` except at a near-tie; with ``rotations`` the R2 rotation runs
    once per layer of every forward."""
    from repro_torch.core.apsd import PAR
    from repro_torch.serving.engine import Engine, SamplingParams

    sps = [SamplingParams(max_tokens=max_tokens)] * len(prompts)
    eng = Engine(target, target, cfg, device=dev)
    outs, launches = _drive(phase, eng, prompts, sps, dev, needs=needs, stagger=True)
    if rotations:
        _check_rotations(phase, launches, target.cfg.n_layers)
    windows = [eng.request(r).history for r in range(len(prompts))]
    long_rounds = sum(h[0] == PAR and h[1] == cfg.long_dl for hist in windows for h in hist)
    emit(phase=f"{phase}_windows", long_dl_rounds=long_rounds,
         history=[[list(map(int, h)) for h in hist] for hist in windows])
    if long_rounds <= 0:
        raise AssertionError(f"{phase}: no controller reached PAR (no long_dl window)")
    # the draft is the target: its one-token step and the window verify
    # compute each row with the same bits (kernels and torch ops alike
    # are gated row-count independent), so every proposal is accepted
    acceptance = eng.summary()["acceptance_rate"]
    emit(phase=f"{phase}_acceptance", acceptance_rate=acceptance)
    if acceptance != 1.0:
        raise AssertionError(f"{phase}: acceptance {acceptance} < 1 with the target "
                             f"drafting for itself")
    _compare_decisions(phase, target, prompts, sps, outs, want, None, None,
                       ["none"] * len(prompts))
    return launches


def phase_stop_path(dev, pair, fp_outs):
    """One greedy request (the main path's first) whose stop string is the
    text of tokens k and k+1 of its main-path output (the first k >= 2
    whose text is not found earlier): the output must be the main-path
    prefix before token k, finish "stop", reach the sink whole, and return
    every page."""
    from repro_torch.serving.api import default_detokenize
    from repro_torch.serving.engine import Engine, EngineConfig, SamplingParams

    target, draft, prompts = pair
    out0 = fp_outs[0]
    text = "".join(default_detokenize(t) for t in out0)
    for k in range(2, len(out0) - 1):
        stop = f"{out0[k]} {out0[k + 1]}"
        if text.find(stop) == len("".join(default_detokenize(t) for t in out0[:k])):
            break
    else:
        raise AssertionError("stop path: no token pair of the main-path output is unique")
    eng = Engine(target, draft, EngineConfig(), device=dev)
    sink = []
    rid = eng.add_request(prompts[0], SamplingParams(max_tokens=32, stop=(stop,)),
                          sink=sink.append)
    while eng.has_unfinished():
        eng.step()
    got = eng.output_tokens(rid).tolist()
    used = [st.used_pages for st in eng.pool_stats()]
    reason = eng.request(rid).finish_reason
    emit(phase="stop_path", stop=stop, k=k, output_len=len(got), finish_reason=reason,
         sink_equal=sink == got, used_pages_after=used)
    if got != out0[:k] or reason != "stop" or sink != got or any(used):
        raise AssertionError(f"stop path: output {got} (want {out0[:k]}), reason {reason}, "
                             f"sink {sink}, used pages {used}")


def phase_profile(dev, pair, path, cfg, sps, rounds: int = 3, stagger=False) -> None:
    """Where a round's time goes on one path: the same 4 requests on a
    fresh engine of ``cfg`` (request i with ``sps[i]``), two warm rounds
    (with ``stagger``, one round after each request's arrival instead),
    then ``rounds`` rounds under torch.profiler (CPU and CUDA
    activities).  Prints wall ms per round, summed device-kernel ms per
    round (their ratio is the device's busy share; the profiler adds host
    overhead, so the share is a lower bound), each port kernel's device ms
    and launches per round, and the top entries by device and by host
    time, and ``cudaLaunchKernel`` calls per target forward (all of a
    round's launches, the draft's included, over its target forwards)."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.serving.engine import Engine

    target, draft, prompts = pair
    eng = Engine(target, draft, cfg, device=dev)
    for p, sp in zip(prompts, sps):
        eng.add_request(p, sp)
        if stagger:
            eng.step()
    if not stagger:
        eng.step()
        eng.step()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof, \
            _ForwardCount(target.cfg) as fwd:
        t0 = time.perf_counter()
        for _ in range(rounds):
            eng.step()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    events = prof.key_averages()

    def dev_us(e):
        return getattr(e, "self_device_time_total", 0.0)

    device_ms = sum(dev_us(e) for e in events) / 1e3
    top_dev = sorted(events, key=dev_us, reverse=True)[:12]
    port = {}  # the port's kernels by their CUDA symbol: [ms, launches] per round
    for e in events:
        for sym in PORT_SYMBOLS:
            if sym in e.key:
                ms, n = port.get(sym, (0.0, 0))
                port[sym] = (ms + dev_us(e) / 1e3 / rounds, n + e.count // rounds)
    top_cpu = sorted(events, key=lambda e: e.self_cpu_time_total, reverse=True)[:12]
    calls = {key: sum(e.count for e in events if e.key == key) // rounds
             for key in ("aten::roll", "aten::cat", "cudaLaunchKernel", "Memcpy DtoH")}
    calls["Memcpy DtoH (any)"] = sum(e.count for e in events if "DtoH" in e.key) // rounds
    emit(phase="profile", path=path, rounds=rounds, staggered=stagger,
         target_forwards_per_round=fwd.calls / rounds,
         launches_per_target_forward=calls["cudaLaunchKernel"] * rounds / max(fwd.calls, 1),
         wall_ms_per_round=wall * 1e3 / rounds,
         device_ms_per_round=device_ms / rounds, device_busy_share=device_ms / (wall * 1e3),
         port_kernels_ms_per_round={k: list(v) for k, v in port.items()},
         calls_per_round=calls,
         top_device_ms_per_round=[[e.key[:80], dev_us(e) / 1e3 / rounds, e.count // rounds]
                                  for e in top_dev],
         top_host_ms_per_round=[[e.key[:80], e.self_cpu_time_total / 1e3 / rounds,
                                 e.count // rounds] for e in top_cpu])


def _first_divergence_margin(target, prompt, a, b, kv_quant=None):
    """Where two greedy streams first differ, and the top-2 margin of the
    target's logits there: the position whose argmax the two runs
    disagreed on.  ``kv_quant=None`` reads the logits from a dense-cache
    prefill of the common prefix; ``"none"``/``"int8"`` through the paged
    path of that storage kind, as the engine computes them: the dense
    prefill of all but the last token scattered into a one-request store,
    then a one-token window over it."""
    from repro_torch.serving import engine as E
    from repro_torch.serving.paged_cache import device_pool_store

    i = next(j for j in range(len(a)) if a[j] != b[j])
    seq = torch.as_tensor(np.concatenate([prompt, np.asarray(a[:i], np.int32)]),
                          device=target.device)
    iface = E.make_interface(target)
    if kv_quant is None:
        logits, _ = iface.prefill(target.params, seq[None])
    else:
        n = seq.shape[0]
        pool = E._pool_for(target, E.EngineConfig(max_batch=1, kv_quant=kv_quant), [n])
        store = device_pool_store(pool, target.device, kv_quant)
        table = torch.arange(pool.num_pages, dtype=torch.int32, device=target.device)
        _, cache = iface.prefill(target.params, seq[None, :-1])
        E._scatter_prefill(store, cache["attn"]["k"][:, 0], cache["attn"]["v"][:, 0],
                           table, n - 1)
        logits = E._make_paged_step(target)(
            target.params, seq[None, -1:], store, table[None],
            torch.tensor([n - 1], dtype=torch.int32, device=target.device))
    top2 = torch.topk(logits[0, -1].float(), 2).values
    return i, float(top2[0] - top2[1])


class _RouterLog:
    """Every MoE layer's expert selection in the forwards run inside the
    context: per ``models/layers.moe_apply_dense`` call (both MoE forwards
    call it, layer by layer), the (B, T, k) expert ids each token selects,
    ascending, and the (B, T) margin between its k-th and (k+1)-th router
    logit, read from the logits the combine itself computes (patched
    ``topk_gates``, in the combine's fixed row blocks)."""

    def __enter__(self):
        from repro_torch.models import layers as L

        self.calls, self._orig = [], (L.moe_apply_dense, L.topk_gates)
        blocks = []

        def topk_gates(logits, k):
            blocks.append(logits)
            return self._orig[1](logits, k)

        def moe_apply_dense(p, x, cfg):
            blocks.clear()
            out = self._orig[0](p, x, cfg)
            logits = torch.cat(blocks)[:x.shape[0] * x.shape[1]]
            vals, ids = torch.sort(logits, dim=-1, descending=True, stable=True)
            k = cfg.top_k
            self.calls.append((torch.sort(ids[:, :k], dim=-1).values.reshape(*x.shape[:2], k),
                               (vals[:, k - 1] - vals[:, k]).reshape(x.shape[:2])))
            return out

        L.moe_apply_dense, L.topk_gates = moe_apply_dense, topk_gates
        return self

    def __exit__(self, *exc):
        from repro_torch.models import layers as L

        L.moe_apply_dense, L.topk_gates = self._orig


def _expert_flips(log_a, log_b, n_layers, row, last):
    """Where two runs of the same forwards (``_RouterLog``s, the same token
    inputs up to position ``last``) select different experts for batch row
    ``row``.  A flip at (layer l, position t) can change the router inputs
    only of layers above l at positions t and later, so the flips that no
    other flip explains are those with no flip at a lower layer and an
    earlier or equal position: the roots.  The divergence is a router
    near-tie when there are flips and every root's own margin is within
    ROUTER_NEAR_TIE in both runs."""
    if len(log_a.calls) != len(log_b.calls):
        raise AssertionError(f"router logs of {len(log_a.calls)} and {len(log_b.calls)} calls")
    flips, offset = [], 0
    for c, ((ids_a, m_a), (ids_b, m_b)) in enumerate(zip(log_a.calls, log_b.calls)):
        t = ids_a.shape[1]
        differ = (ids_a[row].cpu() != ids_b[row].cpu()).any(dim=-1)
        for j in torch.nonzero(differ).flatten().tolist():
            if offset + j <= last:
                flips.append((c % n_layers, offset + j, float(m_a[row, j]), float(m_b[row, j])))
        if c % n_layers == n_layers - 1:
            offset += t
    roots = []
    for f in sorted(flips):
        if not any(r[0] < f[0] and r[1] <= f[1] for r in roots):
            roots.append(f)
    return {"flips": len(flips), "roots": [list(r) for r in roots[:8]], "n_roots": len(roots),
            "near_tie": bool(roots) and all(max(r[2], r[3]) <= ROUTER_NEAR_TIE for r in roots)}


def _router_flip(models, prompt, a, b):
    """The router rule for a greedy row where ``models[0]`` emitted ``a`` and
    ``models[1]`` emitted ``b``: both replay the prompt and the common
    prefix through the engine's paged path (``_paged_replay``, which gives
    each token the bits a verify window gives it), their expert
    selections recorded, and ``_expert_flips`` over them."""
    i = next(j for j in range(len(a)) if a[j] != b[j])
    logs = []
    for model in models:
        with _RouterLog() as log:
            _paged_replay(model, prompt, i + 1, forced=a[:i])
        logs.append(log)
    return dict(_expert_flips(logs[0], logs[1], models[0].cfg.n_layers, 0, len(prompt) - 1 + i),
                position=i)


class _DecisionLog:
    """Every host sampling decision of the engine runs inside the context,
    per request: patched into serving/engine.py (the samplers and the tree
    grower) and Request (whose key methods map each key to its request).
    An event is (identity, outcome, logit rows it was decided from): the
    draws and accept rules are identified by their key, a tree level by
    (round, depth).  Two runs of the same requests make the same decisions
    in the same order until one outcome differs."""

    _ENGINE = ("sample_token_host", "speculative_sample_host", "speculative_tree_sample_host",
               "_sample_tree_level")

    def __init__(self):
        self.events = {}
        self._rid_of = {}

    def _add(self, rid, ident, outcome, rows):
        self.events.setdefault(rid, []).append(
            (ident, outcome, [np.array(r, np.float32, copy=True) for r in rows]))

    def __enter__(self):
        from repro_torch.serving import engine as E
        from repro_torch.serving.request import Request

        self._saved = ([(E, n, getattr(E, n)) for n in self._ENGINE]
                       + [(Request, n, getattr(Request, n)) for n in ("draft_key", "accept_key")])
        orig = {n: f for _, n, f in self._saved}

        def keyed(name):
            def method(req, *args):
                key = orig[name](req, *args)
                self._rid_of[key.tobytes()] = req.rid
                return key
            return method

        def draw(key, logits, *args):
            tok = orig["sample_token_host"](key, logits, *args)
            self._add(self._rid_of[key.tobytes()], ("draw", key.tobytes()), tok, [logits])
            return tok

        def accept(key, drafts, p, q, dl, *args):
            res = orig["speculative_sample_host"](key, drafts, p, q, dl, *args)
            self._add(self._rid_of[key.tobytes()], ("accept", key.tobytes()), res,
                      [p[: dl + 1], q[:dl]])
            return res

        def tree_accept(key, nodes, parents, p, q, *args):
            res = orig["speculative_tree_sample_host"](key, nodes, parents, p, q, *args)
            n = len(nodes) + 1
            self._add(self._rid_of[key.tobytes()], ("tree_accept", key.tobytes()), res,
                      [p[:n], q[:n]])
            return res

        def level(req, cfg, logits):
            ident = ("level", req.rounds, req.tree_depth)
            orig["_sample_tree_level"](req, cfg, logits)
            self._add(req.rid, ident, (list(req.tree_nodes), list(req.tree_parents)), [logits])

        E.sample_token_host, E.speculative_sample_host = draw, accept
        E.speculative_tree_sample_host, E._sample_tree_level = tree_accept, level
        Request.draft_key, Request.accept_key = keyed("draft_key"), keyed("accept_key")
        return self

    def __exit__(self, *exc):
        for owner, name, f in self._saved:
            setattr(owner, name, f)


def _first_decision_flip(a: _DecisionLog, b: _DecisionLog, rid):
    """The first decision of request ``rid`` whose outcome differs between
    two runs, with the largest difference of the logit rows it was decided
    from (None when the runs never disagree, or disagree on which decision
    comes next)."""
    for (ia, oa, ra), (ib, ob, rb) in zip(a.events.get(rid, []), b.events.get(rid, [])):
        if ia != ib:
            return None
        if oa != ob:
            diff = max(float(np.abs(x - y).max()) for x, y in zip(ra, rb))
            return {"decision": ia[0], "logit_max_abs_diff": diff}
    return None


def phase_card_vs_cpu(dev, seed):
    """The same smoke-size requests through the port on the card and on
    the CPU (f32 pair from one seed): tokens must be equal, unless a greedy
    row's first divergence is a near-tie of the target's top-2 logits, or
    a sampled row's first differing host decision was taken from logit
    rows that differ by at most NEAR_TIE between the two devices (the
    samplers are the same numpy code on both, so only the rows differ)."""
    from repro_torch.core import prng
    from repro_torch.launch.serve import build_pair, to_device
    from repro_torch.serving import engine as E
    from repro_torch.serving.batcher import BatchConfig
    from repro_torch.serving.engine import Engine, EngineConfig, SamplingParams

    t_cpu, d_cpu = build_pair(seed=seed, s_max=128, device="cpu")
    t_gpu, d_gpu = to_device(t_cpu, dev), to_device(d_cpu, dev)
    prompts = _prompts(4, 3, 24, t_cpu.cfg.vocab, seed + 1)
    kinds = ["int8" if i % 2 else "none" for i in range(len(prompts))]
    runs = [
        ("chain", EngineConfig(max_batch=4), [SamplingParams(max_tokens=32)] * len(prompts)),
        ("mixed_tree", EngineConfig(max_batch=4, kv_quant="mixed", spec_mode="tree"),
         [SamplingParams(max_tokens=32, kv_quant=k) for k in kinds]),
        ("sampled_chain", EngineConfig(max_batch=4),
         [_sampled(i) if i % 2 == 0 else SamplingParams(max_tokens=32)
          for i in range(len(prompts))]),
        ("sampled_mixed_tree", EngineConfig(max_batch=4, kv_quant="mixed", spec_mode="tree"),
         [_sampled(i, k) for i, k in enumerate(kinds)]),
        ("wdos_chain", EngineConfig(max_batch=4, adaptive=True, par_mode="wdos"),
         [_sampled(i) if i % 2 == 0 else SamplingParams(max_tokens=32)
          for i in range(len(prompts))]),
    ]
    bad = []
    for name, cfg, sps in runs:
        stagger = cfg.par_mode == "wdos"  # arrivals out of phase: mixed slots
        with _DecisionLog() as log_gpu:
            gpu, _ = _run(Engine(t_gpu, d_gpu, cfg, device=dev), prompts, sps, stagger)
        with _DecisionLog() as log_cpu:
            cpu, _ = _run(Engine(t_cpu, d_cpu, cfg, device="cpu"), prompts, sps, stagger)
        gpu, cpu = [o.tolist() for o in gpu], [o.tolist() for o in cpu]
        ties = _divergences(t_cpu, prompts, sps, gpu, cpu, log_gpu, log_cpu,
                            [None] * len(prompts))
        emit(phase="card_vs_cpu", engine=name,
             equal=f"{len(prompts) - len(ties)}/{len(prompts)}", divergences=ties)
        bad += [dict(t, engine=name) for t in ties if not t["near_tie"]]
    # the legacy host-gather loop, two batch slots for the four requests
    host_cfg = BatchConfig(max_batch=2, max_tokens=32, kv_path="host")
    rows = [[o.tolist() for o in E.serve_batch(prng.PRNGKey(seed), t, d, prompts, host_cfg)[0]]
            for t, d in ((t_gpu, d_gpu), (t_cpu, d_cpu))]
    greedy = [SamplingParams(max_tokens=32)] * len(prompts)
    ties = _divergences(t_cpu, prompts, greedy, rows[0], rows[1], None, None,
                        [None] * len(prompts))
    emit(phase="card_vs_cpu", engine="host_gather",
         equal=f"{len(prompts) - len(ties)}/{len(prompts)}", divergences=ties)
    bad += [dict(t, engine="host_gather") for t in ties if not t["near_tie"]]
    # the prefix cache on the reference's workload (tests/test_prefix_cache.py)
    # at page_size 8: the donor first (once per kind), then the followers, a
    # fork that copies on write, a full hit and a repeat (under mixed KV the
    # kinds alternate, int8 first: the int8 causal body over shared pages);
    # the prefix stats are host bookkeeping and must be equal
    donor = np.arange(7, 48, dtype=np.int32)
    followers = [np.concatenate([donor[:33], np.arange(200, 208, dtype=np.int32)]),
                 donor[:34].copy(), donor.copy()]
    for name, kinds in (("prefix_chain", ["none"]), ("prefix_mixed_chain", ["int8", "none"])):
        cfg = EngineConfig(max_batch=4, page_size=8, prefix_cache=True,
                           kv_quant="mixed" if len(kinds) > 1 else "none")
        sps = [SamplingParams(max_tokens=32, kv_quant=k) for k in kinds]
        sps += [SamplingParams(max_tokens=32, kv_quant=kinds[i % len(kinds)])
                for i in range(len(followers))]
        reqs = [donor] * len(kinds) + followers
        rows, stats = [], []
        for t, d, where in ((t_gpu, d_gpu, dev), (t_cpu, d_cpu, "cpu")):
            eng = Engine(t, d, cfg, device=where)
            first, _ = eng.run(reqs[:len(kinds)], sps[:len(kinds)])
            rest, summary = eng.run(reqs[len(kinds):], sps[len(kinds):])
            rows.append([o.tolist() for o in first + rest])
            stats.append(summary["prefix_cache"])
        ties = _divergences(t_cpu, reqs, sps, rows[0], rows[1], None, None, [None] * len(reqs))
        emit(phase="card_vs_cpu", engine=name, equal=f"{len(reqs) - len(ties)}/{len(reqs)}",
             divergences=ties, prefix_cache=stats[0], prefix_stats_equal=stats[0] == stats[1])
        bad += [dict(t, engine=name) for t in ties if not t["near_tie"]]
        if stats[0] != stats[1] or stats[0]["hits"] != len(followers):
            bad.append({"engine": name, "prefix_cache": stats})
    if bad:
        raise AssertionError(f"card and CPU tokens differ beyond a near-tie: {bad}")


# ---------------------------------------------------------------------------
# Phases 14-17: the prefix cache, byte budgets and the dense pair
# ---------------------------------------------------------------------------


def _prefix_workload(vocab, seed, ps=16):
    """A 160-token system prompt S (10 full pages); the donor S + 16 tokens;
    nine followers: six S + a distinct 8-40-token suffix, a fork S[:150] +
    20 other tokens (its block 9 maps partially: copy on write), a full hit
    S[:130] (every row but the tip shared, on a partial page: copy on
    write, no forward) and an exact repeat of the donor.  Every suffix
    starts with its own token, unlike the donor's 161st and S[150], so no
    follower shares more with another than with the donor, and each one's
    match is min(common prefix with the donor, plen - 1, the donor's 160
    full-block tokens).  Returns (donor, followers, tokens_saved implied)."""
    from repro_torch.serving.prefix_cache import _lcp

    rng = np.random.RandomState(seed + 7)

    def draw(n):
        return rng.randint(0, vocab, size=n).astype(np.int32)

    s = draw(160)
    donor = np.concatenate([s, draw(16)])
    firsts = {int(donor[160]), int(s[150])}
    suffixes = []
    while len(suffixes) < 7:
        suf = draw(20 if len(suffixes) == 6 else int(rng.randint(8, 41)))
        if int(suf[0]) not in firsts:
            firsts.add(int(suf[0]))
            suffixes.append(suf)
    followers = [np.concatenate([s, suf]) for suf in suffixes[:6]]
    followers += [np.concatenate([s[:150], suffixes[6]]), s[:130].copy(), donor.copy()]
    cached = (len(donor) - 1) // ps * ps
    implied = sum(min(_lcp(f, donor), len(f) - 1, cached) for f in followers)
    return donor, followers, implied


class _PrefillClock:
    """Host wall of each request's prefill (both pools; after a
    ``torch.cuda.synchronize()`` on each side of each call), by kind: a
    miss, a tail hit (the seeded extend of the unshared tail) or a full
    hit (no forward); and the prefix mirrors' device-to-host and
    host-to-device bytes and ms (each copy bracketed by synchronizes).
    Patched into serving/engine.py for the runs inside the context."""

    def __enter__(self):
        from repro_torch.serving import engine as E

        self.prefill, self.mirror = {}, {"d2h": [0, 0.0], "h2d": [0, 0.0]}
        self._saved = [(E.Engine, "_prefill_into", E.Engine._prefill_into),
                       (E, "_pull_mirror", E._pull_mirror), (E, "_push_mirror", E._push_mirror)]
        prefill, pull, push = (f for _, _, f in self._saved)

        def timed(f, record):
            def run(*args):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                out = f(*args)
                torch.cuda.synchronize()
                record(args, out, time.perf_counter() - t0)
                return out
            return run

        def rec_prefill(args, out, dt):
            req = args[1]
            m = req.prefix_match.tokens_matched if req.prefix_match is not None else 0
            kind = "miss" if m == 0 else "full_hit" if m >= len(req.prompt) - 1 else "tail_hit"
            entry = self.prefill.setdefault(req.rid, [kind, 0.0])
            entry[1] += dt

        def rec_mirror(way, tensors):
            def rec(args, out, dt):
                self.mirror[way][0] += sum(t.numel() * t.element_size()
                                           for t in tensors(args, out))
                self.mirror[way][1] += dt
            return rec

        E.Engine._prefill_into = timed(prefill, rec_prefill)
        E._pull_mirror = timed(pull, rec_mirror("d2h", lambda args, out: out))
        # _push_mirror(match, role, k_dst, v_dst) fills rows [0, m) of both
        E._push_mirror = timed(push, rec_mirror("h2d", lambda args, out: [
            a[:, :args[0].tokens_matched] for a in args[2:]]))
        return self

    def __exit__(self, *exc):
        for owner, name, f in self._saved:
            setattr(owner, name, f)

    def report(self):
        by_kind = {}
        for kind, sec in self.prefill.values():
            by_kind.setdefault(kind, []).append(sec * 1e3)
        return {
            "prefill_ms_by_kind": {k: {"requests": len(v), "mean": float(np.mean(v)),
                                       "median": float(np.median(v)), "each": v}
                                   for k, v in sorted(by_kind.items())},
            "mirror": {way: {"bytes": b, "ms": sec * 1e3} for way, (b, sec) in self.mirror.items()},
        }


def _pinned_rows(eng, pinned):
    """Device copies of the pool rows of ``pinned`` ({kind: {role: pages}})."""
    stores = {"target": eng._t_stores, "draft": eng._d_stores}
    return {(kind, role, name): a[:, pages].clone()
            for kind, by_role in pinned.items() for role, pages in by_role.items()
            for name, a in stores[role][kind].items()}


def _prefix_run(phase, dev, pair, cfg, kinds, needs):
    """The prefix workload on one engine of ``cfg``: the donor alone (once
    per kind of ``kinds``), then the nine followers at once (kinds
    alternating).  Counters are zeroed before the followers and read after
    them.  Returns (follower rows, launches, engine, prefill clock,
    the pages the tree pinned after the donor, their rows before and after
    the followers, the followers and their sampling params)."""
    from repro_torch.kernels import _lib
    from repro_torch.serving.engine import Engine, SamplingParams

    target, draft, _ = pair
    donor, followers, _ = _prefix_workload(target.cfg.vocab, SEED)
    eng = Engine(target, draft, cfg, device=dev)
    with _PrefillClock() as clock:
        eng.run([donor] * len(kinds), [SamplingParams(max_tokens=32, kv_quant=k) for k in kinds])
        pinned = eng._prefix.pinned_pages() if eng._prefix is not None else {}
        before = _pinned_rows(eng, pinned)
        sps = [SamplingParams(max_tokens=32, kv_quant=kinds[i % len(kinds)])
               for i in range(len(followers))]
        outs, launches = _drive(phase, eng, followers, sps, dev, needs=needs)
    return outs, launches, eng, clock, pinned, before, _pinned_rows(eng, pinned), followers, sps


def _phase_prefix(phase, dev, pair, cfg, kinds, needs):
    """One prefix path against its twin (the same arrivals with the cache
    off, run first in the same call): rows equal except at a near-tie,
    every follower a hit, tokens saved as the workload implies, at least
    two copies on write, and every page the tree pinned after the donor
    bitwise unchanged when the followers drained."""
    target = pair[0]
    twin_cfg = dataclasses.replace(cfg, prefix_cache=False)
    twin, _, _, twin_clock, *_ = _prefix_run(f"{phase}_twin", dev, pair, twin_cfg, kinds,
                                                    needs)
    outs, launches, eng, clock, pinned, before, after, followers, sps = _prefix_run(
        phase, dev, pair, cfg, kinds, needs)
    st = eng.summary()["prefix_cache"]
    _, _, implied = _prefix_workload(target.cfg.vocab, SEED)
    unchanged = before.keys() == after.keys() and all(torch.equal(before[k], after[k])
                                                      for k in before)
    emit(phase=f"{phase}_report", prefix_cache=st, tokens_saved_implied=implied,
         pinned_pages=pinned, pinned_rows_bitwise_unchanged=unchanged,
         with_cache=clock.report(), without_cache=twin_clock.report())
    kinds_of = [sp.kv_quant for sp in sps]
    _compare_decisions(phase, target, followers, sps, outs, twin, None, None, kinds_of)
    bad = []
    if st["hits"] != len(followers):
        bad.append(f"hits {st['hits']} != {len(followers)}")
    if st["tokens_saved"] != implied:
        bad.append(f"tokens_saved {st['tokens_saved']} != {implied}")
    if st["cow_copies"] < 2:
        bad.append(f"cow_copies {st['cow_copies']} < 2")
    if not before or not unchanged:
        bad.append(f"pinned pages written (or none pinned: {len(before)} rows)")
    if bad:
        raise AssertionError(f"{phase}: " + "; ".join(bad))
    return launches


def phase_prefix_path(dev, pair):
    """The W4A8 + BVQ pair under ``EngineConfig(prefix_cache=True)``."""
    from repro_torch.serving.engine import EngineConfig

    return _phase_prefix("prefix_path", dev, pair, EngineConfig(prefix_cache=True), [None],
                         MAIN_KERNELS)


def phase_prefix_mixed_tree_path(dev, pair):
    """The same workload under ``EngineConfig(prefix_cache=True, kv_quant=
    "mixed", spec_mode="tree")``: the donor once per kind, the followers
    alternating kinds (fp first).  Both tree bodies launch (tree windows
    never run the int8 causal body, K5; the card-vs-CPU prefix engines do,
    over shared int8 pages)."""
    from repro_torch.serving.engine import EngineConfig

    cfg = EngineConfig(prefix_cache=True, kv_quant="mixed", spec_mode="tree")
    return _phase_prefix("prefix_mixed_tree_path", dev, pair, cfg, ["none", "int8"],
                         ["w4a8_matmul", "block_rotate", "bvq_matmul", "paged_attention_tree",
                          "paged_attention_int8_tree"])


def phase_pool_bytes(dev, pair):
    """``EngineConfig(pool_bytes=...)`` at 4 GiB and 1 GiB: each pool's
    pages per storage kind, and the requests resident after one step with
    16 queued (200-token prompts, 50 tokens each: 16 pages at page_size 16
    per request), fp against int8."""
    from repro_torch.serving.engine import Engine, EngineConfig, SamplingParams

    target, draft, _ = pair
    prompts = _prompts(16, 200, 200, target.cfg.vocab, SEED + 3)
    rows = []
    for budget in (4 << 30, 1 << 30):
        for kind in ("none", "int8"):
            eng = Engine(target, draft, EngineConfig(max_batch=16, pool_bytes=budget,
                                                     kv_quant=kind), device=dev)
            for p in prompts:
                eng.add_request(p, SamplingParams(max_tokens=50))
            eng.step()
            t_st, d_st = eng.pool_stats()
            rows.append(dict(pool_bytes=budget, kv_quant=kind, target_pages=t_st.num_pages,
                             draft_pages=d_st.num_pages, resident=eng.num_active(),
                             target_bytes_per_token=t_st.bytes_per_token))
            del eng
            torch.cuda.empty_cache()
    emit(phase="pool_bytes", rows=rows)
    for budget in (4 << 30, 1 << 30):
        fp, i8 = (r for r in rows if r["pool_bytes"] == budget)
        if i8["target_pages"] <= fp["target_pages"] or i8["resident"] < fp["resident"]:
            raise AssertionError(f"pool_bytes {budget}: int8 holds no more than fp: {fp} {i8}")


# ---------------------------------------------------------------------------
# Phases 16-18: a QAT-compressed draft, observability, the HTTP front end
# ---------------------------------------------------------------------------

# the engine's 25 metric families, the batcher's 6 and the flight
# recorder's anomalies_total: what the JAX engine's registry renders
# (tests/test_torch_observability.py holds the port's registry to it)
REFERENCE_FAMILIES = (
    "requests_submitted_total", "steps_total", "tokens_emitted_total", "tokens_drafted_total",
    "tokens_accepted_total", "table_upload_seconds_total", "acceptance_rate", "queue_depth",
    "active_requests", "pool_pages", "kv_bytes_total", "kv_bytes_per_token", "ttft_seconds",
    "itl_seconds", "round_wall_seconds", "admission_wait_seconds", "round_acceptance",
    "tree_nodes_total", "tree_branches_total", "tree_accept_depth", "tree_compactions_total",
    "prefix_hit_rate", "shared_pages", "prefill_tokens_saved_total", "prefix_cow_total",
    "rounds_total", "requests_finished_total", "fused_slots_total", "fused_rows_total",
    "fused_wall_seconds_total", "wdos_modeled_seconds_total", "anomalies_total",
)
LINEARS = ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down")


def _dense_linears(lp, cfg):
    """A dense layer's seven linears as (K, N) weights, in the shapes
    ``quantized_lm.bvq_compress_layer`` compresses them."""
    d, h, kv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv, cfg.hd
    a, m = lp["attn"], lp["mlp"]
    return {"wq": a["wq"].reshape(d, h * hd), "wk": a["wk"].reshape(d, kv * hd),
            "wv": a["wv"].reshape(d, kv * hd), "wo": a["wo"].reshape(h * hd, d),
            "w_gate": m["w_gate"], "w_up": m["w_up"], "w_down": m["w_down"]}


def phase_qat_draft_path(dev, pair, fp_outs):
    """A draft compressed with quantization-aware refinement: a dense
    LLaMA-68M-width draft (made from SEED + 1) compressed twice on the
    card, with the pair's k-means-only settings (``PAIR_BVQ``) and with
    the same k-means settings plus the reference's ``BVQConfig()`` QAT
    defaults (60 Gumbel-softmax steps, lr 5e-2, tau 2.0 -> 0.2, INT4
    codebooks).  Prints each compression's seconds and each of the 14
    linears' reconstruction MSE under both; then serves the main path's 4
    greedy requests with the QAT draft and the main path's target: bvq
    launches, each row equals the main path's except at a near-tie (the
    draft changes only acceptance), and the acceptance is printed."""
    from repro_torch.configs.paper_pair import DLM
    from repro_torch.core import bvq as bvq_mod
    from repro_torch.launch.serve import PAIR_BVQ
    from repro_torch.models import lm
    from repro_torch.serving import quantized_lm as qlm
    from repro_torch.serving.engine import Engine, EngineConfig, SamplingParams, ServingModel

    target, draft, prompts = pair
    dense = lm.init_lm(torch.Generator(device=dev).manual_seed(SEED + 1), DLM, dev)
    qat_cfg = dataclasses.replace(PAIR_BVQ, qat_steps=bvq_mod.BVQConfig().qat_steps)
    compressed, seconds = {}, {}
    for name, bcfg in (("kmeans", PAIR_BVQ), ("qat", qat_cfg)):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        compressed[name] = qlm.bvq_compress_lm(dense, DLM, bcfg,
                                               torch.Generator(device=dev).manual_seed(7))
        torch.cuda.synchronize()
        seconds[name] = time.perf_counter() - t0
    mse = []
    for i, lp in enumerate(dense["layers"]):
        for lin, w in _dense_linears(lp, DLM).items():
            row = {"layer": i, "linear": lin, "shape": list(w.shape)}
            for name, params in compressed.items():
                c = params["layers"][i][lin]
                rec = bvq_mod.reconstruct_dense(c["cb"], c["idx"])
                row[f"mse_{name}"] = float(((rec - w.float()) ** 2).mean())
            row["ratio"] = row["mse_qat"] / row["mse_kmeans"]
            mse.append(row)
    if not all(math.isfinite(r["mse_qat"]) for r in mse):
        raise AssertionError(f"qat draft: a non-finite reconstruction error: {mse}")
    emit(phase="qat_draft_compress", seconds=seconds, qat_steps=qat_cfg.qat_steps,
         linears=len(mse), mse=mse,
         mean_ratio=float(np.mean([r["ratio"] for r in mse])))
    qat_draft = ServingModel(cfg=DLM, params=compressed["qat"], mode="bvq", s_max=draft.s_max,
                             device=dev)
    del compressed, dense
    sp = SamplingParams(max_tokens=32)
    report = {}
    outs, launches = _drive("qat_draft_path",
                            Engine(target, qat_draft, EngineConfig(), device=dev), prompts,
                            sp, dev, needs=MAIN_KERNELS, report=report)
    _check_rotations("qat_draft_path", launches, target.cfg.n_layers)
    _compare_decisions("qat_draft_path", target, prompts, [sp] * len(prompts), outs, fp_outs,
                       None, None, ["none"] * len(prompts))
    return launches


def _device_programs(tracer):
    return {e["name"] for e in tracer.events() if e["track"] == "device"}


def _observed(phase, dev, pair, cfg, sps, want, stagger, needs):
    """One path's engine with a ``Tracer`` and ``profile_every_n=1``: its
    rows must equal ``want`` bitwise (unless ``want`` is None), the trace
    must validate, the device track must name every program the profiler
    bracketed, and the flight recorder must hold one record per round.
    Prints profile_summary() with each program's achieved bytes/s against
    the card's memory rate (its bytes are the mean of the calls' own
    counts, so bytes * calls / wall is the calls' rate).  Returns
    (launches, profile_summary, engine, rows)."""
    from repro_torch.serving.engine import Engine
    from repro_torch.serving.tracing import Tracer, validate_chrome_trace

    target, draft, prompts = pair
    tracer = Tracer()
    eng = Engine(target, draft, dataclasses.replace(cfg, profile_every_n=1), device=dev,
                 trace=tracer)
    outs, launches = _drive(phase, eng, prompts, sps, dev, needs=needs, stagger=stagger)
    same = [a == b for a, b in zip(outs, want if want is not None else outs)]
    problems = validate_chrome_trace(tracer.to_chrome_trace())
    prof = eng.profile_summary()
    steps = eng.summary()["steps"]
    flight = eng.flight_snapshot()
    emit(phase=f"{phase}_profile", rows_equal_to_unprofiled=f"{sum(same)}/{len(same)}",
         trace_events=len(tracer.events()), trace_problems=problems[:5],
         flight_rounds=flight["rounds_recorded"], steps=steps,
         anomalies=flight["anomalies"],
         programs={k: dict(v, wall_ms_per_call=v["wall_s"] * 1e3 / v["calls"],
                           achieved_bytes_per_s=v["bytes"] * v["calls"] / v["wall_s"],
                           share_of_memory_rate=v["bytes"] * v["calls"] / v["wall_s"]
                           / HBM_BYTES_PER_S)
                   for k, v in prof.items()})
    if not all(same):
        raise AssertionError(f"{phase}: profiled rows differ from the unprofiled run: {same}")
    if problems:
        raise AssertionError(f"{phase}: invalid trace: {problems[:5]}")
    if _device_programs(tracer) != set(prof):
        raise AssertionError(f"{phase}: device track {_device_programs(tracer)} against "
                             f"profiled programs {set(prof)}")
    if flight["rounds_recorded"] != steps:
        raise AssertionError(f"{phase}: {flight['rounds_recorded']} flight records for "
                             f"{steps} rounds")
    return launches, prof, eng, outs


def phase_observed_path(dev, pair, fp_outs, wdos_sps, wdos_outs):
    """The main path's engine and then the WDOS path's (``adaptive=True,
    par_mode="wdos"``, staggered, requests 0 and 2 sampled) with a Tracer
    and ``profile_every_n=1`` (``_observed``): the main path's device
    track must hold prefill, draft and verify, the WDOS path's fused_wdos
    and draft_slot.  Then, for the overlap question, a two-phase engine at
    a fixed draft length of the WDOS engine's ``long_dl`` (greedy main-path
    requests, staggered; each row equals the main path's except at a
    near-tie): its verify scores the same (max_batch, long_dl + 1) window
    a ``fused_wdos`` slot does, so ``fused_wdos`` wall per call is printed
    beside that verify plus draft_slot.  The WDOS registry must render
    every family the JAX engine's registry renders.  Last, the main path
    with the tracer on and profiling off beside a plain run, tokens/s each
    (reported)."""
    from repro_torch.serving.engine import Engine, EngineConfig, SamplingParams
    from repro_torch.serving.tracing import Tracer

    target, draft, prompts = pair
    sp = SamplingParams(max_tokens=32)
    launches, main_prof, _, _ = _observed("observed_path", dev, pair, EngineConfig(),
                                          [sp] * len(prompts), fp_outs, False, MAIN_KERNELS)
    _check_rotations("observed_path", launches, target.cfg.n_layers)
    wdos_cfg = EngineConfig(adaptive=True, par_mode="wdos")
    _, wdos_prof, eng, _ = _observed("observed_wdos_path", dev, pair, wdos_cfg, wdos_sps,
                                     wdos_outs, True, MAIN_KERNELS)
    wide = [sp] * len(prompts)
    _, wide_prof, _, wide_outs = _observed("observed_wide_verify_path", dev, pair,
                                           EngineConfig(draft_len=wdos_cfg.long_dl), wide, None,
                                           True, MAIN_KERNELS)
    _compare_decisions("observed_wide_verify_path", target, prompts, wide, wide_outs, fp_outs,
                       None, None, ["none"] * len(prompts))
    for name, prof, want in (("observed_path", main_prof, {"prefill", "draft", "verify"}),
                             ("observed_wdos_path", wdos_prof,
                              {"prefill", "fused_wdos", "draft_slot"})):
        if not want <= set(prof):
            raise AssertionError(f"{name}: programs {set(prof)} lack {want - set(prof)}")

    def per_call(prof, k):
        return prof[k]["wall_s"] * 1e3 / prof[k]["calls"]

    emit(phase="observed_overlap", window=wdos_cfg.max_dl + 1, rows=wdos_cfg.max_batch,
         fused_wdos_ms=per_call(wdos_prof, "fused_wdos"),
         verify_ms=per_call(wide_prof, "verify"),
         draft_slot_ms=per_call(wdos_prof, "draft_slot"),
         fused_over_verify_plus_draft=per_call(wdos_prof, "fused_wdos")
         / (per_call(wide_prof, "verify") + per_call(wdos_prof, "draft_slot")),
         main_path_verify_ms=per_call(main_prof, "verify"))
    text = eng.metrics.render()
    rendered = {ln.split()[2] for ln in text.splitlines() if ln.startswith("# TYPE")}
    missing = [f for f in REFERENCE_FAMILIES if f"serving_{f}" not in rendered]
    emit(phase="observed_metrics", families=len(rendered), reference_families=len(
        REFERENCE_FAMILIES), missing=missing)
    if missing:
        raise AssertionError(f"observed path: /metrics lacks {missing}")
    plain, traced = {}, {}
    _drive("observed_plain_main_path", Engine(target, draft, EngineConfig(), device=dev),
           prompts, sp, dev, needs=MAIN_KERNELS, report=plain)
    _drive("observed_traced_main_path", Engine(target, draft, EngineConfig(), device=dev,
                                               trace=Tracer()),
           prompts, sp, dev, needs=MAIN_KERNELS, report=traced)
    emit(phase="observed_tracer_cost", plain_tokens_per_s=plain["tokens_per_s"],
         traced_tokens_per_s=traced["tokens_per_s"],
         ratio=traced["tokens_per_s"] / plain["tokens_per_s"], gated=False)
    return launches


def phase_server_path(dev, pair, fp_outs, sampled_sps, sampled_outs, sampled_log):
    """The HTTP front end on the card: ``CompletionServer(AsyncEngine(
    Engine(pair, EngineConfig())))`` on 127.0.0.1, port 0, four concurrent
    completions through the shared client (requests 1 and 3 of the main
    path streamed over SSE, request 2 as one JSON response, request 0
    sampled with the sampled path's parameters): each row must equal the
    main / sampled path's except at a near-tie (decision rule for the
    sampled row).  Then a fifth streamed request disconnects after 4
    tokens; eight decoding and two queued streams saturate the gate and a
    ``wait: false`` request must answer 429; the streams disconnect, every
    page returns (free pages end where they started), and /healthz,
    /stats and /metrics answer 200.  Prints HTTP tokens/s beside
    ``Engine.run`` of the same four requests just before it, and the TTFT
    / ITL means."""
    import asyncio

    from repro_torch.kernels import _lib
    from repro_torch.serving import http_client as hc
    from repro_torch.serving.async_engine import AsyncEngine
    from repro_torch.serving.engine import Engine, EngineConfig, SamplingParams
    from repro_torch.serving.server import CompletionServer

    target, draft, prompts = pair
    # the index-less device, as the server CLI passes it: the AsyncEngine's
    # worker thread must make the engine's resolved index current
    eng = Engine(target, draft, EngineConfig(), device="cuda")
    max_queued = 2
    sp0 = sampled_sps[0]
    sps = [sp0] + [SamplingParams(max_tokens=32)] * (len(prompts) - 1)
    direct = {}
    _drive("server_path_engine_run", Engine(target, draft, EngineConfig(), device=dev), prompts,
           sps, dev, needs=MAIN_KERNELS, report=direct)
    rows = {}

    async def stats(port):
        status, _, body = await hc.request(port, "GET", "/stats")
        if status != 200:
            raise AssertionError(f"server path: /stats answered {status}")
        return json.loads(body)

    async def drained(port):
        for _ in range(600):
            st = await stats(port)
            if st["active"] == 0 and st["queued"] == 0 and st["target_pool"]["used_pages"] == 0:
                return st
            await asyncio.sleep(0.05)
        raise AssertionError(f"server path: pages did not return: {st}")

    async def scenario():
        server = CompletionServer(AsyncEngine(eng, max_queued=max_queued))
        await server.start("127.0.0.1", 0)
        task = asyncio.ensure_future(server.serve_forever())
        try:
            port = server.port
            start = await stats(port)

            async def sse(i):
                status, _, chunks = await hc.sse_request(
                    port, {"prompt": prompts[i].tolist(), "max_tokens": 32})
                if status != 200:
                    raise AssertionError(f"server path: request {i} answered {status}")
                rows[i] = [c["token"] for c in chunks if c["token"] is not None]

            async def whole(i, payload):
                status, _, body = await hc.request(port, "POST", "/v1/completions", dict(
                    payload, prompt=prompts[i].tolist(), max_tokens=32))
                if status != 200:
                    raise AssertionError(f"server path: request {i} answered {status}")
                rows[i] = json.loads(body)["token_ids"]

            t0 = time.perf_counter()
            await asyncio.gather(
                whole(0, {"temperature": sp0.temperature, "top_k": sp0.top_k,
                          "top_p": sp0.top_p, "seed": sp0.seed}),
                sse(1), whole(2, {}), sse(3))
            wall = time.perf_counter() - t0
            # a fifth stream hangs up after 4 tokens
            reader, writer = await hc.open_request(port, "POST", "/v1/completions", {
                "prompt": prompts[0].tolist(), "max_tokens": 32, "stream": True})
            await hc.read_head(reader)
            for _ in range(4):
                await reader.readuntil(b"\n\n")
            writer.close()
            await drained(port)
            # saturate: max_batch decoding + max_queued waiting, then fail fast
            hogs = [await hc.open_request(port, "POST", "/v1/completions", {
                "prompt": prompts[i % len(prompts)].tolist(), "max_tokens": 64,
                "stream": True}) for i in range(eng.cfg.max_batch + max_queued)]
            for _ in range(600):
                if (await stats(port))["pending_admission"] == max_queued:
                    break
                await asyncio.sleep(0.05)
            status_429, _, _ = await hc.request(port, "POST", "/v1/completions", {
                "prompt": prompts[1].tolist(), "max_tokens": 4, "wait": False})
            for _, w in hogs:
                w.close()
            end = await drained(port)
            codes = {path: (await hc.request(port, "GET", path))[0]
                     for path in ("/healthz", "/stats", "/metrics")}
            return wall, start, end, status_429, codes
        finally:
            task.cancel()
            try:
                await task
            except asyncio.CancelledError:
                pass
            await server.stop()

    _lib.launches.clear()
    torch.cuda.synchronize()
    with _DecisionLog() as log:
        wall, start, end, status_429, codes = asyncio.run(scenario())
    launches = dict(_lib.launches)
    got = [rows[i] for i in range(len(prompts))]
    want = [sampled_outs[0]] + list(fp_outs[1:])
    # the sampled row's decisions, under the sampled path's request id
    srv_rid = next(iter(log.events), None)
    log.events = {0: log.events[srv_rid]} if srv_rid is not None else {}
    m = eng.metrics
    emit(phase="server_path", emitted=sum(len(r) for r in got), wall_s=wall,
         http_tokens_per_s=sum(len(r) for r in got) / wall,
         engine_run_tokens_per_s=direct["tokens_per_s"],
         http_over_engine_run=sum(len(r) for r in got) / wall / direct["tokens_per_s"],
         ttft_mean_s=m.get("ttft_seconds").sum_value() / max(m.value("ttft_seconds"), 1),
         itl_mean_s=m.get("itl_seconds").sum_value() / max(m.value("itl_seconds"), 1),
         status_429=status_429, codes=codes,
         free_pages_start=[start["target_pool"]["free_pages"], start["draft_pool"]["free_pages"]],
         free_pages_end=[end["target_pool"]["free_pages"], end["draft_pool"]["free_pages"]],
         launches=launches)
    _compare_decisions("server_path", target, prompts, sps, got, want, log, sampled_log,
                       ["none"] * len(prompts))
    if status_429 != 429 or any(c != 200 for c in codes.values()):
        raise AssertionError(f"server path: status codes 429={status_429}, {codes}")
    for pool in ("target_pool", "draft_pool"):
        if end[pool]["free_pages"] != start[pool]["free_pages"]:
            raise AssertionError(f"server path: {pool} free pages {start[pool]['free_pages']} "
                                 f"-> {end[pool]['free_pages']}")
    missing = [k for k in ("w4a8_matmul", "block_rotate", "bvq_matmul", "paged_attention")
               if launches.get(k, 0) <= 0]
    if missing:
        raise AssertionError(f"server path did not launch {missing}")
    _server_cli()
    return launches


def _server_cli(timeout_s: float = 300.0):
    """``python -m repro_torch.serving.server --port 0`` as a user starts
    it, with its defaults (device cuda, the quantized smoke pair, its
    EngineConfig): one streamed completion must equal ``Engine.run`` of
    the same request on the pair and config the CLI builds, made here, and
    /healthz must answer 200.  The process is stopped after, pass or
    fail."""
    import asyncio
    import queue
    import threading

    from repro_torch.launch.serve import build_pair
    from repro_torch.serving import http_client as hc
    from repro_torch.serving.engine import Engine, EngineConfig, SamplingParams

    prompt = np.arange(5, 17, dtype=np.int32)
    sp = SamplingParams(max_tokens=16)
    target, draft = build_pair(seed=0, s_max=256, quantize=True, device="cuda")
    outs, _ = Engine(target, draft, EngineConfig(max_batch=4, page_size=16),
                     device="cuda").run([prompt], sp)
    want = outs[0].tolist()
    del target, draft
    env = dict(os.environ, PYTHONUNBUFFERED="1", PYTHONPATH=os.pathsep.join(
        p for p in (os.path.join(ROOT, "src"), os.environ.get("PYTHONPATH")) if p))
    t0 = time.perf_counter()
    proc = subprocess.Popen([sys.executable, "-m", "repro_torch.serving.server", "--port", "0"],
                            cwd=ROOT, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    lines: "queue.Queue[str]" = queue.Queue()
    threading.Thread(target=lambda: [lines.put(ln) for ln in proc.stdout], daemon=True).start()
    try:
        port, seen = None, []
        while port is None and time.perf_counter() - t0 < timeout_s:
            try:
                line = lines.get(timeout=1.0)
            except queue.Empty:
                if proc.poll() is not None:
                    break
                continue
            seen.append(line)
            if "listening on http://" in line:
                port = int(line.split("listening on http://")[1].split()[0].rsplit(":", 1)[1])
        if port is None:
            raise AssertionError(f"server CLI did not start: {''.join(seen)[-2000:]}")
        startup = time.perf_counter() - t0

        async def ask():
            status, _, chunks = await hc.sse_request(port, {"prompt": prompt.tolist(),
                                                            "max_tokens": sp.max_tokens})
            health = (await hc.request(port, "GET", "/healthz"))[0]
            return status, [c["token"] for c in chunks if c["token"] is not None], health

        status, got, health = asyncio.run(ask())
    finally:
        proc.terminate()
        try:
            proc.wait(timeout=30)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait()
    emit(phase="server_cli", startup_s=startup, status=status, healthz=health,
         equal=got == want, emitted=len(got))
    if status != 200 or health != 200 or got != want:
        raise AssertionError(f"server CLI: status {status}, /healthz {health}, "
                             f"tokens {got} against Engine.run {want}")


# ---------------------------------------------------------------------------
# Phases 19-20: the legacy host-gather loop and the quickstart's steps
# ---------------------------------------------------------------------------


def phase_host_path(dev, pair, fp_outs, main_report):
    """The legacy host-gather loop on the card: ``serve_batch(...,
    BatchConfig(max_batch=4, max_tokens=32, kv_path="host"))`` over the
    main path's pair and requests.  Host pools; every round the whole
    (n_layers, 4, s_max, kv heads, hd) K and V buffers of each model go up
    and come back.  Every main-path kernel launches (the rotation once per
    layer of each target forward), each row equals the main path's except
    at a near-tie, the sinks saw every token, and the copy seconds are
    counted.  Prints tokens/s beside the main path's, rounds, copy ms and
    K/V bytes moved per round."""
    from repro_torch.core import prng
    from repro_torch.kernels import _lib
    from repro_torch.models import layers as L
    from repro_torch.serving import engine as E
    from repro_torch.serving.batcher import BatchConfig
    from repro_torch.serving.engine import SamplingParams

    target, draft, prompts = pair
    cfg = BatchConfig(max_batch=4, max_tokens=32, kv_path="host")
    sinks = [[] for _ in prompts]
    _lib.launches.clear()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    outs, summary = E.serve_batch(prng.PRNGKey(SEED), target, draft, prompts, cfg,
                                  sinks=[s.append for s in sinks])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(_lib.launches)
    outs = [o.tolist() for o in outs]
    emitted = sum(len(o) for o in outs)
    rounds = summary["rounds"]
    # per round each model's K and V buffers go up whole and come back whole
    per_round = 2 * sum(
        2 * m.cfg.n_layers * cfg.max_batch * m.s_max * L.kv_store_heads(m.cfg) * m.cfg.hd
        * m.cfg.tdtype.itemsize for m in (target, draft))
    emit(phase="host_path", requests=len(outs), emitted=emitted, wall_s=wall,
         tokens_per_s=emitted / wall, main_path_tokens_per_s=main_report["tokens_per_s"],
         over_main_path=emitted / wall / main_report["tokens_per_s"], rounds=rounds,
         steps=summary["steps"], acceptance_rate=summary["acceptance_rate"],
         kv_copy_s=summary["kv_copy_s"], kv_copy_ms_per_round=summary["kv_copy_s"] * 1e3 / rounds,
         kv_bytes_moved_per_round=per_round,
         target_kv_bytes_per_row_per_round=2 * target.cfg.n_layers * target.s_max
         * L.kv_store_heads(target.cfg) * target.cfg.hd * target.cfg.tdtype.itemsize,
         copy_bytes_per_s=per_round * rounds / summary["kv_copy_s"], launches=launches)
    missing = [k for k in MAIN_KERNELS if launches.get(k, 0) <= 0]
    if missing:
        raise AssertionError(f"host_path did not launch {missing}")
    _check_rotations("host_path", launches, target.cfg.n_layers)
    if sinks != outs or [len(o) for o in outs] != [cfg.max_tokens] * len(prompts):
        raise AssertionError("host_path: a sink missed tokens or a request did not drain")
    if summary["kv_path"] != "host" or not summary["kv_copy_s"] > 0.0:
        raise AssertionError(f"host_path: summary {summary['kv_path']}, "
                             f"kv_copy_s {summary['kv_copy_s']}")
    _compare_decisions("host_path", target, prompts,
                       [SamplingParams(max_tokens=cfg.max_tokens)] * len(prompts), outs, fp_outs,
                       None, None, ["none"] * len(prompts))
    return launches


def phase_quickstart_path(dev, pair):
    """examples/quickstart.py's steps through the port on the card: the
    offline-quantized linear layer (``quantized_linear_apply``, the W4A8
    kernel) at M = 32 on the target's (4096, 11008) and (11008, 4096)
    weights with 3 outlier channels, plain and LRU-rotated (the R2
    rotation kernel), each equal to the CPU plain version within rtol
    1e-6, with its SQNR against the float product; kurtosis before and
    after the rotation (it must fall: the tiled 11008 plan mixes an
    outlier over two 256-wide blocks only, so by less than the exact 4096
    plan); the draft's bits per weight; the
    Markov LM at vocab 64 through ``sd_generate`` and ``apsd_generate`` on
    the card (greedy equal to ``markov_greedy_decode``, a sampled run
    replayed from its key identical); and ``fig6_table()`` on the host,
    every row inside ``PAPER_BANDS``."""
    from repro_torch.core import bvq, prng, toylm
    from repro_torch.core import perfmodel as pm
    from repro_torch.core import quantization as q
    from repro_torch.core import rotation as rot
    from repro_torch.core.apsd import APSDConfig, apsd_generate
    from repro_torch.core.speculative import SDConfig, sd_generate
    from repro_torch.kernels import _lib, ops
    from repro_torch.launch.serve import PAIR_BVQ

    _, draft, _ = pair
    t0 = time.perf_counter()
    _lib.launches.clear()
    g = torch.Generator(device=dev).manual_seed(SEED)
    bad = []
    for k, n in ((4096, 11008), (11008, 4096)):
        plan = rot.plan_rotation(k)
        x = torch.randn(32, k, generator=g, device=dev)
        x[:, [7, k // 3, k - 5]] *= 80.0
        w = torch.randn(k, n, generator=g, device=dev) * 0.05
        ref = (x.double() @ w.double()).float()
        xr = ops.lru_rotate(x, plan)
        wr = rot.rotate_weight_in(w, plan)
        kurt = [float(rot.kurtosis(a).mean()) for a in (x, xr)]
        arms = {}
        for arm, (xa, wa) in (("plain", (x, w)), ("lru", (xr, wr))):
            ql = q.quantize_linear_weights(wa)
            y = q.quantized_linear_apply(xa, ql)
            y_cpu = q.quantized_linear_apply(xa.cpu(), q.QuantizedLinear(ql.wq.cpu(), ql.sw.cpu()))
            err = float((y.cpu() - y_cpu).abs().max())
            close = bool(torch.allclose(y.cpu(), y_cpu, rtol=1e-6, atol=1e-6))
            arms[arm] = {"sqnr_db": q.sqnr_db(ref, y), "max_abs_err_vs_cpu": err,
                         "within_rtol_1e-6": close}
            if not close:
                bad.append(f"quantized_linear_apply {arm} ({k}, {n}): max err {err}")
        emit(phase="quickstart_path_w4a8", shape=[32, k, n], plan=[plan.kind, plan.m, plan.k],
             kurtosis_before=kurt[0], kurtosis_after=kurt[1], **arms)
        if not kurt[1] < kurt[0]:
            bad.append(f"kurtosis ({k}): {kurt[0]} -> {kurt[1]}, the rotation did not lower it")
    bits = {name: bvq.bits_per_weight(PAIR_BVQ, lin["idx"].shape[1] * lin["cb"].shape[-1],
                                      lin["cb"].shape[0] * lin["idx"].shape[-1])
            for name, lin in draft.params["layers"][0].items() if "cb" in lin}
    kt, kd = prng.split(prng.PRNGKey(1))
    tp = toylm.random_transition_logits(kt, 64, sharpness=2.0)
    dp = tp + np.float32(0.8) * prng.normal(kd, (64, 64))
    tp_d, dp_d = (torch.from_numpy(a).to(dev) for a in (tp, dp))
    lm_iface = toylm.make_markov_lm(max_len=512, device=dev)
    prompt = torch.tensor([[3, 5]], dtype=torch.int32, device=dev)
    want = toylm.markov_greedy_decode(tp, 5, 32).tolist()
    markov = {}
    for name, gen, cfg in (
            ("sd", sd_generate, SDConfig(draft_len=4, temperature=0.0, max_tokens=32)),
            ("apsd", apsd_generate, APSDConfig(short_dl=2, long_dl=6, temperature=0.0,
                                               max_tokens=32)),
            ("sd_sampled", sd_generate, SDConfig(draft_len=4, temperature=0.8, max_tokens=32)),
            ("apsd_sampled", apsd_generate, APSDConfig(short_dl=2, long_dl=6, temperature=0.8,
                                                       max_tokens=32))):
        runs = [gen(prng.PRNGKey(2), lm_iface, tp_d, lm_iface, dp_d, prompt, cfg)
                for _ in range(2)]
        toks = [r[0].tolist() for r in runs]
        markov[name] = {"acceptance": runs[0][1].accepted / max(runs[0][1].drafted, 1),
                        "rounds": runs[0][1].rounds, "replay_identical": toks[0] == toks[1]}
        if toks[0] != toks[1] or len(toks[0]) != 32:
            bad.append(f"markov {name}: replay differs or short: {toks}")
        if cfg.temperature == 0.0:
            markov[name]["equal_to_greedy"] = toks[0] == want
            if toks[0] != want:
                bad.append(f"markov {name}: {toks[0]} against greedy {want}")
    table = pm.fig6_table()
    outside = [(row["pair"], key, row[key]) for row in table
               for key, (lo, hi) in pm.PAPER_BANDS.items() if not lo <= row[key] <= hi]
    launches = dict(_lib.launches)
    emit(phase="quickstart_path", draft_bits_per_weight=bits, markov=markov,
         fig6=[{k: row[k] for k in ("pair", "total_speedup", "tok_per_s", "energy_savings")}
               for row in table], fig6_outside_bands=outside, launches=launches,
         seconds=time.perf_counter() - t0)
    bad += [f"fig6 {o} outside PAPER_BANDS" for o in outside]
    bad += [f"quickstart_path did not launch {k}" for k in ("w4a8_matmul", "block_rotate")
            if launches.get(k, 0) <= 0]
    if bad:
        raise AssertionError("quickstart_path:\n" + "\n".join(bad))
    return launches


def _paged_greedy(target, prompt, n):
    """Target-only greedy decode through the engine's own paged path
    (``_paged_replay``).  Every op of a forward gives a row the same bits
    at any row count, so a lossless greedy speculative decode must
    reproduce these tokens exactly."""
    return _paged_replay(target, prompt, n)


def _paged_replay(target, prompt, n, forced=()):
    """``n`` argmax tokens through the engine's own paged path: the dense
    prefill of prompt[:-1] scattered into a one-request fp store, then
    one-token paged steps, over a table as wide as an engine's at
    ``max_model_len = s_max``; step j feeds ``forced[j - 1]`` where
    given, else the previous step's argmax."""
    from repro_torch.serving import engine as E
    from repro_torch.serving.paged_cache import device_pool_store, pages_for

    dev = target.device
    pool = E._pool_for(target, E.EngineConfig(max_batch=1), [target.s_max])
    store = device_pool_store(pool, dev, "none")
    table = torch.arange(pages_for(target.s_max, pool.page_size), dtype=torch.int32,
                         device=dev)[None]
    tokens = torch.as_tensor(prompt, dtype=torch.int32, device=dev)[None]
    _, cache = E.make_interface(target).prefill(target.params, tokens[:, :-1])
    E._scatter_prefill(store, cache["attn"]["k"][:, 0], cache["attn"]["v"][:, 0], table[0],
                       tokens.shape[1] - 1)
    step, cur, out = E._make_paged_step(target), tokens[:, -1:], []
    for i in range(n):
        length = torch.tensor([tokens.shape[1] - 1 + i], dtype=torch.int32, device=dev)
        cur = torch.argmax(step(target.params, cur, store, table, length)[:, -1], dim=-1)
        cur = cur.to(torch.int32).reshape(1, 1)
        out.append(int(cur))
        if i < len(forced):
            cur = torch.tensor([[forced[i]]], dtype=torch.int32, device=dev)
    return out


def phase_dense_path(dev, prompts, profile=False):
    """The dense pair at the paper's widths (``build_paper_pair(quantize=
    False)``: a bf16 LLaMA2-7B-width target, 32 layers, and a bf16
    LLaMA-68M-width draft) served at ``EngineConfig()``, the main path's
    prompts, 32 tokens each: paged attention launches and no matmul or
    rotation kernel does; each row equals the target-only greedy decode
    through the paged path (``_paged_greedy``) except at a near-tie.  The
    dense-cache decode (``greedy_reference``: bf16 attention operands
    where the paged kernel computes in f32) is compared and reported, as
    on the main path.  Frees the pair before it returns."""
    from repro_torch.launch.serve import build_paper_pair, greedy_reference
    from repro_torch.serving.engine import Engine, EngineConfig, SamplingParams

    t0 = time.perf_counter()
    target, draft = build_paper_pair(seed=SEED, s_max=256, quantize=False, device=dev)
    torch.cuda.synchronize()
    params = sum(t.numel() for t in _tensors(target.params))
    print(f"built dense paper pair in {time.perf_counter() - t0:.1f} s "
          f"(target {params} parameters, {torch.cuda.memory_allocated(dev)} bytes allocated)")
    sp = SamplingParams(max_tokens=32)
    outs, launches = _drive("dense_path", Engine(target, draft, EngineConfig(), device=dev),
                            prompts, sp, dev, needs=["paged_attention"])
    _no_quantized("dense_path", launches)
    dense = _compare_rows(target, prompts, outs,
                          [greedy_reference(target, p, sp.max_tokens) for p in prompts],
                          [None] * len(prompts))
    emit(phase="dense_path_dense_cache_check", equal=f"{sum(r['equal'] for r in dense)}"
         f"/{len(dense)}", rows=dense, gated=False)
    want = [_paged_greedy(target, p, sp.max_tokens) for p in prompts]
    _compare_decisions("dense_path", target, prompts, [sp] * len(prompts), outs, want, None,
                       None, ["none"] * len(prompts))
    if profile:
        phase_profile(dev, (target, draft, prompts), "dense_path", EngineConfig(),
                      [sp] * len(prompts))
    del target, draft
    torch.cuda.empty_cache()
    return launches


# ---------------------------------------------------------------------------
# Phases 20-23: the repo's public configurations
# ---------------------------------------------------------------------------

QUANTIZED_KERNELS = ("w4a8_matmul", "bvq_matmul", "block_rotate")


def _build_arch(arch, quantize, dev):
    """``launch.serve.build_arch_pair``: the target at the config's full
    width and depth, the draft the same config cut to 2 layers."""
    from repro_torch.core.costs import tensor_bytes
    from repro_torch.launch.serve import build_arch_pair
    from repro_torch.models.lm import param_count

    t0 = time.perf_counter()
    target, draft = build_arch_pair(arch, seed=SEED, s_max=256, quantize=quantize, device=dev)
    torch.cuda.synchronize()
    emit(phase=f"build_{arch}", seconds=time.perf_counter() - t0, target=target.cfg.name,
         target_mode=target.mode, target_layers=target.cfg.n_layers,
         target_parameters=None if quantize else param_count(target.params),
         target_bytes=tensor_bytes(target.params), draft_mode=draft.mode,
         reduced=[f"draft: {target.cfg.n_layers} -> {draft.cfg.n_layers} layers"],
         memory_allocated=torch.cuda.memory_allocated(dev))
    return target, draft


def _no_quantized(phase, launches):
    ran = [k for k in QUANTIZED_KERNELS if launches.get(k)]
    if ran:
        raise AssertionError(f"{phase}: a bf16 path launched {ran}")


def phase_qwen3_path(dev, profile=False):
    """Qwen3-8B at full width and depth (36 layers, GQA 32/8, qk-norm, d_ff
    12288, vocab 151,936) as a W4A8 + LRU target (R2 plan n = 12288, m =
    12) with a 2-layer BVQ draft of the same config: ``EngineConfig()``
    (rows equal the target-only paged greedy decode except at a near-tie;
    every main-path kernel launches, block_rotate once per layer of each
    target forward), int8 KV (reported against the fp rows), mixed KV +
    tree (each row equals the chain row of its kind except at a near-tie;
    both tree bodies launch), and the target drafting for itself
    (``adaptive=True``: PAR reached, acceptance 1.0).  Frees the pair."""
    from repro_torch.serving.engine import Engine, EngineConfig, SamplingParams

    target, draft = _build_arch("qwen3-8b", True, dev)
    prompts = _prompts(4, 32, 128, target.cfg.vocab, SEED)
    sp = SamplingParams(max_tokens=32)
    launches = {}
    outs, launches["qwen3_path"] = _drive("qwen3_path",
                                          Engine(target, draft, EngineConfig(), device=dev),
                                          prompts, sp, dev, needs=MAIN_KERNELS)
    _check_rotations("qwen3_path", launches["qwen3_path"], target.cfg.n_layers)
    _compare_decisions("qwen3_path", target, prompts, [sp] * len(prompts), outs,
                       [_paged_greedy(target, p, sp.max_tokens) for p in prompts], None, None,
                       ["none"] * len(prompts))
    if profile:
        phase_profile(dev, (target, draft, prompts), "qwen3_path", EngineConfig(),
                      [sp] * len(prompts))
    int8_outs, launches["qwen3_int8_path"] = _drive(
        "qwen3_int8_path", Engine(target, draft, EngineConfig(kv_quant="int8"), device=dev),
        prompts, sp, dev, needs=["w4a8_matmul", "block_rotate", "bvq_matmul",
                                 "paged_attention_int8"])
    rows = _compare_rows(target, prompts, int8_outs, outs, ["none"] * len(prompts))
    emit(phase="qwen3_int8_path_check", equal_to_fp=f"{sum(r['equal'] for r in rows)}"
         f"/{len(rows)}", rows=rows, gated=False)
    kinds = ["int8" if i % 2 else "none" for i in range(len(prompts))]
    eng = Engine(target, draft, EngineConfig(kv_quant="mixed", spec_mode="tree"), device=dev)
    tree_outs, launches["qwen3_tree_path"] = _drive(
        "qwen3_tree_path", eng, prompts, [SamplingParams(max_tokens=32, kv_quant=k)
                                          for k in kinds], dev,
        needs=["w4a8_matmul", "block_rotate", "bvq_matmul", "paged_attention_tree",
               "paged_attention_int8_tree"])
    _check_rotations("qwen3_tree_path", launches["qwen3_tree_path"], target.cfg.n_layers)
    want = [i8 if k == "int8" else fp for k, fp, i8 in zip(kinds, outs, int8_outs)]
    rows = _compare_rows(target, prompts, tree_outs, want, kinds)
    emit(phase="qwen3_tree_path_check", equal_to_chain=f"{sum(r['equal'] for r in rows)}"
         f"/{len(rows)}", rows=rows, near_tie=NEAR_TIE)
    bad = [r for r in rows if not r["equal"] and not _near_tie(r)]
    if bad:
        raise AssertionError(f"qwen3 tree rows differ from the chain rows beyond a near-tie: {bad}")
    launches["qwen3_self_draft_path"] = _self_draft(
        "qwen3_self_draft_path", dev, target, prompts, outs, EngineConfig(adaptive=True),
        ["w4a8_matmul", "block_rotate", "paged_attention"], rotations=True)
    del target, draft, eng
    torch.cuda.empty_cache()
    return launches


def _greedy_dense(forward, params, cfg, tokens, steps, dev):
    """A prefill of ``tokens`` (B, P) and ``steps`` greedy one-token steps
    over a dense cache: (B, steps + 1) tokens, the top-2 logit margin of
    each, and the wall seconds (host clock, synchronized)."""
    from repro_torch.models import lm

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    cache = lm.init_cache(cfg, tokens.shape[0], tokens.shape[1] + steps + 1, dev)
    logits, cache = forward(params, cfg, tokens, cache)
    out, margins = [], []
    for i in range(steps + 1):
        top2 = torch.topk(logits[:, -1].float(), 2).values
        margins.append(top2[:, 0] - top2[:, 1])
        out.append(torch.argmax(logits[:, -1], dim=-1).to(torch.int32))
        if i < steps:
            logits, cache = forward(params, cfg, out[-1][:, None], cache)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    return (torch.stack(out, 1).tolist(), torch.stack(margins, 1).tolist(), wall)


def _moe_w4a8(dev, target, prompts, steps=16):
    """The W4A8 MoE forward (``quantize_moe_lm`` + ``apply_quantized_moe_lm``,
    dense cache) from the bf16 target's weights, each bf16 layer freed as
    it is packed: a prefill of the prompts (cut to the shortest) and
    ``steps`` greedy steps with the card's kernels, then again with the
    plain versions on the card (``ops.w4a8_matmul`` swapped for
    ``ref.w4a8_matmul_ref2``), both timed.  Tokens must be equal except at
    a near-tie: the top-2 margin, or, where a row differs, both runs
    repeated with their expert selections recorded (``_RouterLog``; the
    kernel run must repeat its tokens bit for bit) and the row's first
    differing selections held by ``_expert_flips``.  w4a8 must launch in
    the first run, never in the second.  Returns the first run's
    launches."""
    from repro_torch.core.costs import tensor_bytes
    from repro_torch.kernels import _lib, ops, ref
    from repro_torch.kernels.w4a8_matmul import unprepack
    from repro_torch.serving import quantized_lm as qlm

    cfg, params = target.cfg, target.params
    t0 = time.perf_counter()
    qparams = qlm.quantize_moe_lm(dict(params, layers=[]), cfg)  # embedding, head, norm
    layers = params["layers"]
    for i in range(len(layers)):
        qparams["layers"].append(qlm.quantize_moe_layer(layers[i], cfg))
        layers[i] = None  # the bf16 experts go as their int4 copy arrives
    torch.cuda.synchronize()
    emit(phase="moe_w4a8_build", seconds=time.perf_counter() - t0,
         bytes=tensor_bytes(qparams), memory_allocated=torch.cuda.memory_allocated(dev))
    n = min(len(p) for p in prompts)
    tokens = torch.as_tensor(np.stack([p[:n] for p in prompts]), device=dev)
    def run(record):
        with _RouterLog() if record else contextlib.nullcontext() as log:
            out = _greedy_dense(qlm.apply_quantized_moe_lm, qparams, cfg, tokens, steps, dev)
        return out, log

    def plain(xq, wp, sx, sw):
        return ref.w4a8_matmul_ref2(xq, unprepack(wp, xq.shape[1], sw.shape[-1]), sx, sw)

    def run_plain(record):
        saved, ops.w4a8_matmul = ops.w4a8_matmul, plain
        try:
            return run(record)
        finally:
            ops.w4a8_matmul = saved

    _lib.launches.clear()
    (got, margins, wall), _ = run(False)
    launches = dict(_lib.launches)
    _lib.launches.clear()
    (want, _, plain_wall), _ = run_plain(False)
    plain_launches = dict(_lib.launches)
    rows, logs = [], None
    for r, (a, b, m) in enumerate(zip(got, want, margins)):
        if a == b:
            rows.append({"equal": True})
            continue
        if logs is None:
            (again, _, _), log_k = run(True)
            if again != got:
                raise AssertionError("moe_w4a8_path: the kernel run did not repeat its tokens")
            logs = (log_k, run_plain(True)[1])
        i = next(j for j in range(len(a)) if a[j] != b[j])
        rows.append({"equal": False, "row": r, "position": i, "top2_margin": m[i],
                     "router": _expert_flips(*logs, cfg.n_layers, r, n - 1 + i)})
    emit(phase="moe_w4a8_path", rows=len(prompts), prompt_len=n, tokens=steps + 1,
         wall_s=wall, tokens_per_s=len(prompts) * (steps + 1) / wall, plain_wall_s=plain_wall,
         launches=launches, plain_launches=plain_launches,
         equal_to_plain=f"{sum(r['equal'] for r in rows)}/{len(rows)}", divergences=rows)
    if launches.get("w4a8_matmul", 0) <= 0 or plain_launches.get("w4a8_matmul", 0):
        raise AssertionError(f"moe_w4a8_path: w4a8 launches {launches} / plain {plain_launches}")
    bad = [r for r in rows if not r["equal"] and not _near_tie(r)]
    if bad:
        raise AssertionError(f"moe_w4a8_path: kernel and plain tokens differ beyond a near-tie: "
                             f"{bad}")
    del qparams
    return launches


def phase_moe_path(dev, profile=False):
    """``moonshot-v1-16b-a3b`` as the repo defines it (48 layers, 64
    experts top-6, d_ff 1408 per expert; ~28 B parameters, ~56 GB in bf16)
    at full width and depth with a 2-layer bf16 draft, over paged KV at
    ``EngineConfig()``: paged attention launches, no quantized kernel
    does, rows equal the target-only paged greedy decode except at a
    top-2 near-tie; then the target drafting for itself
    (``adaptive=True``: PAR, acceptance 1.0); then the W4A8 MoE forward
    built from the same weights (``_moe_w4a8``).  Frees the models."""
    from repro_torch.serving.engine import Engine, EngineConfig, SamplingParams

    target, draft = _build_arch("moonshot-v1-16b-a3b", False, dev)
    prompts = _prompts(4, 32, 128, target.cfg.vocab, SEED)
    sp = SamplingParams(max_tokens=32)
    launches = {}
    outs, launches["moe_path"] = _drive("moe_path",
                                        Engine(target, draft, EngineConfig(), device=dev),
                                        prompts, sp, dev, needs=["paged_attention"])
    _no_quantized("moe_path", launches["moe_path"])
    _compare_decisions("moe_path", target, prompts, [sp] * len(prompts), outs,
                       [_paged_greedy(target, p, sp.max_tokens) for p in prompts], None, None,
                       ["none"] * len(prompts))
    if profile:
        phase_profile(dev, (target, draft, prompts), "moe_path", EngineConfig(),
                      [sp] * len(prompts))
    del draft
    launches["moe_self_draft_path"] = _self_draft(
        "moe_self_draft_path", dev, target, prompts, outs, EngineConfig(adaptive=True),
        ["paged_attention"], rotations=False)
    launches["moe_w4a8_path"] = _moe_w4a8(dev, target, prompts)
    del target
    torch.cuda.empty_cache()
    return launches


def phase_nemotron_path(dev, profile=False):
    """Nemotron-4-15B (squared-ReLU MLP, GQA 48/8 so G = 6, vocab 256,000;
    ~15.6 B parameters, ~31 GB in bf16) at full width and depth with a
    2-layer bf16 draft, 2 requests x 16 tokens at ``EngineConfig()``:
    paged attention launches, no quantized kernel does, rows equal the
    target-only paged greedy decode except at a near-tie.  Frees the
    pair."""
    from repro_torch.serving.engine import Engine, EngineConfig, SamplingParams

    target, draft = _build_arch("nemotron-4-15b", False, dev)
    prompts = _prompts(2, 32, 128, target.cfg.vocab, SEED)
    sp = SamplingParams(max_tokens=16)
    outs, launches = _drive("nemotron_path", Engine(target, draft, EngineConfig(), device=dev),
                            prompts, sp, dev, needs=["paged_attention"])
    _no_quantized("nemotron_path", launches)
    _compare_decisions("nemotron_path", target, prompts, [sp] * len(prompts), outs,
                       [_paged_greedy(target, p, sp.max_tokens) for p in prompts], None, None,
                       ["none"] * len(prompts))
    if profile:
        phase_profile(dev, (target, draft, prompts), "nemotron_path", EngineConfig(),
                      [sp] * len(prompts))
    del target, draft
    torch.cuda.empty_cache()
    return {"nemotron_path": launches}


def phase_kvq8_path(dev):
    """``kvq8_path``: Qwen3-8B at full width, cut to KVQ8_LAYERS layers, in
    bf16 with ``ModelConfig.kv_quant`` (the dense int8 KV cache), built
    from SEED on the card (``launch.steps.build_params``): a prefill of
    TP_BATCH x TP_PROMPT seeded tokens and KVQ8_STEPS greedy steps through
    ``lm.apply_lm``, every one-token step's attention through K7 (counted:
    KVQ8_LAYERS x KVQ8_STEPS launches).  K7 on the run's own layer-0 int8
    cache and scales at full width (B = 4, S = KVQ8_S_MAX, 8 kv heads of G
    = 4, hd = 128) against its plain version within the kernel phase's
    2e-5.  The same weights and prompts on the CPU, where the step runs
    the reference's bfloat16 decode math (K7 keeps float32): tokens equal
    except at a near-tie of the bf16 logits (``_hold_rows``' bf16 rule:
    top-2 margin <= max(NEAR_TIE, BF16_NEAR_TIE_ULPS ulps of the top
    logit) at the first differing step; the first card call read a margin
    of one ulp, 0.03125 at a top logit in [4, 8))."""
    from repro_torch import configs
    from repro_torch.core.tree import tree_map
    from repro_torch.kernels import _lib, ref
    from repro_torch.kernels.decode_attn import decode_attention_int8
    from repro_torch.launch import mesh as M
    from repro_torch.launch import steps
    from repro_torch.models import lm

    cfg = dataclasses.replace(configs.get_config("qwen3-8b"), n_layers=KVQ8_LAYERS,
                              kv_quant=True)
    t0 = time.perf_counter()
    params = steps.build_params(cfg, M.make_mesh(dev), SEED)
    prompts = np.random.RandomState(SEED).randint(0, cfg.vocab, (TP_BATCH, TP_PROMPT))

    def greedy(p, device):
        toks = torch.as_tensor(prompts, device=device)
        with torch.no_grad():
            cache = lm.init_cache(cfg, TP_BATCH, KVQ8_S_MAX, device)
            logits, cache = lm.apply_lm(p, cfg, toks, cache=cache, last_logit_only=True)
            out, picked = [logits[:, -1].float().cpu()], [logits[:, -1].argmax(-1)]
            for _ in range(KVQ8_STEPS):
                logits, cache = lm.apply_lm(p, cfg, picked[-1][:, None], cache=cache)
                out.append(logits[:, -1].float().cpu())
                picked.append(logits[:, -1].argmax(-1))
        return {"logits": torch.stack(out, 1), "tokens": torch.stack(picked, 1).cpu()}, cache

    _lib.launches.clear()
    t1 = time.perf_counter()
    card, cache = greedy(params, dev)
    _sync(dev)
    card_s = time.perf_counter() - t1
    launches = dict(_lib.launches)
    if dev.type == "cuda" and launches.get("decode_attention_int8") != KVQ8_LAYERS * KVQ8_STEPS:
        raise AssertionError(f"kvq8_path: K7 launched {launches} for {KVQ8_LAYERS} layers x "
                             f"{KVQ8_STEPS} steps")
    attn = cache["attn"]
    length = int(cache["length"])
    g = torch.Generator(device=dev).manual_seed(SEED)
    q = torch.randn((TP_BATCH, 8, 4, cfg.hd), generator=g, device=dev).to(torch.bfloat16)
    args = (q, attn["k"][0], attn["k_scale"][0][..., 0], attn["v"][0],
            attn["v_scale"][0][..., 0], torch.tensor([length], dtype=torch.int32, device=dev))
    k7_err = float((decode_attention_int8(*args) - ref.decode_attn_int8_ref(*args)).abs().max())
    cpu_params = tree_map(lambda t: t.cpu(), params)
    del params, cache, attn, args
    _free(dev)
    t1 = time.perf_counter()
    cpu, _ = greedy(cpu_params, torch.device("cpu"))
    cpu_s = time.perf_counter() - t1
    emit(phase="kvq8_path", config=cfg.name, layers=cfg.n_layers, launches=launches,
         k7_on_path_cache={"shape": f"B={TP_BATCH} S={KVQ8_S_MAX} KVS=8 G=4 hd={cfg.hd}",
                           "length": length, "max_abs_err": k7_err, "tol": 2e-5},
         card_s=card_s, cpu_s=cpu_s, total_s=time.perf_counter() - t0)
    if not k7_err <= 2e-5:
        raise AssertionError(f"kvq8_path: K7 on the path's cache misses its plain version by "
                             f"{k7_err}")
    _hold_rows("kvq8_path", card, cpu, bf16=True)
    return launches


def phase_families_card_vs_cpu(dev):
    """The smoke configs of the three public paths, built on the CPU from
    SEED and copied to the card: ``qwen3-smoke`` as a W4A8 target with a
    BVQ draft (chain, and mixed KV + tree), ``moonshot-smoke`` and
    ``nemotron-smoke`` as bf16 pairs (chain); 4 greedy requests each
    through the port on cuda (kernels) and on cpu (plain versions): tokens
    equal except at a near-tie (top-2, or for the MoE pair the router rule
    of ``_router_flip``)."""
    from repro_torch.launch.serve import build_arch_pair, to_device
    from repro_torch.serving.engine import Engine, EngineConfig, SamplingParams

    bad = []
    for arch, quantize in (("qwen3-8b", True), ("moonshot-v1-16b-a3b", False),
                           ("nemotron-4-15b", False)):
        t_cpu, d_cpu = build_arch_pair(arch, seed=SEED, s_max=128, quantize=quantize, smoke=True,
                                       device="cpu")
        t_gpu, d_gpu = to_device(t_cpu, dev), to_device(d_cpu, dev)
        prompts = _prompts(4, 3, 24, t_cpu.cfg.vocab, SEED + 1)
        kinds = ["int8" if i % 2 else "none" for i in range(len(prompts))]
        runs = [("chain", EngineConfig(max_batch=4), [None] * len(prompts))]
        if quantize:
            runs.append(("mixed_tree", EngineConfig(max_batch=4, kv_quant="mixed",
                                                    spec_mode="tree"), kinds))
        for name, cfg, ks in runs:
            sps = [SamplingParams(max_tokens=32, kv_quant=k) for k in ks]
            gpu, _ = _run(Engine(t_gpu, d_gpu, cfg, device=dev), prompts, sps)
            cpu, _ = _run(Engine(t_cpu, d_cpu, cfg, device="cpu"), prompts, sps)
            gpu, cpu = [o.tolist() for o in gpu], [o.tolist() for o in cpu]
            routed = (t_gpu, t_cpu) if t_cpu.cfg.n_experts else None
            ties = _divergences(t_cpu, prompts, sps, gpu, cpu, None, None,
                                [None] * len(prompts), routed=routed)
            emit(phase="families_card_vs_cpu", config=t_cpu.cfg.name, engine=name,
                 equal=f"{len(prompts) - len(ties)}/{len(prompts)}", divergences=ties)
            bad += [dict(t, config=t_cpu.cfg.name, engine=name) for t in ties
                    if not t["near_tie"]]
    if bad:
        raise AssertionError(f"card and CPU tokens differ beyond a near-tie: {bad}")


# ---------------------------------------------------------------------------
# Phases 25-28: training, and the recurrent and encoder-decoder families
# ---------------------------------------------------------------------------

LOSS_DROP = 0.8  # the draft's last loss must be below this times its first
BF16_DECODE_FACTOR = 2.0  # bf16 decode's distance from the float32 logits over
# the bf16 re-forward's: both round one float32 function to bf16 in other
# orders (measured 1.00-1.20 on the card at full width); a decode that loses
# its state or a cache entry lands far outside, and the float32 gate holds
# the decode to its re-forward's argmax


def _train_steps(tr, n, dev, save_at=None):
    """``n`` steps of a Trainer, each timed on the host clock between device
    synchronizations (``float`` of the loss syncs, as ``Trainer.run``'s
    does); a checkpoint of ``save_at`` is queued as ``run`` queues one.
    Returns one dict per step."""
    rows = []
    for _ in range(n):
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        m = tr.train_step()
        loss, gnorm = float(m["loss"]), float(m["grad_norm"])
        rows.append({"step": tr.step, "loss": loss, "grad_norm": gnorm,
                     "ms": (time.perf_counter() - t0) * 1e3})
        if tr.step == save_at:
            tr.ckpt.save(tr.step, tr.checkpoint_tree())
        tr.step += 1
    return rows


def _profile_step(path, tr, dev):
    """One more Trainer step under torch.profiler (CPU and CUDA
    activities): its wall ms, summed device-kernel ms (their ratio is the
    device's busy share, a lower bound: the profiler adds host overhead),
    kernel launches, host ms, and the top aten ops by device time."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize(dev)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        float(tr.train_step()["loss"])
        torch.cuda.synchronize(dev)
        wall_ms = (time.perf_counter() - t0) * 1e3
    tr.step += 1
    events = prof.key_averages()
    device_ms = sum(e.self_device_time_total for e in events
                    if e.device_type == torch.autograd.DeviceType.CUDA) / 1e3
    ops = sorted((e for e in events if e.key.startswith("aten::")),
                 key=lambda e: e.self_device_time_total, reverse=True)[:10]
    emit(phase="profile", path=path, wall_ms=wall_ms, device_ms=device_ms,
         device_busy_share=device_ms / wall_ms,
         launches=sum(e.count for e in events if e.key == "cudaLaunchKernel"),
         host_ms=sum(e.self_cpu_time_total for e in events) / 1e3,
         top_device_ops=[[e.key, e.self_device_time_total / 1e3, e.count] for e in ops])


TRAIN_LAYERS = 24  # train_path's depth: its 48 layers wrote and read a 14.5 GB checkpoint


def phase_train_path(dev, profile=False):
    """The Trainer on mamba2-1.3b at full width, its depth cut to
    TRAIN_LAYERS of 48 for the run's time limit (d 2048, bf16, float32
    moments, remat), batch 4 x 512 tokens, 8 steps, a
    checkpoint at step 4: losses and grad norms finite, parameters moved;
    step ms (median of steps 1-7), tokens/s, peak GB, and the step's model
    FLOPs (6 N T; 8 N T with remat's second forward) over the bf16 peak.
    Then a fresh Trainer restores step 4 and runs steps 5-7: their losses
    and grad norms equal the first run's bit for bit (one card, the same
    ops; step 5 reads the restored parameters, steps 6-7 the restored
    moments and count as well).  ``profile``: one more step under
    torch.profiler (``_profile_step``)."""
    import gc
    import tempfile

    from repro_torch.configs import get_config
    from repro_torch.launch.steps import param_counts
    from repro_torch.launch.train import Trainer
    from repro_torch.models.lm import param_count

    cfg = dataclasses.replace(get_config("mamba2-1.3b"), n_layers=TRAIN_LAYERS)
    seq, batch, steps, save_at = 512, 4, 8, 4
    tmp = tempfile.mkdtemp(prefix="train_path_")
    try:
        free = shutil.disk_usage(tmp).free
        t0 = time.perf_counter()
        tr = Trainer(cfg, seq_len=seq, global_batch=batch, ckpt_dir=tmp, device=dev)
        torch.cuda.synchronize(dev)
        build_s = time.perf_counter() - t0
        n_params = param_count(tr.params)
        probe = {"head": tr.params["embed"]["head"][:256, :256].clone(),
                 "w_in": tr.params["layers"][0]["mamba"]["w_in"][:256, :256].clone()}
        torch.cuda.reset_peak_memory_stats(dev)
        rows = _train_steps(tr, steps, dev, save_at)
        peak = torch.cuda.max_memory_allocated(dev)
        t0 = time.perf_counter()
        tr.ckpt.wait()
        ckpt_wait_s = time.perf_counter() - t0
        moved = {"head": bool((tr.params["embed"]["head"][:256, :256] != probe["head"]).any()),
                 "w_in": bool((tr.params["layers"][0]["mamba"]["w_in"][:256, :256]
                               != probe["w_in"]).any())}
        ckpt_bytes = sum(os.path.getsize(os.path.join(r, f))
                         for r, _, fs in os.walk(tmp) for f in fs)
        del tr, probe
        gc.collect()
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        tr2 = Trainer(cfg, seq_len=seq, global_batch=batch, ckpt_dir=tmp, device=dev)
        restored = tr2.restore()
        torch.cuda.synchronize(dev)
        restore_s = time.perf_counter() - t0
        again = _train_steps(tr2, steps - save_at - 1, dev) if restored else []
        if profile:
            _profile_step("train_path", tr2, dev)
        del tr2
        gc.collect()
        torch.cuda.empty_cache()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    step_ms = float(np.median([r["ms"] for r in rows[1:]]))
    tokens = batch * seq
    model_flops = 6 * param_counts(cfg)["active"] * tokens
    restored_equal = [a["loss"] == b["loss"] and a["grad_norm"] == b["grad_norm"]
                      for a, b in zip(again, rows[save_at + 1:])]
    emit(phase="train_path", config=cfg.name, layers=cfg.n_layers, d_model=cfg.d_model,
         dtype=cfg.dtype, moments=cfg.optim_dtype, remat=cfg.remat, parameters=n_params,
         batch=batch, seq_len=seq, steps=rows, build_s=build_s, step_ms=step_ms,
         tokens_per_s=tokens / (step_ms / 1e3), peak_gb=peak / 1e9,
         model_flops_per_step=model_flops, remat_flops_per_step=model_flops * 8 / 6,
         model_flops_share_of_bf16_peak=model_flops / (step_ms / 1e3) / PEAK_OPS["bf16"],
         params_moved=moved, checkpoint_step=save_at, checkpoint_bytes=ckpt_bytes,
         disk_free_bytes=free, checkpoint_wait_s=ckpt_wait_s, restore_s=restore_s,
         restored_steps=again, restored_bitwise_equal=restored_equal)
    bad = [r for r in rows if not (math.isfinite(r["loss"]) and math.isfinite(r["grad_norm"]))]
    if bad:
        raise AssertionError(f"train_path: non-finite steps {bad}")
    if not all(moved.values()):
        raise AssertionError(f"train_path: parameters did not move: {moved}")
    if not restored or len(restored_equal) != steps - save_at - 1 or not all(restored_equal):
        raise AssertionError(f"train_path: restored steps {again} against "
                             f"{rows[save_at + 1:]} (bitwise)")


def phase_draft_train_path(dev, profile=False):
    """The paper's draft at LLaMA-68M widths (``configs/paper_pair.DLM``:
    2 layers, d 768, vocab 32,000, bf16) trained 200 steps on the synthetic
    stream, batch 32 x 256: the last loss below LOSS_DROP times the first
    (as examples/train_and_recover.py asserts); ms per step.
    ``profile``: one more step under torch.profiler."""
    from repro_torch.configs.paper_pair import DLM
    from repro_torch.launch.train import Trainer

    t0 = time.perf_counter()
    tr = Trainer(DLM, seq_len=256, global_batch=32, device=dev)
    rows = _train_steps(tr, 200, dev)
    wall = time.perf_counter() - t0
    first, last = rows[0]["loss"], rows[-1]["loss"]
    step_ms = float(np.median([r["ms"] for r in rows[1:]]))
    emit(phase="draft_train_path", config=DLM.name, batch=32, seq_len=256, steps=len(rows),
         first_loss=first, last_loss=last, ratio=last / first,
         losses_every_25=[r["loss"] for r in rows[::25]], step_ms=step_ms,
         tokens_per_s=32 * 256 / (step_ms / 1e3), wall_s=wall)
    if not last < LOSS_DROP * first:
        raise AssertionError(f"draft_train_path: loss {first} -> {last} did not fall below "
                             f"{LOSS_DROP}x")
    if profile:
        _profile_step("draft_train_path", tr, dev)
    del tr
    torch.cuda.empty_cache()


def phase_elastic_path(dev):
    """examples/train_and_recover.py's three phases through the port on the
    card, mamba2-smoke: 60 steps with a checkpoint every 20 (the loss must
    fall below 0.8x), a fresh Trainer restored from the latest checkpoint
    (its first loss below 0.9x the first run's first), and an
    ElasticTrainer over 4 hosts with a node lost at tick 25 (a restart on a
    smaller fleet, the last step 39)."""
    import tempfile

    from repro_torch.configs import get_smoke
    from repro_torch.launch.train import Trainer
    from repro_torch.runtime import ElasticTrainer, FaultToleranceConfig

    cfg = get_smoke("mamba2-1.3b")
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as d:
        tr = Trainer(cfg, seq_len=64, global_batch=8, ckpt_dir=d, device=dev)
        hist = tr.run(steps=60, ckpt_every=20, log_every=10**9)
        first, last = hist[0]["loss"], hist[-1]["loss"]
        tr2 = Trainer(cfg, seq_len=64, global_batch=8, ckpt_dir=d, device=dev)
        restored = tr2.restore()
        hist2 = tr2.run(steps=10, ckpt_every=100, log_every=10**9) if restored else [{}]
    failures = iter([None] * 25 + [2] + [None] * 100)
    with tempfile.TemporaryDirectory() as d2:
        def build(n_hosts, restore):
            t = Trainer(cfg, seq_len=64, global_batch=8, device=dev)
            if restore is not None:
                t.load_state(restore[1])

            def step_fn(state, step):
                t.step = step
                return state, {"loss": t.run(steps=1, ckpt_every=10**9,
                                             log_every=10**9)[0]["loss"]}

            return {"t": t}, step_fn

        et = ElasticTrainer(FaultToleranceConfig(ckpt_dir=d2, ckpt_every=10), n_hosts=4,
                            build_fn=build, state_to_tree=lambda s: s["t"].checkpoint_tree(),
                            failure_source=lambda: next(failures), min_hosts=2, device=dev)
        hist3 = et.run(40)
        et.ckpt.close()
    events = [h["event"] for h in hist3]
    steps = [h["step"] for h in hist3 if h["event"] == "step"]
    emit(phase="elastic_path", config=cfg.name, first_loss=first, last_loss=last,
         restored=restored, restart_step=tr2.step - 10 if restored else None,
         restarted_first_loss=hist2[0].get("loss"), elastic_steps=events.count("step"),
         restarts=events.count("restart"), fleet=et.n_hosts,
         restart_events=[h for h in hist3 if h["event"] == "restart"],
         wall_s=time.perf_counter() - t0)
    if not last < 0.8 * first:
        raise AssertionError(f"elastic_path: loss {first} -> {last} did not fall")
    if not restored or not hist2[0]["loss"] < 0.9 * first:
        raise AssertionError(f"elastic_path: the restart did not continue: {hist2[0]}")
    if "restart" not in events or steps[-1] != 39:
        raise AssertionError(f"elastic_path: events {events}")


def _greedy_family(params, cfg, prompts, frames, n, dev):
    """Greedy decode of ``n`` tokens through a prefill of prompts (B, P) and
    n - 1 cached one-token steps on ``dev`` (the card, or the CPU), then
    one full re-forward over the prompt and the tokens.  Returns a dict:
    ``tokens`` (B, n), ``step_logits`` (B, n, V) float32 (the logits each
    token was chosen from), ``seq`` (B, P + n - 1) the re-forward's input,
    ``full`` (B, n, V) float32 the re-forward's logits at those positions,
    ``prefill_ms`` and ``step_ms`` (ms per decode step)."""
    from repro_torch.models import lm

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    b, p = prompts.shape
    kw = {"frames": frames} if frames is not None else {}
    with torch.no_grad():
        sync()
        t0 = time.perf_counter()
        cache = lm.init_cache(cfg, b, p + n + 1, dev)
        logits, cache = lm.apply_lm(params, cfg, prompts, cache=cache, **kw)
        steps = [logits[:, -1].float()]
        out = [torch.argmax(logits[:, -1], dim=-1).to(torch.int32)]
        sync()
        t1 = time.perf_counter()
        for _ in range(n - 1):
            logits, cache = lm.apply_lm(params, cfg, out[-1][:, None], cache=cache)
            steps.append(logits[:, -1].float())
            out.append(torch.argmax(logits[:, -1], dim=-1).to(torch.int32))
        sync()
        t2 = time.perf_counter()
        toks = torch.stack(out, 1)
        seq = torch.cat([prompts, toks[:, :-1]], 1)
        full = _reforward(params, cfg, seq, frames, p)
    return {"tokens": toks, "step_logits": torch.stack(steps, 1), "seq": seq, "full": full,
            "prefill_ms": (t1 - t0) * 1e3, "step_ms": (t2 - t1) * 1e3 / max(n - 1, 1)}


def _reforward(params, cfg, seq, frames, p):
    """The full forward's float32 logits over seq (B, P + n - 1) at the n
    positions from P - 1 on (those greedy decode chose its tokens at)."""
    from repro_torch.models import lm

    kw = {"frames": frames} if frames is not None else {}
    with torch.no_grad():
        return lm.apply_lm(params, cfg, seq, **kw)[0][:, p - 1:].float()


def _family_rows(run):
    """Each row's positions where the decode differs from the re-forward's
    argmax, with the re-forward's top-2 margin; a row passes when every
    such position is a near-tie."""
    want = torch.argmax(run["full"], -1).tolist()
    top2 = torch.topk(run["full"], 2, dim=-1).values
    margins = (top2[..., 0] - top2[..., 1]).tolist()
    rows = []
    for r, (a, b, m) in enumerate(zip(run["tokens"].tolist(), want, margins)):
        diff = [{"position": i, "top2_margin": m[i]} for i in range(len(a)) if a[i] != b[i]]
        rows.append({"row": r, "equal": not diff, "differences": diff,
                     "near_tie": all(d["top2_margin"] <= NEAR_TIE for d in diff)})
    return rows


def _row_max_abs(a, b, vocab):
    """Per row of (B, n, V) logits: the largest |a - b| over the first
    ``vocab`` (a padded vocabulary's -1e9 logits round apart in bf16)."""
    return (a[..., :vocab] - b[..., :vocab]).abs().flatten(1).max(dim=1).values.tolist()


def phase_ssm_families_path(dev):
    """mamba2-1.3b, zamba2-7b (81 layers, 13 applications of the one shared
    attention block) and whisper-large-v3 (1,500 frames) at full width and
    depth, each built one layer at a time on the card in bf16 (the
    configs' dtype) and then cast to float32: in each dtype 2 x 16 greedy
    tokens through a 32-token prefill and cached decode, then one full
    re-forward over the prompt and the tokens.

    float32: each token equals the re-forward's argmax except at a
    near-tie (top-2 margin <= NEAR_TIE), where the two differ only in
    summation order.  bf16: a decode step and a prefill sum in another
    order and bf16 rounds the two apart, so each row's decode logits are
    held to the float32 re-forward of the same weights over the same
    tokens: their largest difference must stay within BF16_DECODE_FACTOR
    times the bf16 re-forward's own.  Printed beside it: the decode
    against the bf16 re-forward and, in the SSM families (whose scan is
    float32 in both paths), the bf16 re-forward at another ``ssm_chunk``,
    an exact change of summation order, against the first.  Then the three smoke configs, built
    on the CPU from SEED and copied: card tokens equal CPU tokens under
    the near-tie rule (at the first position a row differs, the top-2
    margin of the CPU run's re-forward)."""
    from repro_torch.configs import get_config, get_smoke
    from repro_torch.core.tree import tree_map
    from repro_torch.models import lm
    from repro_torch.models.common import Family

    archs = ("mamba2-1.3b", "zamba2-7b", "whisper-large-v3")
    bad = []
    for arch in archs:
        cfg = get_config(arch)
        cfg32 = dataclasses.replace(cfg, dtype="float32")
        t0 = time.perf_counter()
        params = lm.init_lm(torch.Generator(device=dev).manual_seed(SEED), cfg, dev)
        torch.cuda.synchronize(dev)
        build_s = time.perf_counter() - t0
        prompts = torch.as_tensor(np.random.RandomState(SEED).randint(0, cfg.vocab, (2, 32)),
                                  dtype=torch.int32, device=dev)
        frames = None
        if cfg.family is Family.AUDIO:
            frames = torch.randn((2, cfg.n_audio_frames, cfg.d_model),
                                 generator=torch.Generator(device=dev).manual_seed(SEED),
                                 device=dev).to(cfg.tdtype)
        n_params = lm.param_count(params)
        runs = {"bfloat16": _greedy_family(params, cfg, prompts, frames, 16, dev)}
        other_chunk = None
        if cfg.family in (Family.SSM, Family.HYBRID):
            other_chunk = min(16, cfg.ssm_chunk // 2)
            runs["bfloat16"]["full_other_chunk"] = _reforward(
                params, dataclasses.replace(cfg, ssm_chunk=other_chunk), runs["bfloat16"]["seq"],
                frames, prompts.shape[1])
        params = tree_map(lambda t: t.float(), params)
        frames = None if frames is None else frames.float()
        full32 = _reforward(params, cfg32, runs["bfloat16"]["seq"], frames, prompts.shape[1])
        runs["float32"] = _greedy_family(params, cfg32, prompts, frames, 16, dev)
        for dtype, run in runs.items():
            rows = _family_rows(run)
            extra = {}
            if dtype == "bfloat16":
                gap = _row_max_abs(run["step_logits"], run["full"], cfg.vocab)
                noise = _row_max_abs(run["full"], full32, cfg.vocab)
                extra = {"decode_vs_reforward_max_abs": gap,
                         "reforward_vs_float32_max_abs": noise,
                         "decode_vs_float32_max_abs": _row_max_abs(run["step_logits"], full32, cfg.vocab)}
                if other_chunk is not None:
                    extra["other_chunk"] = other_chunk
                    extra["reforward_vs_other_chunk_max_abs"] = _row_max_abs(
                        run["full_other_chunk"], run["full"], cfg.vocab)
                bad += [{"config": cfg.name, "row": r, "decode_vs_float32": g,
                         "reforward_vs_float32": e}
                        for r, (g, e) in enumerate(zip(extra["decode_vs_float32_max_abs"], noise))
                        if g > BF16_DECODE_FACTOR * e]
            else:
                extra = {"decode_vs_reforward_max_abs": _row_max_abs(
                    run["step_logits"], run["full"], cfg.vocab)}
                bad += [dict(r, config=cfg.name) for r in rows if not r["near_tie"]]
            emit(phase="ssm_families_path", config=cfg.name, family=cfg.family.value,
                 dtype=dtype, layers=cfg.n_layers, parameters=n_params, build_s=build_s,
                 prefill_ms=run["prefill_ms"], decode_ms_per_step=run["step_ms"],
                 decode_tokens_per_s=2 * 1e3 / run["step_ms"],
                 memory_allocated=torch.cuda.memory_allocated(dev),
                 equal_to_reforward=f"{sum(r['equal'] for r in rows)}/{len(rows)}", rows=rows,
                 near_tie=NEAR_TIE, **extra)
        del params, frames, runs, full32
        torch.cuda.empty_cache()
    for arch in archs:
        cfg = get_smoke(arch)
        params = lm.init_lm(torch.Generator().manual_seed(SEED), cfg, "cpu")
        prompts = torch.as_tensor(np.random.RandomState(SEED + 1).randint(0, cfg.vocab, (2, 8)),
                                  dtype=torch.int32)
        frames = (torch.randn((2, cfg.n_audio_frames, cfg.d_model),
                              generator=torch.Generator().manual_seed(SEED))
                  if cfg.family is Family.AUDIO else None)
        cpu = _greedy_family(params, cfg, prompts, frames, 16, torch.device("cpu"))
        card = _greedy_family(tree_map(lambda t: t.to(dev), params), cfg, prompts.to(dev),
                              None if frames is None else frames.to(dev), 16, dev)["tokens"]
        top2 = torch.topk(cpu["full"], 2, dim=-1).values
        margins = (top2[..., 0] - top2[..., 1]).tolist()
        rows = []
        for r, (a, b) in enumerate(zip(card.tolist(), cpu["tokens"].tolist())):
            i = next((j for j in range(len(a)) if a[j] != b[j]), None)
            rows.append({"row": r, "equal": i is None, "position": i,
                         "top2_margin": None if i is None else margins[r][i]})
        emit(phase="ssm_families_card_vs_cpu", config=cfg.name,
             equal=f"{sum(r['equal'] for r in rows)}/{len(rows)}", rows=rows)
        bad += [dict(r, config=cfg.name) for r in rows
                if not r["equal"] and r["top2_margin"] > NEAR_TIE]
    if bad:
        raise AssertionError(f"ssm_families_path: decode beyond its tolerance: {bad}")


# ---------------------------------------------------------------------------
# The sharded mesh (ranks sharing the card over gloo)
# ---------------------------------------------------------------------------

TP_PROMPT, TP_BATCH, TP_STEPS = 64, 4, 32  # tp paths: prefill 4 x 64, 32 greedy steps
CELL_STEPS = 16  # the launch cells' decode steps (after the same 4 x 64 prefill)
CELL_S_MAX = TP_PROMPT + CELL_STEPS + 1  # their dense caches' depth
# kvq8_path: Qwen3-8B in bf16 cut to 2 layers, 8 greedy steps: its CPU twin pads each
# step's 4 rows to a 128-row block (layers.linear) and took 42 s at 4 layers x 16 steps
KVQ8_LAYERS, KVQ8_STEPS = 2, 8
KVQ8_S_MAX = TP_PROMPT + KVQ8_STEPS + 1
# the launch cells of the (1, 2) world: name -> (arch, config fields, quant, depth cut
# at full width; the whole run took 942.6 s of the 1200 s limit at full depth):
# mamba2-1.3b 24 of 48 layers, zamba2-7b 27 of 81 (4 of the shared block's 13
# applications, the 3 tail blocks), whisper-large-v3 16 + 16 of 32 + 32, the
# w4a8+kvq8 cell 8 of Qwen3-8B's 36 (tp_path runs all 36)
CELLS = {"mamba2_cell_path": ("mamba2-1.3b", {}, None, {"n_layers": 24}),
         "zamba2_cell_path": ("zamba2-7b", {}, None, {"n_layers": 27}),
         "whisper_cell_path": ("whisper-large-v3", {}, None,
                               {"n_layers": 16, "n_encoder_layers": 16}),
         "w4a8_kvq8_cell_path": ("qwen3-8b", {"kv_quant": True}, "w4a8", {"n_layers": 8})}
# the cells ``--cpu-dry-run`` runs at smoke size (the others share their code; the
# tests run every family's smoke cells in their worlds)
SMOKE_CELLS = ("mamba2_cell_path", "w4a8_kvq8_cell_path")
# bf16 logits of the cells on (1, 2), teacher-forced, against one device, the prefill's
# and every decode step's: about four times the largest gap read on the H100 at the
# cut depths (PERF.md section 6: 0.2958984375, 0.25, 0.078125)
CELL_LOGIT_ATOL = {"mamba2_cell_path": 1.25, "zamba2_cell_path": 1.0,
                   "whisper_cell_path": 0.3125}
# the dry-run CLI's cells in dryrun_path: decode_32k of three families on both meshes
# (the whole grid's wall is in PERF.md)
DRYRUN_GRID = ("qwen3-8b", "mamba2-1.3b", "whisper-large-v3")
EP_LAYERS = 8  # ep_path depth: the (1, 1) reference and two half shards on one card
EP_PROMPT, EP_STEPS = 32, 8
MESH_TRAIN_STEPS, MESH_TRAIN_SAVE = 8, 4
BF16_NEAR_TIE_ULPS = 2  # bf16 logits: a near-tie in units of the top logit's last place
EP_BF16_RTOL = 2.0 ** -6  # bf16 a2a MoE layer against the dense combine: 4 ulps of the max
# Sharded against one device where partial sums add in other orders, each bound about
# four times the largest gap read on the H100 (PERF.md section 6, PR 23):
TP_BF16_PREFILL_ATOL = 0.5  # Nemotron bf16 prefill logits on (1, 2): read 0.140625
EP_PREFILL_ATOL = 2e-4  # Moonlight float32 prefill logits, a2a on (1, 2): read 3.9e-5
MESH_LOSS_ATOL = 3e-3  # bf16 training losses, (2, 2) against (1, 1): read 7.2e-4
MESH_NORM_RTOL = 3e-3  # and their grad norms, relative: read 7.5e-4
W4A8_MOE_RTOL = 5e-2  # relative RMS of a W4A8 a2a MoE layer's output against the dense
# combine on the dequantized experts: the a2a path quantizes the expert activations to
# int8 (the reference's _moe_a2a_quant), the dense one multiplies bf16 activations


def check_w4a8_shard(dev, timer, g, m, k, n, int32):
    """K1 at one shard's shape: scaled, or its int32 epilogue (a row
    shard's partial accumulators), against the plain version."""
    from repro_torch.core import quantization as q
    from repro_torch.kernels import ref
    from repro_torch.kernels.w4a8_matmul import prepack, w4a8_matmul, w4a8_matmul_int32

    if not int32:
        return check_w4a8(dev, timer, g, m, k, n)
    x = torch.randn((m, k), generator=g, device=dev)
    w = torch.randn((k, n), generator=g, device=dev) * 0.02
    xq, _ = q.quantize_act_int8(x)
    wq, sw = q.quantize_weight_int(w, bits=4, axis=0)
    wp = q.pack_int4(wq, axis=0)
    wpp = prepack(wp)
    got = w4a8_matmul_int32(xq, wpp, n)
    want = ref.w4a8_matmul_int32_ref(xq, wp)
    w_deq = (wq.float() * sw).to(torch.bfloat16)
    xb = x.to(torch.bfloat16)
    bound, by = bound_ms(m * k + k * n / 2 + 4 * m * n, 2.0 * m * k * n, "int8")
    return dict(
        max_abs_err=float((got - want).abs().max()), tol=0.0,
        repeat_bitwise_equal=bool(torch.equal(got, w4a8_matmul_int32(xq, wpp, n))),
        kernel_ms=timer.ms(lambda: w4a8_matmul_int32(xq, wpp, n)),
        plain_ms=timer.ms(lambda: ref.w4a8_matmul_int32_ref(xq, wp)),
        library_ms=timer.ms(lambda: torch.matmul(xb, w_deq)),
        bound_ms=bound, bound_by=by,
    )


def _shard_kernel_cases(dev, timer, g):
    """K1 at Qwen3-8B's shard shapes for tp 2 and 4, decode (M = 4) and
    the 4 x 64 prefill (M = 256): column shards at N / tp (scaled), row
    shards at K / tp (the int32 epilogue the path runs, and the scaled one
    beside it), the head at vocab / tp."""
    d, qkv, kv, f, vocab = 4096, 4096, 1024, 12288, 151936
    cases = []
    for tp in (2, 4):
        for m, what in ((TP_BATCH, "decode"), (TP_BATCH * TP_PROMPT, "prefill")):
            for name, k, n, rows in (("wq", d, qkv // tp, False), ("wk/wv", d, kv // tp, False),
                                     ("w_gate/w_up", d, f // tp, False),
                                     ("head", d, vocab // tp, False),
                                     ("wo", qkv // tp, d, True), ("w_down", f // tp, d, True)):
                # a row shard's int32 epilogue, timed beside the scaled one at its shape
                for int32 in ((False, True) if rows else (False,)):
                    kern = "w4a8_matmul_int32" if int32 else "w4a8_matmul"
                    cases.append((kern, f"Qwen3-8B tp={tp} {name} M={m} K={k} N={n} "
                                        f"({what} shard)",
                                  lambda m=m, k=k, n=n, int32=int32:
                                  check_w4a8_shard(dev, timer, g, m, k, n, int32)))
    return cases


def _rank_note(mesh):
    return {"rank": mesh.rank, "coords": mesh.coords, "backend": mesh.backend,
            "transport": mesh.transport, "device": str(mesh.device)}


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _peak_gb(dev):
    return torch.cuda.max_memory_allocated(dev) / 1e9 if dev.type == "cuda" else None


def _tp_decode(mesh, arch, quantize, n_layers=None, moe_fields=None, dev="cuda", smoke=False):
    """One rank's (or, without a mesh, one device's) run of a tp path: the
    target built from SEED (the config's smoke version with ``smoke``, a
    CPU dry run of the phase; cut to ``n_layers``), a prefill of TP_BATCH
    x TP_PROMPT seeded tokens and TP_STEPS greedy steps over the dense
    cache, timed; logits of the prefill's last position and of every step,
    the tokens, the kernels' launches, the collectives per decode step and
    the peak memory."""
    from repro_torch import configs
    from repro_torch.kernels import _lib
    from repro_torch.launch.serve import build_sharded_target
    from repro_torch.models import lm
    from repro_torch.serving import quantized_lm as qlm

    dev = mesh.device if mesh is not None else torch.device(dev)
    cfg = (configs.get_smoke if smoke else configs.get_config)(arch)
    if n_layers and not smoke:
        cfg = dataclasses.replace(cfg, n_layers=n_layers)
    if moe_fields:
        cfg = dataclasses.replace(cfg, **moe_fields)
    if dev.type == "cuda":
        torch.zeros(1, device=dev)  # the allocator's stats exist once CUDA is up
        torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    params = build_sharded_target(cfg, mesh, quantize=quantize, seed=SEED, device=dev)
    _sync(dev)
    build_s = time.perf_counter() - t0
    if quantize:
        fwd = (qlm.apply_quantized_moe_lm if cfg.n_experts else qlm.apply_quantized_lm)
    else:
        fwd = lm.apply_lm
    rng = np.random.RandomState(SEED)
    tokens = torch.as_tensor(rng.randint(0, cfg.vocab, (TP_BATCH, TP_PROMPT)), device=dev)
    tokens = lm.local_rows(tokens, mesh)
    steps = TP_STEPS if not cfg.n_experts else EP_STEPS
    cache = lm.init_cache(cfg, TP_BATCH, TP_PROMPT + steps + 1, dev, mesh=mesh)
    _lib.launches.clear()
    comm = mesh.comm if mesh is not None else None
    with torch.no_grad():
        _sync(dev)
        t0 = time.perf_counter()
        logits, cache = fwd(params, cfg, tokens, cache=cache, mesh=mesh)
        _sync(dev)
        prefill_s = time.perf_counter() - t0
        prefill_logits = logits[:, -1].float().cpu()
        step_logits, toks = [prefill_logits], [logits[:, -1].argmax(-1)]
        if comm is not None:
            comm.clear()
        t0 = time.perf_counter()
        for _ in range(steps):
            logits, cache = fwd(params, cfg, toks[-1][:, None], cache=cache, mesh=mesh)
            step_logits.append(logits[:, -1].float().cpu())
            toks.append(logits[:, -1].argmax(-1))
        _sync(dev)
        decode_s = time.perf_counter() - t0
    return {
        "mesh": None if mesh is None else dict(mesh.shape), "note": None if mesh is None
        else _rank_note(mesh), "keep": (mesh is None or mesh.coords["model"] == 0),
        "config": cfg.name, "layers": cfg.n_layers, "build_s": build_s,
        "prefill_ms": prefill_s * 1e3, "step_ms": decode_s * 1e3 / steps,
        "logits": torch.stack(step_logits, 1), "tokens": torch.stack(toks, 1).cpu(),
        "launches": dict(_lib.launches), "forwards": steps + 1,
        "comm_per_step": ({k: v / steps for k, v in comm.items()} if comm is not None else {}),
        "peak_gb": _peak_gb(dev),
    }


def _cell_names(smoke):
    return list(SMOKE_CELLS if smoke else CELLS)


def _cell_cfg(name, smoke):
    """(config, quant) of a launch cell: the arch's full config with its
    fields and depth cut, or its smoke config with its fields."""
    from repro_torch import configs

    arch, fields, quant, depth = CELLS[name]
    cfg = (configs.get_smoke if smoke else configs.get_config)(arch)
    return dataclasses.replace(cfg, **fields, **({} if smoke else depth)), quant


def _cell_decode(mesh, name, dev="cuda", smoke=False, forced=None):
    """One rank's (or, without a mesh, one device's) run of a launch cell
    (``CELLS[name]``): ``launch.steps.build_cell``'s prefill cell (TP_BATCH
    x TP_PROMPT seeded tokens, whisper's seeded frames, params from SEED,
    a CELL_S_MAX-deep dense cache) and then its decode cell's step for
    CELL_STEPS tokens over that cache: greedy, or teacher-forced on
    ``forced`` (another run's tokens, (TP_BATCH, CELL_STEPS + 1)), so each
    step's logits come from the same inputs as that run's.  The logits,
    the argmax tokens, launches and the collectives of the prefill and per
    decode step (calls and bytes by kind)."""
    from repro_torch.kernels import _lib
    from repro_torch.launch import mesh as M
    from repro_torch.launch import steps
    from repro_torch.models.common import ShapeConfig

    dev = mesh.device if mesh is not None else torch.device(dev)
    cfg, quant = _cell_cfg(name, smoke)
    m = mesh if mesh is not None else M.make_mesh(dev)
    if dev.type == "cuda":
        torch.zeros(1, device=dev)
        torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    prefill = steps.build_cell(cfg, ShapeConfig("prefill", TP_PROMPT, TP_BATCH, "prefill"), m,
                               seed=SEED, quant=quant, s_max=CELL_S_MAX)
    params = prefill.args[0]
    decode = steps.build_cell(cfg, ShapeConfig("decode", TP_PROMPT, TP_BATCH, "decode"), m,
                              seed=SEED, quant=quant, params=params)
    _sync(dev)
    build_s = time.perf_counter() - t0
    _lib.launches.clear()
    m.comm.clear()
    with torch.no_grad():
        _sync(dev)
        t0 = time.perf_counter()
        logits, cache = prefill.fn(*prefill.args)
        _sync(dev)
        prefill_s = time.perf_counter() - t0
        comm_prefill = dict(m.comm)
        m.comm.clear()
        step_logits, toks = [logits[:, -1].float().cpu()], [logits[:, -1].argmax(-1)]
        t0 = time.perf_counter()
        for i in range(CELL_STEPS):
            fed = toks[-1] if forced is None else forced[:, i].to(dev)
            logits, cache = decode.fn(params, fed[:, None].to(torch.int32), cache)
            step_logits.append(logits[:, -1].float().cpu())
            toks.append(logits[:, -1].argmax(-1))
        _sync(dev)
        decode_s = time.perf_counter() - t0
    per_step = {k: v / CELL_STEPS for k, v in m.comm.items()}
    return {
        "mesh": None if mesh is None else dict(mesh.shape),
        "note": None if mesh is None else _rank_note(mesh),
        "keep": mesh is None or mesh.coords["model"] == 0, "config": cfg.name,
        "layers": cfg.n_layers, "build_s": build_s, "prefill_ms": prefill_s * 1e3,
        "step_ms": decode_s * 1e3 / CELL_STEPS, "logits": torch.stack(step_logits, 1),
        "tokens": torch.stack(toks, 1).cpu(), "launches": dict(_lib.launches),
        "forwards": CELL_STEPS + 1, "comm_prefill": comm_prefill, "comm_per_step": per_step,
        "peak_gb": _peak_gb(dev), "cell": name,
    }


def _free(dev):
    if dev.type == "cuda":
        torch.cuda.empty_cache()


def _margins(logits):
    top2 = torch.topk(logits, 2, dim=-1).values
    return top2[..., 0] - top2[..., 1]


def _bf16_ulp(v: float) -> float:
    return 2.0 ** (math.floor(math.log2(abs(v))) - 7) if v else 0.0


def _hold_rows(phase, got, want, bf16=False):
    """Tokens of every row equal, except a row whose first differing step
    is a near-tie of the reference: top-2 margin <= NEAR_TIE, or, for bf16
    logits (whose sharded partial sums round in another order),
    <= BF16_NEAR_TIE_ULPS units in the last place of the top logit."""
    rows, bad = [], []
    margins = _margins(want["logits"])
    for b in range(want["tokens"].shape[0]):
        diff = (got["tokens"][b] != want["tokens"][b]).nonzero()
        first = int(diff[0]) if len(diff) else None
        margin = float(margins[b, first]) if first is not None else None
        tie = NEAR_TIE
        if first is not None and bf16:
            top = float(want["logits"][b, first].max())
            tie = max(NEAR_TIE, BF16_NEAR_TIE_ULPS * _bf16_ulp(top))
        rows.append({"row": b, "equal": first is None, "first_diff": first, "top2_margin": margin,
                     "near_tie": tie})
        if first is not None and margin > tie:
            bad.append(rows[-1])
    emit(phase=f"{phase}_rows", rows=rows,
         equal=f"{sum(r['equal'] for r in rows)}/{len(rows)}")
    if bad:
        raise AssertionError(f"{phase}: rows differ beyond a near-tie: {bad}")


def _hold_forced(phase, got, want, atol):
    """A teacher-forced run (``got``: every step fed ``want``'s token)
    against ``want``: the logits of the prefill and of every decode step
    within ``atol``.  Printed: each step's largest gap, and each step whose
    argmax differs with ``want``'s top-2 margin there in units of the top
    logit's last bf16 place (the bound admits a flip only where that
    margin is <= 2 atol)."""
    gaps = (got["logits"] - want["logits"]).abs().amax(dim=(0, 2))
    margins = _margins(want["logits"])
    flips = [{"row": b, "step": t, "top2_margin": float(margins[b, t]),
              "ulps": float(margins[b, t]) / _bf16_ulp(float(want["logits"][b, t].max()))}
             for b, t in (got["tokens"] != want["tokens"]).nonzero().tolist()]
    n = want["tokens"].numel()
    emit(phase=f"{phase}_forced", atol=atol, step_max_abs_logit_diff=gaps.tolist(),
         max_abs_logit_diff=float(gaps.max()), argmax_equal=f"{n - len(flips)}/{n}",
         flips=flips)
    if not float(gaps.max()) <= atol:
        raise AssertionError(f"{phase}: teacher-forced logits differ from one device's by "
                             f"{float(gaps.max())} > {atol} (steps: {gaps.tolist()})")


def _max_abs_logit(logits):
    """The largest |logit| but a padded vocabulary's -1e9 entries."""
    return float(logits[logits > -1e8].abs().max())


def _mesh_report(phase, one, ranks, prefill_atol=None):
    """Prints the sharded run against the one-device run; with
    ``prefill_atol`` fails where their prefill logits (computed from the
    same tokens, before any row can diverge) differ by more.  The logits of
    each row up to its first differing token are printed, not gated."""
    kept = [r for r in ranks if r["keep"]]
    got, want = kept[0], one
    pre = 0.0
    for b in range(want["tokens"].shape[0]):
        diff = (got["tokens"][b] != want["tokens"][b]).nonzero()
        last = int(diff[0]) + 1 if len(diff) else want["tokens"].shape[1]
        pre = max(pre, float((got["logits"][b, :last] - want["logits"][b, :last]).abs().max()))
    prefill_diff = float((got["logits"][:, 0] - want["logits"][:, 0]).abs().max())
    emit(phase=phase, config=one["config"], layers=one["layers"],
         mesh=ranks[0]["mesh"], ranks=[r["note"] for r in ranks],
         step_ms={"1x1": one["step_ms"], "sharded": [r["step_ms"] for r in ranks]},
         prefill_ms={"1x1": one["prefill_ms"], "sharded": [r["prefill_ms"] for r in ranks]},
         build_s={"1x1": one["build_s"], "sharded": [r["build_s"] for r in ranks]},
         peak_gb={"1x1": one["peak_gb"], "sharded": [r["peak_gb"] for r in ranks]},
         collectives_per_decode_step=[r["comm_per_step"] for r in ranks],
         launches=[r["launches"] for r in ranks], forwards=one["forwards"],
         max_abs_logit_diff=float((kept[0]["logits"] - one["logits"]).abs().max()),
         prefill_max_abs_logit_diff=prefill_diff, prefill_atol=prefill_atol,
         prefill_max_abs_logit=_max_abs_logit(want["logits"][:, 0]),
         pre_divergence_max_abs_logit_diff=pre,
         logits_bitwise_equal=bool(torch.equal(kept[0]["logits"], one["logits"])))
    if prefill_atol is not None and not prefill_diff <= prefill_atol:
        raise AssertionError(f"{phase}: the prefill logits differ from one device's by "
                             f"{prefill_diff} > {prefill_atol}")
    return kept[0]


def _rank_jobs(mesh, jobs):
    """Each (fn, args) of ``jobs`` on this rank in turn, the card freed
    between them: one world serves several phases (starting a world of
    ranks on the shared card took 10-25 s)."""
    import gc

    out = []
    for fn, args in jobs:
        out.append(fn(mesh, *args))
        gc.collect()
        _free(mesh.device)
    return out


def _one_device(dev, runs, smoke):
    """The one-device run of each sharded decode job, freed in turn before
    the ranks start."""
    import gc

    from repro_torch.launch import mesh as M

    out = {}
    for name, (arch, quantize, layers, fields, one_rank) in runs.items():
        base = M.make_mesh(dev) if one_rank else None
        out[name] = _tp_decode(base, arch, quantize, layers, fields, dev=dev, smoke=smoke)
        gc.collect()
        _free(dev)
    for name in _cell_names(smoke):
        out[name] = _cell_decode(None, name, dev=dev, smoke=smoke)
        gc.collect()
        _free(dev)
    return out


def phase_sharded_serving(dev, smoke=False):
    """``tp_path``, ``tp_bf16_path``, ``ep_path`` and the launch cells
    (``CELLS``, checked by ``check_cell_paths``; then ``dryrun_path``) in
    one (1, 2) world: every one-device run first, then the ranks run the
    sharded jobs in turn, then each path's checks."""
    from repro_torch import configs
    from repro_torch.launch import mesh as M

    moon = configs.get_config("moonshot-v1-16b-a3b")
    ep = {"moe_impl": "a2a", "capacity_factor": moon.n_experts / moon.top_k}
    runs = {"tp_path": ("qwen3-8b", True, None, None, False),
            "tp_bf16_path": ("nemotron-4-15b", False, None, None, False),
            "ep_path": ("moonshot-v1-16b-a3b", False, EP_LAYERS, ep | {"dtype": "float32"}, False),
            # the W4A8 MoE against the same function on a one-rank mesh
            "ep_w4a8_path": ("moonshot-v1-16b-a3b", True, EP_LAYERS, ep, True)}
    t0 = time.perf_counter()
    one = _one_device(dev, runs, smoke)
    print(f"chip_smoke: sharded serving, one-device runs {time.perf_counter() - t0:.1f} s",
          flush=True)
    jobs = [(_ep_layer, (dev.type, smoke, ep))] + [
        (_tp_decode, (arch, quantize, layers, fields, dev.type, smoke))
        for arch, quantize, layers, fields, _ in runs.values()] + [
        (_cell_decode, (name, dev.type, smoke, one[name]["tokens"]))
        for name in _cell_names(smoke)]
    t0 = time.perf_counter()
    res = M.spawn(_rank_jobs, 1, 2, device=dev.type, args=(jobs,))
    print(f"chip_smoke: sharded serving, the (1, 2) world {time.perf_counter() - t0:.1f} s",
          flush=True)
    names = list(runs) + _cell_names(smoke)
    ranks = {name: [r[i + 1] for r in res] for i, name in enumerate(names)}
    out = check_tp_path(dev, one["tp_path"], ranks["tp_path"])
    out.update(check_tp_bf16_path(one["tp_bf16_path"], ranks["tp_bf16_path"]))
    out.update(check_ep_path(dev, [r[0] for r in res], one, ranks))
    out.update(check_cell_paths(dev, one, ranks))
    t0 = time.perf_counter()
    dryrun_path(ranks, smoke)
    print(f"chip_smoke: dryrun_path {time.perf_counter() - t0:.1f} s", flush=True)
    return out


def check_cell_paths(dev, one, ranks):
    """The launch cells on (1, 2) against one device, each rank's decode
    teacher-forced on the one-device tokens: mamba2-1.3b, zamba2-7b and
    whisper-large-v3 at full width in bf16 (``_hold_forced``: the logits
    of the prefill and of every step within CELL_LOGIT_ATOL, read on the
    card and printed; a rank's partial sums, norms and per-head products
    round in other orders than one device's, which moved mamba2's argmax
    at margins of 1-4 ulps of the top logit; no quantized kernel
    launched), and Qwen3-8B's ``w4a8+kvq8`` decode cell at 8 layers (the
    W4A8 + LRU target over a dense int8 KV cache: logits bit for bit one
    device's, K1 scaled and int32, K2 once a layer per forward and K7 once
    a layer per decode step on every rank).  Each prints its collectives
    per decode step."""
    out, failed = {}, []
    for name in [n for n in CELLS if n in ranks]:
        try:
            out[name] = _check_cell(dev, name, one[name], ranks[name])
        except AssertionError as e:  # every cell reported before any failure is raised
            failed.append(str(e))
    if failed:
        raise AssertionError("; ".join(failed))
    return out


def _check_cell(dev, name, one, ranks):
    quant = CELLS[name][2]
    got = _mesh_report(name, one, ranks)
    emit(phase=f"{name}_collectives", prefill=[r["comm_prefill"] for r in ranks],
         per_decode_step=[r["comm_per_step"] for r in ranks])
    launches = ranks[0]["launches"]
    if quant is None:
        _no_quantized(name, launches)
        _hold_forced(name, got, one, CELL_LOGIT_ATOL[name])
        return launches
    for r in ranks if dev.type == "cuda" else ():
        n = r["launches"]
        need = {"w4a8_matmul", "w4a8_matmul_int32", "block_rotate", "decode_attention_int8"}
        if not need <= {k for k, v in n.items() if v}:
            raise AssertionError(f"{name}: rank {r['note']['rank']} launched {n}")
        if n["block_rotate"] != r["layers"] * r["forwards"] or \
                n["decode_attention_int8"] != r["layers"] * CELL_STEPS:
            raise AssertionError(f"{name}: {n} for {r['layers']} layers x "
                                 f"{r['forwards']} forwards")
    if not torch.equal(got["logits"], one["logits"]):
        raise AssertionError(f"{name}: the (1, 2) logits differ from one device's: max "
                             f"{float((got['logits'] - one['logits']).abs().max())}")
    _hold_rows(name, got, one)
    return launches


def _by_kind(comm):
    """{kind: (calls, bytes)} of a mesh's ``comm`` counters."""
    from repro_torch.launch.dryrun import KINDS

    return {KINDS[k]: (round(comm.get(f"{k}_calls", 0), 6), round(comm.get(f"{k}_bytes", 0), 6))
            for k in KINDS if comm.get(f"{k}_calls")}


def dryrun_path(ranks, smoke=False):
    """The dry-run (``launch/dryrun.py``) of the launch cells on the meta
    (1, 2) mesh: each cell's prefill and decode step must log the
    collectives (kind, calls, bytes) every rank of the real world ran
    (gated); the dry-run's roofline time of a decode step is printed beside
    the step's measured wall (not gated: H100 SXM5 datasheet constants
    against a card the two ranks share over gloo).  Then the dry-run CLI
    on the production meshes (DRYRUN_GRID: a decode cell of three families,
    both meshes, no calibration; the whole grid's wall is in PERF.md):
    exit 0."""
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models.common import ShapeConfig

    mesh = make_mesh("meta", 1, 2)
    bad = []
    for name in _cell_names(smoke):
        cfg, quant = _cell_cfg(name, smoke)
        pre = dryrun.measure_cell(cfg, ShapeConfig("prefill", TP_PROMPT, TP_BATCH, "prefill"),
                                  mesh, False, quant, s_max=CELL_S_MAX)
        dec = dryrun.measure_cell(cfg, ShapeConfig("decode", TP_PROMPT, TP_BATCH, "decode"),
                                  mesh, False, quant)
        want = {kind: ({k: (c["count"], c["bytes"]) for k, c in rec["collectives"].items()})
                for kind, rec in (("prefill", pre), ("decode", dec))}
        r = dryrun.roofline_terms(dec["flops"], dec["bytes"], dec["collectives"])
        for rank in ranks[name]:
            got = {"prefill": _by_kind(rank["comm_prefill"]),
                   "decode": _by_kind(rank["comm_per_step"])}
            if got != want:
                bad.append({"cell": name, "rank": rank["note"]["rank"], "meta": want,
                            "world": got})
        emit(phase="dryrun_path", cell=name, collectives=want,
             predicted_step_ms={k: r[f"t_{k}"] * 1e3
                                for k in ("compute", "memory", "collective")},
             predicted_roofline_ms=max(r["t_compute"], r["t_memory"], r["t_collective"]) * 1e3,
             measured_step_ms=[rank["step_ms"] for rank in ranks[name]],
             trace_s=pre["trace_s"] + dec["trace_s"])
    if bad:
        raise AssertionError(f"dryrun_path: the meta trace's collectives differ from the "
                             f"world's: {bad}")
    if smoke:
        return
    t0 = time.perf_counter()
    failed = 0
    for arch in DRYRUN_GRID:
        failed += dryrun.main(["--arch", arch, "--shape", "decode_32k", "--both-meshes",
                               "--no-calibrate"])
    emit(phase="dryrun_grid", cells=len(DRYRUN_GRID) * 2, failed=failed,
         wall_s=time.perf_counter() - t0)
    if failed:
        raise AssertionError(f"dryrun_path: {failed} dry-run grid calls failed")


def check_tp_path(dev, one, ranks):
    """Qwen3-8B W4A8 + LRU at full width and depth, one device and then on
    mesh (1, 2) (two ranks sharing the card over gloo): prefill 4 x 64 and
    TP_STEPS greedy steps over the dense cache.  The sharded logits must equal
    the one-device run's bit for bit and so the tokens; K1 (scaled on the
    column shards, int32 on the row shards) and K2 launch on every rank, K2
    once per layer of each forward."""
    got = _mesh_report("tp_path", one, ranks)
    for r in ranks if dev.type == "cuda" else ():  # the plain versions count nothing
        n = r["launches"]
        need = {"w4a8_matmul", "w4a8_matmul_int32", "block_rotate"}
        if not need <= {k for k, v in n.items() if v}:
            raise AssertionError(f"tp_path: rank {r['note']['rank']} launched {n}")
        if n["block_rotate"] != r["layers"] * r["forwards"]:
            raise AssertionError(f"tp_path: {n['block_rotate']} rotations for "
                                 f"{r['layers']} layers x {r['forwards']} forwards")
    if not torch.equal(got["logits"], one["logits"]):
        raise AssertionError("tp_path: the (1, 2) logits differ from one device's: "
                             f"max {float((got['logits'] - one['logits']).abs().max())}")
    _hold_rows("tp_path", got, one)
    return {"tp_path": ranks[0]["launches"]}


def check_tp_bf16_path(one, ranks):
    """Nemotron-4-15B in bf16 (G = 6, squared ReLU, 256,000-wide vocab) at
    full width and depth, one device and then on mesh (1, 2), Megatron
    sequence sharding in the prefill: tokens equal except at a near-tie
    (``_hold_rows`` with the bf16 rule: the row-parallel linears' bf16
    partial sums add in another order, which moves a logit by an ulp), and
    the prefill logits within TP_BF16_PREFILL_ATOL of one device's."""
    got = _mesh_report("tp_bf16_path", one, ranks, TP_BF16_PREFILL_ATOL)
    _no_quantized("tp_bf16_path", ranks[0]["launches"])
    _hold_rows("tp_bf16_path", got, one, bf16=True)
    return {"tp_bf16_path": ranks[0]["launches"]}


def _ep_layer(mesh, dev, smoke, fields):
    """One Moonlight MoE layer on this rank: the whole layer made from SEED
    on every rank (bf16), TP_BATCH x TP_PROMPT seeded hidden states, and on
    the same inputs (every rank routes every token) the one-device dense
    combine against the all-to-all over the rank's experts, in bf16 and
    with the experts packed int4 (the dense combine on the dequantized
    experts against ``_moe_a2a_quant``: int8 slots through K1)."""
    from repro_torch import configs
    from repro_torch.models import layers as L
    from repro_torch.models import lm
    from repro_torch.serving import quantized_lm as qlm

    cfg = dataclasses.replace((configs.get_smoke if smoke else configs.get_config)(
        "moonshot-v1-16b-a3b"), **fields)
    gen = torch.Generator(device=mesh.device).manual_seed(SEED)
    moe = lm.init_layer(gen, cfg, mesh.device)["moe"]
    x = torch.randn((TP_BATCH, TP_PROMPT, cfg.d_model), generator=gen,
                    device=mesh.device).to(cfg.tdtype)
    specs = {"layers": [{"moe": L.moe_specs(cfg, mesh.tp)}]}
    names = ("w_gate", "w_up", "w_down")
    out = {"note": _rank_note(mesh)}
    with torch.no_grad():
        packed = {k: qlm._quant_pack_experts(moe[k]) for k in names}
        dense = L.moe_apply_dense(moe, x, cfg).float()
        dense_q = L.moe_apply_dense(dict({k: qlm._dequant_experts(packed[k], x.dtype)
                                          for k in names}, router=moe["router"]), x, cfg).float()
        shard = lm.shard_params({"layers": [{"moe": moe}]}, specs, mesh, cfg)["layers"][0]["moe"]
        shard_q = dict({k: qlm._shard_experts(packed[k], k, cfg, mesh) for k in names},
                       router=moe["router"])
        del moe, packed
        for name, fn, p, want in (("bf16", L.moe_apply_a2a, shard, dense),
                                  ("w4a8", qlm._moe_a2a_quant, shard_q, dense_q)):
            mesh.comm.clear()
            _sync(mesh.device)
            t0 = time.perf_counter()
            got = fn(p, x, cfg, L.Shard(mesh)).float()
            _sync(mesh.device)
            out[name] = {"a2a_ms": (time.perf_counter() - t0) * 1e3, "comm": dict(mesh.comm),
                         "max_abs": float((got - want).abs().max()),
                         "dense_max": float(want.abs().max()),
                         "rel_rms": float((got - want).pow(2).mean().sqrt()
                                          / want.pow(2).mean().sqrt())}
    out["experts_per_rank"] = shard["w_gate"].shape[0]
    return out


def check_ep_path(dev, layer, one, ranks):
    """The repo's Moonlight config (64 experts, top-6) with
    ``moe_impl="a2a"`` on mesh (1, 2), 32 experts a rank, the capacity
    factor raised to E / k so no slot drops.  (1) One MoE layer, the
    all-to-all against the dense combine on the same hidden states: in
    bf16 within EP_BF16_RTOL of the output's largest magnitude (the expert
    GEMMs run on other row counts, so their bf16 outputs round apart);
    with int4 experts (``_moe_a2a_quant``, K1 once per local expert on its
    (tp * cap, d) int8 slots) against the dense combine on the dequantized
    experts, relative RMS within W4A8_MOE_RTOL (the int8 activations).
    (2) EP_LAYERS layers at full width in float32 (the same config and
    seed): a prefill and 8 greedy steps, rows held to the one-device dense
    combine (near-tie rule), prefill logits within EP_PREFILL_ATOL; in bf16 the GEMMs' other rounding reaches the
    router, whose k-th and (k+1)-th logits among 64 experts sit within a
    bf16 ulp of each other often enough to flip experts.  (3) The W4A8 MoE
    forward (bf16 activations) at EP_LAYERS layers on (1, 2) against the
    same function on a one-rank mesh (the all-to-all with every expert
    local): logits bit for bit, K1 launched."""
    emit(phase="ep_layer", ranks=[r["note"] for r in layer],
         experts_per_rank=layer[0]["experts_per_rank"],
         bf16=[r["bf16"] for r in layer], w4a8=[r["w4a8"] for r in layer],
         bf16_tol=EP_BF16_RTOL, w4a8_tol=W4A8_MOE_RTOL)
    for r in layer:
        if not r["bf16"]["max_abs"] <= EP_BF16_RTOL * r["bf16"]["dense_max"]:
            raise AssertionError(f"ep_path: the bf16 a2a layer misses the dense combine: {r}")
        if not r["w4a8"]["rel_rms"] <= W4A8_MOE_RTOL:
            raise AssertionError(f"ep_path: the W4A8 a2a layer misses its dense combine: {r}")
    out = {}
    for phase, quantize in (("ep_path", False), ("ep_w4a8_path", True)):
        got = _mesh_report(phase, one[phase], ranks[phase], None if quantize else EP_PREFILL_ATOL)
        out[phase] = ranks[phase][0]["launches"]
        if not quantize:
            _no_quantized(phase, out[phase])
            _hold_rows(phase, got, one[phase])
            continue
        if dev.type == "cuda" and not out[phase].get("w4a8_matmul"):
            raise AssertionError(f"{phase}: the expert kernel did not launch: {out[phase]}")
        if not torch.equal(got["logits"], one[phase]["logits"]):
            raise AssertionError(f"{phase}: the (1, 2) logits differ from one rank's: max "
                                 f"{float((got['logits'] - one[phase]['logits']).abs().max())}")
        _hold_rows(phase, got, one[phase])
    return out


def _train_cfg(smoke):
    from repro_torch.configs.paper_pair import DLM, DLM_SMOKE

    return (DLM_SMOKE, 16) if smoke else (DLM, 256)


def _train_rank(mesh, ckpt_dir, steps, save_at, restore, dev="cuda", smoke=False):
    """Trainer steps of the paper draft at LLaMA-68M widths on this rank
    (or one device): losses, grad norms, and with ``restore`` the restored
    params gathered whole."""
    from repro_torch.core.tree import tree_leaves
    from repro_torch.launch.train import Trainer

    dev = mesh.device if mesh is not None else torch.device(dev)
    cfg, seq = _train_cfg(smoke)
    tr = Trainer(cfg, mesh, seq_len=seq, global_batch=8, ckpt_dir=ckpt_dir, seed=SEED,
                 device=dev)
    if restore:
        tr.restore()
        params, _, _ = tr.full_state()
        return {"step": tr.step, "params": [t.cpu() for t in tree_leaves(params)]}
    hist, times = [], []
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    for _ in range(steps):
        _sync(dev)
        t0 = time.perf_counter()
        m = tr.train_step()
        hist.append((float(m["loss"]), float(m["grad_norm"])))
        times.append(time.perf_counter() - t0)
        if ckpt_dir is not None and tr.step == save_at:
            tr.save(tr.step)
        tr.step += 1
    if tr.ckpt is not None:
        tr.ckpt.wait()
    if mesh is not None:
        mesh.barrier()
    return {"hist": hist, "step_ms": float(np.median(times[1:])) * 1e3,  # steps after the first
            "note": None if mesh is None else _rank_note(mesh),
            "zero1_moment": None if mesh is None else
            list(tr.opt_state["mu"]["layers"][0]["mlp"]["w_up"].shape),
            "peak_gb": _peak_gb(dev)}


def _elastic_rank(mesh, ckpt_dir, fail_at, steps, smoke=False):
    from repro_torch.launch.train import elastic_trainer
    from repro_torch.runtime import FaultToleranceConfig

    cfg, seq = _train_cfg(smoke)
    ticks = iter([None] * fail_at + [1] + [None] * 100)
    et = elastic_trainer(cfg, mesh, FaultToleranceConfig(ckpt_dir=ckpt_dir, ckpt_every=2),
                         model=mesh.shape["model"], failure_source=lambda: next(ticks),
                         seq_len=seq, global_batch=8, seed=SEED, device=mesh.device)
    hist = et.run(steps)
    return None if hist is None else {"hist": hist, "rank": mesh.rank}


def _train_and_elastic_rank(mesh, ckpt_dir, elastic_dir, smoke):
    """The (2, 2) training run, then the elastic run, in one world."""
    import gc

    train = _train_rank(mesh, ckpt_dir, MESH_TRAIN_STEPS, MESH_TRAIN_SAVE, False,
                        mesh.device.type, smoke)
    gc.collect()
    _free(mesh.device)
    return {"train": train, "elastic": _elastic_rank(mesh, elastic_dir, 5, MESH_TRAIN_STEPS,
                                                     smoke)}


def phase_mesh_train_path(dev, smoke=False):
    """The paper draft at LLaMA-68M widths (bf16, float32 moments), batch 8
    x 256: 8 Trainer steps on mesh (2, 2) with ZeRO-1 and sequence
    sharding against the one-device run (losses within MESH_LOSS_ATOL, every
    rank's grad norms within MESH_NORM_RTOL), a
    checkpoint saved on (2, 2) at step 4 and restored onto (1, 1) and
    (2, 1) with every parameter bit for bit the saved one, and an elastic
    run from 4 ranks (2 hosts x 2) that loses a host at tick 5 and resumes
    on 2 ranks from the step-4 checkpoint: its losses up to the failure
    equal the (2, 2) run's bit for bit, and every step's within
    MESH_LOSS_ATOL of the one-device run."""
    import tempfile

    from repro_torch.checkpoint import load_checkpoint
    from repro_torch.core.tree import tree_leaves
    from repro_torch.launch import mesh as M
    from repro_torch.models.convert import from_reference

    cfg, _ = _train_cfg(smoke)
    kind = dev.type
    one = _train_rank(None, None, MESH_TRAIN_STEPS, None, False, kind, smoke)
    with tempfile.TemporaryDirectory() as d, tempfile.TemporaryDirectory() as d2:
        both = M.spawn(_train_and_elastic_rank, 2, 2, device=kind, args=(d, d2, smoke))
        ranks, elastic = [b["train"] for b in both], [b["elastic"] for b in both]
        _, saved, _ = load_checkpoint(d, MESH_TRAIN_SAVE, device="cpu")
        want = tree_leaves(from_reference(saved["params"], cfg))
        onto_one = _train_rank(None, d, 0, None, True, kind, smoke)
        onto_21 = M.spawn(_train_rank, 2, 1, device=kind, args=(d, 0, None, True, kind, smoke))
    losses = [h[0] for h in ranks[0]["hist"]]
    one_losses = [h[0] for h in one["hist"]]
    grad_norms_one = [h[1] for h in one["hist"]]
    bitwise = {"1x1": all(torch.equal(a.cpu(), b) for a, b in zip(onto_one["params"], want)),
               "2x1": all(all(torch.equal(a, b) for a, b in zip(r["params"], want))
                          for r in onto_21)}
    survivors = [e for e in elastic if e is not None]
    ehist = survivors[0]["hist"]
    events = [h["event"] for h in ehist]
    esteps = [(h["step"], h["loss"], h["n_hosts"]) for h in ehist if h["event"] == "step"]
    before = [l for s, l, n in esteps if n == 2]
    emit(phase="mesh_train_path", config=cfg.name, mesh={"data": 2, "model": 2},
         ranks=[r["note"] for r in ranks], losses_2x2=losses, losses_1x1=one_losses,
         grad_norms_2x2=[h[1] for h in ranks[0]["hist"]],
         grad_norms_1x1=[h[1] for h in one["hist"]], loss_atol=MESH_LOSS_ATOL,
         norm_rtol=MESH_NORM_RTOL,
         step_ms={"1x1": one["step_ms"], "2x2": [r["step_ms"] for r in ranks]},
         peak_gb={"1x1": one["peak_gb"], "2x2": [r["peak_gb"] for r in ranks]},
         zero1_moment_w_up=ranks[0]["zero1_moment"], restored_step=onto_one["step"],
         restored_bitwise=bitwise, elastic_events=events, elastic_steps=esteps,
         elastic_survivors=len(survivors))
    if any(abs(a - b) > MESH_LOSS_ATOL for a, b in zip(losses, one_losses)):
        raise AssertionError(f"mesh_train_path: losses {losses} vs {one_losses}")
    for r in ranks:
        norms = [h[1] for h in r["hist"]]
        if any(abs(a - b) > MESH_NORM_RTOL * abs(b) for a, b in zip(norms, grad_norms_one)):
            raise AssertionError(f"mesh_train_path: grad norms {norms} vs {grad_norms_one}")
    if not all(bitwise.values()) or onto_one["step"] != MESH_TRAIN_SAVE + 1:
        raise AssertionError(f"mesh_train_path: restored parameters {bitwise}")
    if len(survivors) != 2 or "restart" not in events or esteps[-1][2] != 1:
        raise AssertionError(f"mesh_train_path: elastic events {events} {esteps}")
    if before != losses[:len(before)]:
        raise AssertionError(f"mesh_train_path: elastic losses {before} vs {losses}")
    if any(abs(l - one_losses[s]) > MESH_LOSS_ATOL for s, l, _ in esteps):
        raise AssertionError(f"mesh_train_path: elastic losses {esteps} vs {one_losses}")
    return {"mesh_train_path": {}}


MESH_PHASES = {"sharded_serving": phase_sharded_serving,
               "mesh_train_path": phase_mesh_train_path}


def _tensors(tree):
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in _tensors(v)]
    if isinstance(tree, list):
        return [t for v in tree for t in _tensors(v)]
    return [tree]


# ---------------------------------------------------------------------------


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--profile", action="store_true",
                    help="profile a few rounds of ten of the paths "
                         "(torch.profiler)")
    ap.add_argument("--cpu-dry-run", action="store_true",
                    help="the mesh phases at smoke size on the CPU (no card, no build; "
                         "checks the phases' own logic), no result line")
    ap.add_argument("--mesh-only", action="store_true",
                    help="the kernels' build and the mesh phases alone on the card, "
                         "no result line")
    args = ap.parse_args(argv)
    if args.cpu_dry_run:
        for phase in MESH_PHASES.values():
            phase(torch.device("cpu"), smoke=True)
        return 0

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is false)", file=sys.stderr)
        return 1
    if shutil.which("nvidia-smi") is None:
        print("chip_smoke: nvidia-smi not found", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    print(f"python {sys.version.split()[0]} torch {torch.__version__} cuda {torch.version.cuda}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)

    t0 = time.perf_counter()
    phase_build()
    if args.mesh_only:
        for name, phase in MESH_PHASES.items():
            t_phase = time.perf_counter()
            phase(dev)
            print(f"chip_smoke: {name} {time.perf_counter() - t_phase:.1f} s", flush=True)
        return 0
    summary = phase_kernels(dev, SEED)
    launches = {}
    main_report = {}
    launches["main_path"], pair, fp_outs = phase_main_path(dev, SEED, main_report)
    launches["int8_path"], int8_outs = phase_int8_path(dev, pair, fp_outs)
    launches["tree_path"] = phase_tree_path(dev, pair, fp_outs, int8_outs)
    sampled_sps, sampled_outs, sampled_log = phase_sampled_path(dev, pair, fp_outs)
    sampled_tree_sps, sampled_tree_outs, sampled_tree_log = phase_sampled_tree_path(dev, pair)
    phase_stop_path(dev, pair, fp_outs)
    phase_adaptive_path(dev, pair, fp_outs)
    wdos_sps, wdos_outs = phase_wdos_path(dev, pair)
    wdos_tree_cfg = phase_wdos_tree_path(dev, pair, sampled_tree_sps, sampled_tree_outs,
                                         sampled_tree_log)
    del sampled_tree_log
    phase_self_draft_path(dev, pair, fp_outs)
    launches["prefix_path"] = phase_prefix_path(dev, pair)
    launches["prefix_mixed_tree_path"] = phase_prefix_mixed_tree_path(dev, pair)
    phase_pool_bytes(dev, pair)
    launches["qat_draft_path"] = phase_qat_draft_path(dev, pair, fp_outs)
    launches["observed_path"] = phase_observed_path(dev, pair, fp_outs, wdos_sps, wdos_outs)
    launches["server_path"] = phase_server_path(dev, pair, fp_outs, sampled_sps, sampled_outs,
                                                sampled_log)
    del sampled_log
    t_phase = time.perf_counter()
    launches["host_path"] = phase_host_path(dev, pair, fp_outs, main_report)
    launches["quickstart_path"] = phase_quickstart_path(dev, pair)
    print(f"chip_smoke: host and quickstart paths {time.perf_counter() - t_phase:.1f} s",
          flush=True)
    if args.profile:
        from repro_torch.serving.engine import EngineConfig, SamplingParams

        tree_cfg = EngineConfig(kv_quant="mixed", spec_mode="tree")
        phase_profile(dev, pair, "main_path", EngineConfig(), [SamplingParams(max_tokens=32)] * 4)
        phase_profile(dev, pair, "tree_path", tree_cfg,
                      [SamplingParams(max_tokens=32, kv_quant=k)
                       for k in ("none", "int8", "none", "int8")])
        phase_profile(dev, pair, "sampled_path", EngineConfig(), sampled_sps)
        phase_profile(dev, pair, "sampled_tree_path", tree_cfg, sampled_tree_sps)
        phase_profile(dev, pair, "wdos_path", EngineConfig(adaptive=True, par_mode="wdos"),
                      wdos_sps, stagger=True)
        phase_profile(dev, pair, "wdos_tree_path", wdos_tree_cfg, sampled_tree_sps,
                      stagger=True)
    prompts = pair[2]
    del pair
    torch.cuda.empty_cache()
    launches["dense_path"] = phase_dense_path(dev, prompts, profile=args.profile)
    launches.update(phase_qwen3_path(dev, profile=args.profile))
    launches.update(phase_moe_path(dev, profile=args.profile))
    launches.update(phase_nemotron_path(dev, profile=args.profile))
    phase_card_vs_cpu(dev, SEED)
    phase_families_card_vs_cpu(dev)
    t_phase = time.perf_counter()
    launches["kvq8_path"] = phase_kvq8_path(dev)
    print(f"chip_smoke: kvq8_path {time.perf_counter() - t_phase:.1f} s", flush=True)
    t_train = time.perf_counter()
    for phase, kw in ((phase_train_path, {"profile": args.profile}),
                      (phase_draft_train_path, {"profile": args.profile}),
                      (phase_elastic_path, {}), (phase_ssm_families_path, {})):
        t_phase = time.perf_counter()
        phase(dev, **kw)
        print(f"chip_smoke: {phase.__name__[6:]} {time.perf_counter() - t_phase:.1f} s",
              flush=True)
    print(f"chip_smoke: training and family phases {time.perf_counter() - t_train:.1f} s")
    t_mesh = time.perf_counter()
    for name, phase in MESH_PHASES.items():
        t_phase = time.perf_counter()
        launches.update(phase(dev))
        print(f"chip_smoke: {name} {time.perf_counter() - t_phase:.1f} s", flush=True)
    print(f"chip_smoke: mesh phases {time.perf_counter() - t_mesh:.1f} s")
    print(f"chip_smoke: all phases passed in {time.perf_counter() - t0:.1f} s on {smi}")
    print(json.dumps({"kernels": [
        {
            "name": name, "route": "cuda", "source": src, "replaces": replaces,
            "shape": summary[name]["shape"],
            "launches": launches[PATH_OF[name]].get(name, 0), "path": PATH_OF[name],
            "max_abs_err": summary[name]["max_abs_err"],
            "ms": summary[name]["kernel_ms"], "plain_ms": summary[name]["plain_ms"],
            "bound_ms": summary[name]["bound_ms"], "bound_by": summary[name]["bound_by"],
            "library_ms": summary[name]["library_ms"],
            "launches_by_path": {path: n.get(name, 0) for path, n in launches.items()},
        }
        for name, (src, replaces) in KERNELS.items()
    ]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

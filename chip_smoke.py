"""Drive the PyTorch/CUDA port on one NVIDIA H100 and check it end to end.

    python3 chip_smoke.py             # every phase (what a GPU check runs)
    python3 chip_smoke.py --profile   # also profile a few rounds of four paths

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
   poisoned.
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
   run), the rotation runs once per layer of every forward, and each row
   equals the main path's except at a near-tie.
13. Card against CPU at smoke size: one smoke pair built on the CPU from a
   fixed seed, copied to the card; the same requests through the port on
   cuda (kernels) and on cpu (plain versions) with five engines (greedy
   chain, greedy mixed-KV tree, sampled chain, sampled mixed-KV tree, and
   a staggered adaptive WDOS chain with two sampled requests) must give
   the same tokens, unless the first divergence is shown to be a
   near-tie: of the target's top-2 logits for a greedy row, or, for a
   sampled row, a host decision taken from logit rows that differ by at
   most NEAR_TIE between the devices.

Each path prints its tokens/s, rounds, target forwards per emitted token,
device-to-host copies per round and, on a WDOS engine, its fused-slot
summary; ``--profile`` adds a torch.profiler breakdown (device busy share,
kernels, launches and copies, host time) of three rounds of the main,
tree, sampled, sampled tree, WDOS and WDOS tree paths.

The last two lines are the kernels summary (JSON) and the result line
``{"ok": true, "device": {...}}``.  Weights are random, made from SEED.
"""
from __future__ import annotations

import argparse
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
}
# the path whose run each kernel's launches are read from (counts zeroed
# just before that path, read just after)
PATH_OF = {"w4a8_matmul": "main_path", "block_rotate": "main_path", "bvq_matmul": "main_path",
           "paged_attention": "main_path", "paged_attention_int8": "int8_path",
           "paged_attention_tree": "tree_path", "paged_attention_int8_tree": "tree_path",
           "decode_attention_int8": "main_path"}
# kernels no path must launch: no serving path of the reference calls
# decode_attention_int8, so only its kernel phase runs it; the summary
# line still reads its (zero) count from the main path's counters
NO_PATH = {"decode_attention_int8"}
# the CUDA symbols of the port's kernels, as the profiler names them
PORT_SYMBOLS = ("w4a8_mma_kernel", "bvq_mma_kernel", "block_rotate_kernel", "paged_attn_kernel",
                "decode_attn_int8_kernel")


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
                masked=()):
    """``masked`` rows are laid out as a role mask leaves them in a fused
    WDOS slot (``models/layers.forward_cache_ctx``): their whole table row
    the scratch page (the pool's last) and their length the window alone;
    the other rows' bits must not change when the scratch page is
    poisoned."""
    import torch.nn.functional as F
    from repro_torch.kernels import ref
    from repro_torch.kernels.paged_attn import paged_attention
    from repro_torch.models.layers import kv_quantize

    n_pages = b * mp + 1
    q = torch.randn((b, w, kvs, 1, hd), generator=g, device=dev).to(torch.bfloat16)
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
    kd = kd.to(torch.bfloat16).permute(0, 2, 1, 3)  # (B, KVS, S, hd)
    vd = vd.to(torch.bfloat16).permute(0, 2, 1, 3)
    qd = q[:, :, :, 0].permute(0, 2, 1, 3)  # (B, KVS, W, hd)
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
                         4.0 * w * hd * kvs * walked * ps, "bf16")
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


def check_decode_int8(dev, timer, g, b, s, kvs, hd, length):
    """The dense int8 decode kernel at a full LLaMA2-7B cache (G = 1), and
    a bitwise check that a poisoned tail past `length` changes nothing."""
    import torch.nn.functional as F
    from repro_torch.kernels import ref
    from repro_torch.kernels.decode_attn import decode_attention_int8
    from repro_torch.models.layers import kv_quantize

    q = torch.randn((b, kvs, 1, hd), generator=g, device=dev).to(torch.bfloat16)
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
    mask = (torch.arange(s, device=dev) < length)[None, None, None]
    n = min(length, s) if length > 0 else s
    bound, by = bound_ms(2 * b * n * kvs * (hd + 4) + (q.element_size() + 4) * q.numel() + 4,
                         4.0 * hd * kvs * b * n, "bf16")
    return dict(
        max_abs_err=float((got - want).abs().max()), tol=2e-5,
        repeat_bitwise_equal=bool(torch.equal(got, decode_attention_int8(*args))),
        poisoned_tail_bitwise_equal=bool(torch.equal(got, poisoned)),
        kernel_ms=timer.ms(lambda: decode_attention_int8(*args)),
        plain_ms=timer.ms(lambda: ref.decode_attn_int8_ref(*args)),
        library_ms=timer.ms(lambda: F.scaled_dot_product_attention(q, kd, vd, attn_mask=mask)),
        bound_ms=bound, bound_by=by,
    )


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
    for length in (4096, 1500, 17, 1):
        cases.append(("decode_attention_int8",
                      f"full LLaMA2-7B cache B=4 S=4096 KVS=32 G=1 hd=128 length={length}",
                      lambda n=length: check_decode_int8(dev, timer, g, 4, 4096, 32, 128, n)))
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


def phase_main_path(dev, seed):
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
                            prompts, sp, dev)
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


def _drive(phase, eng, prompts, sps, dev, needs=None, stagger=False):
    """Run one engine over the prompts (``_run``) with the launch counters
    zeroed just before and read just after; print the path's numbers
    (device-to-host copies per round, target forwards per emitted token
    and, on a WDOS engine, the fused-slot summary among them); fail unless
    every kernel of ``needs`` (default: those PATH_OF assigns to this path)
    launched and every request drained.  Host ms per round in the copies
    and decision rules (``_HostClock``) ride along.  Returns (token lists,
    launches)."""
    from repro_torch.kernels import _lib

    torch.cuda.reset_peak_memory_stats(dev)
    _lib.launches.clear()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with _HostClock() as clock:
        outs, summary = _run(eng, prompts, sps, stagger)
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(_lib.launches)
    outs = [o.tolist() for o in outs]
    emitted = sum(len(o) for o in outs)
    t_stats, d_stats = eng.pool_stats()
    # one block_rotate launch per layer of each target forward
    t_forwards = launches.get("block_rotate", 0) / eng.target.cfg.n_layers
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
         kv_bytes_per_token_by_kind=summary["kv_bytes_per_token"],
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
    bad = [r for r in rows if not r["equal"] and r["top2_margin"] > NEAR_TIE]
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
    outs, launches = _drive("sampled_path", Engine(target, draft, EngineConfig(), device=dev),
                            prompts, sps, dev, needs=MAIN_KERNELS)
    _check_rotations("sampled_path", launches, target.cfg.n_layers)
    greedy = [i for i in range(len(prompts)) if i % 2]
    rows = _compare_rows(target, [prompts[i] for i in greedy], [outs[i] for i in greedy],
                         [fp_outs[i] for i in greedy], ["none"] * len(greedy))
    emit(phase="sampled_path_check", greedy_rows_equal_to_main_path=
         f"{sum(r['equal'] for r in rows)}/{len(rows)}", rows=rows, near_tie=NEAR_TIE,
         sampled_rows_equal_to_main_path=sum(outs[i] == fp_outs[i] for i in (0, 2)))
    bad = [r for r in rows if not r["equal"] and r["top2_margin"] > NEAR_TIE]
    if bad:
        raise AssertionError(f"sampled path: greedy rows differ from the main path beyond a "
                             f"near-tie: {bad}")
    _replay_equal("sampled_path", dev, pair, EngineConfig(), sps, outs)
    return sps


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


def _divergences(target, prompts, sps, got, want, log_got, log_want, kinds):
    """The rows of two runs of the same requests that differ, each with
    whether it is excused as a near-tie: a greedy row's first divergence
    at a top-2 margin of at most NEAR_TIE (``_compare_rows``, of the row's
    storage kind; ``None``: the dense-cache logits), a sampled row's first
    differing host decision taken from logit rows within NEAR_TIE of each
    other (``_first_decision_flip``)."""
    out = []
    for rid, (p, sp, a, b, kind) in enumerate(zip(prompts, sps, got, want, kinds)):
        if a == b:
            continue
        if sp.greedy:
            row = _compare_rows(target, [p], [a], [b], [kind])[0]
            out.append(dict(row, request=rid, near_tie=row["top2_margin"] <= NEAR_TIE))
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
    return sps


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
    from repro_torch.serving.engine import Engine, EngineConfig, SamplingParams
    from repro_torch.core.apsd import PAR

    target, _, prompts = pair
    sps = [SamplingParams(max_tokens=32)] * len(prompts)
    needs = ["w4a8_matmul", "block_rotate", "paged_attention"]
    for phase, cfg in (("self_draft_path_two_phase", EngineConfig(adaptive=True)),
                       ("self_draft_wdos_path", EngineConfig(adaptive=True, par_mode="wdos"))):
        eng = Engine(target, target, cfg, device=dev)
        outs, launches = _drive(phase, eng, prompts, sps, dev, needs=needs, stagger=True)
        _check_rotations(phase, launches, target.cfg.n_layers)
        windows = [eng.request(r).history for r in range(len(prompts))]
        long_rounds = sum(h[0] == PAR and h[1] == cfg.long_dl for hist in windows for h in hist)
        emit(phase=f"{phase}_windows", long_dl_rounds=long_rounds,
             history=[[list(map(int, h)) for h in hist] for hist in windows])
        if long_rounds <= 0:
            raise AssertionError(f"{phase}: no controller reached PAR (no long_dl window)")
        _compare_decisions(phase, target, prompts, sps, outs, fp_outs, None, None,
                           ["none"] * len(prompts))


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
    time."""
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
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
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
        E._scatter_prefill(store, cache["attn"]["k"][:, 0], cache["attn"]["v"][:, 0], table,
                           n - 1)
        logits = E._make_paged_step(target)(
            target.params, seq[None, -1:], store, table[None],
            torch.tensor([n - 1], dtype=torch.int32, device=target.device))
    top2 = torch.topk(logits[0, -1].float(), 2).values
    return i, float(top2[0] - top2[1])


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
    from repro_torch.launch.serve import build_pair, to_device
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
    if bad:
        raise AssertionError(f"card and CPU tokens differ beyond a near-tie: {bad}")


# ---------------------------------------------------------------------------


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--profile", action="store_true",
                    help="after the paths, profile a few rounds of six of them "
                         "(torch.profiler)")
    args = ap.parse_args(argv)

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
    summary = phase_kernels(dev, SEED)
    launches = {}
    launches["main_path"], pair, fp_outs = phase_main_path(dev, SEED)
    launches["int8_path"], int8_outs = phase_int8_path(dev, pair, fp_outs)
    launches["tree_path"] = phase_tree_path(dev, pair, fp_outs, int8_outs)
    sampled_sps = phase_sampled_path(dev, pair, fp_outs)
    sampled_tree_sps, sampled_tree_outs, sampled_tree_log = phase_sampled_tree_path(dev, pair)
    phase_stop_path(dev, pair, fp_outs)
    phase_adaptive_path(dev, pair, fp_outs)
    wdos_sps = phase_wdos_path(dev, pair)
    wdos_tree_cfg = phase_wdos_tree_path(dev, pair, sampled_tree_sps, sampled_tree_outs,
                                         sampled_tree_log)
    del sampled_tree_log
    phase_self_draft_path(dev, pair, fp_outs)
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
    del pair
    phase_card_vs_cpu(dev, SEED)
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
        }
        for name, (src, replaces) in KERNELS.items()
    ]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Drive the PyTorch/CUDA port on one NVIDIA H100 and check it end to end.

    python3 chip_smoke.py             # every phase (what a GPU check runs)
    python3 chip_smoke.py --profile   # also profile a few main-path rounds

Phases, in order (any failure exits non-zero before the final line):

1. Build: find nvcc and the card, compile src/repro_torch/kernels/csrc/*.cu
   for sm_90a into build/ (one nvcc per source, in parallel) and print the
   build seconds and each kernel's ptxas register / shared-memory report.
2. Kernels against their plain versions at the main path's full-width
   shapes: one JSON line per (kernel, shape) with the error, the stated
   tolerance, the kernel's and the plain version's times, one PyTorch
   library call's time as a yardstick, and the card's bound for the work.
3. The main path at full width: the paper pair (LLaMA2-7B widths, W4A8 +
   LRU target with all 32 layers, built layer by layer; LLaMA-68M widths,
   BVQ draft) served by ``Engine`` at ``EngineConfig()`` defaults, 4 greedy
   requests with seeded 32-128-token prompts and max_tokens=32.  Launch
   counters are zeroed just before and read just after; every kernel must
   have launched.  Speculative outputs are compared with a target-only
   greedy decode.
4. Card against CPU at smoke size: one smoke pair built on the CPU from a
   fixed seed, copied to the card; the same greedy requests through the
   port on cuda (kernels) and on cpu (plain versions) must give the same
   tokens, unless the first divergence is shown to be a near-tie.

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
}


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
    """Median per-launch device time with a cold L2: a 64 MB buffer is
    rewritten before every timed launch (the main path reads each weight
    once per forward, so it finds the L2 cold too)."""

    def __init__(self, device):
        self.scratch = torch.empty(64 << 20, dtype=torch.uint8, device=device)

    def ms(self, fn, iters: int = 15) -> float:
        fn()
        torch.cuda.synchronize()
        pairs = []
        for _ in range(iters):
            self.scratch.zero_()
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
    from repro_torch.kernels.w4a8_matmul import w4a8_matmul

    x = torch.randn((m, k), generator=g, device=dev)
    w = torch.randn((k, n), generator=g, device=dev) * 0.02
    xq, sx = q.quantize_act_int8(x)
    wq, sw = q.quantize_weight_int(w, bits=4, axis=0)
    wp = q.pack_int4(wq, axis=0)
    got = w4a8_matmul(xq, wp, sx, sw)
    want = ref.w4a8_matmul_ref2(xq, wp, sx, sw)
    err = float((got - want).abs().max())
    tol = 1e-6 * float(want.abs().max())  # the reference test's rtol 1e-6
    w_deq = (wq.float() * sw).to(torch.bfloat16)
    xb = x.to(torch.bfloat16)
    bound, by = bound_ms(m * k + k * n / 2 + 4 * m + 4 * n + 4 * m * n, 2.0 * m * k * n, "int8")
    return dict(
        max_abs_err=err, tol=tol,
        kernel_ms=timer.ms(lambda: w4a8_matmul(xq, wp, sx, sw)),
        plain_ms=timer.ms(lambda: ref.w4a8_matmul_ref2(xq, wp, sx, sw)),
        library_ms=timer.ms(lambda: torch.matmul(xb, w_deq)),
        bound_ms=bound, bound_by=by,
    )


def check_block_rotate(dev, timer, g, tokens, n, m, k):
    from repro_torch.core import hadamard
    from repro_torch.kernels import ref
    from repro_torch.kernels.fwht import block_rotate

    x = torch.randn((tokens, n), generator=g, device=dev).to(torch.bfloat16)
    got = block_rotate(x, m, k).float()
    want = ref.block_rotate_ref(x, m, k).float()
    b = m << k
    hb = np.kron(hadamard.hadamard_matrix(m), hadamard.hadamard_matrix(1 << k)) / math.sqrt(b)
    hb = torch.as_tensor(hb, dtype=torch.bfloat16, device=dev)
    xv = x.view(tokens, n // b, b)
    bound, by = bound_ms(2 * 2 * tokens * n + 2 * m * m, tokens * n * (k + 2 * m + 1), "bf16")
    return dict(
        # bf16 tolerance of the reference test: the plain version rounds to
        # bf16 after every butterfly stage, the kernel once at the store
        max_abs_err=float((got - want).abs().max()), tol=5e-2,
        kernel_ms=timer.ms(lambda: block_rotate(x, m, k)),
        plain_ms=timer.ms(lambda: ref.block_rotate_ref(x, m, k)),
        library_ms=timer.ms(lambda: torch.matmul(xv, hb)),
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
    c, v = cb.shape[1], cb.shape[2]
    bytes_moved = 2 * m * k + 4 * cb.numel() + 4 * idx.numel() + 4 * m * n
    bound, by = bound_ms(bytes_moved, 2.0 * m * k * n, "bf16")
    return dict(
        # same bf16 operands on both sides; f32 sums in another order
        max_abs_err=float((got - want).abs().max()),
        tol=1e-4 * (1.0 + float(want.abs().max())),
        kernel_ms=timer.ms(lambda: bvq_matmul(x, cb, idx)),
        plain_ms=timer.ms(lambda: ref.bvq_matmul_ref2(x, cb, idx)),
        library_ms=timer.ms(lambda: torch.matmul(x, w_dense)),
        bound_ms=bound, bound_by=by,
    )


def check_paged(dev, timer, g, b, w, kvs, hd, ps, mp, lengths):
    import torch.nn.functional as F
    from repro_torch.kernels import ref
    from repro_torch.kernels.paged_attn import paged_attention

    n_pages = b * mp + 1
    q = torch.randn((b, w, kvs, 1, hd), generator=g, device=dev).to(torch.bfloat16)
    kp = torch.randn((n_pages, ps, kvs, hd), generator=g, device=dev).to(torch.bfloat16)
    vp = torch.randn((n_pages, ps, kvs, hd), generator=g, device=dev).to(torch.bfloat16)
    table = torch.randperm(n_pages - 1, generator=g, device=dev)[: b * mp]
    table = table.reshape(b, mp).to(torch.int32)
    lens = torch.as_tensor(lengths, dtype=torch.int32, device=dev)
    got = paged_attention(q, kp, vp, table, lens)
    want = ref.paged_attn_ref(q, kp, vp, table, lens)
    # library yardstick: SDPA over the gathered (dense) K/V with the mask
    kd = ref.gather_pages_ref(kp, table).permute(0, 2, 1, 3)  # (B, KVS, S, hd)
    vd = ref.gather_pages_ref(vp, table).permute(0, 2, 1, 3)
    qd = q[:, :, :, 0].permute(0, 2, 1, 3)  # (B, KVS, W, hd)
    s = mp * ps
    horizon = lens[:, None].long() - w + torch.arange(w, device=dev)[None, :]
    mask = (torch.arange(s, device=dev)[None, None] <= horizon[..., None])[:, None]
    walked = sum(min(mp, -(-ln // ps)) if ln >= w else mp for ln in lengths)
    kv_bytes = 2 * walked * ps * kvs * hd * 2
    ops = 4.0 * w * hd * kvs * walked * ps
    bound, by = bound_ms(kv_bytes + 2 * 4 * q.numel() + 4 * table.numel() + 4 * b, ops, "bf16")
    return dict(
        max_abs_err=float((got - want).abs().max()), tol=2e-5,
        kernel_ms=timer.ms(lambda: paged_attention(q, kp, vp, table, lens)),
        plain_ms=timer.ms(lambda: ref.paged_attn_ref(q, kp, vp, table, lens)),
        library_ms=timer.ms(lambda: F.scaled_dot_product_attention(qd, kd, vd, attn_mask=mask)),
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
    cases = [
        ("w4a8_matmul", "M=32 K=4096 N=11008 (w_gate/w_up, verify)",
         lambda: check_w4a8(dev, timer, g, mb * win, 4096, 11008)),
        ("w4a8_matmul", "M=32 K=4096 N=4096 (wq/wk/wv/wo, verify)",
         lambda: check_w4a8(dev, timer, g, mb * win, 4096, 4096)),
        ("w4a8_matmul", "M=32 K=11008 N=4096 (w_down, verify)",
         lambda: check_w4a8(dev, timer, g, mb * win, 11008, 4096)),
        ("w4a8_matmul", "M=32 K=4096 N=32000 (head, verify)",
         lambda: check_w4a8(dev, timer, g, mb * win, 4096, 32000)),
        ("w4a8_matmul", "M=128 K=4096 N=11008 (prefill, 128-token prompt)",
         lambda: check_w4a8(dev, timer, g, 128, 4096, 11008)),
        ("block_rotate", "tokens=32 n=11008 m=4 k=6 bf16 (R2, verify)",
         lambda: check_block_rotate(dev, timer, g, mb * win, 11008, 4, 6)),
        ("bvq_matmul", "M=8 K=768 N=3072 bf16 (w_gate/w_up, draft step)",
         lambda: check_bvq(dev, timer, g, mb, 768, 3072)),
        ("bvq_matmul", "M=8 K=3072 N=768 bf16 (w_down, draft step)",
         lambda: check_bvq(dev, timer, g, mb, 3072, 768)),
        ("bvq_matmul", "M=8 K=768 N=768 bf16 (wq/wk/wv/wo, draft step)",
         lambda: check_bvq(dev, timer, g, mb, 768, 768)),
        ("paged_attention", "target verify B=8 W=4 KVS=32 hd=128 ps=16 bf16",
         lambda: check_paged(dev, timer, g, mb, win, 32, 128, 16, 11,
                             [163, 100, 45, 129, 4, 4, 7, 88])),
        ("paged_attention", "draft step B=8 W=1 KVS=12 hd=64 ps=16 bf16",
         lambda: check_paged(dev, timer, g, mb, 1, 12, 64, 16, 11,
                             [160, 97, 42, 126, 1, 1, 4, 85])),
    ]
    summary, failed = {}, []
    for name, shape, run in cases:
        rec = run()
        torch.cuda.synchronize()
        emit(phase="kernel", kernel=name, shape=shape, **rec)
        summary.setdefault(name, dict(rec, shape=shape))
        if not rec["max_abs_err"] <= rec["tol"]:
            failed.append(f"{name} [{shape}]: err {rec['max_abs_err']} > tol {rec['tol']}")
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
    from repro_torch.kernels import _lib
    from repro_torch.launch.serve import build_paper_pair, greedy_reference
    from repro_torch.serving.engine import Engine, EngineConfig, SamplingParams

    t0 = time.perf_counter()
    target, draft = build_paper_pair(seed=seed, s_max=256, device=dev)
    torch.cuda.synchronize()
    print(f"built paper pair in {time.perf_counter() - t0:.1f} s "
          f"(target layers {target.cfg.n_layers}, draft layers {draft.cfg.n_layers}; "
          f"depth cut: none)")
    eng = Engine(target, draft, EngineConfig(), device=dev)
    prompts = _prompts(4, 32, 128, target.cfg.vocab, seed)
    sp = SamplingParams(max_tokens=32)
    torch.cuda.reset_peak_memory_stats(dev)
    _lib.launches.clear()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    outs, summary = eng.run(prompts, sp)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(_lib.launches)
    emitted = sum(len(o) for o in outs)
    emit(phase="main_path", requests=len(outs), prompt_lens=[len(p) for p in prompts],
         emitted=emitted, wall_s=wall, tokens_per_s=emitted / wall, rounds=summary["rounds"],
         acceptance_rate=summary["acceptance_rate"],
         max_memory_allocated=torch.cuda.max_memory_allocated(dev), launches=launches)
    missing = [k for k in KERNELS if launches.get(k, 0) <= 0]
    if missing:
        raise AssertionError(f"main path did not launch {missing}")
    if any(len(o) != sp.max_tokens for o in outs):
        raise AssertionError("a request did not drain to max_tokens")
    # the target-only decode runs the dense-cache path, whose attention
    # takes bf16 operands (the reference's _decode_attention), while the
    # paged kernel computes in f32: at bf16 the two can part at a near-tie,
    # so each divergence is reported with the top-2 margin there
    same, divergences = 0, []
    for p, o in zip(prompts, outs):
        ref_toks, spec = greedy_reference(target, p, sp.max_tokens), o.tolist()
        if ref_toks == spec:
            same += 1
        else:
            pos, margin = _first_divergence_margin(target, p, ref_toks, spec)
            divergences.append({"position": pos, "top2_margin": margin})
    emit(phase="main_path_check", equal_to_target_only_greedy=f"{same}/{len(outs)}",
         divergences=divergences)
    return launches, (target, draft, prompts)


def phase_profile(dev, pair, rounds: int = 3) -> None:
    """Where a round's time goes: the same 4 requests on a fresh engine,
    two warm rounds, then ``rounds`` rounds under torch.profiler (CPU and
    CUDA activities).  Prints wall ms per round, summed device-kernel ms
    per round (their ratio is the device's busy share; the profiler adds
    host overhead, so the share is a lower bound) and the top entries by
    device and by host time."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.serving.engine import Engine, EngineConfig, SamplingParams

    target, draft, prompts = pair
    eng = Engine(target, draft, EngineConfig(), device=dev)
    for p in prompts:
        eng.add_request(p, SamplingParams(max_tokens=32))
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
    top_cpu = sorted(events, key=lambda e: e.self_cpu_time_total, reverse=True)[:12]
    emit(phase="profile", rounds=rounds, wall_ms_per_round=wall * 1e3 / rounds,
         device_ms_per_round=device_ms / rounds, device_busy_share=device_ms / (wall * 1e3),
         top_device_ms_per_round=[[e.key[:80], dev_us(e) / 1e3 / rounds, e.count // rounds]
                                  for e in top_dev],
         top_host_ms_per_round=[[e.key[:80], e.self_cpu_time_total / 1e3 / rounds,
                                 e.count // rounds] for e in top_cpu])


def _first_divergence_margin(target, prompt, a, b):
    """Top-2 margin of the target's logits (dense-cache prefill of the
    common prefix) where two greedy streams first differ: the position
    whose argmax the two paths disagreed on."""
    from repro_torch.serving.engine import make_interface

    i = next(j for j in range(len(a)) if a[j] != b[j])
    seq = np.concatenate([prompt, np.asarray(a[:i], np.int32)])
    logits, _ = make_interface(target).prefill(
        target.params, torch.as_tensor(seq[None], device=target.device))
    top2 = torch.topk(logits[0, -1].float(), 2).values
    return i, float(top2[0] - top2[1])


def phase_card_vs_cpu(dev, seed):
    from repro_torch.launch.serve import build_pair, to_device
    from repro_torch.serving.engine import Engine, EngineConfig, SamplingParams

    t_cpu, d_cpu = build_pair(seed=seed, s_max=128, device="cpu")
    t_gpu, d_gpu = to_device(t_cpu, dev), to_device(d_cpu, dev)
    prompts = _prompts(4, 3, 24, t_cpu.cfg.vocab, seed + 1)
    sp = SamplingParams(max_tokens=32)
    cfg = EngineConfig(max_batch=4)
    gpu, _ = Engine(t_gpu, d_gpu, cfg, device=dev).run(prompts, sp)
    cpu, _ = Engine(t_cpu, d_cpu, cfg, device="cpu").run(prompts, sp)
    gpu, cpu = [o.tolist() for o in gpu], [o.tolist() for o in cpu]
    equal = sum(a == b for a, b in zip(gpu, cpu))
    ties = []
    for p, a, b in zip(prompts, gpu, cpu):
        if a != b:
            pos, margin = _first_divergence_margin(t_cpu, p, a, b)
            ties.append({"position": pos, "top2_margin": margin})
    emit(phase="card_vs_cpu", equal=f"{equal}/{len(prompts)}", divergences=ties)
    bad = [t for t in ties if t["top2_margin"] > NEAR_TIE]
    if bad:
        raise AssertionError(f"card and CPU tokens differ beyond a near-tie: {bad}")


# ---------------------------------------------------------------------------


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--profile", action="store_true",
                    help="after the main path, profile a few rounds (torch.profiler)")
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
    launches, pair = phase_main_path(dev, SEED)
    if args.profile:
        phase_profile(dev, pair)
    del pair
    phase_card_vs_cpu(dev, SEED)
    print(f"chip_smoke: all phases passed in {time.perf_counter() - t0:.1f} s on {smi}")
    print(json.dumps({"kernels": [
        {
            "name": name, "route": "cuda", "source": src, "replaces": replaces,
            "shape": summary[name]["shape"],
            "launches": launches.get(name, 0),
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

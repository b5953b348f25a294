"""The traced segment of a ``--trace 1`` run: ``torch.profiler`` over a few
seconds after the window, with spans and shape records taken from the
benchmark's side.

While it is on, ``Hooks`` wraps (and afterwards restores):

* Engine methods in ``record_function`` spans, so the trace says what the
  host was doing: ``engine.admit`` (admission and prefill), ``engine.round``
  (one chain round), ``dispatch.draft`` / ``dispatch.verify`` (one batched
  forward), ``host.to_host`` (a device-to-host copy, which waits for the
  device), ``host.commit``, ``host.tables``, ``host.retire``, and
  ``bench.step`` around each ``Engine.step``;
* the kernel wrappers the forwards call, to record each call's shapes:
  ``ops.w4a8_matmul`` (K1), ``ops.bvq_matmul`` (K3) and
  ``layers.paged_attention_update`` (K4 / K5: the rows' lengths are copied
  to pinned memory without a sync, once per forward), and
  ``Engine._prefill_into`` (a prefill's rows, for the model FLOPs).

``summarize`` reads the exported trace: the union of device operations
(kernels, copies, sets) inside the segment, kernel time by name, launch
API calls, the top device operations and the idle gaps labelled by the
innermost span the host was in at each gap's middle.
"""
from __future__ import annotations

import collections
import json
import os
import tempfile
import time
from typing import Dict, List, Optional

import torch

LAUNCH_APIS = ("cudaLaunchKernel", "cuLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernelEx",
               "cudaGraphLaunch")
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
SPAN_PREFIXES = ("bench.", "engine.", "dispatch.", "host.")
_PINNED = 1 << 20


def _span(name: str, fn):
    def wrapped(*a, **kw):
        with torch.profiler.record_function(name):
            return fn(*a, **kw)
    return wrapped


class Hooks:
    def __init__(self, device):
        self.device = torch.device(device)
        self.k1: List[tuple] = []
        self.k3: List[tuple] = []
        self.attn: List[tuple] = []  # (b, s, h, kvh, hd, q_es, kv_es, int8, tree, mp, group)
        self.groups: List[dict] = []  # one per paged forward: lengths offset, b, s, calls
        self.prefills: List[tuple] = []  # (role, rows)
        self._saved: List[tuple] = []
        self._last_len = None
        self._pin = torch.zeros(_PINNED, dtype=torch.int32,
                                pin_memory=self.device.type == "cuda")
        self._used = 0
        self.prof = None
        self.t_start = self.t_stop = 0.0
        self.trace: Optional[dict] = None
        self._window = None

    # -- patching ------------------------------------------------------------

    def _patch(self, obj, name: str, new) -> None:
        self._saved.append((obj, name, getattr(obj, name)))
        setattr(obj, name, new)

    def _install(self) -> None:
        from repro_torch.kernels import ops
        from repro_torch.models import layers
        from repro_torch.serving import engine as E
        eng = E.Engine
        for meth, name in (("_admit", "engine.admit"), ("_chain_round", "engine.round"),
                           ("_to_host", "host.to_host"), ("_commit", "host.commit"),
                           ("_load_tables", "host.tables"), ("_retire", "host.retire"),
                           ("step", "bench.step")):
            self._patch(eng, meth, _span(name, getattr(eng, meth)))
        dispatch = eng._dispatch

        def _dispatch(self_, program, *a, **kw):
            with torch.profiler.record_function(f"dispatch.{program}"):
                return dispatch(self_, program, *a, **kw)
        self._patch(eng, "_dispatch", _dispatch)
        prefill = eng._prefill_into
        hooks = self

        def _prefill_into(self_, req, model, iface, seq, store, tables, slot, role):
            matched = req.prefix_match.tokens_matched if req.prefix_match is not None else 0
            hooks.prefills.append((role, max(req.prompt.shape[0] - 1 - matched, 0), matched))
            return prefill(self_, req, model, iface, seq, store, tables, slot, role)
        self._patch(eng, "_prefill_into", _prefill_into)
        w4a8 = ops.w4a8_matmul

        def _w4a8(xq, packed, sx, sw):
            hooks.k1.append((xq.shape[0], xq.shape[1], sw.shape[-1]))
            return w4a8(xq, packed, sx, sw)
        self._patch(ops, "w4a8_matmul", _w4a8)
        bvq = ops.bvq_matmul

        def _bvq(x, cb, idx):
            nb, c, v = cb.shape
            hooks.k3.append((x.shape[0], x.shape[1], nb * idx.shape[2], nb, c, v,
                             x.element_size(), idx.element_size()))
            return bvq(x, cb, idx)
        self._patch(ops, "bvq_matmul", _bvq)
        upd = layers.paged_attention_update

        def _paged(q, k_new, v_new, pc):
            b, s, h, hd = q.shape
            if pc.length is not hooks._last_len:
                hooks._last_len = pc.length
                o = hooks._used
                hooks._pin[o:o + b].copy_(pc.length, non_blocking=True)
                hooks._used += b
                hooks.groups.append({"off": o, "b": b, "s": s, "calls": 0})
            g = hooks.groups[-1]
            g["calls"] += 1
            hooks.attn.append((b, s, h, pc.k.shape[2], hd, q.element_size(),
                               pc.k.element_size(), pc.k_scale is not None,
                               pc.tree_mask is not None, pc.page_table.shape[1],
                               len(hooks.groups) - 1))
            return upd(q, k_new, v_new, pc)
        self._patch(layers, "paged_attention_update", _paged)

    def _uninstall(self) -> None:
        for obj, name, old in reversed(self._saved):
            setattr(obj, name, old)
        self._saved.clear()

    # -- the segment ---------------------------------------------------------

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def start(self) -> None:
        self._sync()
        self._install()
        acts = [torch.profiler.ProfilerActivity.CPU]
        if self.device.type == "cuda":
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        self.prof = torch.profiler.profile(activities=acts, record_shapes=False)
        self.prof.start()
        self._window = torch.profiler.record_function("bench.window")
        self._window.__enter__()
        self.t_start = time.perf_counter()

    def stop(self) -> None:
        self._sync()
        self.t_stop = time.perf_counter()
        self._window.__exit__(None, None, None)
        self.prof.stop()
        self._uninstall()
        fd, path = tempfile.mkstemp(suffix=".json")
        os.close(fd)
        try:
            self.prof.export_chrome_trace(path)
            with open(path) as f:
                self.trace = json.load(f)
        finally:
            os.remove(path)
        self.prof = None

    def lengths(self, group: int) -> List[int]:
        g = self.groups[group]
        return self._pin[g["off"]:g["off"] + g["b"]].tolist()


def _union(intervals) -> float:
    total, end = 0.0, None
    for a, b in sorted(intervals):
        if end is None or a > end:
            total += b - a
            end = b
        elif b > end:
            total += b - end
            end = b
    return total


def short_name(name: str) -> str:
    """A kernel's name without its return type, anonymous namespace,
    template arguments and parameters."""
    name = name.strip()
    for prefix in ("void ", "(anonymous namespace)::"):
        if name.startswith(prefix):
            name = name[len(prefix):]
    name = name.replace("(anonymous namespace)::", "")
    for stop in ("<", "("):
        i = name.find(stop)
        if i > 0:
            name = name[:i]
    return name.strip()[:80] or "unnamed"


def summarize(trace: dict, top: int = 10) -> Dict:
    """Busy and window seconds, kernel time by name, launch calls, and the
    breakdown (top device operations, idle gaps by host span)."""
    events = [e for e in trace.get("traceEvents", []) if e.get("ph") == "X"]
    win = [e for e in events if e.get("name") == "bench.window" and e.get("cat") == "user_annotation"]
    if not win:
        raise RuntimeError("the trace has no bench.window span")
    w0 = float(win[0]["ts"])
    w1 = w0 + float(win[0]["dur"])
    dev, by_name, kernels = [], collections.Counter(), collections.Counter()
    launches = 0
    spans = []
    for e in events:
        cat, name = e.get("cat", ""), e.get("name", "")
        ts, dur = float(e.get("ts", 0.0)), float(e.get("dur", 0.0))
        if cat in DEVICE_CATS:
            a, b = max(ts, w0), min(ts + dur, w1)
            if b > a:
                dev.append((a, b))
                by_name[short_name(name)] += (b - a) * 1e-6
                if cat == "kernel":
                    kernels[name] += (b - a) * 1e-6
        elif name in LAUNCH_APIS and w0 <= ts <= w1:
            launches += 1
        elif cat == "user_annotation" and name.startswith(SPAN_PREFIXES) and name != "bench.window":
            spans.append((ts, ts + dur, name))
    n_kernels = sum(1 for e in events if e.get("cat") == "kernel" and w0 <= float(e["ts"]) <= w1)
    busy_us = _union(dev)
    # idle gaps: the complement of the device intervals inside the window
    gaps, end = [], w0
    for a, b in sorted(dev):
        if a > end:
            gaps.append((end, a))
        end = max(end, b)
    if w1 > end:
        gaps.append((end, w1))
    idle = collections.Counter()
    # one host thread: its spans nest, so a sweep with a stack finds the
    # innermost span open at each gap's middle
    marks = [(s0, 0, name) for s0, _, name in spans] + [(s1, 2, "") for _, s1, _ in spans]
    marks += [(0.5 * (a + b), 1, (b - a) * 1e-6) for a, b in gaps]
    stack: List[str] = []
    for _, kind, val in sorted(marks, key=lambda m: (m[0], m[1])):
        if kind == 0:
            stack.append(val)
        elif kind == 2:
            if stack:
                stack.pop()
        else:
            idle[stack[-1] if stack else "outside spans"] += val
    return {
        "window_s": (w1 - w0) * 1e-6,
        "busy_s": busy_us * 1e-6,
        "kernel_s": dict(kernels),
        "launches": launches if launches else n_kernels,
        "launch_source": "runtime API" if launches else "kernel records",
        "device_ops": [[k, v] for k, v in by_name.most_common(top)],
        "idle_gaps": [[k, v] for k, v in idle.most_common(top)],
    }


def kernel_seconds(summary: Dict, fragment: str) -> float:
    return sum(v for k, v in summary["kernel_s"].items() if fragment in k)

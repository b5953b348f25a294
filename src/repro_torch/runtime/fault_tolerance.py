"""Fault-tolerant training runtime: heartbeats, checkpoint-restart,
elastic re-meshing, straggler mitigation (torch counterpart of
repro/runtime/fault_tolerance.py: the same pure-Python logic over the
port's checkpoint store; ``ElasticTrainer`` restores onto ``device``).

At 1000+ nodes the design invariants are:

  * every piece of training state is (a) a pure function of (seed, step) —
    the data pipeline — or (b) in the checkpoint — params/optimizer;
  * the checkpoint stores every leaf whole, so it restores onto any
    fleet and a failed node shrinks the fleet instead of stopping it;
  * stragglers are detected from step-time statistics (p50-relative) and
    mitigated by re-meshing away the slow host or, for the serving path,
    shrinking the draft window (APSD's own feedback does this natively).

The ``ElasticTrainer`` here drives those pieces with an injectable failure
source so the whole recovery path is unit-testable on CPU: tests kill a
"node" mid-run and assert training resumes from the last checkpoint on a
smaller mesh with identical loss trajectory up to the failure point.
"""
from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np

from repro_torch.checkpoint.store import AsyncCheckpointer, latest_step, load_checkpoint

__all__ = [
    "FaultToleranceConfig",
    "HeartbeatMonitor",
    "StragglerMitigator",
    "ElasticTrainer",
]


@dataclasses.dataclass(frozen=True)
class FaultToleranceConfig:
    ckpt_dir: str  # no default: a shared fixed path would mix runs' checkpoints
    ckpt_every: int = 50
    heartbeat_timeout_s: float = 60.0
    straggler_factor: float = 2.0  # p50 multiplier that flags a host
    straggler_window: int = 16
    max_restarts: int = 8


class HeartbeatMonitor:
    """Tracks per-host liveness from timestamped heartbeats."""

    def __init__(self, hosts: List[int], timeout_s: float, clock=time.monotonic):
        self._clock = clock
        self.timeout = timeout_s
        self._last: Dict[int, float] = {h: clock() for h in hosts}

    def beat(self, host: int):
        self._last[host] = self._clock()

    def dead_hosts(self) -> List[int]:
        now = self._clock()
        return [h for h, t in self._last.items() if now - t > self.timeout]

    def remove(self, host: int):
        self._last.pop(host, None)


class StragglerMitigator:
    """Flags hosts whose step time exceeds ``factor`` x fleet median."""

    def __init__(self, hosts: List[int], factor: float, window: int):
        self.factor = factor
        self._times: Dict[int, deque] = {h: deque(maxlen=window) for h in hosts}

    def record(self, host: int, step_time: float):
        if host in self._times:
            self._times[host].append(step_time)

    def remove(self, host: int):
        self._times.pop(host, None)

    def stragglers(self) -> List[int]:
        means = {
            h: float(np.mean(t)) for h, t in self._times.items() if len(t) >= 4
        }
        if len(means) < 2:
            return []
        med = float(np.median(list(means.values())))
        return [h for h, m in means.items() if m > self.factor * med]


class ElasticTrainer:
    """Checkpoint-restart + elastic re-mesh driver.

    Parameters
    ----------
    build_fn(n_hosts, restore) -> (state, step_fn): constructs the mesh-
        dependent training state; ``restore`` is (step, tree) or None.
        ``step_fn(state, step) -> (state, metrics)`` runs one step.
    state_to_tree / tree_to_state: checkpointable view of the state.
    failure_source() -> Optional[int]: host id that died this tick (tests
        inject here; production wires the HeartbeatMonitor).
    device: where restored trees are placed.
    writer() -> bool: whether this process writes checkpoints (on a mesh,
        rank 0; every rank still builds ``state_to_tree``, a collective).
    sync(): a barrier over the current world, run before a checkpoint is
        read, so no rank reads before the writer has finished.

    Over real ranks every rank runs its own ElasticTrainer with the same failure
    source; ``build_fn`` re-forms the world for the new fleet size
    (``launch.train.elastic_trainer``) and returns ``(None, None)`` on a
    rank that is no longer part of it, whose ``run`` then returns None.
    """

    def __init__(
        self,
        cfg: FaultToleranceConfig,
        n_hosts: int,
        build_fn: Callable[..., Tuple[Any, Callable]],
        state_to_tree: Callable[[Any], Any],
        failure_source: Optional[Callable[[], Optional[int]]] = None,
        min_hosts: int = 1,
        device="cuda",
        writer: Optional[Callable[[], bool]] = None,
        sync: Optional[Callable[[], None]] = None,
    ):
        self.cfg = cfg
        self.n_hosts = n_hosts
        self.min_hosts = min_hosts
        self.device = device
        self.build_fn = build_fn
        self.state_to_tree = state_to_tree
        self.failure_source = failure_source or (lambda: None)
        self.writer = writer or (lambda: True)
        self.sync = sync or (lambda: None)
        self.ckpt = AsyncCheckpointer(cfg.ckpt_dir) if self.writer() else None
        self.restarts = 0
        self.history: List[dict] = []

    def _restore_tuple(self):
        step = latest_step(self.cfg.ckpt_dir)
        if step is None:
            return None
        step, tree, extra = load_checkpoint(self.cfg.ckpt_dir, step, device=self.device)
        return step, tree, extra

    def run(self, total_steps: int) -> Optional[List[dict]]:
        step = 0
        state, step_fn = self.build_fn(self.n_hosts, self._restore_tuple())
        restored = self._restore_tuple()
        if restored is not None:
            step = restored[0] + 1
        while step < total_steps:
            dead = self.failure_source()
            if dead is not None:
                # --- node failure: shrink fleet, restore, rebuild mesh
                self.restarts += 1
                if self.restarts > self.cfg.max_restarts:
                    raise RuntimeError("restart budget exhausted")
                self.n_hosts = max(self.n_hosts - 1, self.min_hosts)
                if self.ckpt is not None:
                    self.ckpt.wait()
                self.sync()
                restored = self._restore_tuple()
                state, step_fn = self.build_fn(self.n_hosts, restored)
                if state is None:  # this rank left the world
                    return None
                step = (restored[0] + 1) if restored is not None else 0
                self.history.append({"event": "restart", "step": step,
                                     "n_hosts": self.n_hosts})
                continue
            state, metrics = step_fn(state, step)
            metrics = dict(metrics)
            metrics.update({"event": "step", "step": step, "n_hosts": self.n_hosts})
            self.history.append(metrics)
            if step % self.cfg.ckpt_every == 0 or step == total_steps - 1:
                tree = self.state_to_tree(state)
                if self.ckpt is not None:
                    self.ckpt.save(step, tree, {"step": step})
            step += 1
        if self.ckpt is not None:
            self.ckpt.wait()
        return self.history

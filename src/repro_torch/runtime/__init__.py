"""Fault-tolerant training runtime (torch counterpart of repro/runtime)."""
from repro_torch.runtime.fault_tolerance import (  # noqa: F401
    ElasticTrainer,
    FaultToleranceConfig,
    HeartbeatMonitor,
    StragglerMitigator,
)

"""repro_torch stands alone: importing every one of its modules pulls in
neither jax nor the JAX package ``repro``."""
import json
import os
import subprocess
import sys

import pytest

pytest.importorskip("torch")

_PROBE = r"""
import importlib, json, pkgutil, sys
import repro_torch
names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__, "repro_torch.")]
for name in names:
    importlib.import_module(name)
leaked = sorted(m for m in sys.modules
                if m == "jax" or m.startswith(("jax.", "jaxlib")) or m == "repro"
                or m.startswith("repro."))
print(json.dumps({"modules": names, "leaked": leaked}))
"""


def test_port_imports_neither_jax_nor_reference():
    src = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "src")
    env = dict(os.environ, PYTHONPATH=src)
    out = subprocess.run([sys.executable, "-c", _PROBE], capture_output=True, text=True,
                         env=env, timeout=300, check=True)
    report = json.loads(out.stdout.strip().splitlines()[-1])
    assert "repro_torch.serving.engine" in report["modules"]
    assert "repro_torch.kernels.w4a8_matmul" in report["modules"]
    for name in ("models.ssm", "models.whisper", "models.convert", "optim.adamw",
                 "optim.schedule", "optim.compression", "data.pipeline", "checkpoint.store",
                 "runtime.fault_tolerance", "launch.mesh", "launch.steps", "launch.train",
                 "core.tree"):
        assert f"repro_torch.{name}" in report["modules"], name
    assert report["leaked"] == []

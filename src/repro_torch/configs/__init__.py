"""Architecture registry (torch counterpart of repro/configs/__init__.py):
``--arch <id>`` resolves here.

Each module exports FULL (the exact published config) and SMOKE (a reduced
same-family config for CPU tests).  ``long_500k`` applicability follows the
assignment: sub-quadratic decode only (SSM / hybrid)."""
from __future__ import annotations

import importlib
from typing import Dict, List

from repro_torch.models.common import ModelConfig, ShapeConfig, SHAPES

_MODULES = {
    "mamba2-1.3b": "mamba2_1_3b",
    "internvl2-1b": "internvl2_1b",
    "zamba2-7b": "zamba2_7b",
    "moonshot-v1-16b-a3b": "moonshot_v1_16b_a3b",
    "grok-1-314b": "grok_1_314b",
    "deepseek-67b": "deepseek_67b",
    "llama3-405b": "llama3_405b",
    "nemotron-4-15b": "nemotron_4_15b",
    "qwen3-8b": "qwen3_8b",
    "whisper-large-v3": "whisper_large_v3",
}

ARCH_IDS: List[str] = list(_MODULES)

# archs whose decode is sub-quadratic in context (long_500k runs)
LONG_CONTEXT_ARCHS = {"mamba2-1.3b", "zamba2-7b"}


def _mod(arch: str):
    if arch not in _MODULES:
        raise KeyError(f"unknown arch {arch!r}; known: {ARCH_IDS}")
    return importlib.import_module(f"repro_torch.configs.{_MODULES[arch]}")


def get_config(arch: str) -> ModelConfig:
    return _mod(arch).FULL


def get_smoke(arch: str) -> ModelConfig:
    return _mod(arch).SMOKE


def shape_applicable(arch: str, shape: str) -> bool:
    """The 40-cell grid minus the assignment's documented skips."""
    if shape == "long_500k":
        return arch in LONG_CONTEXT_ARCHS
    return True


def cells(include_skipped: bool = False):
    """All (arch, shape) dry-run cells."""
    out = []
    for a in ARCH_IDS:
        for s in SHAPES:
            if include_skipped or shape_applicable(a, s):
                out.append((a, s))
    return out

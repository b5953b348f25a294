"""The device mesh of the launch entry points (torch counterpart of
repro/launch/mesh.py), one device only.

A ``DeviceMesh`` names one device and carries the reference's axis sizes
(``data``, ``model``), both 1.  Larger meshes, ``make_production_mesh`` and
``--multi-pod`` raise ``NotImplementedError``: they wait for ROADMAP's
sharded-mesh item (tensor parallelism, ZeRO-1 ``optimizer_specs`` and the
production mesh over ``torch.distributed``, with the expert-parallel MoE
paths)."""
from __future__ import annotations

import dataclasses
from typing import Dict

import torch

__all__ = ["DeviceMesh", "make_mesh", "make_cpu_mesh", "make_production_mesh"]

_SHARDED = ("a mesh over more than one device waits for ROADMAP's sharded-mesh item "
            "(tensor parallelism, ZeRO-1 optimizer_specs, the production mesh and the "
            "expert-parallel MoE paths on torch.distributed)")


@dataclasses.dataclass(frozen=True)
class DeviceMesh:
    device: torch.device
    shape: Dict[str, int] = dataclasses.field(default_factory=lambda: {"data": 1, "model": 1})


def make_mesh(device="cuda", data: int = 1, model: int = 1) -> DeviceMesh:
    """A one-device mesh on ``device``; data or model > 1 raises."""
    if data != 1 or model != 1:
        raise NotImplementedError(f"mesh (data={data}, model={model}): {_SHARDED}")
    return DeviceMesh(torch.device(device))


def make_cpu_mesh(data: int = 1, model: int = 1) -> DeviceMesh:
    """The CPU mesh of tests and ``--device cpu``."""
    return make_mesh("cpu", data, model)


def make_production_mesh(*, multi_pod: bool = False) -> DeviceMesh:
    raise NotImplementedError(
        f"the production mesh ({'2 x ' if multi_pod else ''}16 x 16): {_SHARDED}")


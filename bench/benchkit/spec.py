"""A configuration file, and the family module that builds and checks it.

A configuration file (``configs/<config>.json``) holds the published
config's keys as they are run, ``family`` (the name of the module
``families/<family>.py`` that turns them into the program's pair and
holds its reference), the family's own serving keys, and ``check`` (the
limits of the comparison that decides ``correct``).  A new kind of model
arrives as a new family file plus a configuration naming it; nothing here
changes.

A family module exposes (``model`` is whatever its ``load`` returns):

* ``load(raw) -> model``: the sizes and serving modes, from the file;
* ``vocab(model) -> int``: the target's vocabulary (token ids are drawn
  below it);
* ``pair(model, seed, s_max, device) -> (target, draft)``: the program's
  two ``ServingModel``s, from weights made from the seed;
* ``keep(model, target, draft) -> kept``: what the comparison takes from
  the program's pair before it is freed (operands the reference cannot
  remake, such as a draft's BVQ codebooks and indices), or None;
* ``target_logits(model, seed, seqs, starts, device, precision)``: the
  reference's float32 logits at every position of each sequence that
  predicts a served token (``precision="control"``: one step lower);
* ``draft_logits(model, seed, kept, seq, rows, device, precision)``: the
  reference draft's logits at ``rows`` of one sequence;
* ``draft_readings(model, seed, kept, device) -> dict``: further numbers
  about the draft's operands (compared where ``check`` names them);
* ``role_of_forward(model, calls)``: "target", "draft" or None, for a
  paged forward that made ``calls`` attention calls;
* ``forward_flops(model, role, rows, keys) -> float``: the model FLOPs of
  ``rows`` rows that see ``keys`` (query, key) pairs in all.

Nothing here imports the program.
"""
from __future__ import annotations

import dataclasses
import importlib.util
import json
import pathlib
import sys
from types import ModuleType
from typing import Any, Dict

import torch

ACTS = {"silu": "swiglu", "relu2": "squared_relu"}


@dataclasses.dataclass(frozen=True)
class ModelSpec:
    """The sizes of a dense pre-norm decoder (the ``dense`` family's)."""
    name: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv: int
    head_dim: int
    d_ff: int
    vocab: int
    rope_theta: float
    act: str  # swiglu | squared_relu
    qk_norm: bool
    dtype: torch.dtype
    eps: float = 1e-6

    def cut(self, n_layers: int, name: str) -> "ModelSpec":
        return dataclasses.replace(self, n_layers=n_layers, name=name)


def spec_of(raw: Dict[str, Any], name: str) -> ModelSpec:
    d, h = int(raw["hidden_size"]), int(raw["num_attention_heads"])
    return ModelSpec(
        name=name,
        n_layers=int(raw["num_hidden_layers"]),
        d_model=d,
        n_heads=h,
        n_kv=int(raw["num_key_value_heads"]),
        head_dim=int(raw.get("head_dim") or d // h),
        d_ff=int(raw["intermediate_size"]),
        vocab=int(raw["vocab_size"]),
        rope_theta=float(raw["rope_theta"]),
        act=ACTS[raw["hidden_act"]],
        qk_norm=bool(raw.get("qk_norm", False)),
        dtype=getattr(torch, raw.get("torch_dtype", "bfloat16")),
        eps=float(raw.get("rms_norm_eps", 1e-6)),
    )


@dataclasses.dataclass(frozen=True)
class ConfigFile:
    name: str
    raw: Dict[str, Any]
    family: ModuleType
    model: Any
    check: Dict[str, float]

    @property
    def vocab(self) -> int:
        return int(self.family.vocab(self.model))


def family(name: str, bench_dir: pathlib.Path) -> ModuleType:
    path = pathlib.Path(bench_dir) / "families" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"bench_family_{name.replace('-', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = mod  # its dataclasses look their module up
    spec.loader.exec_module(mod)
    return mod


def load(path: pathlib.Path, bench_dir: pathlib.Path) -> ConfigFile:
    raw = json.loads(pathlib.Path(path).read_text())
    fam = family(raw["family"], bench_dir)
    return ConfigFile(name=raw["name"], raw=raw, family=fam, model=fam.load(raw),
                      check=dict(raw.get("check", {})))

"""Public serving API types of the stepwise ``Engine`` (torch counterpart of
repro/serving/api.py).

* ``SamplingParams`` — frozen per-request decode knobs.  The port serves
  greedy requests (``temperature == 0``); ``Engine.add_request`` refuses
  sampled requests and stop strings until the reference's key streams are
  reproduced.
* ``RequestOutput`` / ``CompletionOutput`` — the streaming result type.
* ``EngineConfig`` — engine-wide knobs.  The paged-attention path is not a
  knob here: the device decides (kernel on the card, plain version on the
  CPU).  Non-default values of the features this port does not carry yet
  are accepted by the dataclass and refused by ``Engine``; the knobs that
  only those features read (tree budget, APSD short/long lengths, byte
  budgets) are left out.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple, Union

__all__ = [
    "SamplingParams",
    "CompletionOutput",
    "RequestOutput",
    "EngineConfig",
]


@dataclasses.dataclass(frozen=True)
class SamplingParams:
    """Per-request decode parameters.  ``temperature == 0`` is greedy."""

    temperature: float = 0.0
    top_k: int = 0
    top_p: float = 1.0
    seed: int = 0
    max_tokens: int = 64
    stop: Tuple[str, ...] = ()
    kv_quant: Optional[str] = None

    def __post_init__(self):
        if self.kv_quant not in (None, "none", "int8"):
            raise ValueError(
                f"kv_quant must be None, 'none' or 'int8', got {self.kv_quant!r}"
            )
        if self.temperature < 0.0:
            raise ValueError(f"temperature must be >= 0, got {self.temperature}")
        if self.top_k < 0:
            raise ValueError(f"top_k must be >= 0, got {self.top_k}")
        if not 0.0 < self.top_p <= 1.0:
            raise ValueError(f"top_p must be in (0, 1], got {self.top_p}")
        if self.max_tokens <= 0:
            raise ValueError(f"max_tokens must be > 0, got {self.max_tokens}")
        stop: Union[str, Tuple[str, ...]] = self.stop
        if isinstance(stop, str):
            stop = (stop,)
        stop = tuple(stop)
        for s in stop:
            if not isinstance(s, str) or not s:
                raise ValueError(f"stop entries must be non-empty strings, got {s!r}")
        object.__setattr__(self, "stop", stop)

    @property
    def greedy(self) -> bool:
        return self.temperature == 0.0


@dataclasses.dataclass
class CompletionOutput:
    """One completion of a request (the engine produces exactly one)."""

    index: int
    token_ids: List[int]
    finish_reason: Optional[str] = None  # None | "length" | "abort"

    @property
    def finished(self) -> bool:
        return self.finish_reason is not None


@dataclasses.dataclass
class RequestOutput:
    """Streaming per-request result emitted by ``Engine.step()``:
    ``new_token_ids`` are the tokens verified this step,
    ``outputs[0].token_ids`` the cumulative completion."""

    request_id: int
    prompt_token_ids: List[int]
    new_token_ids: List[int]
    finished: bool
    outputs: List[CompletionOutput]

    @property
    def token_ids(self) -> List[int]:
        return self.outputs[0].token_ids


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    """Engine-wide knobs: scheduling and paging (see the reference for the
    meaning of each)."""

    max_batch: int = 8  # concurrent DECODE slots (batched model rows)
    page_size: int = 16  # tokens per KV page
    draft_len: int = 3  # fixed draft window
    num_pages: Optional[int] = None  # page budget per pool (None: fit
    # max_batch worst-case requests of max_model_len tokens)
    max_model_len: Optional[int] = None  # peak cache length of a request
    # not ported yet: refused by Engine at any value but the default
    adaptive: bool = False  # APSD draft-length adaptation
    par_mode: str = "off"  # "wdos" fused rounds
    kv_quant: str = "none"  # "int8" / "mixed" pools
    prefix_cache: bool = False
    spec_mode: str = "chain"  # "tree" speculation
    profile_every_n: int = 0  # sampled device-time profiling

    def __post_init__(self):
        if self.par_mode not in ("off", "wdos"):
            raise ValueError(f"par_mode must be 'off' or 'wdos', got {self.par_mode!r}")
        if self.spec_mode not in ("chain", "tree"):
            raise ValueError(f"spec_mode must be 'chain' or 'tree', got {self.spec_mode!r}")
        if self.kv_quant not in ("none", "int8", "mixed"):
            raise ValueError(
                f"kv_quant must be 'none', 'int8' or 'mixed', got {self.kv_quant!r}"
            )
        if self.profile_every_n < 0:
            raise ValueError(f"profile_every_n must be >= 0, got {self.profile_every_n}")

    @property
    def spec_window(self) -> int:
        """Worst-case speculative tokens resident in a request's cache at
        once — what admission reserves beyond prompt + max_tokens."""
        return self.draft_len

    def unported(self) -> List[str]:
        """The non-default settings this port does not carry yet."""
        defaults = EngineConfig.__dataclass_fields__
        names = ("adaptive", "par_mode", "kv_quant", "prefix_cache", "spec_mode",
                 "profile_every_n")
        return [f"{n}={getattr(self, n)!r}" for n in names
                if getattr(self, n) != defaults[n].default]

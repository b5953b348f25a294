"""Public serving API types of the stepwise ``Engine`` (torch counterpart of
repro/serving/api.py).

* ``SamplingParams`` — frozen per-request decode knobs.  ``temperature >
  0`` selects lossless speculative rejection sampling from a per-request
  key stream seeded by ``seed``; ``stop`` holds stop strings matched
  against the detokenized output (``default_detokenize`` unless the engine
  is given its own).
* ``RequestOutput`` / ``CompletionOutput`` — the streaming result type.
* ``EngineConfig`` — engine-wide knobs.  ``paged_attn_impl`` takes the
  reference's values (``resolve_paged_attn_impl``), but the device decides
  the route: the paged-attention kernel on the card, its plain version on
  the CPU, whichever value is given.

``warn_deprecated_once`` backs the deprecated ``serve_*`` wrappers.
"""
from __future__ import annotations

import dataclasses
import warnings
from typing import List, Optional, Tuple, Union

__all__ = [
    "SamplingParams",
    "CompletionOutput",
    "RequestOutput",
    "EngineConfig",
    "resolve_paged_attn_impl",
    "default_detokenize",
    "warn_deprecated_once",
]


def default_detokenize(token_id: int) -> str:
    """The toy LMs decode over an untextured integer vocab, so the default
    detokenizer renders a token as its decimal id plus a space (``[5, 17]
    -> "5 17 "``).  Stop-string matching runs on this stream; pass a real
    detokenizer to ``Engine`` when serving a real vocabulary."""
    return f"{token_id} "


_PAGED_ATTN_IMPLS = ("gather", "pallas")


def resolve_paged_attn_impl(impl: Optional[str] = "auto", backend: Optional[str] = None) -> str:
    """A paged-attention choice resolved as the reference resolves it:
    ``"gather"`` or ``"pallas"`` as given, ``None`` / ``"auto"`` to
    ``"pallas"`` on a TPU backend and ``"gather"`` elsewhere (``backend``
    defaults to ``"gpu"`` where CUDA is present, else ``"cpu"``), anything
    else ValueError.  The name is kept for the reference's API; in the port
    both names run the same attention, the kernel on the card and its plain
    version on the CPU."""
    if impl in _PAGED_ATTN_IMPLS:
        return impl
    if impl not in (None, "auto"):
        raise ValueError(
            f"paged_attn_impl must be one of {_PAGED_ATTN_IMPLS + ('auto',)}, got {impl!r}"
        )
    if backend is None:
        import torch

        backend = "gpu" if torch.cuda.is_available() else "cpu"
    return "pallas" if backend == "tpu" else "gather"


@dataclasses.dataclass(frozen=True)
class SamplingParams:
    """Per-request decode parameters.  ``temperature == 0`` is greedy;
    ``temperature > 0`` samples (after ``top_k`` and ``top_p`` filtering)
    from the key stream of ``seed``.  Generation ends with
    ``finish_reason="stop"`` at the first match of a ``stop`` string, and
    the output excludes the tokens whose text overlaps the match."""

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
    finish_reason: Optional[str] = None  # None | "length" | "stop" | "abort"

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
    draft_len: int = 3  # fixed draft window (adaptive=False)
    # per-request APSD draft lengths: each request's controller picks
    # short_dl (NONPAR) or long_dl (PAR) per round from its own acceptance
    adaptive: bool = False
    short_dl: int = 2
    long_dl: int = 6
    num_pages: Optional[int] = None  # page budget per pool (None: fit
    # max_batch worst-case requests of max_model_len tokens)
    # byte budget per pool, in the bytes of its storage kinds (int8 pages
    # with their scales are ~3.5x smaller than f32 ones, so the same budget
    # holds more of them); exclusive with num_pages
    pool_bytes: Optional[int] = None
    max_model_len: Optional[int] = None  # peak cache length of a request
    model_wdos: bool = True  # price each round with the WDOS model (stats)
    # paged-KV storage: "none" (model dtype), "int8" (every request stores
    # int8 pages + one f32 scale per (slot, kv head)) or "mixed" (both
    # stores; each request picks with SamplingParams.kv_quant, default none)
    kv_quant: str = "none"
    # speculation topology: "chain", or "tree" — a frontier node fans out to
    # spec_branches top-k children when the draft's top-1 probability is
    # below branch_threshold and the tree_budget node budget allows; the
    # target verifies the whole tree in one ancestor-masked pass
    spec_mode: str = "chain"
    spec_branches: int = 2
    tree_budget: int = 8
    branch_threshold: float = 0.6
    # "off": two-phase rounds (every row drafts in lockstep, then one
    # verify pass); "wdos": each step runs a horizon of fused slots in
    # which window-full rows verify while the other rows draft
    # (core/scheduler.plan_mixed_slot).  Tokens are the same in both.
    par_mode: str = "off"
    # copy-on-write prefix cache: full prompt blocks are shared read-only
    # between requests of one KV kind (serving/prefix_cache.py)
    prefix_cache: bool = False
    # sampled device-time profiling: every Nth engine round each dispatched
    # program is bracketed by device synchronizations, timed on the engine's
    # clock and stamped once with its FLOP / byte count (Engine._profiled);
    # 0 disables.  Timing never changes the math.
    profile_every_n: int = 0
    # flight recorder (serving/flight_recorder.py): a ring of per-round
    # records with anomaly triggers; 0 disables it.  flight_dump_dir, when
    # set, receives a postmortem JSON file per anomaly.
    flight_ring: int = 256
    flight_dump_dir: Optional[str] = None
    # the reference's paged decode-attention choice: "gather" | "pallas" |
    # "auto" | None, checked by ``resolve_paged_attn_impl`` when the Engine
    # is built (as the reference checks it).  Every value selects the same
    # route in the port: the paged-attention kernel (kernels/csrc/
    # paged_attn.cu) on a CUDA device, its plain version on the CPU.
    paged_attn_impl: Optional[str] = None

    def __post_init__(self):
        if self.par_mode not in ("off", "wdos"):
            raise ValueError(f"par_mode must be 'off' or 'wdos', got {self.par_mode!r}")
        if self.spec_mode not in ("chain", "tree"):
            raise ValueError(f"spec_mode must be 'chain' or 'tree', got {self.spec_mode!r}")
        if self.spec_mode == "tree":
            if self.spec_branches < 2:
                raise ValueError(f"spec_branches must be >= 2, got {self.spec_branches}")
            if self.tree_budget < 1:
                raise ValueError(f"tree_budget must be >= 1, got {self.tree_budget}")
            if not 0.0 <= self.branch_threshold <= 1.0:
                raise ValueError(
                    f"branch_threshold must be in [0, 1], got {self.branch_threshold}"
                )
        if self.kv_quant not in ("none", "int8", "mixed"):
            raise ValueError(
                f"kv_quant must be 'none', 'int8' or 'mixed', got {self.kv_quant!r}"
            )
        if self.pool_bytes is not None:
            if self.num_pages is not None:
                raise ValueError("set num_pages or pool_bytes, not both")
            if self.pool_bytes <= 0:
                raise ValueError(f"pool_bytes must be > 0, got {self.pool_bytes}")
        if self.profile_every_n < 0:
            raise ValueError(f"profile_every_n must be >= 0, got {self.profile_every_n}")
        if self.flight_ring < 0:
            raise ValueError(f"flight_ring must be >= 0, got {self.flight_ring}")

    @property
    def max_dl(self) -> int:
        """The longest draft window a request can open."""
        return self.long_dl if self.adaptive else self.draft_len

    @property
    def spec_window(self) -> int:
        """Worst-case speculative tokens resident in a request's cache at
        once — what admission reserves beyond prompt + max_tokens.  A chain
        round writes at most ``max_dl`` uncommitted drafts; a tree round
        writes the whole padded window (``tree_budget`` nodes)."""
        return self.tree_budget if self.spec_mode == "tree" else self.max_dl

    @property
    def kv_kinds(self) -> Tuple[str, ...]:
        """The KV storage kinds this engine allocates stores for."""
        return ("none", "int8") if self.kv_quant == "mixed" else (self.kv_quant,)

    def resolve_kv_quant(self, requested: Optional[str]) -> str:
        """A request's storage kind: ``None`` takes the engine default
        ("none" under "mixed"); an explicit choice must name an allocated
        kind, else ValueError."""
        if requested is None:
            return "none" if self.kv_quant == "mixed" else self.kv_quant
        if requested not in self.kv_kinds:
            raise ValueError(
                f"request kv_quant={requested!r} is incompatible with engine "
                f"kv_quant={self.kv_quant!r} (allocated kinds: {self.kv_kinds})"
            )
        return requested


_DEPRECATION_EMITTED: set = set()


def warn_deprecated_once(name: str, replacement: str) -> None:
    """Emit a DeprecationWarning for ``name`` at most once per process."""
    if name in _DEPRECATION_EMITTED:
        return
    _DEPRECATION_EMITTED.add(name)
    warnings.warn(f"{name}() is deprecated; use {replacement}", DeprecationWarning,
                  stacklevel=3)

"""Build and load the port's CUDA kernels.

The sources under ``kernels/csrc`` are compiled with ``nvcc`` for
``sm_90a`` into one shared library with a plain C interface and loaded
with ``ctypes`` (a build that includes PyTorch's headers takes minutes; this
one takes seconds).  Each source compiles to its own object in parallel,
then one link.  The library lands in ``build/`` at the repository root,
named by a hash of the sources and flags, and is built at first use.

``launches`` counts kernel launches per wrapper: each wrapper adds one
where it launches its kernel and nowhere else, so a caller can show that
a run went through the kernels (set it to zero with ``launches.clear()``).

``scratch`` hands the split-K and split-sequence kernels their workspaces
and arrival counters: allocated once per (device, stream, name), grown
when a call needs more, never filled per call (the kernels re-arm the
counters).
"""
from __future__ import annotations

import collections
import ctypes
import functools
import hashlib
import os
import pathlib
import shutil
import subprocess
import threading
import time
from typing import Dict, List, NamedTuple, Optional, Tuple

import torch

__all__ = ["launches", "nvcc", "build", "lib", "check", "dtype_code", "stream_ptr",
           "require_cuda", "sm_count", "scratch", "Plan", "token_tiles", "split_k_elems",
           "attn_splits", "attn_scratch"]

CSRC = pathlib.Path(__file__).resolve().parent / "csrc"
BUILD_DIR = pathlib.Path(__file__).resolve().parents[3] / "build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
)

launches: "collections.Counter[str]" = collections.Counter()

_P = ctypes.c_void_p
_I = ctypes.c_int
# C signatures: every entry point returns cudaGetLastError() as int
_SIGNATURES = {
    "repro_w4a8_matmul": (_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _P),
    "repro_block_rotate": (_P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _P),
    "repro_bvq_matmul": (_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I,
                         _P),
    "repro_paged_attn": (_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                         _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _P),
    "repro_decode_attn_int8": (_P, _P, _P, _P, _P, _P, _P, _P, _P,
                               _I, _I, _I, _I, _I, _I, _I, _P),
}

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_scratch: Dict[Tuple[torch.device, int, str], torch.Tensor] = {}


def nvcc() -> str:
    """Path of nvcc: $CUDA_HOME/bin, /usr/local/cuda/bin, then $PATH."""
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and os.path.exists(os.path.join(root, "bin", "nvcc")):
            return os.path.join(root, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return found


def _sources() -> Tuple[List[pathlib.Path], str]:
    cus = sorted(CSRC.glob("*.cu"))
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in cus + sorted(CSRC.glob("*.cuh")):
        h.update(f.name.encode())
        h.update(f.read_bytes())
    return cus, h.hexdigest()[:16]


def build() -> Tuple[pathlib.Path, Dict[str, object]]:
    """Compile every ``csrc/*.cu`` (one nvcc per source, all at once) and
    link them into ``build/librepro_kernels-<hash>.so``.  Returns the path
    and a report: build seconds and each source's ``-Xptxas -v`` output
    (registers, shared memory and spills per kernel); an up-to-date library
    is reused and reports 0 seconds."""
    cus, digest = _sources()
    so = BUILD_DIR / f"librepro_kernels-{digest}.so"
    report: Dict[str, object] = {"library": str(so), "seconds": 0.0, "ptxas": {}}
    if so.exists():
        return so, report
    t0 = time.perf_counter()
    obj_dir = BUILD_DIR / f"obj-{digest}"
    obj_dir.mkdir(parents=True, exist_ok=True)
    exe = nvcc()
    procs = []
    for src in cus:
        obj = obj_dir / (src.stem + ".o")
        cmd = [exe, *NVCC_FLAGS, "-Xptxas", "-v", "-c", str(src), "-o", str(obj)]
        procs.append((src, obj, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    failed = []
    for src, _, proc in procs:
        text, _ = proc.communicate()
        report["ptxas"][src.name] = text
        if proc.returncode != 0:
            failed.append(f"{src.name}:\n{text}")
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    tmp = so.with_suffix(f".{os.getpid()}.tmp")
    link = subprocess.run(
        [exe, *NVCC_FLAGS, "-shared", "-o", str(tmp), *(str(o) for _, o, _ in procs)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
    )
    if link.returncode != 0:
        raise RuntimeError("nvcc link failed:\n" + link.stdout)
    os.replace(tmp, so)
    report["seconds"] = time.perf_counter() - t0
    return so, report


def lib() -> ctypes.CDLL:
    """The loaded kernel library, built on first use."""
    global _lib
    with _lock:
        if _lib is None:
            path, _ = build()
            handle = ctypes.CDLL(str(path))
            for name, args in _SIGNATURES.items():
                fn = getattr(handle, name)
                fn.argtypes = list(args)
                fn.restype = ctypes.c_int
            _lib = handle
        return _lib


def check(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with cudaError {err}")


def dtype_code(dtype: torch.dtype) -> int:
    if dtype not in _DTYPE_CODES:
        raise TypeError(f"kernel dtype must be float32, bfloat16 or int8, got {dtype}")
    return _DTYPE_CODES[dtype]


def stream_ptr(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def require_cuda(name: str, *tensors: torch.Tensor) -> torch.device:
    """Every tensor on one CUDA device and contiguous, else raise."""
    dev = tensors[0].device
    for t in tensors:
        if t.device.type != "cuda" or t.device != dev:
            raise ValueError(f"{name}: all inputs must be on one CUDA device, got {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: inputs must be contiguous")
    return dev


@functools.lru_cache(maxsize=None)
def sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def scratch(device: torch.device, name: str, numel: int, dtype: torch.dtype) -> torch.Tensor:
    """A cached buffer of at least ``numel`` elements for the current stream
    of ``device``, zeroed when it is (re)allocated and never again: a
    kernel that uses it as arrival counters leaves them at zero."""
    key = (device, stream_ptr(device), name)
    buf = _scratch.get(key)
    if buf is None or buf.numel() < numel or buf.dtype != dtype:
        buf = torch.zeros(max(numel, 2 * buf.numel() if buf is not None else 0), dtype=dtype,
                          device=device)
        _scratch[key] = buf
    return buf


class Plan(NamedTuple):
    """How one matmul call tiles its work: ``mt`` token tiles of 8 per
    pass, ``passes`` over the weight (``MAX_TOKENS`` tokens each), ``ctas``
    64-channel tiles, and K split ``ksplit`` ways of ``stages_per_split``
    of the kernel's ``k_stages`` pipeline stages."""

    mt: int
    passes: int
    ctas: int
    ksplit: int
    stages_per_split: int
    k_stages: int


MAX_TOKENS = 128  # tokens per pass of the matmul kernels


def token_tiles(m: int) -> Tuple[int, int]:
    """(mt, passes) for M tokens: the smallest power-of-two count of 8-token
    tiles holding one pass of at most MAX_TOKENS tokens, and the passes."""
    mt = 1
    while mt * 8 < min(m, MAX_TOKENS):
        mt *= 2
    return mt, -(-m // MAX_TOKENS)


def split_k_elems(p: Plan) -> int:
    """Workspace elements of a split-K call (csrc/common.cuh split_k_reduce:
    a 4-element vector per lane of a 4-warp group, token tile, split and
    output tile)."""
    return p.passes * p.ctas * p.ksplit * p.mt * 128 * 4


MIN_SPLIT_POSITIONS = 256  # least positions a split of an attention walk holds
ATTN_BLOCKS_PER_SM = 2  # blocks of the attention kernels resident on an SM


def attn_splits(sms: int, pairs: int, positions: int) -> int:
    """Blocks per (request, kv head) for the attention kernels
    (csrc/flash_decode.cuh), from static shapes only: ``pairs`` (request,
    kv head) pairs over a walk of at most ``positions`` cached positions.
    As many splits as keep the blocks within one wave of ATTN_BLOCKS_PER_SM
    blocks per SM (a second, partial wave costs more than the splits win),
    but none shorter than MIN_SPLIT_POSITIONS, so the main path's rows (<= 12
    pages) take one block and no workspace."""
    fit = ATTN_BLOCKS_PER_SM * sms // max(pairs, 1)
    return max(1, min(fit, positions // MIN_SPLIT_POSITIONS))


def attn_scratch(device: torch.device, splits: int, pairs: int, rows: int,
                 hd: int) -> Tuple[Optional[torch.Tensor], Optional[torch.Tensor]]:
    """(workspace, arrival counters) of a split attention call, or (None,
    None) for one split: (pairs, splits, rows, hd + 2) f32 partials, and a
    counter per pair and group of query rows (``rows`` bounds the groups)."""
    if splits == 1:
        return None, None
    ws = scratch(device, "attn_ws", pairs * splits * rows * (hd + 2), torch.float32)
    return ws, scratch(device, "attn_cnt", pairs * rows, torch.int32)

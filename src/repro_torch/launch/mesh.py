"""The device mesh (torch counterpart of repro/launch/mesh.py) over
``torch.distributed``: one process per rank.

A ``DeviceMesh`` names the axes ``("data", "model")``, or ``("pod",
"data", "model")`` for the multi-pod mesh, over an initialized process
group: rank ``r`` sits at the row-major coordinates of ``r`` in the axis
sizes (``model`` fastest), as ``jax.make_mesh`` lays devices out.  Every
subset of the axes has its sub-groups, so a collective runs over ``"model"``
(tensor and expert parallelism, sequence sharding), ``"data"`` (the
gradient reduction, FSDP and ZeRO-1 gathers), or several axes at once.  A
mesh of one rank needs no process group and its collectives are the
identity.

The backend follows one rule, which the mesh records (``backend``,
``transport``):

* gloo on the CPU;
* gloo when ranks share a card (NCCL refuses two ranks on one device in one
  communicator): each rank runs its kernels on the shared card and the
  collectives go through host memory;
* NCCL when every rank has its own card.

On a shared card gloo takes the CUDA tensors themselves: every collective
the mesh runs (all-reduce sum and max, all-gather, reduce-scatter,
all-to-all) accepted CUDA float32, bfloat16, int32 and int8
tensors with correct results on the H100 machine's torch 2.11, so none is
staged through host buffers by the mesh (gloo copies through host memory
inside the collective).  ``tests/test_torch_mesh_cuda.py`` holds each of
them on CUDA tensors.

``spawn(fn, data, model, device)`` starts a local world (tests and
chip_smoke.py): one spawned process per rank (a forked child cannot use
CUDA), a ``file://`` store in a fresh temp dir (no TCP port to race for),
one intra-op thread per rank; each rank runs ``fn(mesh, *args)`` and the
parent gets every rank's return value.  A real world starts under
``torchrun`` (``init_world`` reads its environment), and
``make_production_mesh`` builds the 16 x 16 or 2 x 16 x 16 mesh from a
world of 256 or 512 ranks.

``comm`` counts the collectives a rank ran (calls, bytes, host seconds
including staging), so a caller can report them per step; ``clear()`` it
before the span to be measured."""
from __future__ import annotations

import collections
import itertools
import os
import shutil
import tempfile
import time
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple, Union

import torch
import torch.distributed as dist

__all__ = ["DeviceMesh", "make_mesh", "make_cpu_mesh", "make_production_mesh", "init_world",
           "spawn", "remesh", "backend_for", "all_reduce", "copy_to_region",
           "all_gather", "gather_replicated", "reduce_scatter", "split", "all_to_all", "axis_size",
           "axis_index"]

Axis = Union[str, Tuple[str, ...]]

_OPS = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}
# the single-tensor collectives under their newer names where torch has them
_ALL_GATHER = getattr(dist, "all_gather_single", dist.all_gather_into_tensor)
_REDUCE_SCATTER = getattr(dist, "reduce_scatter_single", dist.reduce_scatter_tensor)


def backend_for(device: str, local_ranks: int) -> Tuple[str, str]:
    """(backend, transport) for ``local_ranks`` ranks on this host on
    ``device``: gloo on the CPU, gloo through host memory when the ranks
    share a card, NCCL when each rank has a card of its own."""
    if torch.device(device).type == "cpu":
        return "gloo", "gloo-cpu"
    if torch.cuda.device_count() >= local_ranks:
        return "nccl", "nccl"
    return "gloo", "gloo-shared-card"


def _as_axes(axis: Axis) -> Tuple[str, ...]:
    return (axis,) if isinstance(axis, str) else tuple(axis)


class DeviceMesh:
    """This rank's view of the mesh: ``shape`` (axis -> size, the
    reference's ``mesh.shape``), ``coords`` (axis -> index), ``device``,
    ``rank``, ``backend`` and ``transport``, and a process group per subset
    of the axes (None where the subset has one rank)."""

    def __init__(self, device, shape: Dict[str, int], rank: int = 0,
                 groups: Optional[Dict[Tuple[str, ...], Any]] = None,
                 backend: Optional[str] = None, transport: str = "none",
                 init_method: Optional[str] = None):
        self.device = torch.device(device)
        self.shape = dict(shape)
        self.axes = tuple(self.shape)
        self.rank = rank
        idx, self.coords = rank, {}
        for a in reversed(self.axes):
            self.coords[a] = idx % self.shape[a]
            idx //= self.shape[a]
        self.coords = {a: self.coords[a] for a in self.axes}
        self.groups = groups or {}
        self.backend = backend
        self.transport = transport
        self.init_method = init_method
        self.comm: "collections.Counter[str]" = collections.Counter()

    def __repr__(self) -> str:
        return (f"DeviceMesh(shape={self.shape}, rank={self.rank}, coords={self.coords}, "
                f"device={self.device}, backend={self.backend}, transport={self.transport})")

    @property
    def size(self) -> int:
        n = 1
        for v in self.shape.values():
            n *= v
        return n

    @property
    def tp(self) -> int:
        return self.shape["model"]

    @property
    def dp(self) -> int:
        return self.size // self.tp

    def axis_size(self, axis: Axis) -> int:
        n = 1
        for a in _as_axes(axis):
            n *= self.shape.get(a, 1)
        return n

    def axis_index(self, axis: Axis) -> int:
        """This rank's index along ``axis`` (axes in mesh order, the first
        slowest)."""
        i = 0
        for a in _as_axes(axis):
            if a in self.shape:
                i = i * self.shape[a] + self.coords[a]
        return i

    def group(self, axis: Axis):
        key = tuple(a for a in self.axes if a in _as_axes(axis))
        return self.groups.get(key)

    # -- collectives (no autograd; see the module functions for that) -----

    def _count(self, name: str, t: torch.Tensor, t0: float) -> None:
        self.comm["calls"] += 1
        self.comm[f"{name}_calls"] += 1
        self.comm["bytes"] += t.numel() * t.element_size()
        self.comm["seconds"] += time.perf_counter() - t0

    def all_reduce(self, t: torch.Tensor, axis: Axis, op: str = "sum") -> torch.Tensor:
        """A new tensor: t reduced (``op`` "sum" or "max") over ``axis``."""
        g = self.group(axis)
        out = t.contiguous().clone()
        if self.axis_size(axis) == 1:
            return out
        t0 = time.perf_counter()
        dist.all_reduce(out, op=_OPS[op], group=g)
        self._count("all_reduce", out, t0)
        return out

    def all_gather(self, t: torch.Tensor, axis: Axis, dim: int) -> torch.Tensor:
        """The ``axis`` ranks' tensors concatenated along ``dim``, in rank
        order along the axis."""
        n = self.axis_size(axis)
        if n == 1:
            return t
        t0 = time.perf_counter()
        src = t.movedim(dim, 0).contiguous()
        out = torch.empty((n * src.shape[0],) + src.shape[1:], dtype=t.dtype, device=t.device)
        _ALL_GATHER(out, src, group=self.group(axis))
        self._count("all_gather", out, t0)
        return out.movedim(0, dim).contiguous()

    def reduce_scatter(self, t: torch.Tensor, axis: Axis, dim: int) -> torch.Tensor:
        """t summed over ``axis``, this rank's 1/n slice along ``dim``."""
        n = self.axis_size(axis)
        if n == 1:
            return t
        t0 = time.perf_counter()
        src = t.movedim(dim, 0).contiguous()
        out = torch.empty((src.shape[0] // n,) + src.shape[1:], dtype=t.dtype, device=t.device)
        _REDUCE_SCATTER(out, src, group=self.group(axis))
        self._count("reduce_scatter", src, t0)
        return out.movedim(0, dim).contiguous()

    def all_to_all(self, t: torch.Tensor, axis: Axis) -> torch.Tensor:
        """t (n, ...) with chunk j sent to rank j of ``axis``; returns
        (n, ...) with chunk j received from rank j."""
        n = self.axis_size(axis)
        if n == 1:
            return t
        t0 = time.perf_counter()
        src = t.contiguous()
        out = torch.empty_like(src)
        dist.all_to_all_single(out, src, group=self.group(axis))
        self._count("all_to_all", src, t0)
        return out

    def barrier(self) -> None:
        if self.size > 1:
            dist.barrier()


def axis_size(mesh: Optional[DeviceMesh], axis: Axis) -> int:
    return 1 if mesh is None else mesh.axis_size(axis)


def axis_index(mesh: Optional[DeviceMesh], axis: Axis) -> int:
    return 0 if mesh is None else mesh.axis_index(axis)


# ---------------------------------------------------------------------------
# Collectives with gradients (the Megatron pairs)
# ---------------------------------------------------------------------------


class _AllReduce(torch.autograd.Function):
    """Forward all-reduce (sum), backward identity: a row-parallel output."""

    @staticmethod
    def forward(ctx, x, mesh, axis):
        return mesh.all_reduce(x, axis)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


class _CopyToRegion(torch.autograd.Function):
    """Forward identity, backward all-reduce (sum): a replicated value
    entering a computation partitioned over the axis."""

    @staticmethod
    def forward(ctx, x, mesh, axis):
        ctx.mesh, ctx.axis = mesh, axis
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.mesh.all_reduce(g, ctx.axis), None, None


class _Gather(torch.autograd.Function):
    """Forward all-gather along dim, backward reduce-scatter (each rank's
    slice of the summed gradient): sequence sharding, FSDP weights."""

    @staticmethod
    def forward(ctx, x, mesh, axis, dim):
        ctx.mesh, ctx.axis, ctx.dim = mesh, axis, dim
        return mesh.all_gather(x, axis, dim)

    @staticmethod
    def backward(ctx, g):
        return ctx.mesh.reduce_scatter(g, ctx.axis, ctx.dim), None, None, None


class _GatherReplicated(torch.autograd.Function):
    """Forward all-gather along dim, backward this rank's slice: what
    follows the gather is computed identically on every rank of the axis
    (the gathered logits and the loss), so each rank's gradient is the
    whole gradient already."""

    @staticmethod
    def forward(ctx, x, mesh, axis, dim):
        ctx.mesh, ctx.axis, ctx.dim, ctx.n = mesh, axis, dim, x.shape[dim]
        return mesh.all_gather(x, axis, dim)

    @staticmethod
    def backward(ctx, g):
        i = ctx.mesh.axis_index(ctx.axis)
        return g.narrow(ctx.dim, i * ctx.n, ctx.n), None, None, None


class _ReduceScatter(torch.autograd.Function):
    """Forward reduce-scatter along dim, backward all-gather: a
    row-parallel output into the sequence-sharded residual."""

    @staticmethod
    def forward(ctx, x, mesh, axis, dim):
        ctx.mesh, ctx.axis, ctx.dim = mesh, axis, dim
        return mesh.reduce_scatter(x, axis, dim)

    @staticmethod
    def backward(ctx, g):
        return ctx.mesh.all_gather(g, ctx.axis, ctx.dim), None, None, None


class _Split(torch.autograd.Function):
    """Forward this rank's 1/n chunk along dim, backward all-gather: a
    value every rank of the axis holds whole, entering a computation
    partitioned along dim (the sequence-sharded residual)."""

    @staticmethod
    def forward(ctx, x, mesh, axis, dim):
        ctx.mesh, ctx.axis, ctx.dim = mesh, axis, dim
        n = x.shape[dim] // mesh.axis_size(axis)
        return x.narrow(dim, mesh.axis_index(axis) * n, n).contiguous()

    @staticmethod
    def backward(ctx, g):
        return ctx.mesh.all_gather(g, ctx.axis, ctx.dim), None, None, None


class _AllToAll(torch.autograd.Function):
    """all_to_all over equal chunks of dim 0: its own inverse, so the
    backward is the same exchange of the gradient."""

    @staticmethod
    def forward(ctx, x, mesh, axis):
        ctx.mesh, ctx.axis = mesh, axis
        return mesh.all_to_all(x, axis)

    @staticmethod
    def backward(ctx, g):
        return ctx.mesh.all_to_all(g, ctx.axis), None, None


def all_reduce(x, mesh, axis: Axis = "model"):
    return x if axis_size(mesh, axis) == 1 else _AllReduce.apply(x, mesh, axis)


def copy_to_region(x, mesh, axis: Axis = "model"):
    return x if axis_size(mesh, axis) == 1 else _CopyToRegion.apply(x, mesh, axis)


def all_gather(x, mesh, axis: Axis, dim: int):
    return x if axis_size(mesh, axis) == 1 else _Gather.apply(x, mesh, axis, dim)


def gather_replicated(x, mesh, axis: Axis, dim: int):
    return x if axis_size(mesh, axis) == 1 else _GatherReplicated.apply(x, mesh, axis, dim)


def reduce_scatter(x, mesh, axis: Axis, dim: int):
    return x if axis_size(mesh, axis) == 1 else _ReduceScatter.apply(x, mesh, axis, dim)


def split(x, mesh, axis: Axis, dim: int):
    return x if axis_size(mesh, axis) == 1 else _Split.apply(x, mesh, axis, dim)


def all_to_all(x, mesh, axis: Axis = "model"):
    return x if axis_size(mesh, axis) == 1 else _AllToAll.apply(x, mesh, axis)


# ---------------------------------------------------------------------------
# Building meshes
# ---------------------------------------------------------------------------


def _subgroups(shape: Dict[str, int], backend: str) -> Dict[Tuple[str, ...], Any]:
    """For every non-empty subset of the axes, this rank's group (None
    where the subset holds one rank).  Every rank creates every group, in
    one order, as ``new_subgroups_by_enumeration`` requires."""
    axes = tuple(shape)
    sizes = [shape[a] for a in axes]
    ranks = torch.arange(int(torch.tensor(sizes).prod())).reshape(sizes)
    groups: Dict[Tuple[str, ...], Any] = {}
    for n in range(1, len(axes) + 1):
        for subset in itertools.combinations(range(len(axes)), n):
            key = tuple(axes[i] for i in subset)
            size = 1
            for i in subset:
                size *= sizes[i]
            if size == 1:
                groups[key] = None
                continue
            if size == ranks.numel():
                groups[key] = dist.group.WORLD
                continue
            rest = [i for i in range(len(axes)) if i not in subset]
            perm = ranks.permute(*rest, *subset).reshape(-1, size)
            mine, _ = dist.new_subgroups_by_enumeration(perm.tolist(), backend=backend)
            groups[key] = mine
    return groups


def _rank_device(device, backend: str) -> torch.device:
    """This rank's card: its own under NCCL (LOCAL_RANK, torchrun's, or the
    rank), else the shared one."""
    dev = torch.device(device)
    if dev.type != "cuda":
        return dev
    if backend == "nccl":
        return torch.device("cuda", int(os.environ.get("LOCAL_RANK", dist.get_rank()))
                            % torch.cuda.device_count())
    return torch.device("cuda", dev.index or 0)


def _shape(data: int, model: int, pod: Optional[int]) -> Dict[str, int]:
    return ({"pod": pod} if pod else {}) | {"data": data, "model": model}


def make_mesh(device="cuda", data: int = 1, model: int = 1, pod: Optional[int] = None
              ) -> DeviceMesh:
    """The mesh of this rank on ``device``: one device when data x model
    (x pod) is 1 and no process group is up, else over the initialized
    process group, whose world size must be the mesh's."""
    shape = _shape(data, model, pod)
    n = data * model * (pod or 1)
    if not dist.is_available() or not dist.is_initialized():
        if n != 1:
            raise RuntimeError(
                f"a {' x '.join(map(str, shape.values()))} mesh needs a process group of {n} "
                "ranks: start the world with repro_torch.launch.mesh.spawn, or under torchrun "
                "and init_world()")
        return DeviceMesh(device, shape)
    world = dist.get_world_size()
    if world != n:
        raise ValueError(f"mesh {shape} has {n} ranks but the process group has {world}")
    backend = dist.get_backend()
    transport = ("gloo-cpu" if torch.device(device).type == "cpu" else
                 ("nccl" if backend == "nccl" else "gloo-shared-card"))
    dev = _rank_device(device, backend)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    return DeviceMesh(dev, shape, rank=dist.get_rank(), groups=_subgroups(shape, backend),
                      backend=backend, transport=transport,
                      init_method=os.environ.get("REPRO_MESH_INIT"))


def make_cpu_mesh(data: int = 1, model: int = 1) -> DeviceMesh:
    """The CPU mesh of tests and ``--device cpu``."""
    return make_mesh("cpu", data, model)


def init_world(device="cuda") -> None:
    """Initialize the default process group from torchrun's environment
    (RANK, WORLD_SIZE, MASTER_ADDR, MASTER_PORT; LOCAL_WORLD_SIZE, the ranks
    on this host) with the backend ``backend_for`` picks; nothing when it
    is up already."""
    if dist.is_initialized():
        return
    missing = [k for k in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT")
               if k not in os.environ]
    if missing:
        raise RuntimeError(f"init_world: {', '.join(missing)} unset: start the ranks with "
                           "torchrun (or repro_torch.launch.mesh.spawn for a local world)")
    local = int(os.environ.get("LOCAL_WORLD_SIZE", os.environ["WORLD_SIZE"]))
    if torch.device(device).type == "cuda":
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", 0)) % torch.cuda.device_count())
    dist.init_process_group(backend_for(device, local)[0], init_method="env://")


def make_production_mesh(*, multi_pod: bool = False, device="cuda") -> DeviceMesh:
    """16 x 16 (data, model), or 2 x 16 x 16 (pod, data, model) under
    ``multi_pod``, over a world of 256 or 512 ranks (torchrun's)."""
    need = 512 if multi_pod else 256
    if not dist.is_initialized():
        init_world(device)
    world = dist.get_world_size()
    if world != need:
        raise ValueError(f"the production mesh ({'2 x ' if multi_pod else ''}16 x 16) needs a "
                         f"world of {need} ranks; this one has {world}")
    return make_mesh(device, 16, 16, 2 if multi_pod else None)


# ---------------------------------------------------------------------------
# Local worlds
# ---------------------------------------------------------------------------


def _init_group(device, world: int, rank: int, store: str) -> None:
    backend, _ = backend_for(device, world)
    os.environ["REPRO_MESH_INIT"] = store
    dist.init_process_group(backend, init_method="file://" + store, rank=rank,
                            world_size=world)


def _rank_entry(rank: int, fn: Callable, shape: Dict[str, int], device, root: str,
                args: Sequence[Any]) -> None:
    torch.set_num_threads(1)
    world = 1
    for v in shape.values():
        world *= v
    _init_group(device, world, rank, os.path.join(root, "store0"))
    try:
        mesh = make_mesh(device, shape["data"], shape["model"], shape.get("pod"))
        result = fn(mesh, *args)
        torch.save(result, os.path.join(root, f"result{rank}.pt"))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def spawn(fn: Callable, data: int = 1, model: int = 1, device="cpu", args: Sequence[Any] = (),
          pod: Optional[int] = None) -> List[Any]:
    """Run ``fn(mesh, *args)`` on every rank of a local (pod x) data x model
    world on ``device`` and return the ranks' results in rank order.  A
    rank that raises fails the call (torch.multiprocessing re-raises in the
    parent).  ``fn`` and ``args`` must pickle (a module-level function)."""
    import torch.multiprocessing as mp

    shape = _shape(data, model, pod)
    world = data * model * (pod or 1)
    root = tempfile.mkdtemp(prefix="repro_mesh_")
    try:
        mp.start_processes(_rank_entry, args=(fn, shape, device, root, tuple(args)),
                           nprocs=world, start_method="spawn", join=True)
        return [torch.load(os.path.join(root, f"result{r}.pt"), weights_only=False)
                for r in range(world)]
    finally:
        shutil.rmtree(root, ignore_errors=True)


def remesh(mesh: DeviceMesh, data: int, model: int) -> Optional[DeviceMesh]:
    """Re-form the world as a data x model mesh of its first data x model
    ranks (the elastic re-mesh after a host is lost): the old group is
    destroyed, the kept ranks meet at a new ``file://`` store beside the
    old one, and a rank that is not kept gets None.  For a world started
    by ``spawn`` (its store path is known)."""
    if mesh.init_method is None:
        raise RuntimeError("remesh: the mesh's store is unknown (a spawn world only)")
    n = data * model
    rank = mesh.rank
    base, gen = mesh.init_method.rstrip("0123456789"), mesh.init_method[len(
        mesh.init_method.rstrip("0123456789")):]
    store = f"{base}{int(gen or 0) + 1}"
    dist.barrier()
    dist.destroy_process_group()
    if rank >= n:
        return None
    _init_group(mesh.device.type, n, rank, store)
    return make_mesh(mesh.device.type, data, model)

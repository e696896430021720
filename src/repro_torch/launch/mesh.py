"""The device mesh and the cluster tier over ``torch.distributed`` (the port
of the JAX package's ``launch/mesh.py``; its DESIGN.md §6 and §11 describe
the design).

A mesh is a process group with one rank a device, every rank running the
same program (SPMD): the counterpart of a 1-D ``jax`` mesh with
``shard_map`` over its ``"data"`` axis. ``Mesh`` carries the group, its
size, this rank's index and ``torch.device`` and the backend
(``"nccl"`` where each rank has a card of its own, ``"gloo"`` on the CPU or
for ranks that share one card: NCCL refuses two ranks on one GPU). The
backend is the caller's choice, passed explicitly; nothing here picks or
switches it.

``init_cluster`` joins a process to the world (``dist.init_process_group``)
from its arguments or ``AMP_COORDINATOR`` (``host:port``) /
``AMP_NUM_PROCESSES`` / ``AMP_PROCESS_ID``, or through a ``FileStore``
(``store_path``: tests, and the ranks a launcher spawns on one host).
Unlike jaxlib's CPU client, both backends run collectives across hosts, so
``supports_cross_host_collectives`` is true and ``make_cluster_mesh`` is
the mesh over the whole world. ``spawn_world`` runs a function on a world
of spawned processes and returns each rank's result.

The LM trainer's meshes have named axes, ``("pod",) "data", "model"``:
``GridMesh`` lays the world's ranks out row-major over them and holds one
process group per axis (``mesh.axis(name)``, the 1-D ``Mesh`` that
``core/collectives.py`` and ``compressed_psum`` take) and one over the
data axes together (``mesh.axes(("pod", "data"))``, ZeRO-1's) and one
over every axis (the world). The
reference's ``make_production_mesh`` and ``make_host_mesh`` build them
(``make_mesh`` any other).

Importing this module touches no device and starts nothing.
"""
from __future__ import annotations

import contextlib
import dataclasses
import datetime
import itertools
import math
import os
import pickle
import queue as queue_mod
import sys
import time
import traceback
from typing import ClassVar

import torch
import torch.distributed as dist

from ..core.collectives import CollectiveStats

__all__ = ["Mesh", "GridMesh", "make_mesh", "make_count_mesh",
           "make_production_mesh",
           "make_host_mesh", "make_serve_mesh", "ClusterInfo", "init_cluster",
           "supports_cross_host_collectives", "make_cluster_mesh",
           "spawn_world", "rank_device"]

AXIS = "data"


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A 1-D device mesh: a process group, one rank a device. ``group``
    None is the default (world) group. Its one axis is always named
    ``"data"`` (``AXIS``); ``axes`` names the grid axes it spans (a
    ``GridMesh``'s). ``stats`` counts what the collectives of
    ``core/collectives.py`` moved over it. Backend ``"count"``: a counting
    mesh (``make_count_mesh``), no group behind it."""

    axis: ClassVar[str] = AXIS
    group: object
    size: int
    rank: int
    device: torch.device
    backend: str
    stats: CollectiveStats = dataclasses.field(
        default_factory=CollectiveStats, compare=False, repr=False)
    axes: tuple = (AXIS,)

    @property
    def shape(self) -> dict:
        """``{axis: size}``, as the reference's ``mesh.shape``."""
        return {self.axis: self.size}


def rank_device(device: str | None, rank: int) -> torch.device:
    """This rank's device: ``device`` as given, or (None) card ``rank %
    cards``. Raises for a CUDA device where no card is available."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device is available; pass "
                               "device='cpu' to run the mesh on the CPU")
        device = f"cuda:{rank % torch.cuda.device_count()}"
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device={device!r} but no CUDA device is "
                           "available; pass device='cpu'")
    return dev


def make_serve_mesh(n_devices: int | None = None,
                    device: str | None = None) -> Mesh | None:
    """The solve service's 1-D mesh over the first ``n_devices`` ranks of
    the initialised world (all of them by default). Every rank of the world
    must call it (a sub-mesh is a new group); a rank outside the mesh gets
    None. ``device`` is this rank's device (``rank_device``)."""
    if not dist.is_initialized():
        raise RuntimeError("torch.distributed is not initialised: call "
                           "init_cluster first")
    world, rank = dist.get_world_size(), dist.get_rank()
    n = world if n_devices is None else n_devices
    if not 1 <= n <= world:
        raise ValueError(f"n_devices={n_devices}: the world has {world}")
    group = None if n == world else dist.new_group(list(range(n)))
    if rank >= n:
        return None
    return Mesh(group=group, size=n, rank=rank,
                device=rank_device(device, rank),
                backend=dist.get_backend(group))


# -- the LM trainer's meshes --------------------------------------------------

DATA_AXES = ("pod", "data")


@dataclasses.dataclass(frozen=True)
class GridMesh:
    """A mesh of named axes over the world (``shape``: the ordered ``{axis:
    size}``), ranks laid out row-major: rank = sum of coords[a] x the sizes
    of the axes after a. Each axis, and the data axes together, is a 1-D
    ``Mesh`` over the ranks that share every other coordinate, its ranks in
    the same row-major order (``axis``, ``axes``); every axis together is
    the world (``axes(tuple(shape))``: ZeRO-1's under 'fsdp', and the
    gradient norm's)."""

    shape: dict
    coords: dict
    rank: int
    device: torch.device
    meshes: dict = dataclasses.field(repr=False, compare=False)

    def axis(self, name: str) -> Mesh:
        """The 1-D mesh of axis ``name`` through this rank."""
        return self.meshes[(name,)]

    def axes(self, names) -> Mesh:
        """The 1-D mesh over the axes ``names`` (in the mesh's order)
        through this rank; a single axis is ``axis``."""
        return self.meshes[tuple(names)]

    def axes_size(self, names) -> int:
        return math.prod(self.shape[a] for a in names)

    def axes_index(self, names) -> int:
        """This rank's index over ``names``, row-major."""
        return _row_major(self.coords, self.shape, names)


def _row_major(coords: dict, shape: dict, names) -> int:
    """The row-major index of ``coords`` over the axes ``names``."""
    i = 0
    for a in names:
        i = i * shape[a] + coords[a]
    return i


def make_mesh(shape, axis_names, device: str | None = None) -> GridMesh:
    """A ``GridMesh`` of ``shape`` over the initialised world (or, with no
    world, over this process alone, where every axis must have size 1).
    Every rank must call it, in the same order as its other group-making
    calls: each axis group is made on every rank (``dist.new_group``, the
    group of the whole world being the default group). ``device`` is this
    rank's (``rank_device``: the card unless asked otherwise)."""
    shape = dict(zip(axis_names, (int(n) for n in shape)))
    if len(shape) != len(axis_names) or min(shape.values()) < 1:
        raise ValueError(f"mesh {tuple(shape)} of {tuple(axis_names)}")
    world = dist.get_world_size() if dist.is_initialized() else 1
    rank = dist.get_rank() if dist.is_initialized() else 0
    if math.prod(shape.values()) != world:
        raise ValueError(f"a mesh of {dict(shape)} needs "
                         f"{math.prod(shape.values())} ranks; the world has "
                         f"{world}")
    dev = rank_device(device, rank)
    names = list(shape)
    coords, r = {}, rank
    for a in reversed(names):
        coords[a] = r % shape[a]
        r //= shape[a]
    meshes = {}
    for axes in _groups(names):
        others = [a for a in names if a not in axes]
        size = math.prod(shape[a] for a in axes)
        mine = None
        for fixed in itertools.product(*(range(shape[a]) for a in others)):
            pin = dict(zip(others, fixed))
            ranks = [_row_major({**pin, **dict(zip(axes, c))}, shape, names)
                     for c in itertools.product(*(range(shape[a])
                                                  for a in axes))]
            if size == world:
                group = None
            else:      # every rank makes every group, in this order
                group = dist.new_group(sorted(ranks))
            if rank in ranks:
                mine = group
        backend = dist.get_backend(mine) if dist.is_initialized() else "none"
        meshes[axes] = Mesh(group=mine, size=size,
                            rank=_row_major(coords, shape, axes),
                            device=dev, backend=backend, axes=axes)
    return GridMesh(shape=shape, coords=coords, rank=rank, device=dev,
                    meshes=meshes)


def _groups(names) -> list:
    """The axis groups a ``GridMesh`` holds: each axis, the data axes
    together, the whole mesh."""
    groups = [(a,) for a in names]
    data = tuple(a for a in DATA_AXES if a in names)
    if len(data) > 1:
        groups.append(data)
    if len(names) > 1 and tuple(names) not in groups:
        groups.append(tuple(names))
    return groups


def make_count_mesh(shape, axis_names, rank: int = 0) -> GridMesh:
    """One rank's view of a mesh of ``shape`` over ``axis_names`` (the
    production meshes' (16, 16) or (2, 16, 16) among them) with no world
    behind it: every axis group a counting ``Mesh`` (backend ``"count"``,
    device ``meta``), whose collectives return tensors of the right shape
    and dtype and record their calls and bytes (``core/collectives.py``).
    Nothing is allocated and no process group is made."""
    shape = dict(zip(axis_names, (int(n) for n in shape)))
    names = list(shape)
    if not 0 <= rank < math.prod(shape.values()):
        raise ValueError(f"rank {rank} of a mesh of {shape}")
    coords, r = {}, rank
    for a in reversed(names):
        coords[a] = r % shape[a]
        r //= shape[a]
    dev = torch.device("meta")
    meshes = {axes: Mesh(group=None, size=math.prod(shape[a] for a in axes),
                         rank=_row_major(coords, shape, axes), device=dev,
                         backend="count", axes=axes)
              for axes in _groups(names)}
    return GridMesh(shape=shape, coords=coords, rank=rank, device=dev,
                    meshes=meshes)


def make_production_mesh(*, multi_pod: bool = False,
                         device: str | None = None) -> GridMesh:
    """The reference's production mesh: ("data", "model") of (16, 16), or
    ("pod", "data", "model") of (2, 16, 16), over a world of that size."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes, device)


def make_host_mesh(data: int | None = None, model: int = 1,
                   device: str | None = None) -> GridMesh:
    """A small ("data", "model") mesh over whatever ranks exist (this
    process alone when no world is initialised): tests, ``--smoke``."""
    n = dist.get_world_size() if dist.is_initialized() else 1
    data = data or (n // model)
    return make_mesh((data, model), ("data", "model"), device)


# -- cluster tier -------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ClusterInfo:
    """This process's view of the cluster after ``init_cluster``."""

    process_index: int
    process_count: int
    local_devices: int
    global_devices: int
    coordinator: str | None

    @property
    def is_frontend(self) -> bool:
        """Process 0 hosts the cluster frontend/router by convention."""
        return self.process_index == 0


def init_cluster(coordinator_address: str | None = None,
                 num_processes: int | None = None,
                 process_id: int | None = None, *,
                 backend: str = "nccl", store_path: str | None = None,
                 device: str | None = None,
                 timeout_s: float = 600.0) -> ClusterInfo:
    """Join (or stand alone as) a ``torch.distributed`` world.

    Arguments fall back to ``AMP_COORDINATOR`` / ``AMP_NUM_PROCESSES`` /
    ``AMP_PROCESS_ID``. The rendezvous is ``tcp://coordinator`` or, with
    ``store_path``, a ``FileStore`` at that path (no port). With neither
    configured this is a single-process no-op reporting one process.
    Idempotent: a process already initialised reports the live world.
    ``backend`` is the caller's (``"nccl"``: one card a rank, set as the
    current device from ``device``/``rank_device`` before the group
    exists; ``"gloo"``: the CPU, or ranks sharing a card). ``timeout_s``
    bounds every collective, so a rank that died ends the others' wait."""
    coordinator_address = (coordinator_address
                           or os.environ.get("AMP_COORDINATOR"))
    if num_processes is None:
        env = os.environ.get("AMP_NUM_PROCESSES")
        num_processes = int(env) if env else None
    if process_id is None:
        env = os.environ.get("AMP_PROCESS_ID")
        process_id = int(env) if env else None
    if backend not in ("nccl", "gloo"):
        raise ValueError(f"unknown backend {backend!r}: 'nccl' or 'gloo'")
    if not dist.is_initialized() and (coordinator_address or store_path):
        if num_processes is None or process_id is None:
            raise ValueError("a world needs num_processes and process_id "
                             "(or AMP_NUM_PROCESSES / AMP_PROCESS_ID)")
        if backend == "nccl":
            torch.cuda.set_device(rank_device(device, process_id))
        timeout = datetime.timedelta(seconds=timeout_s)
        if store_path is not None:
            store = dist.FileStore(store_path, num_processes)
            dist.init_process_group(backend, store=store, rank=process_id,
                                    world_size=num_processes,
                                    timeout=timeout)
        else:
            dist.init_process_group(
                backend, init_method=f"tcp://{coordinator_address}",
                rank=process_id, world_size=num_processes, timeout=timeout)
    if dist.is_initialized():
        rank, world = dist.get_rank(), dist.get_world_size()
    else:
        rank, world = 0, 1
    return ClusterInfo(process_index=rank, process_count=world,
                       local_devices=1, global_devices=world,
                       coordinator=coordinator_address)


def supports_cross_host_collectives() -> bool:
    """Whether collectives may span the world's hosts: always, under
    ``torch.distributed`` (NCCL and gloo both cross hosts; the reference's
    jaxlib CPU client could not, which is why it asked)."""
    return True


def make_cluster_mesh(device: str | None = None) -> Mesh:
    """The widest 1-D serve mesh: the whole world, across hosts."""
    return make_serve_mesh(device=device)


# -- a world of spawned processes ---------------------------------------------

def _rank_main(fn, rank, world, backend, device, store_path, args_path,
               out, threads, timeout_s):
    try:
        with open(args_path, "rb") as fh:
            args = pickle.load(fh)
        if threads is not None:
            torch.set_num_threads(threads)
        init_cluster(num_processes=world, process_id=rank, backend=backend,
                     store_path=store_path, device=device,
                     timeout_s=timeout_s)
        try:
            mesh = make_serve_mesh(device=device)
            res = fn(mesh, *args)
        finally:
            dist.destroy_process_group()
        out.put((rank, True, res))
    except BaseException:   # reported to the parent, which raises
        out.put((rank, False, traceback.format_exc()))


@contextlib.contextmanager
def _children_skip_main(fn):
    """While the block starts children, and ``fn`` is not of the parent's
    ``__main__``: that module's path and spec hidden, so that a spawned
    child imports only what unpickling ``fn`` and its arguments needs.
    Otherwise it first runs the parent's main script again as its own
    ``__mp_main__``, all of that script's imports included: for a script
    that imports the whole port, every child imports all of it at once
    before it starts its work."""
    main = sys.modules["__main__"]
    if getattr(fn, "__module__", "__main__") == "__main__":
        yield
        return
    saved = {key: main.__dict__[key] for key in ("__file__", "__spec__")
             if key in main.__dict__}
    main.__dict__.pop("__file__", None)
    main.__spec__ = None
    try:
        yield
    finally:
        main.__dict__.pop("__spec__", None)
        main.__dict__.update(saved)


def spawn_world(fn, world: int, *, backend: str, device: str | None,
                store_path: str, args: tuple = (), timeout_s: float = 600.0,
                threads: int | None = None) -> list:
    """Run ``fn(mesh, *args)`` on ``world`` spawned processes joined through
    a ``FileStore`` at ``store_path`` (a path no other world uses) and
    return each rank's result, by rank. ``fn`` and its arguments and
    results must pickle (``fn`` a module-level function). ``threads`` sets
    each child's ``torch.set_num_threads``. Raises with every failing
    rank's traceback, or when ``timeout_s`` passes first (the children are
    then terminated); every child is joined before it returns."""
    import multiprocessing as mp
    ctx = mp.get_context("spawn")
    out = ctx.Queue()
    # the arguments go to the children through a file: a child reads its
    # start pipe only as far as it has imported what unpickling needs, and
    # the parent's write of a pipe past its buffer waits for that, so
    # arrays passed there made the children start one after another
    args_path = store_path + ".args"
    with open(args_path, "wb") as fh:
        pickle.dump(args, fh, protocol=pickle.HIGHEST_PROTOCOL)
    procs = [ctx.Process(target=_rank_main,
                         args=(fn, r, world, backend, device, store_path,
                               args_path, out, threads, timeout_s))
             for r in range(world)]
    deadline = time.monotonic() + timeout_s
    results, errors = {}, {}
    try:
        with _children_skip_main(fn):
            for p in procs:
                p.start()
        while len(results) + len(errors) < world:
            left = deadline - time.monotonic()
            if left <= 0:
                raise TimeoutError(
                    f"spawn_world: {world - len(results) - len(errors)} "
                    f"rank(s) gave no result in {timeout_s} s"
                    + "".join(f"\nrank {r}:\n{tb}"
                              for r, tb in sorted(errors.items())))
            try:
                rank, ok, res = out.get(timeout=min(left, 1.0))
            except queue_mod.Empty:
                dead = [r for r, p in enumerate(procs)
                        if p.exitcode not in (None, 0)
                        and r not in results and r not in errors]
                for r in dead:
                    errors[r] = f"exited with code {procs[r].exitcode}"
                continue
            (results if ok else errors)[rank] = res
    finally:
        for p in procs:
            if p.pid is not None:
                p.join(timeout=max(1.0, deadline - time.monotonic()))
        for p in procs:
            if p.pid is not None and p.is_alive():
                p.terminate()
                p.join(timeout=10)
        os.remove(args_path)
    if errors:
        raise RuntimeError("spawn_world: " + "".join(
            f"\nrank {r}:\n{tb}" for r, tb in sorted(errors.items())))
    return [results[r] for r in range(world)]

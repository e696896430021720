"""Collectives over a device mesh: the port's counterparts of the ``lax``
collectives the JAX engine calls inside ``shard_map``.

The mesh is a ``torch.distributed`` process group, one rank a device, every
rank running the same program (SPMD; ``launch/mesh.py::Mesh``):

    lax.psum(x, axis)                  psum(x, mesh)        dist.all_reduce
    lax.pmean(x, axis)                 pmean(x, mesh)
    lax.all_to_all(x, axis, 0, 0,      all_to_all(x, mesh)  dist.all_to_all_single
                   tiled=True)
    lax.all_gather(x, axis)            all_gather(x, mesh)  dist.all_gather
    lax.psum_scatter(x, axis, 0,       reduce_scatter(x,    dist.reduce_scatter_tensor
                     tiled=True)         mesh)              (NCCL; gloo: all_to_all
                                                            and a sum in rank order)
    axis_size(axis), axis_index(axis)  axis_size(mesh), axis_index(mesh)

Every function returns a new tensor (``all_reduce`` works in place on a
copy) and reads no value on the host: under NCCL, where each rank has its
own card, a solve loop of these makes no host synchronisation.

Payloads of ``int8`` or ``bfloat16`` travel as ``uint8`` views of the same
bytes (never widened), so one rule serves both backends whatever dtypes
they take. Each mesh counts, per collective, the calls and the bytes handed
to it by the dtype that travelled (``CollectiveStats``): the port's form of
the reference's check that the compressed wire carries s8/u8 collective
operands in the lowered HLO.

**gloo with CUDA tensors** (several ranks sharing one card, where NCCL
refuses two ranks on one GPU): gloo reduces and exchanges in host memory.
``all_reduce``, ``all_to_all_single`` and ``all_gather`` take CUDA tensors
and copy them to the host and back themselves; ``send`` and ``recv`` do not
(gloo hands the device pointer to the socket: "Bad address";
``chip_gloo_probe.py`` checks each on the card). Those two, the
``GLOO_HOST_ONLY`` set, run here on host copies of the operand, the
result brought back to the rank's device. Every collective that gloo runs
on CUDA tensors goes through host memory either way and is counted
(``CollectiveStats.staged``); it is a host synchronisation by nature, and
the compute stays on the card. No collective is ever replaced by a local
sum.

**Counting** (``backend == "count"``: one rank's view of a mesh of any
shape, ``launch/mesh.py::make_count_mesh``, on ``meta`` tensors; the dry
run, ``launch/dryrun.py``): every collective returns a tensor of the shape
and dtype it would, records the call, its bytes, its mesh axes and their
size, and moves nothing; no process group exists. ``reduce_scatter``
counts as NCCL runs it (one call on the operand).

The object and point-to-point helpers at the end carry the solve
service's commands between rank 0 and its workers (``serving/service.py``).
"""
from __future__ import annotations

import dataclasses
import threading

import torch
import torch.distributed as dist

__all__ = ["CollectiveStats", "psum", "pmean", "all_to_all", "all_gather",
           "reduce_scatter", "axis_size", "axis_index", "send_tensor", "recv_tensor",
           "broadcast_object", "gather_object"]


# the collectives gloo refuses with CUDA tensors (chip_gloo_probe.py)
GLOO_HOST_ONLY = frozenset({"send", "recv"})


@dataclasses.dataclass
class CollectiveStats:
    """Per collective: calls, and bytes handed to it by the dtype that
    travelled; ``staged`` counts the collectives that went through host
    memory (gloo with CUDA tensors, by gloo's own copies or by ours);
    ``groups`` the calls and bytes by (collective, mesh axes, their size),
    "op axis+axis size" as its key (what the dry run's ring factors
    take)."""

    calls: dict = dataclasses.field(default_factory=dict)
    bytes: dict = dataclasses.field(default_factory=dict)
    staged: int = 0
    groups: dict = dataclasses.field(default_factory=dict)
    _lock: threading.Lock = dataclasses.field(default_factory=threading.Lock,
                                              repr=False)

    def add(self, op: str, t: torch.Tensor, staged: bool,
            axes: tuple = (), size: int = 0) -> None:
        nbytes = t.numel() * t.element_size()
        with self._lock:
            self.calls[op] = self.calls.get(op, 0) + 1
            per = self.bytes.setdefault(op, {})
            key = str(t.dtype).replace("torch.", "")
            per[key] = per.get(key, 0) + nbytes
            self.staged += int(staged)
            g = self.groups.setdefault(f"{op} {'+'.join(axes)} {size}",
                                       {"calls": 0, "bytes": 0})
            g["calls"] += 1
            g["bytes"] += nbytes

    def reset(self) -> None:
        with self._lock:
            self.calls.clear()
            self.bytes.clear()
            self.groups.clear()
            self.staged = 0

    def snapshot(self) -> dict:
        with self._lock:
            return {"calls": dict(self.calls),
                    "bytes": {k: dict(v) for k, v in self.bytes.items()},
                    "staged": self.staged,
                    "groups": {k: dict(v) for k, v in self.groups.items()}}


def axis_size(mesh) -> int:
    return mesh.size


def axis_index(mesh) -> int:
    return mesh.rank


def _wire(t: torch.Tensor) -> torch.Tensor:
    """The bytes a collective moves: int8 and bfloat16 as uint8 views."""
    t = t.contiguous()
    if t.dtype in (torch.int8, torch.bfloat16):
        return t.view(torch.uint8)
    return t


def _run(op: str, mesh, send: torch.Tensor, out: torch.Tensor | None, call):
    """Count the call and run ``call(send, out)`` (which writes ``out``, or
    ``send`` in place when ``out`` is None), on host copies where gloo
    refuses the CUDA tensors (``GLOO_HOST_ONLY``). Returns what ``call``
    wrote, on the rank's device."""
    staged = mesh.backend == "gloo" and send.is_cuda
    mesh.stats.add(op, send, staged, mesh.axes, mesh.size)
    if mesh.backend == "count":
        return send if out is None else out
    if not (staged and op in GLOO_HOST_ONLY):
        call(send, out)
        return send if out is None else out
    s_host = send.cpu()
    o_host = None if out is None else torch.empty_like(out, device="cpu")
    call(s_host, o_host)
    return (s_host if o_host is None else o_host).to(send.device)


def psum(x: torch.Tensor, mesh) -> torch.Tensor:
    """The sum of ``x`` over the mesh; every rank gets the same bits (one
    reduction, broadcast)."""
    buf = x.detach().reshape(-1).clone()
    out = _run("all_reduce", mesh, buf, None,
               lambda s, _: dist.all_reduce(s, group=mesh.group))
    return out.reshape(x.shape)


def pmean(x: torch.Tensor, mesh) -> torch.Tensor:
    """``psum(x) / size``, divided by a tensor (an IEEE division on the card,
    where a Python divisor becomes a product with its reciprocal)."""
    s = psum(x, mesh)
    return s / torch.full_like(s, mesh.size)


def all_to_all(x: torch.Tensor, mesh) -> torch.Tensor:
    """``lax.all_to_all(x, split_axis=0, concat_axis=0, tiled=True)``: x
    (D * k, ...) is cut into D blocks along axis 0, block d goes to rank d,
    and the result holds the blocks received, in rank order."""
    if x.shape[0] % mesh.size:
        raise ValueError(f"all_to_all: axis 0 ({x.shape[0]}) is not a "
                         f"multiple of the mesh size ({mesh.size})")
    send = _wire(x)
    out = _run("all_to_all", mesh, send, torch.empty_like(send),
               lambda s, o: dist.all_to_all_single(o, s, group=mesh.group))
    return out.view(x.dtype).reshape(x.shape)


def all_gather(x: torch.Tensor, mesh) -> torch.Tensor:
    """``lax.all_gather(x, axis=0, tiled=False)``: (D, *x.shape), rank d's
    ``x`` at index d."""
    send = _wire(x)
    out = torch.empty((mesh.size,) + tuple(send.shape), dtype=send.dtype,
                      device=send.device)

    def call(s, o):
        dist.all_gather(list(o.unbind(0)), s, group=mesh.group)

    out = _run("all_gather", mesh, send, out, call)
    return out.view(x.dtype).reshape((mesh.size,) + tuple(x.shape))


def reduce_scatter(x: torch.Tensor, mesh) -> torch.Tensor:
    """``lax.psum_scatter(x, scatter_dimension=0, tiled=True)``: x (D * k,
    ...) summed over the mesh, rank d keeping block d (k, ...). Under NCCL
    one ``reduce_scatter_tensor``. Under gloo (whose reduce-scatter some
    builds lack) the blocks travel by ``all_to_all`` and each rank adds the
    D blocks it received in rank order, as ``compressed_psum``'s phase 1
    does: the bits depend on nothing but the summands."""
    if x.shape[0] % mesh.size:
        raise ValueError(f"reduce_scatter: axis 0 ({x.shape[0]}) is not a "
                         f"multiple of the mesh size ({mesh.size})")
    k = x.shape[0] // mesh.size
    if mesh.backend in ("nccl", "count"):
        send = x.contiguous()
        out = torch.empty((k,) + tuple(x.shape[1:]), dtype=x.dtype,
                          device=x.device)
        return _run("reduce_scatter", mesh, send, out,
                    lambda s, o: dist.reduce_scatter_tensor(
                        o, s, group=mesh.group))
    send = _wire(x)
    out = _run("reduce_scatter", mesh, send, torch.empty_like(send),
               lambda s, o: dist.all_to_all_single(o, s, group=mesh.group))
    blocks = out.view(x.dtype).reshape((mesh.size, k) + tuple(x.shape[1:]))
    total = blocks[0]
    for b in blocks[1:]:
        total = total + b
    return total


# -- the solve service's commands (rank 0 -> workers) ------------------------

def send_tensor(t: torch.Tensor, dst: int, mesh) -> None:
    """Point-to-point send of ``t`` to group rank ``dst``."""
    send = _wire(t)
    _run("send", mesh, send, None,
         lambda s, _: dist.send(s, _global(mesh, dst), group=mesh.group))


def recv_tensor(shape, dtype: torch.dtype, src: int, mesh) -> torch.Tensor:
    """Receive a tensor of ``shape`` and ``dtype`` from group rank ``src``,
    on the rank's device."""
    probe = torch.empty(shape, dtype=dtype, device=mesh.device)
    buf = _wire(probe)
    out = _run("recv", mesh, buf, None,
               lambda s, _: dist.recv(s, _global(mesh, src), group=mesh.group))
    return out.view(dtype).reshape(shape)


def broadcast_object(obj, mesh, src: int = 0):
    """Rank ``src``'s picklable ``obj`` on every rank."""
    box = [obj if mesh.rank == src else None]
    dist.broadcast_object_list(box, src=_global(mesh, src), group=mesh.group)
    return box[0]


def gather_object(obj, mesh, dst: int = 0) -> list | None:
    """Every rank's picklable ``obj`` in a list on rank ``dst`` (None
    elsewhere)."""
    out = [None] * mesh.size if mesh.rank == dst else None
    dist.gather_object(obj, out, dst=_global(mesh, dst), group=mesh.group)
    return out


def _global(mesh, r: int) -> int:
    return r if mesh.group is None else dist.get_global_rank(mesh.group, r)

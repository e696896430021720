"""Wrapper of the CUDA kernel in ``csrc/wkv6.cu``: the RWKV-6 WKV recurrence
in chunks of 32 steps, written by hand for Hopper.

    wkv6_cuda   r, k, v, logw (B, T, H, Dh), u (H, Dh), state0 (B, H, Dh, Dh)
                -> y (B, T, H, Dh) float32, final state (B, H, Dh, Dh) float32
    wkv6_bwd_cuda  the same inputs and the cotangents dy, dS_T
                -> dr, dk, dv, dlogw, du, dstate0 (its gradient)

The kernel runs one block per (b, h) and slice of value columns: column
block j of y and of the state depends only on the same columns of v, so
``wkv_plan`` splits the Dh value columns into NV slices and the grid is
(B * H, NV). Every block walks the whole sequence, so a second wave of
blocks would double the kernel's time: the plan takes the largest NV whose
B * H * NV blocks the card holds at once (``max_active_blocks``, asked once
per card, dtype and slice width).

It takes CUDA tensors only and either launches or raises: the plain version
(``ref.py::wkv_chunked``, the same function) is chosen one level up
(``ops.py``) and only for CPU tensors. The caller keeps ``logw >= -2``.
Outputs come from ``torch.empty``; the launch goes to PyTorch's current
stream and nothing synchronises. ``launch_counts`` adds one per wrapper
call that launched.

The backward kernel takes the same split: a grid (B * H, NV) of value
slices, the NV blocks of a (b, h) one thread-block cluster, which sums the
slices' partials of dr, dk, dlogw and du (they sum over value columns)
through distributed shared memory in rank order. ``bwd_plan`` takes the
largest NV whose B * H clusters the card runs at once
(``max_active_clusters``). The kernel keeps each chunk's start state in a
scratch tensor of (B, H, ceil(T / 32), Dh, Dh) float32 that the wrapper
allocates for the call.
"""
from __future__ import annotations

import ctypes

import torch

from ..build import check, load

__all__ = ["wkv6_cuda", "wkv6_bwd_cuda", "launch_counts",
           "reset_launch_counts", "MAX_DH", "BWD_DHS", "value_splits",
           "value_slices", "wkv_plan", "max_active_blocks", "bwd_plan",
           "max_active_clusters"]

launch_counts = {"wkv6": 0, "wkv6_bwd": 0}

MAX_DH = 128
BWD_DHS = (4, 8, 16, 32, 64)     # the backward's head sizes

_lib = None
_active: dict = {}
_clusters: dict = {}


def reset_launch_counts() -> None:
    for k in launch_counts:
        launch_counts[k] = 0


def _library():
    global _lib
    if _lib is None:
        lib = load("wkv6")
        vp, ci = ctypes.c_void_p, ctypes.c_int
        lib.wkv6_launch.argtypes = [vp] * 8 + [ci] * 7 + [vp]
        lib.wkv6_launch.restype = ci
        lib.wkv6_bwd_launch.argtypes = [vp] * 15 + [ci] * 7 + [vp]
        lib.wkv6_bwd_launch.restype = ci
        lib.wkv6_bwd_max_active_clusters.argtypes = [ci, ci, ci,
                                                     ctypes.POINTER(ci)]
        lib.wkv6_bwd_max_active_clusters.restype = ci
        lib.wkv6_max_active_blocks.argtypes = [ci, ci, ci, ctypes.POINTER(ci)]
        lib.wkv6_max_active_blocks.restype = ci
        _lib = lib
    return _lib


def value_splits(dh: int) -> list[int]:
    """The NV the kernel takes for head size ``dh``, ascending: NV divides
    Dh into slices of Dh / NV columns, each a multiple of 8 (the tensor
    cores' step), or NV = 1 (the whole Dh, padded to 8 in shared memory)."""
    return [nv for nv in range(1, dh + 1)
            if dh % nv == 0 and (nv == 1 or (dh // nv) % 8 == 0)]


def value_slices(dh: int, nv: int) -> list[tuple[int, int]]:
    """The value columns ``[lo, hi)`` block j of an (b, h) owns."""
    if nv not in value_splits(dh):
        raise ValueError(f"NV={nv} does not split Dh={dh} into slices of a "
                         "multiple of 8 columns")
    vb = dh // nv
    return [(j * vb, (j + 1) * vb) for j in range(nv)]


def wkv_plan(b: int, h: int, dh: int, n_slots) -> int:
    """NV, the value slices of each (b, h): the largest of
    ``value_splits(dh)`` whose ``b * h * NV`` blocks all fit the
    ``n_slots`` the card holds at once (1 when even NV = 1 does not).
    ``n_slots`` is a number, or a function of the slice width Dh / NV (the
    blocks an SM holds depend on the shared memory a slice needs)."""
    slots = n_slots if callable(n_slots) else (lambda vb: n_slots)
    best = 1
    for nv in value_splits(dh):
        if b * h * nv <= slots(dh // nv):
            best = nv
    return best


def max_active_blocks(dev: torch.device, dtype: torch.dtype, dh: int,
                      vb: int) -> int:
    """Blocks of the kernel for head size ``dh`` and slices of ``vb``
    columns that the card ``dev`` holds at once: its SM count times
    ``cudaOccupancyMaxActiveBlocksPerMultiprocessor`` (asked once per card,
    dtype, dh and vb). Raises if it is 0: such a block cannot run, and
    nothing takes its place."""
    idx = dev.index if dev.index is not None else torch.cuda.current_device()
    key = (idx, dtype, dh, vb)
    if key not in _active:
        out = ctypes.c_int(0)
        with torch.cuda.device(idx):
            code = _library().wkv6_max_active_blocks(
                int(dtype == torch.bfloat16), dh, vb, ctypes.byref(out))
        check("wkv6", code, "wkv6_max_active_blocks")
        if out.value < 1:
            raise RuntimeError(
                f"a WKV6 block for Dh={dh}, slices of {vb} columns in "
                f"{dtype} cannot run on {torch.cuda.get_device_name(idx)}: "
                f"cudaOccupancyMaxActiveBlocksPerMultiprocessor = {out.value}")
        _active[key] = out.value * torch.cuda.get_device_properties(
            idx).multi_processor_count
    return _active[key]


def bwd_plan(b: int, h: int, dh: int, n_clusters) -> int:
    """NV of the backward, the value slices of each (b, h), a cluster of NV
    blocks: the largest of ``value_splits(dh)`` whose ``b * h`` clusters
    the card runs at once, ``n_clusters(nv)`` (a function; 0 where such a
    cluster cannot run); 1 when even NV = 1 takes more than one wave.
    Raises if a cluster of one block cannot run: nothing takes its place."""
    if n_clusters(1) < 1:
        raise RuntimeError(
            f"a WKV6 backward block for Dh={dh} cannot run: no cluster of "
            "one block is resident")
    best = 1
    for nv in value_splits(dh):
        if b * h <= n_clusters(nv):
            best = nv
    return best


def max_active_clusters(dev: torch.device, dtype: torch.dtype, dh: int,
                        nv: int) -> int:
    """Clusters of the backward's ``nv`` blocks (slices of ``dh // nv``
    columns) that the card ``dev`` runs at once
    (``cudaOccupancyMaxActiveClusters`` at the kernel's shared memory;
    asked once per card, dtype, dh and nv)."""
    idx = dev.index if dev.index is not None else torch.cuda.current_device()
    key = (idx, dtype, dh, nv)
    if key not in _clusters:
        out = ctypes.c_int(0)
        with torch.cuda.device(idx):
            code = _library().wkv6_bwd_max_active_clusters(
                int(dtype == torch.bfloat16), dh, nv, ctypes.byref(out))
        check("wkv6", code, "wkv6_bwd_max_active_clusters")
        _clusters[key] = out.value
    return _clusters[key]


def _need(t: torch.Tensor, name: str, dtypes, shape) -> None:
    if not t.is_cuda or t.dtype not in dtypes \
            or tuple(t.shape) != tuple(shape) or not t.is_contiguous():
        raise ValueError(
            f"{name}: need a contiguous CUDA tensor of shape {tuple(shape)} "
            f"in {[str(d) for d in dtypes]}, got {t.dtype} "
            f"{tuple(t.shape)} on {t.device}, contiguous={t.is_contiguous()}")


def wkv6_cuda(r, k, v, logw, u, state0=None, nv=None):
    """The recurrence on the card: r, k, v bf16 or float32 (one dtype),
    logw float32, u any float dtype (widened to float32 here, (H, Dh) is
    small), state0 float32 or None for zeros. ``nv`` (value slices) is
    ``wkv_plan``'s unless given; the model never gives it."""
    if r.ndim != 4:
        raise ValueError(f"r: need (B, T, H, Dh), got {tuple(r.shape)}")
    b, t, h, dh = r.shape
    if dh % 4 or not 4 <= dh <= MAX_DH:
        raise ValueError(f"Dh={dh}: the kernel takes a multiple of 4 up to "
                         f"{MAX_DH}")
    _need(r, "r", (torch.bfloat16, torch.float32), r.shape)
    _need(k, "k", (r.dtype,), r.shape)
    _need(v, "v", (r.dtype,), r.shape)
    _need(logw, "logw", (torch.float32,), r.shape)
    if tuple(u.shape) != (h, dh) or not u.is_cuda:
        raise ValueError(f"u: need a CUDA tensor of shape {(h, dh)}, got "
                         f"{tuple(u.shape)} on {u.device}")
    if state0 is not None:
        _need(state0, "state0", (torch.float32,), (b, h, dh, dh))
    if len({x.device for x in (r, k, v, logw, u)}) != 1 or (
            state0 is not None and state0.device != r.device):
        raise ValueError("all inputs must be on one device")
    if nv is None:
        nv = wkv_plan(b, h, dh, lambda vb: max_active_blocks(
            r.device, r.dtype, dh, vb))
    vb = value_slices(dh, nv)[0][1]
    esize = r.element_size()
    vec = int(dh * esize % 16 == 0 and vb * esize % 16 == 0
              and all(x.data_ptr() % 16 == 0 for x in (r, k, v, logw)))
    u32 = u.float().contiguous()
    y = torch.empty((b, t, h, dh), dtype=torch.float32, device=r.device)
    state = torch.empty((b, h, dh, dh), dtype=torch.float32, device=r.device)
    with torch.cuda.device(r.device):
        code = _library().wkv6_launch(
            r.data_ptr(), k.data_ptr(), v.data_ptr(), logw.data_ptr(),
            u32.data_ptr(), None if state0 is None else state0.data_ptr(),
            y.data_ptr(), state.data_ptr(), b, t, h, dh, nv, vec,
            int(r.dtype == torch.bfloat16),
            torch.cuda.current_stream().cuda_stream)
    check("wkv6", code, "wkv6_launch")
    launch_counts["wkv6"] += 1
    return y, state


def wkv6_bwd_cuda(r, k, v, logw, u, state0, dy, ds=None,
                  need_state0_grad: bool = False, nv=None):
    """The gradient of ``wkv6_cuda``'s (y, final state) on the card, for the
    cotangents ``dy`` (B, T, H, Dh) float32 and ``ds`` (B, H, Dh, Dh)
    float32 or None (zero). The inputs as ``wkv6_cuda`` takes them, u
    float32 here. Returns (dr, dk, dv in r's dtype, dlogw float32, du (H,
    Dh) float32, dstate0 (B, H, Dh, Dh) float32 when ``need_state0_grad``,
    else None). ``nv`` (value slices, a cluster's blocks) is ``bwd_plan``'s
    unless given; the model never gives it."""
    if r.ndim != 4:
        raise ValueError(f"r: need (B, T, H, Dh), got {tuple(r.shape)}")
    b, t, h, dh = r.shape
    if dh not in BWD_DHS:
        raise ValueError(f"Dh={dh}: the backward takes Dh in {BWD_DHS}")
    _need(r, "r", (torch.bfloat16, torch.float32), r.shape)
    _need(k, "k", (r.dtype,), r.shape)
    _need(v, "v", (r.dtype,), r.shape)
    _need(logw, "logw", (torch.float32,), r.shape)
    _need(dy, "dy", (torch.float32,), r.shape)
    _need(u, "u", (torch.float32,), (h, dh))
    for name, x in (("state0", state0), ("ds", ds)):
        if x is not None:
            _need(x, name, (torch.float32,), (b, h, dh, dh))
    if len({x.device for x in (r, k, v, logw, u, dy, state0, ds)
            if x is not None}) != 1:
        raise ValueError("all inputs must be on one device")
    dev = r.device
    clusters = lambda n: max_active_clusters(dev, r.dtype, dh, n)
    if nv is None:
        nv = bwd_plan(b, h, dh, clusters)
    elif value_slices(dh, nv) and clusters(nv) < 1:
        raise RuntimeError(f"NV={nv}: a cluster of {nv} WKV6 backward "
                           f"blocks for Dh={dh} cannot run")
    vb = dh // nv
    esize = r.element_size()
    vec = int(dh * esize % 16 == 0 and vb * esize % 16 == 0
              and all(x.data_ptr() % 16 == 0 for x in (r, k, v, logw, dy)))
    scratch = torch.empty((b, h, -(-t // 32), dh, dh), dtype=torch.float32,
                          device=dev)
    dr, dk, dv = (torch.empty_like(r) for _ in range(3))
    dlogw = torch.empty_like(logw)
    du_part = torch.empty((b, h, dh), dtype=torch.float32, device=dev)
    ds0 = (torch.empty((b, h, dh, dh), dtype=torch.float32, device=dev)
           if need_state0_grad else None)
    ptr = lambda x: None if x is None else x.data_ptr()
    with torch.cuda.device(dev):
        code = _library().wkv6_bwd_launch(
            r.data_ptr(), k.data_ptr(), v.data_ptr(), logw.data_ptr(),
            u.data_ptr(), ptr(state0), dy.data_ptr(), ptr(ds),
            scratch.data_ptr(), dr.data_ptr(), dk.data_ptr(), dv.data_ptr(),
            dlogw.data_ptr(), du_part.data_ptr(), ptr(ds0), b, t, h, dh, nv,
            vec, int(r.dtype == torch.bfloat16),
            torch.cuda.current_stream().cuda_stream)
    check("wkv6", code, "wkv6_bwd_launch")
    launch_counts["wkv6_bwd"] += 1
    return dr, dk, dv, dlogw, du_part.sum(0), ds0

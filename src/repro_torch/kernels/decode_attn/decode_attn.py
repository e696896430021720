"""Wrapper of the CUDA kernel in ``csrc/decode_attn.cu``: GQA decode
attention against a KV cache, split over the cache rows (flash-decode),
written by hand for Hopper.

    decode_attn_cuda        q (B, H, Dh), caches (B, S, KV, Dh), pos -> (B, H, Dh)
    decode_attn_slice_cuda  q, a rank's rows (B, S_r, KV, Dh) of a cache
                            sharded along its sequence, pos, row0 ->
                            (out (B, H, Dh), lse (B, H)), float32

One launch a call. A block takes a run of rows of one (b, kv head) and a
slice of up to ``HEADS`` of its query heads; ``split_plan`` cuts the rows a
position attends to into runs so that every block is resident at once
(``resident_blocks``: the occupancy API for the kernel's shared memory,
asked once per card, dtype and Dh). The blocks of a (b, kv head, head
slice) write float32 partials into one scratch tensor, and the last of them
folds them in split order; it finds out that it is last on an int32
counter, which it resets to 0. The counters are zeroed once, when they are
first allocated, and kept for each device and stream, so that two streams
never share one.

It takes CUDA tensors only and either launches or raises: the plain version
in ``ref.py`` is chosen one level up (``ops.py``) and only for CPU tensors.
``pos`` and ``window`` are Python ints, passed to the kernel by value (a
number written into a device tensor would be a copy from the host). The
output and the scratch come from ``torch.empty``; launches go to PyTorch's
current stream and nothing synchronises. ``launch_counts`` adds one per
wrapper call that launched, under ``decode_attn`` or, for the slice form,
``decode_attn_slice``.

The slice form is the same launch on the slice's local rows with the
kernel's fold writing float32 and each head's log-sum-exp beside it
(``ref.decode_attn_slice_ref`` is the same function). A slice holding no
row that the position attends to is decided from the Python ints ``row0``
and ``pos``: its output (0, -inf) is written without a launch, and nothing
is counted.
"""
from __future__ import annotations

import ctypes
import math

import torch

from ..build import check, load
from ..device import counters_for
from .ref import slice_rows, valid_rows

__all__ = ["decode_attn_cuda", "decode_attn_slice_cuda", "split_plan", "layout", "shared_bytes",
           "head_slices", "resident_blocks", "launch_counts",
           "reset_launch_counts", "HEADS", "BATCH", "CONSUMERS",
           "HEADER_BYTES", "MAX_DH", "MAX_G_DH", "MAX_SPLITS", "MIN_ROWS",
           "SMEM_LIMIT"]

launch_counts = {"decode_attn": 0, "decode_attn_slice": 0}

MAX_DH = 256
MAX_G_DH = 4096
# the kernel's constants (csrc/decode_attn.cu)
HEADS = 4           # query heads a block holds (kHeads)
BATCH = 4           # rows a team takes at a time (kBatch)
CONSUMERS = 256     # consumer threads of a block (kConsumers)
MAX_STAGES = 6      # ring stages (kMaxStages)
HEADER_BYTES = 128  # shared memory in front of the ring (kHeader)
SMEM_LIMIT = 232448  # shared memory a block may take on an H100
RING_BYTES = 192 * 1024  # the ring's size aimed at
# the plan: the last block of a group reads every partial in turn, so the
# splits are capped; and a run shorter than MIN_ROWS rows costs more in a
# block's fixed work (q, the fold of its teams, its partial) than it saves
MAX_SPLITS = 32     # (kMaxSplits)
MIN_ROWS = 16

_lib = None
_active: dict = {}


def reset_launch_counts() -> None:
    for k in launch_counts:
        launch_counts[k] = 0


def _library():
    global _lib
    if _lib is None:
        lib = load("decode_attn")
        vp, ci, cf = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.decode_attn_launch.argtypes = [vp] * 7 + [ci] * 14 + [cf, vp]
        lib.decode_attn_launch.restype = ci
        lib.decode_attn_max_active_blocks.argtypes = [ci] * 5 + [
            ctypes.POINTER(ci)] * 2
        lib.decode_attn_max_active_blocks.restype = ci
        _lib = lib
    return _lib


def layout(dh: int, elem_bytes: int) -> tuple[int, int, int]:
    """``(lanes, stage_rows, stages)`` of the kernel for head size ``dh``
    and caches of ``elem_bytes`` (2 or 4) an element: a team of ``lanes``
    lanes takes a row, 16 bytes a lane (two chunks a lane for float32 rows
    of more than 32 chunks); a stage holds ``BATCH`` rows for each team;
    the ring holds ``stages`` stages, about ``RING_BYTES`` in all."""
    chunks = dh * elem_bytes // 16
    lanes = 8 if chunks <= 8 else 16 if chunks <= 16 else 32
    stage_rows = CONSUMERS // lanes * BATCH
    stage_bytes = 2 * stage_rows * dh * elem_bytes
    stages = max(2, min(MAX_STAGES, RING_BYTES // stage_bytes))
    return lanes, stage_rows, stages


def shared_bytes(dh: int, elem_bytes: int) -> int:
    """Shared memory of one block: the header and the ring."""
    _, stage_rows, stages = layout(dh, elem_bytes)
    return HEADER_BYTES + stages * 2 * stage_rows * dh * elem_bytes


def head_slices(g: int) -> int:
    """Blocks across the G query heads of one KV head."""
    return -(-g // HEADS)


def split_plan(n_units: int, lo: int, hi: int, n_slots: int):
    """``(rows_per_split, nsplit)``: rows ``lo..hi`` of each of ``n_units``
    (b, kv head, head slice) units cut into ``nsplit`` runs, so that the
    ``n_units * nsplit`` blocks fit the ``n_slots`` the card holds at once
    (one split a unit when even that does not fit), with at most
    ``MAX_SPLITS`` runs and, where there are several, at least ``MIN_ROWS``
    rows a run. Every run holds at least one row; together they cover
    ``lo..hi`` exactly once."""
    n_valid = hi - lo + 1
    want = max(1, min(n_slots // n_units, MAX_SPLITS, n_valid // MIN_ROWS))
    rows = -(-n_valid // want)
    return rows, -(-n_valid // rows)


def resident_blocks(dev: torch.device, dtype: torch.dtype, dh: int) -> int:
    """Blocks of the kernel for caches of ``dtype`` and head size ``dh``
    that the card ``dev`` holds at once: its SM count times
    ``cudaOccupancyMaxActiveBlocksPerMultiprocessor`` (asked once per card,
    dtype and dh). Raises if it is 0, or if the kernel's shared memory is
    not ``shared_bytes``'s."""
    idx = dev.index if dev.index is not None else torch.cuda.current_device()
    key = (idx, dtype, dh)
    if key not in _active:
        esize = torch.empty((), dtype=dtype).element_size()
        blocks, smem = ctypes.c_int(0), ctypes.c_int(0)
        with torch.cuda.device(idx):
            code = _library().decode_attn_max_active_blocks(
                int(dtype == torch.bfloat16), dh, *layout(dh, esize),
                ctypes.byref(blocks), ctypes.byref(smem))
        check("decode_attn", code, "decode_attn_max_active_blocks")
        if blocks.value < 1 or smem.value != shared_bytes(dh, esize):
            raise RuntimeError(
                f"a decode-attention block for Dh={dh} in {dtype} cannot run "
                f"on {torch.cuda.get_device_name(idx)}: "
                f"cudaOccupancyMaxActiveBlocksPerMultiprocessor = "
                f"{blocks.value}, shared memory {smem.value} bytes (expected "
                f"{shared_bytes(dh, esize)})")
        _active[key] = blocks.value * torch.cuda.get_device_properties(
            idx).multi_processor_count
    return _active[key]


def _need(t: torch.Tensor, name: str, dtypes, ndim: int) -> None:
    if not t.is_cuda or t.dtype not in dtypes or t.ndim != ndim \
            or not t.is_contiguous() or t.data_ptr() % 16:
        raise ValueError(
            f"{name}: need a contiguous, 16-byte aligned CUDA tensor of "
            f"{ndim} dims in {[str(d) for d in dtypes]}, got {t.dtype} "
            f"{tuple(t.shape)} on {t.device}, contiguous={t.is_contiguous()}")


_FLOATS = (torch.float32, torch.bfloat16)


def _check(q, k_cache, v_cache) -> None:
    _need(q, "q", _FLOATS, 3)
    _need(k_cache, "k_cache", _FLOATS, 4)
    _need(v_cache, "v_cache", (k_cache.dtype,), 4)
    b, h, dh = q.shape
    _, s, kv, _ = k_cache.shape
    if k_cache.shape != (b, s, kv, dh) or v_cache.shape != k_cache.shape:
        raise ValueError(f"caches {tuple(k_cache.shape)} / "
                         f"{tuple(v_cache.shape)} do not match q "
                         f"{tuple(q.shape)}: need (B, S, KV, Dh)")
    if h % kv or dh % 8 or dh > MAX_DH or (h // kv) * dh > MAX_G_DH:
        raise ValueError(f"H={h}, KV={kv}, Dh={dh}: the kernel takes "
                         f"H % KV == 0, Dh a multiple of 8 up to {MAX_DH}, "
                         f"(H / KV) * Dh <= {MAX_G_DH}")
    if not (q.device == k_cache.device == v_cache.device):
        raise ValueError("q and the caches must be on one device")


def _launch(q, k_cache, v_cache, lo: int, hi: int, out, lse) -> None:
    """One launch over rows lo..hi of the caches into ``out`` (and, the
    slice form, ``lse``)."""
    b, h, dh = q.shape
    _, s, kv, _ = k_cache.shape
    g = h // kv
    units = b * kv * head_slices(g)
    esize = k_cache.element_size()
    rows, nsplit = split_plan(units, lo, hi,
                              resident_blocks(q.device, k_cache.dtype, dh))
    part = cnt = None
    if nsplit > 1:
        part = torch.empty(units * nsplit * HEADS * (dh + 2),
                           dtype=torch.float32, device=q.device)
        cnt = counters_for(q.device, units)
    with torch.cuda.device(q.device):
        code = _library().decode_attn_launch(
            q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
            out.data_ptr(), None if part is None else part.data_ptr(),
            None if cnt is None else cnt.data_ptr(),
            None if lse is None else lse.data_ptr(), b, s, kv, g, dh, lo, hi,
            rows, nsplit, int(q.dtype == torch.bfloat16),
            int(k_cache.dtype == torch.bfloat16), *layout(dh, esize),
            1.0 / math.sqrt(dh), torch.cuda.current_stream().cuda_stream)
    check("decode_attn", code, "decode_attn_launch")


def decode_attn_cuda(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, pos: int, window: int = 0):
    """One token's attention on the card (``ref.decode_attn_ref`` is the
    same function): rows ``t <= pos`` (and ``t > pos - window`` if
    ``window > 0``) of the caches; output in ``q.dtype``."""
    _check(q, k_cache, v_cache)
    lo, hi = valid_rows(k_cache.shape[1], int(pos), int(window))
    out = torch.empty_like(q)
    _launch(q, k_cache, v_cache, lo, hi, out, None)
    launch_counts["decode_attn"] += 1
    return out


def decode_attn_slice_cuda(q: torch.Tensor, k_slice: torch.Tensor,
                           v_slice: torch.Tensor, pos: int, window: int = 0,
                           row0: int = 0):
    """The slice form on the card (``ref.decode_attn_slice_ref`` is the
    same function): q against a rank's rows ``row0 .. row0 + S_r - 1`` of a
    cache at global position ``pos``; (out (B, H, Dh), lse (B, H)) float32.
    A slice with no row that ``pos`` attends to: (0, -inf), no launch."""
    _check(q, k_slice, v_slice)
    b, h, dh = q.shape
    rows = slice_rows(k_slice.shape[1], int(row0), int(pos), int(window))
    out = torch.empty((b, h, dh), dtype=torch.float32, device=q.device)
    lse = torch.empty((b, h), dtype=torch.float32, device=q.device)
    if rows is None:
        return out.zero_(), lse.fill_(float("-inf"))
    _launch(q, k_slice, v_slice, rows[0], rows[1], out, lse)
    launch_counts["decode_attn_slice"] += 1
    return out, lse

"""Wrapper of the CUDA kernels in ``csrc/amp_local.cu``: the fused AMP
local-computation step of the row layout, written by hand for Hopper.

    amp_local_cuda_grid  z' = y_p - A_p x + onsager z_p,  ss = sum(z'^2),
                         f_p = x / P + A_p^T z'; the counterpart of the JAX
                         package's ``amp_local_pallas_grid``

For N up to ``CLUSTER_MAX_N`` one step reads A once: a band kernel (one
block per (b, p, band of rows), ``split_plan``) and a fixed-order combine
(``combine_groups``), two launches counted as one in
``launch_counts["amp_local"]``. One block takes rows of up to
``SINGLE_READ_MAX_N`` columns; wider rows are split over a thread-block
cluster of ``cluster_size`` blocks, one column slice each
(``cluster_slices``), which exchange their dot products through
distributed shared memory. Past ``CLUSTER_MAX_N`` rows take the two-pass
kernels (z-pass with its ss second stage, then the f-pass; A read twice),
counted in ``launch_counts["amp_local_two_pass"]``. ``single_read`` and
``cluster_size`` choose from (N, dtype) alone, never because something
failed: a cluster the card cannot schedule raises.

It takes CUDA tensors only and either launches or raises: the plain
versions in ``ref.py`` are chosen one level up (``ops.py``) and only for CPU
tensors. Outputs and scratch come from ``torch.empty``; launches go to
PyTorch's current stream and nothing synchronises.
"""
from __future__ import annotations

import ctypes

import torch

from ..build import check, load
from ..device import sm_count

__all__ = ["amp_local_cuda_grid", "launch_counts", "reset_launch_counts",
           "vec_width", "single_read", "cluster_size", "cluster_slices",
           "rows_per_stage", "ring_stages", "split_plan", "combine_groups",
           "sm_count", "max_active_clusters", "SINGLE_READ_MAX_N",
           "CLUSTER_MAX_N", "BAND_THREADS", "Z_WARPS", "F_THREADS"]

BAND_THREADS = 512          # threads of a band block (kBandThreads)
REG_ELEMS = 32              # elements of a stage one thread holds (kRegElems)
SINGLE_READ_MAX_N = BAND_THREADS * REG_ELEMS    # 16384 columns, one block
MAX_CLUSTER = 8             # blocks of a cluster, at most (the portable size)
CLUSTER_MAX_N = MAX_CLUSTER * SINGLE_READ_MAX_N  # 131072 columns, a cluster
RING_BYTES = 192 * 1024     # the band kernel's ring, at most (kRingBytes)
MAX_STAGES = 16             # its slots, at most (kMaxStages)
CLUSTER_HEADER_BYTES = 2048  # its mbarriers and exchange (kClusterHeaderBytes)
Z_WARPS = 8        # rows of A per two-pass z-pass block (one warp each)
F_THREADS = 128    # threads of a two-pass f-pass block, vec_width columns each

launch_counts = {"amp_local": 0, "amp_local_two_pass": 0}

_A_DTYPES = (torch.float32, torch.bfloat16)
_lib = None
_clusters: dict = {}


def reset_launch_counts() -> None:
    for k in launch_counts:
        launch_counts[k] = 0


def _library():
    global _lib
    if _lib is None:
        lib = load("amp_local")
        vp, ci, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.amp_local_launch.argtypes = [
            vp, ci, ll, vp, vp, vp, vp, vp, vp, vp, vp, vp, ctypes.c_float,
            ci, ci, ci, ci, ci, ci, ci, ci, ci, ci, ci, ci, vp]
        lib.amp_local_launch.restype = ci
        lib.amp_local_max_active_clusters.argtypes = [
            ci, ci, ci, ci, ci, ctypes.POINTER(ci)]
        lib.amp_local_max_active_clusters.restype = ci
        lib.amp_local_z_launch.argtypes = [
            vp, ci, ll, vp, vp, vp, vp, vp, vp, vp, ci, ci, ci, ci, ci, vp]
        lib.amp_local_z_launch.restype = ci
        lib.amp_local_f_launch.argtypes = [
            vp, ci, ll, vp, vp, vp, ctypes.c_float, ci, ci, ci, ci, ci, ci,
            vp]
        lib.amp_local_f_launch.restype = ci
        _lib = lib
    return _lib


def vec_width(n: int, dtype: torch.dtype) -> int:
    """Elements of A a thread loads at once: 16 bytes' worth when N is a
    multiple of that, else 1 (rows of A then start unaligned)."""
    v = 16 // torch.empty((), dtype=dtype).element_size()
    return v if n % v == 0 else 1


def single_read(n: int, dtype: torch.dtype) -> bool:
    """Whether a step with rows of N elements of ``dtype`` takes the
    single-read kernels: a thread holds at most ``REG_ELEMS`` elements of a
    row (x and its f partial in float32 registers, whatever A's dtype), so
    one block takes N <= 16384 and a cluster of at most ``MAX_CLUSTER``
    blocks N <= 131072. Wider rows take the two-pass kernels."""
    if dtype not in _A_DTYPES:
        raise ValueError(f"A: float32 or bfloat16, got {dtype}")
    return n <= CLUSTER_MAX_N


def cluster_size(n: int, dtype: torch.dtype) -> int:
    """Blocks of the cluster that takes each band of rows of N elements:
    ceil(N / 16384), 1 (no cluster) up to 8. Raises past
    ``CLUSTER_MAX_N``, where the two-pass kernels take the rows."""
    if not single_read(n, dtype):
        raise ValueError(f"N={n} > {CLUSTER_MAX_N}: the two-pass kernels "
                         "take these rows, not a cluster")
    return -(-n // SINGLE_READ_MAX_N)


def cluster_slices(n: int, dtype: torch.dtype) -> list[tuple[int, int]]:
    """The columns ``[lo, hi)`` each rank of a band's cluster owns: slices
    of W = ceil(N / C) rounded up to the vector width, the last one
    ragged. None is empty and none is wider than 16384; with a vector width
    above 1 every slice starts on a 16-byte boundary of the row and is a
    whole number of vectors, so each rank can bulk-copy its slice."""
    c = cluster_size(n, dtype)
    v = vec_width(n, dtype)
    w = -(-n // (c * v)) * v
    return [(r * w, min(n, (r + 1) * w)) for r in range(c)]


def rows_per_stage(w: int) -> int:
    """Rows of A one stage of the band kernel's ring holds (and one barrier
    serves), for slices of ``w`` columns (all of N without a cluster): 4
    while a thread's share of 4 rows fits its registers (w <= 4096), else
    1. A stage then carries at least ~16 KB for w >= 1024."""
    return 4 if w <= BAND_THREADS * REG_ELEMS // 4 else 1


def ring_stages(w: int, dtype: torch.dtype) -> int:
    """Slots of the band kernel's ring for slices of ``w`` columns: as many
    stages of ``rows_per_stage(w)`` rows as fit ``RING_BYTES``, at most
    ``MAX_STAGES``."""
    stage = rows_per_stage(w) * w * torch.empty((), dtype=dtype).element_size()
    return min(MAX_STAGES, RING_BYTES // stage)


def split_plan(batch: int, p: int, mp: int, n: int, dtype: torch.dtype,
               n_slots: int = 132) -> tuple[int, int]:
    """``(band_rows, n_bands)``: the Mp rows of each of the ``batch * p``
    shards cut into ``n_bands`` bands of ``band_rows`` contiguous rows (the
    last one ragged, none empty), one block (or cluster) each. The count
    aims at one wave of ``n_slots`` over the whole grid: the SM count where
    a band is one block (a band block fills an SM), the card's active
    clusters where it is a cluster. It keeps the partial f's,
    ``batch * p * n_bands * n`` float32 written and read once, under a
    tenth of the per-instance A (``batch * p * mp * n`` elements). ``n``
    scales both sides of that cap alike."""
    esize = torch.empty((), dtype=dtype).element_size()
    want = max(1, n_slots // (batch * p))
    cap = max(1, mp * esize // 40)      # 4 * n_bands <= 0.1 * mp * esize
    rows = -(-mp // max(1, min(want, cap, mp)))
    return rows, -(-mp // rows)


def combine_groups(batch: int, p: int, n: int, n_bands: int,
                   n_sm: int = 132) -> int:
    """Band groups of a combine block: thread (c, g) adds the partials of
    bands g, g + groups, ... of column c, then a block adds its groups'
    sums in order. One group while the ``batch * p * n`` columns give the
    card its 2048 threads an SM; more (a power of two, at most 8 and at most
    the band count) only to make up the shortfall, as at P = 1."""
    want = min(8, n_bands, max(1, n_sm * 2048 // (batch * p * n)))
    return 1 << (want.bit_length() - 1)


def max_active_clusters(dev: torch.device, c: int, dtype: torch.dtype,
                        vec: int, w: int) -> int:
    """Clusters of ``c`` band blocks, with rings for slices of ``w``
    columns (none without ``vec``), that the card ``dev`` runs at once
    (``cudaOccupancyMaxActiveClusters``, asked once per card, cluster
    size, dtype and shared memory size). Raises if it is 0: such a cluster
    cannot be scheduled, and nothing takes its place."""
    stages = ring_stages(w, dtype) if vec else 0
    smem = CLUSTER_HEADER_BYTES + stages * w * torch.empty(
        (), dtype=dtype).element_size()
    idx = dev.index if dev.index is not None else torch.cuda.current_device()
    key = (idx, c, dtype, smem)
    if key not in _clusters:
        out = ctypes.c_int(0)
        with torch.cuda.device(idx):
            code = _library().amp_local_max_active_clusters(
                int(dtype == torch.bfloat16), vec, c, w, stages,
                ctypes.byref(out))
        check("amp_local", code, "amp_local_max_active_clusters")
        if out.value < 1:
            raise RuntimeError(
                f"a cluster of {c} band blocks ({BAND_THREADS} threads, "
                f"{smem} bytes of shared memory each) cannot be scheduled on "
                f"{torch.cuda.get_device_name(idx)}: "
                f"cudaOccupancyMaxActiveClusters = {out.value}")
        _clusters[key] = out.value
    return _clusters[key]


def _f32(t: torch.Tensor, shape, name: str, dev) -> torch.Tensor:
    if t.device != dev or t.dtype != torch.float32 \
            or tuple(t.shape) != tuple(shape) or not t.is_contiguous():
        raise ValueError(
            f"{name}: need a contiguous float32 tensor of shape "
            f"{tuple(shape)} on {dev}, got {t.dtype} {tuple(t.shape)} on "
            f"{t.device}, contiguous={t.is_contiguous()}")
    return t


def _stack(a: torch.Tensor, x: torch.Tensor, x_rank: int = 1,
           dims: str = "(P, Mp, N)"):
    """Validate an A stack ``dims`` or (B,) + ``dims`` against ``x``, whose
    unbatched rank is ``x_rank``; returns (B, P, rows, cols, batch stride,
    batched). The column kernels use it with ``x_rank=2``."""
    if not a.is_cuda:
        raise ValueError("the CUDA LC kernels take CUDA tensors; CPU tensors "
                         "go through kernels.amp_fused.ops")
    if a.dtype not in _A_DTYPES or not a.is_contiguous() \
            or a.ndim not in (3, 4):
        raise ValueError(
            f"A: need a contiguous float32/bfloat16 {dims} or (B, "
            f"{dims[1:]} tensor, got {a.dtype} {tuple(a.shape)}, "
            f"contiguous={a.is_contiguous()}")
    batched = x.ndim == x_rank + 1
    if a.ndim == 4 and not batched:
        raise ValueError("a batched A needs a batched x")
    p, rows, cols = a.shape[-3:]
    b = x.shape[0] if batched else 1
    if a.ndim == 4 and a.shape[0] != b:
        raise ValueError(f"A batch {a.shape[0]} != x batch {b}")
    stride = p * rows * cols if a.ndim == 4 else 0
    return b, p, rows, cols, stride, batched


def _vec_flag(n: int, a_p: torch.Tensor, *others: torch.Tensor) -> int:
    if vec_width(n, a_p.dtype) == 1:
        return 0
    return int(all(t.data_ptr() % 16 == 0 for t in (a_p, *others)))


def _onsager(onsager, b: int, dev) -> torch.Tensor:
    ons = torch.as_tensor(onsager, dtype=torch.float32, device=dev)
    if ons.ndim == 0:
        ons = ons.reshape(1) if b == 1 else ons.expand(b).contiguous()
    return _f32(ons, (b,), "onsager", dev)


def amp_local_cuda_grid(a_p, x, y_p, z_p, onsager, n_proc: int):
    """Fused LC step over the whole (B, P) stack on the card.

    Returns ``(z_new, f_p, ss)`` like ``ref.amp_local_ref_grid``, the same
    bits from run to run."""
    b, p, mp, n, stride, batched = _stack(a_p, x)
    dev = a_p.device
    lead = (b,) if batched else ()
    _f32(x, lead + (n,), "x", dev)
    _f32(y_p, lead + (p, mp), "y_p", dev)
    _f32(z_p, lead + (p, mp), "z_p", dev)
    ons = _onsager(onsager, b, dev)
    z_new = torch.empty_like(y_p)
    f_p = torch.empty(lead + (p, n), dtype=torch.float32, device=dev)
    ss = torch.empty(lead, dtype=torch.float32, device=dev)
    a_bf16 = int(a_p.dtype == torch.bfloat16)
    stream = torch.cuda.current_stream(dev).cuda_stream
    if not single_read(n, a_p.dtype):
        _two_pass(a_p, a_bf16, stride, x, y_p, z_p, ons, z_new, f_p, ss,
                  n_proc, b, p, mp, n, stream)
        launch_counts["amp_local_two_pass"] += 1
        return z_new, f_p, ss
    n_sm = sm_count(dev)
    c = cluster_size(n, a_p.dtype)
    w = cluster_slices(n, a_p.dtype)[0][1]
    vec = _vec_flag(n, a_p, x)
    n_slots = n_sm if c == 1 else max_active_clusters(dev, c, a_p.dtype,
                                                      vec, w)
    band_rows, n_bands = split_plan(b, p, mp, n, a_p.dtype, n_slots)
    # one band a shard writes f itself: no partials
    fpart = torch.empty((b, p, n_bands, n) if n_bands > 1 else (0,),
                        dtype=torch.float32, device=dev)
    sspart = torch.empty((b, p, n_bands), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        code = _library().amp_local_launch(
            a_p.data_ptr(), a_bf16, stride, x.data_ptr(), y_p.data_ptr(),
            z_p.data_ptr(), ons.data_ptr(), z_new.data_ptr(),
            fpart.data_ptr(), sspart.data_ptr(), f_p.data_ptr(),
            ss.data_ptr(), float(n_proc), b, p, mp, n, band_rows, n_bands,
            rows_per_stage(w), combine_groups(b, p, n, n_bands, n_sm), vec,
            c, w, ring_stages(w, a_p.dtype) if vec else 0, stream)
    check("amp_local", code, "amp_local_launch")
    launch_counts["amp_local"] += 1
    return z_new, f_p, ss


def _two_pass(a_p, a_bf16, stride, x, y_p, z_p, ons, z_new, f_p, ss, n_proc,
              b, p, mp, n, stream) -> None:
    """The z-pass (and its ss second stage), then the f-pass: rows wider
    than ``CLUSTER_MAX_N``. Arguments checked by the caller."""
    rows = p * mp
    partial = torch.empty((b, -(-rows // Z_WARPS)), dtype=torch.float32,
                          device=a_p.device)
    with torch.cuda.device(a_p.device):
        code = _library().amp_local_z_launch(
            a_p.data_ptr(), a_bf16, stride, x.data_ptr(), y_p.data_ptr(),
            z_p.data_ptr(), ons.data_ptr(), z_new.data_ptr(),
            partial.data_ptr(), ss.data_ptr(), b, rows, n, Z_WARPS,
            _vec_flag(n, a_p, x), stream)
        check("amp_local", code, "amp_local_z_launch")
        code = _library().amp_local_f_launch(
            a_p.data_ptr(), a_bf16, stride, z_new.data_ptr(), x.data_ptr(),
            f_p.data_ptr(), float(n_proc), b, p, mp, n, F_THREADS,
            _vec_flag(n, a_p), stream)
    check("amp_local", code, "amp_local_f_launch")

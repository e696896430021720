"""Wrappers of the CUDA kernels in ``csrc/quantize.cu``: block-wise max-abs
quantization (int8 symbols, bf16 scales), its inverse, and the two fused
with the sum over processors and the noise accounting of the block-quantized
transport, written by hand for Hopper.

    quantize_cuda         x (R, N) float32 -> q (R, N) int8, scale (R, ceil(N/block)) bf16;
                          packed (qmax <= 7): q (R, ceil(N/2)) uint8, two nibbles a byte
    dequantize_cuda       (q, scale) -> (R, N) float32; q int8 or packed
    dequantize_sum_cuda   (q (D, C), scale (D, ceil(C/block))) -> (C,) float32,
                          the sum over d = 0, 1, ... of q * Delta; q int8 or packed
    block_quant_fuse_cuda f_p (B, P, L) float32 -> f (B, L), extra (B,),
                          symbols (B, P, L) float32 or None; one launch;
                          with keep (P,) or (B, P), the erasure form

They take CUDA tensors only and either launch or raise: the plain versions
in ``ref.py`` are chosen one level up (``ops.py``) and only for CPU tensors.
Outputs and scratch come from ``torch.empty``; launches go to PyTorch's
current stream and nothing synchronises. ``launch_counts`` adds one per
wrapper call that launched its kernel. ``fuse_plan`` is the fusion's grid,
in plain Python.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from ..build import check, load
from ..device import counters_for, sm_count

__all__ = ["quantize_cuda", "dequantize_cuda", "dequantize_sum_cuda",
           "block_quant_fuse_cuda",
           "empty_launch_cuda", "fuse_plan", "fuse_cluster", "FusePlan",
           "launch_counts", "reset_launch_counts", "MAX_WARPS", "MAX_CLUSTER",
           "SMEM_LIMIT", "INDEX_LIMIT"]

launch_counts = {"quantize_blocks": 0, "dequantize_blocks": 0,
                 "block_quant_fuse": 0, "quantize_blocks_packed": 0,
                 "dequantize_blocks_packed": 0, "dequantize_sum": 0,
                 "dequantize_sum_packed": 0}

# the fusion kernel's constants (csrc/quantize.cu)
MAX_WARPS = 31        # quantizing warps a block (kMaxWarps), and one more
MAX_CLUSTER = 8       # blocks a cluster (kMaxCluster)
SMS = 132             # an H100's SMs: fuse_plan's default
SMEM_LIMIT = 232448   # shared memory a block may take on an H100 (kSmemLimit)
# the standalone kernels index a row (and K4b's sum its D x C symbols) with
# 32-bit ints, a grid-stride step past the last element included
INDEX_LIMIT = 2 ** 31 - 2 ** 20

_lib = None


def reset_launch_counts() -> None:
    for k in launch_counts:
        launch_counts[k] = 0


def _library():
    global _lib
    if _lib is None:
        lib = load("quantize")
        vp, ci, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.quantize_blocks_launch.argtypes = [vp, vp, vp, ll, ci, ci, ci,
                                               ci, vp]
        lib.quantize_blocks_launch.restype = ci
        lib.dequantize_blocks_launch.argtypes = [vp, vp, vp, ll, ci, ci, ci,
                                                 vp]
        lib.dequantize_blocks_launch.restype = ci
        lib.dequantize_sum_launch.argtypes = [vp, vp, vp, ci, ci, ci, ci, vp]
        lib.dequantize_sum_launch.restype = ci
        lib.block_quant_fuse_launch.argtypes = [vp] * 6 + [ci] * 9 + [vp]
        lib.block_quant_fuse_launch.restype = ci
        lib.block_quant_empty_launch.argtypes = [ci] * 5 + [vp]
        lib.block_quant_empty_launch.restype = ci
        _lib = lib
    return _lib


def _need(t: torch.Tensor, dtype, shape, name: str) -> None:
    if not t.is_cuda or t.dtype != dtype or tuple(t.shape) != tuple(shape) \
            or not t.is_contiguous():
        raise ValueError(
            f"{name}: need a contiguous CUDA {dtype} tensor of shape "
            f"{tuple(shape)}, got {t.dtype} {tuple(t.shape)} on {t.device}, "
            f"contiguous={t.is_contiguous()}")


def _check_block(block: int) -> None:
    if block < 32 or block % 32:
        raise ValueError(f"block={block}: the kernels take a positive "
                         "multiple of 32")


def _check_index(name: str, elems: int) -> None:
    """Refuse (never split) what the kernels cannot index in int."""
    if elems > INDEX_LIMIT:
        raise ValueError(f"{name}: {elems} elements exceed the kernels' "
                         f"32-bit index limit of {INDEX_LIMIT}; the caller "
                         "must cut the tensor")


def _symbols_shape(rows: int, n: int, packed: bool) -> tuple:
    return (rows, (n + 1) // 2 if packed else n)


def quantize_cuda(x: torch.Tensor, qmax: int, block: int,
                  packed: bool = False):
    """Block-quantize the rows of ``x`` on the card; ``N`` need not be a
    multiple of ``block`` (the ragged tail counts as zeros). ``packed``
    (int4, ``qmax <= 7``) writes the symbols two a byte, the even element
    of each pair in the low nibble: (R, ceil(N / 2)) uint8."""
    if x.ndim != 2:
        raise ValueError(f"x: need (R, N), got {tuple(x.shape)}")
    _need(x, torch.float32, x.shape, "x")
    _check_block(block)
    top = 7 if packed else 127
    if not 1 <= qmax <= top:
        raise ValueError(f"qmax={qmax}: {'packed int4' if packed else 'int8'}"
                         f" symbols need 1 <= qmax <= {top}")
    r, n = x.shape
    _check_index("quantize_cuda row", n)
    q = torch.empty(_symbols_shape(r, n, packed),
                    dtype=torch.uint8 if packed else torch.int8,
                    device=x.device)
    scale = torch.empty((r, -(-n // block)), dtype=torch.bfloat16,
                        device=x.device)
    with torch.cuda.device(x.device):
        code = _library().quantize_blocks_launch(
            x.data_ptr(), q.data_ptr(), scale.data_ptr(), r, n, block, qmax,
            int(packed), torch.cuda.current_stream().cuda_stream)
    check("quantize", code, "quantize_blocks_launch")
    launch_counts["quantize_blocks_packed" if packed
                  else "quantize_blocks"] += 1
    return q, scale


def _need_symbols(q, rows: int, n: int, packed: bool, block: int, scale):
    _need(q, torch.uint8 if packed else torch.int8,
          _symbols_shape(rows, n, packed), "q")
    _need(scale, torch.bfloat16, (rows, -(-n // block)), "scale")


def dequantize_cuda(q: torch.Tensor, scale: torch.Tensor, block: int,
                    packed: bool = False, n: int | None = None):
    """``q * scale`` per block on the card -> float32 (R, N). ``packed``: q
    is (R, ceil(N / 2)) uint8 nibbles and ``n`` the row length (default
    twice the bytes)."""
    if q.ndim != 2:
        raise ValueError(f"q: need (R, N), got {tuple(q.shape)}")
    _check_block(block)
    r = q.shape[0]
    n = (2 * q.shape[1] if packed else q.shape[1]) if n is None else n
    _check_index("dequantize_cuda row", n)
    _need_symbols(q, r, n, packed, block, scale)
    out = torch.empty((r, n), dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        code = _library().dequantize_blocks_launch(
            q.data_ptr(), scale.data_ptr(), out.data_ptr(), r, n, block,
            int(packed), torch.cuda.current_stream().cuda_stream)
    check("quantize", code, "dequantize_blocks_launch")
    launch_counts["dequantize_blocks_packed" if packed
                  else "dequantize_blocks"] += 1
    return out


def dequantize_sum_cuda(q: torch.Tensor, scale: torch.Tensor, block: int,
                        packed: bool = False, c: int | None = None):
    """``sum_d q[d] * scale[d]`` over the rows d = 0, 1, ... of (D, C)
    symbols, in that order, on the card -> float32 (C,): one launch, no
    (D, C) float32 array. ``packed``: q is (D, ceil(C / 2)) uint8 and ``c``
    the row length (default twice the bytes)."""
    if q.ndim != 2:
        raise ValueError(f"q: need (D, C), got {tuple(q.shape)}")
    _check_block(block)
    d = q.shape[0]
    c = (2 * q.shape[1] if packed else q.shape[1]) if c is None else c
    _check_index("dequantize_sum_cuda D x C", d * c)
    _need_symbols(q, d, c, packed, block, scale)
    out = torch.empty((c,), dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        code = _library().dequantize_sum_launch(
            q.data_ptr(), scale.data_ptr(), out.data_ptr(), d, c, block,
            int(packed), torch.cuda.current_stream().cuda_stream)
    check("quantize", code, "dequantize_sum_launch")
    launch_counts["dequantize_sum_packed" if packed
                  else "dequantize_sum"] += 1
    return out


class FusePlan(NamedTuple):
    """The fusion's launch: a cluster of ``cluster`` blocks per (column of
    scale blocks j, batch entry b), ``grid = (nbj * cluster, B)``; rank r
    of a cluster takes the columns ``[r * slice, (r + 1) * slice)`` of the
    scale block. A block has ``warps`` quantizing warps and one that keeps
    the noise accounts; warp w < ``warps`` quantizes processors w,
    w + warps, ... (``groups`` of them), and ``smem_bytes`` of shared memory
    hold a group's rows, the running sum, every processor's squared scale
    and the amax exchange."""
    grid: tuple
    cluster: int
    warps: int
    groups: int
    slice: int
    smem_bytes: int

    def work(self, bx: int, by: int, warp: int, n_proc: int):
        """The (b, p, j, first column, end column) that warp ``warp`` of
        block ``(bx, by)`` quantizes, in the kernel's order (columns of the
        scale block j)."""
        j, r = divmod(bx, self.cluster)
        return [(by, g * self.warps + warp, j, r * self.slice,
                 (r + 1) * self.slice) for g in range(self.groups)
                if g * self.warps + warp < n_proc]


def fuse_cluster(block: int, columns: int = 1, sms: int = SMS) -> int:
    """Blocks a cluster for ``columns`` clusters (B x scale-block columns)
    of scale blocks of ``block``: slices of 128 columns (one 16-byte load a
    lane), at most ``MAX_CLUSTER`` of them, each a multiple of 32 columns,
    and no more than keep the grid in one wave of one block an SM (a
    second wave costs more than a slice of 128 saves)."""
    c = max(1, min(MAX_CLUSTER, block // 128))
    while c > 1 and (block % c or (block // c) % 32 or columns * c > sms):
        c -= 1
    return c


def fuse_plan(b: int, p: int, length: int, block: int,
              cluster: int | None = None, sms: int = SMS) -> FusePlan:
    """The plan of ``block_quant_fuse_cuda`` for messages (B, P, L) cut into
    scale blocks of ``block`` on a card of ``sms`` SMs: ``fuse_cluster``
    blocks a cluster (or ``cluster``, which must divide ``block`` into
    slices of a multiple of 32 columns: timing only), min(P, 31)
    quantizing warps a block, fewer where their rows of shared memory would
    exceed what a block may take."""
    _check_block(block)
    if b < 1 or p < 1 or length < 1:
        raise ValueError(f"(B, P, L) = {(b, p, length)}: all must be >= 1")
    nbj = -(-length // block)
    c = fuse_cluster(block, b * nbj, sms) if cluster is None else cluster
    if not 1 <= c <= MAX_CLUSTER or block % c or (block // c) % 32:
        raise ValueError(f"cluster={c}: need 1..{MAX_CLUSTER} blocks, each "
                         f"a slice of a multiple of 32 of the {block} columns")
    sl = block // c
    smem = lambda w: ((w + 1) * sl + p + 2 * c * w) * 4
    warps = min(p, MAX_WARPS)
    while warps > 1 and smem(warps) > SMEM_LIMIT:
        warps -= 1
    if smem(warps) > SMEM_LIMIT:
        raise ValueError(f"block={block}, P={p}: one warp's row of shared "
                         f"memory and the scales exceed {SMEM_LIMIT} bytes")
    return FusePlan((nbj * c, b), c, warps, -(-p // warps), sl, smem(warps))


def block_quant_fuse_cuda(f_p: torch.Tensor, qmax: int, block: int,
                          symbols: bool = True, cluster: int | None = None,
                          keep: torch.Tensor | None = None):
    """``BlockQuantTransport.fuse`` of messages ``f_p`` (B, P, L) in one
    launch: ``f = sum_p dequantize(quantize(f_p[:, p]))`` (B, L), summed in p
    order; ``extra = P * mean(Delta^2) / 12`` (B,), the mean over the P x
    ceil(L / block) scale blocks of each batch entry; and, with
    ``symbols``, the symbols q as float32 (B, P, L), else None.
    ``cluster`` forces the blocks a cluster (``fuse_plan``; timing
    only). ``keep``, float32 (P,) for every batch entry or (B, P), is the
    erasure form of the same launch (``ref.block_quant_fuse_ref``): the
    kernel reads it on the card, the host never does."""
    if f_p.ndim != 3:
        raise ValueError(f"f_p: need (B, P, L), got {tuple(f_p.shape)}")
    _need(f_p, torch.float32, f_p.shape, "f_p")
    if not 1 <= qmax <= 127:
        raise ValueError(f"qmax={qmax}: int8 symbols need 1 <= qmax <= 127")
    b, p, length = f_p.shape
    dev = f_p.device
    plan = fuse_plan(b, p, length, block, cluster, sm_count(dev))
    if b > 65535:
        raise ValueError(f"B={b}: the grid takes at most 65535 batch entries")
    f = torch.empty((b, length), dtype=torch.float32, device=dev)
    extra = torch.empty((b,), dtype=torch.float32, device=dev)
    sym = (torch.empty((b, p, length), dtype=torch.float32, device=dev)
           if symbols else None)
    keep_stride = 0
    if keep is not None:
        _need(keep, torch.float32, (p,) if keep.ndim == 1 else (b, p),
              "keep")
        keep_stride = 0 if keep.ndim == 1 else p
    nbj = plan.grid[0] // plan.cluster
    # b's counter and its nbj slots of partials, zero between launches
    cnt = counters_for(dev, b * (1 + nbj)) if nbj > 1 else None
    ptr = lambda t: None if t is None else t.data_ptr()
    with torch.cuda.device(dev):
        code = _library().block_quant_fuse_launch(
            f_p.data_ptr(), f.data_ptr(), extra.data_ptr(), ptr(sym),
            ptr(cnt), ptr(keep), keep_stride, b, p, length, block, qmax,
            plan.cluster, plan.warps, plan.smem_bytes,
            torch.cuda.current_stream().cuda_stream)
    check("quantize", code, "block_quant_fuse_launch")
    launch_counts["block_quant_fuse"] += 1
    return f, extra, sym


def empty_launch_cuda(plan: FusePlan, device) -> None:
    """Launch an empty kernel with ``plan``'s grid, clusters, threads and
    shared memory on ``device``: the floor under the fusion's time (timing
    only; counted nowhere)."""
    with torch.cuda.device(device):
        code = _library().block_quant_empty_launch(
            *plan.grid, plan.cluster, plan.warps, plan.smem_bytes,
            torch.cuda.current_stream().cuda_stream)
    check("quantize", code, "block_quant_empty_launch")

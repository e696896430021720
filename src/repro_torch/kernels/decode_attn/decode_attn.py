"""Wrapper of the CUDA kernel in ``csrc/decode_attn.cu``: GQA decode
attention against a KV cache, split over the cache rows (flash-decode),
written by hand for Hopper.

    decode_attn_cuda   q (B, H, Dh), caches (B, S, KV, Dh), pos -> (B, H, Dh)

It takes CUDA tensors only and either launches or raises: the plain version
in ``ref.py`` is chosen one level up (``ops.py``) and only for CPU tensors.
``pos`` and ``window`` are Python ints, passed to the kernel by value (a
number written into a device tensor would be a copy from the host). The
output and the float32 scratch of the split partials come from
``torch.empty``; launches go to PyTorch's current stream and nothing
synchronises. ``launch_counts`` adds one per wrapper call that launched.
"""
from __future__ import annotations

import ctypes
import math

import torch

from ..build import check, load
from .ref import valid_rows

__all__ = ["decode_attn_cuda", "split_plan", "launch_counts",
           "reset_launch_counts", "TILE", "MAX_DH", "MAX_G_DH"]

launch_counts = {"decode_attn": 0}

TILE = 32          # cache rows per shared-memory tile (kTile in the source)
MAX_DH = 256
MAX_G_DH = 4096
_CTAS_PER_SM = 4   # split blocks aimed at per SM

_lib = None
_sm_count: dict[int, int] = {}


def reset_launch_counts() -> None:
    for k in launch_counts:
        launch_counts[k] = 0


def _library():
    global _lib
    if _lib is None:
        lib = load("decode_attn")
        vp, ci, cf = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.decode_attn_launch.argtypes = [vp] * 7 + [ci] * 11 + [cf, vp]
        lib.decode_attn_launch.restype = ci
        _lib = lib
    return _lib


def split_plan(n_groups: int, lo: int, hi: int, n_sm: int = 132):
    """``(rows_per_split, nsplit)``: rows ``lo..hi`` of each of ``n_groups``
    (b, kv head) groups cut into runs of a multiple of ``TILE`` rows, so that
    about ``_CTAS_PER_SM * n_sm`` blocks run in all. Every run holds at least
    one row; together they cover ``lo..hi`` exactly."""
    n_valid = hi - lo + 1
    want = max(1, -(-_CTAS_PER_SM * n_sm // n_groups))
    rows = -(-n_valid // want)
    rows = max(TILE, -(-rows // TILE) * TILE)
    return rows, -(-n_valid // rows)


def _sms(device: torch.device) -> int:
    idx = device.index if device.index is not None else torch.cuda.current_device()
    if idx not in _sm_count:
        _sm_count[idx] = torch.cuda.get_device_properties(idx).multi_processor_count
    return _sm_count[idx]


def _need(t: torch.Tensor, name: str, dtypes, ndim: int) -> None:
    if not t.is_cuda or t.dtype not in dtypes or t.ndim != ndim \
            or not t.is_contiguous() or t.data_ptr() % 16:
        raise ValueError(
            f"{name}: need a contiguous, 16-byte aligned CUDA tensor of "
            f"{ndim} dims in {[str(d) for d in dtypes]}, got {t.dtype} "
            f"{tuple(t.shape)} on {t.device}, contiguous={t.is_contiguous()}")


_FLOATS = (torch.float32, torch.bfloat16)


def decode_attn_cuda(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, pos: int, window: int = 0):
    """One token's attention on the card (``ref.decode_attn_ref`` is the
    same function): rows ``t <= pos`` (and ``t > pos - window`` if
    ``window > 0``) of the caches; output in ``q.dtype``."""
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
    pos, window = int(pos), int(window)
    lo, hi = valid_rows(s, pos, window)
    g = h // kv
    rows, nsplit = split_plan(b * kv, lo, hi, _sms(q.device))
    out = torch.empty_like(q)
    part_m = torch.empty((b * kv, nsplit, g), dtype=torch.float32,
                         device=q.device)
    part_l = torch.empty_like(part_m)
    part_acc = torch.empty((b * kv, nsplit, g, dh), dtype=torch.float32,
                           device=q.device)
    with torch.cuda.device(q.device):
        code = _library().decode_attn_launch(
            q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
            out.data_ptr(), part_m.data_ptr(), part_l.data_ptr(),
            part_acc.data_ptr(), b, s, kv, g, dh, lo, hi, rows, nsplit,
            int(q.dtype == torch.bfloat16),
            int(k_cache.dtype == torch.bfloat16), 1.0 / math.sqrt(dh),
            torch.cuda.current_stream().cuda_stream)
    check("decode_attn", code, "decode_attn_launch")
    launch_counts["decode_attn"] += 1
    return out

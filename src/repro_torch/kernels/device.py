"""What the kernels' wrappers keep for each card: its number of SMs (their
plans fill one wave), and the int32 counters on which the last block of a
group finds out that it is last (decode attention, K5; the block-quantized
fusion, K4).

One counter tensor is kept for each device and stream, so that two streams
never share one. It is zeroed once, when it is allocated, and every kernel
that counts on it leaves it zero again; so kernels on one stream can take
turns with it, as the stream orders them.
"""
from __future__ import annotations

import torch

__all__ = ["counters_for", "sm_count"]

_counters: dict = {}
_sm_count: dict = {}


def sm_count(dev: torch.device) -> int:
    """Streaming multiprocessors of the card ``dev`` (asked once a card)."""
    idx = dev.index if dev.index is not None else torch.cuda.current_device()
    if idx not in _sm_count:
        _sm_count[idx] = torch.cuda.get_device_properties(
            idx).multi_processor_count
    return _sm_count[idx]


def counters_for(dev: torch.device, n: int) -> torch.Tensor:
    """The int32 counters of the current stream on ``dev``, at least ``n``:
    zeroed when allocated; the kernels leave them zero."""
    stream = torch.cuda.current_stream(dev).cuda_stream
    key = (dev.index, stream)
    cnt = _counters.get(key)
    if cnt is None or cnt.numel() < n:
        size = n if cnt is None else max(n, 2 * cnt.numel())
        cnt = _counters[key] = torch.zeros(size, dtype=torch.int32,
                                           device=dev)
    return cnt

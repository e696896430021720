"""Device-resident operand cache for the serving hot path (the JAX
package's ``repro.serving.operand_cache`` on torch tensors; its DESIGN.md
§9).

CS workloads reuse sensing matrices heavily — a stream of requests over
the same A differs only in y (and schedule). Without this cache the
service would re-pad and re-upload O(B*P*M*N) operand bytes per flush;
with it, each distinct A is split/padded/cast/copied to the device **once
per (bucket shape, layout, dtype)** and the per-flush batch assembly is a
``torch.stack`` on the device over resident shards. The cached tensors
live on the service's device only: no host copy stays behind them.

Identity is content, not object: ``fingerprint`` hashes the full A
buffer (blake2b), so in-place mutation of a caller's array is a cache
*miss*, never a stale hit. Callers that manage matrix identity
themselves (a sensing-matrix registry) can skip hashing by passing a
stable ``a_id`` on the request — that is the "id" half of the
fingerprint; the content hash is the default.

Eviction is plain LRU under a byte budget, newest entry always kept
(a single over-budget entry still serves its own stream; it just evicts
everything else). Hit/miss/evict counters feed ``SolveService.stats()``.

Cached values are read, never written: the engine and the service treat
them as inputs only.
"""
from __future__ import annotations

import hashlib
from collections import OrderedDict

import numpy as np
import torch

__all__ = ["OperandCache", "fingerprint"]


def fingerprint(arr) -> tuple:
    """Content fingerprint of an operand array: (shape, dtype, blake2b).

    Hashes the full buffer so mutated arrays never alias a cached entry;
    at ~1 GB/s this is noise next to the pad+upload it saves (a bench-
    scale 64x128 f32 A hashes in ~10us).
    """
    a = np.asarray(arr)
    if not a.flags.c_contiguous:
        a = np.ascontiguousarray(a)
    digest = hashlib.blake2b(a, digest_size=16).hexdigest()
    return (a.shape, str(a.dtype), digest)


def _nbytes(value) -> int:
    """Bytes of a tensor, or of the tensors of a (nested) tuple or list."""
    if isinstance(value, torch.Tensor):
        return value.numel() * value.element_size()
    return sum(_nbytes(v) for v in value)


class OperandCache:
    """LRU map fingerprint-key -> device-resident operand (a tensor or a
    tuple of them), bounded by a byte budget."""

    def __init__(self, max_bytes: int = 256 << 20):
        self.max_bytes = int(max_bytes)
        self.hits = 0
        self.misses = 0
        self.evictions = 0
        self._entries: "OrderedDict[tuple, tuple]" = OrderedDict()
        self._bytes = 0
        # counter snapshot taken at the last clear(): stats()'s
        # ``since_clear`` numbers describe the post-clear stream only
        self._cleared_at = (0, 0, 0)

    def __len__(self) -> int:
        return len(self._entries)

    def __contains__(self, key) -> bool:
        return key in self._entries

    @property
    def nbytes(self) -> int:
        return self._bytes

    def get(self, key: tuple, build):
        """Return the cached value for ``key``, building (and admitting)
        it via ``build()`` on a miss. A dropped entry's memory returns to
        PyTorch's caching allocator once nothing references the tensor;
        work already queued on its stream keeps it alive until it ran."""
        entry = self._entries.get(key)
        if entry is not None:
            self._entries.move_to_end(key)
            self.hits += 1
            return entry[0]
        self.misses += 1
        value = build()
        nb = _nbytes(value)
        self._entries[key] = (value, nb)
        self._bytes += nb
        while self._bytes > self.max_bytes and len(self._entries) > 1:
            _, (_, old_nb) = self._entries.popitem(last=False)
            self._bytes -= old_nb
            self.evictions += 1
        return value

    def clear(self, reset_stats: bool = False) -> None:
        """Drop every entry. With ``reset_stats`` the hit/miss/eviction
        counters restart too, so subsequent ``stats()`` rates describe the
        post-clear stream instead of blending in the discarded one; the
        default preserves the historical lifetime counters."""
        self._entries.clear()
        self._bytes = 0
        if reset_stats:
            self.hits = 0
            self.misses = 0
            self.evictions = 0
        self._cleared_at = (self.hits, self.misses, self.evictions)

    def stats(self) -> dict:
        """Lifetime counters at the top level (stable consumers key on
        them), plus ``since_clear`` deltas relative to the last ``clear``
        — equal to the lifetime numbers when never cleared."""
        h0, m0, e0 = self._cleared_at
        return {
            "hits": self.hits,
            "misses": self.misses,
            "evictions": self.evictions,
            "entries": len(self._entries),
            "bytes": self._bytes,
            "max_bytes": self.max_bytes,
            "since_clear": {
                "hits": self.hits - h0,
                "misses": self.misses - m0,
                "evictions": self.evictions - e0,
            },
        }

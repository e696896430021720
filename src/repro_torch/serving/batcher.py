"""Continuous batching: group submitted requests by bucket, dispatch full
batches eagerly, flush stragglers on demand (the JAX package's
``repro.serving.batcher``, pure Python, kept as it is; its DESIGN.md §5).

The batcher owns no compute — it only decides *which* requests form the
next ``solve_het`` call. A group dispatches as soon as it reaches
``policy.max_batch`` (so a steady stream of same-bucket requests runs at
the full batch width without waiting for a flush), and ``drain`` hands
back whatever is left, largest groups first (they amortize best).

Demand accounting (DESIGN.md §11): every admission bumps two per-bucket
counters — a *lifetime* total (``demand()``, the prewarm-menu signal) and
a *window* counter (``take_demand()``, deltas since the previous take).
The window is what the cluster autoscaler scrapes: successive takes
partition the admission stream, so EWMA rates built from them never
double- or under-count a request. ``clear_demand()`` resets the window
mark without rewriting history (the ``OperandCache.clear``/``since_clear``
idiom); with ``lifetime=True`` it also zeroes the lifetime totals.
All entry points are thread-safe — admission may run concurrently with a
scrape (frontend thread vs. autoscaler tick).
"""
from __future__ import annotations

import threading
from collections import OrderedDict

from .buckets import BucketKey, BucketPolicy

__all__ = ["Batcher"]


class Batcher:
    def __init__(self, policy: BucketPolicy):
        self.policy = policy
        # insertion-ordered so flush keeps request arrival order stable
        # within a bucket
        self._groups: "OrderedDict[BucketKey, list]" = OrderedDict()
        # lifetime per-bucket admission counts — the demand signal the
        # prewarm menu (and the elastic replica scaling) reads
        self._demand: dict[BucketKey, int] = {}
        # lifetime counts at the last take_demand()/clear_demand(): the
        # window delta is lifetime - mark
        self._mark: dict[BucketKey, int] = {}
        # admission vs. demand-scrape threads (frontend / autoscaler)
        self._lock = threading.Lock()

    def __len__(self) -> int:
        with self._lock:
            return sum(len(g) for g in self._groups.values())

    def demand(self) -> dict:
        """Lifetime requests ever admitted per bucket (not reset by
        drain; ``clear_demand(lifetime=True)`` restarts it)."""
        with self._lock:
            return dict(self._demand)

    def take_demand(self) -> dict:
        """Per-bucket admissions since the previous ``take_demand`` (or
        ``clear_demand``), then advance the mark — successive takes
        partition the admission stream, so a rate built from them counts
        every request exactly once. Buckets with a zero delta are
        omitted."""
        with self._lock:
            out = {}
            for key, total in self._demand.items():
                delta = total - self._mark.get(key, 0)
                if delta:
                    out[key] = delta
                self._mark[key] = total
            return out

    def clear_demand(self, lifetime: bool = False) -> None:
        """Reset the ``take_demand`` window (the next take describes only
        post-clear admissions). With ``lifetime=True`` the historical
        totals restart too — ``demand()`` then reports the post-clear
        stream only."""
        with self._lock:
            if lifetime:
                self._demand.clear()
                self._mark.clear()
            else:
                self._mark = dict(self._demand)

    def add(self, key: BucketKey, req):
        """Queue one request; returns (key, batch) if its group is now full,
        else None."""
        with self._lock:
            self._demand[key] = self._demand.get(key, 0) + 1
            group = self._groups.setdefault(key, [])
            group.append(req)
            if len(group) >= self.policy.max_batch:
                del self._groups[key]
                return key, group
        return None

    def drain(self):
        """Yield all remaining (key, batch) groups, largest first."""
        with self._lock:
            groups = sorted(self._groups.items(), key=lambda kv: -len(kv[1]))
            self._groups.clear()
        yield from groups

"""Deterministic synthetic LM data (the port of the JAX package's
``data/pipeline.py``).

A reproducible token stream: each row of the global batch at a step is
drawn from numpy's generator seeded by (seed, step, row), independent of
step order and of which rank draws it, so a restarted job or another
slicing of the batch regenerates the same tokens bit for bit (the
reference's numbers exactly: ``_philox_tokens`` is its function). Each rank
materialises only its rows of the global batch, the batch's logical axis
"batch" sharded over the rules' axes (the data axes "pod" x "data", and
"model" too under 'fsdp') as the reference's ``make_global_batch`` places
it, and gets (tokens, labels) next-token pairs
on its device.

The stream is Zipf-distributed over the vocab with a short Markov flavor,
so losses decrease meaningfully (uniform tokens give a flat loss at log V).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..sharding import logical_spec

__all__ = ["SyntheticLMData", "batch_rows"]


def _philox_tokens(seed: int, step: int, lo: int, hi: int, seq: int,
                   vocab: int):
    """Deterministic tokens for rows [lo, hi) of the global batch."""
    out = np.empty((hi - lo, seq), np.int32)
    for r in range(lo, hi):
        rng = np.random.default_rng(np.random.SeedSequence([seed, step, r]))
        base = rng.zipf(1.3, size=seq).astype(np.int64)
        tok = (base - 1) % vocab
        stay = rng.random(seq) < 0.3
        tok = np.where(stay, np.roll(tok, 1), tok)
        out[r - lo] = tok.astype(np.int32)
    return out


def batch_rows(global_batch: int, mesh,
               batch_axes: tuple | None = None) -> tuple[int, int]:
    """The rows [lo, hi) of a global batch that this rank of ``mesh``
    (``launch/mesh.py::GridMesh``) holds: the batch split over
    ``batch_axes`` (the rules' "batch"; by default the data axes, as under
    'tp' and 'tp_sp', where the "model" ranks of one data coordinate hold
    the same rows; 'fsdp' adds "model"), row-major, or whole where their
    size does not divide it."""
    if batch_axes is None:
        batch_axes = tuple(a for a in ("pod", "data") if a in mesh.shape)
    spec = logical_spec(("batch",), (global_batch,), mesh.shape,
                        {"batch": tuple(batch_axes) or None})
    if spec[0] is None:
        return 0, global_batch
    n = global_batch // mesh.axes_size(batch_axes)
    i = mesh.axes_index(batch_axes)
    return i * n, (i + 1) * n


@dataclasses.dataclass
class SyntheticLMData:
    vocab: int
    seq_len: int
    global_batch: int
    seed: int = 0

    def batch_np(self, step: int, lo: int = 0, hi: int | None = None):
        """Rows [lo, hi) of the global batch at ``step`` (+1 token for
        labels)."""
        hi = self.global_batch if hi is None else hi
        return _philox_tokens(self.seed, step, lo, hi, self.seq_len + 1,
                              self.vocab)

    def global_arrays(self, step: int, mesh, batch_axes: tuple | None = None):
        """This rank's rows (``batch_rows``) of (tokens, labels) at
        ``step``: int32 (rows, seq_len) each, on the rank's device."""
        lo, hi = batch_rows(self.global_batch, mesh, batch_axes)
        rows = torch.from_numpy(self.batch_np(step, lo, hi))
        rows = rows.to(mesh.device)
        return rows[:, :-1].contiguous(), rows[:, 1:].contiguous()

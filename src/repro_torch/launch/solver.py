"""Mesh-distributed MP-AMP solver (the port of the JAX package's
``launch/solver.py``): the paper's processors are the ranks of a
``torch.distributed`` mesh (``launch/mesh.py``).

Processors = the mesh's ``"data"`` axis, one a rank (the quantization
analysis depends on P only through P * sigma_Q^2, which the transports
account at run time). The fusion sum f_t = sum_p Q(f_t^p) is a
``compressed_psum`` over the mesh (int8 / packed int4 on the wire) or, with
``bits=None``, an exact ``psum``.

A thin frontend over ``AmpEngine.solve_sharded``: every rank calls
``solve`` with the whole problem and gets the same result; the iteration
loop is the engine's, with no host synchronisation inside it under NCCL.

Straggler mitigation: ``drop_rate`` simulates P' < P responsive processors
an iteration; the transport rescales f = (P / P') * sum of the responsive
f^p, an unbiased estimate whose extra noise the modified SE absorbs like
quantization noise. The schedule is drawn on the host from the solve's
``key`` (a seed), the same on every rank, shard 0 always responsive.

The reference's ``use_kernel`` has no counterpart: the device decides.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from ..core.denoisers import BernoulliGauss
from ..core.engine import (AmpEngine, ColumnPartition, CompressedPsumTransport,
                           EngineConfig, PsumFusion, RowPartition)

__all__ = ["DistributedMPAMP", "SolverConfig"]


@dataclasses.dataclass(frozen=True)
class SolverConfig:
    n_iter: int = 15              # iterations (row) / outer rounds (col)
    bits: int | None = 8          # None = exact (float32) fusion
    block: int = 512
    drop_rate: float = 0.0        # simulated straggler drop fraction
    layout: str = "row"           # "row" | "col" (C-MP-AMP)
    n_inner: int = 1              # col: local AMP iterations per fusion


class DistributedMPAMP:
    """Partitioned AMP over the mesh: row-wise (the source paper, fusion =
    compressed psum of denoiser messages) or column-wise (C-MP-AMP, fusion
    = compressed psum of length-M residual contributions)."""

    def __init__(self, mesh, prior: BernoulliGauss, cfg: SolverConfig):
        self.mesh = mesh
        self.prior = prior
        self.cfg = cfg
        self.n_proc = mesh.shape["data"]
        if cfg.layout not in ("row", "col"):
            raise ValueError(f"layout {cfg.layout!r}: 'row' or 'col'")
        if cfg.layout == "col":
            if cfg.drop_rate != 0.0:
                raise ValueError(
                    "straggler drop does not apply to the column layout (a "
                    "dropped shard removes its signal block, not noise)")
            layout = ColumnPartition(n_inner=cfg.n_inner)
        else:
            layout = RowPartition()
        if cfg.bits is not None:
            transport = CompressedPsumTransport(bits=cfg.bits, block=cfg.block)
        else:
            transport = PsumFusion()
        self._engine = AmpEngine(
            prior,
            EngineConfig(n_proc=self.n_proc, n_iter=cfg.n_iter,
                         collect_symbols=False, collect_xs=False,
                         layout=layout, device=str(mesh.device)),
            transport)

    def _drop_sched(self, key) -> np.ndarray | None:
        if self.cfg.layout == "col":
            return None
        p = self.n_proc
        drop = np.zeros((self.cfg.n_iter, p), np.float32)
        if self.cfg.drop_rate > 0:
            rng = np.random.default_rng(0 if key is None else key)
            drop = (rng.random((self.cfg.n_iter, p))
                    < self.cfg.drop_rate).astype(np.float32)
            drop[:, 0] = 0.0  # shard 0 always responsive
        return drop

    def solve(self, a_mat: np.ndarray, y: np.ndarray, key=None):
        """Run n_iter iterations. Returns (x, per-iter sigma2_hat, noise)."""
        tr = self._engine.solve_sharded(y, a_mat, self.mesh,
                                        drop_sched=self._drop_sched(key))
        return tr.x, tr.sigma2_hat, tr.extra_var

"""Unified MP-AMP engine, row and column layouts (the counterpart of the JAX
package's ``repro.core.engine``; its DESIGN.md §3 and §7 describe the
structure).

The paper's algorithm family — centralized AMP, lossless MP-AMP, ECSQ
MP-AMP with fixed / DP / BT rate schedules — is one iteration body
parameterized by

  * a **Transport**: how the per-processor fusion messages f_t^p are
    compressed before the sum at the fusion center
    (``ExactFusion`` | ``EcsqTransport`` | ``BlockQuantTransport``), and
  * a **RateController**: how the quantizer resolution is chosen per
    iteration (``FixedSchedule`` | ``DPSchedule`` | ``BTRateControl``; in
    the column layout ``ColDPSchedule`` | ``ColumnBTRateControl``).

``EngineConfig.layout`` picks the partition: ``RowPartition`` (the paper's:
each processor owns M/P rows and sends a length-N message) or
``ColumnPartition`` (C-MP-AMP: each processor owns N/P columns and sends its
length-M residual contribution A_p x_p; ``n_inner`` local iterations per
fusion round).

``AmpEngine.solve`` runs the T iterations as a Python loop of tensor ops on
``EngineConfig.device`` with **no host synchronisation inside the loop**:
schedules and BT tables are device tensors, the BT back-tracking rule is a
fixed count of tensor ops (``bt_delta_for``), lossless iterations are a
``torch.where`` and not a branch, and the per-iteration record is written in
place into preallocated device tensors that come to numpy once, at exit.
``solve_many`` solves B instances at once with an explicit leading batch
dimension on every operand (A per instance or shared). The local
computation goes through ``kernels/amp_fused`` and the block quantizer
through ``kernels/quantize`` — the hand-written CUDA kernels when the
tensors are on the card, their plain versions on the CPU; the device alone
decides. ``solve_host_loop`` (row layout only) is the one entry point that
synchronises every iteration, by design: it serves arbitrary Python
rate-controller callables.

``solve_het`` solves a heterogeneous batch (the solve service's path): B
padded instances with their own prior, measurement count, real columns,
iteration budget and rate policy (``HetParams``, tensors with a leading B
axis), each frozen once its own budget is spent, with no host sync in the
loop either.

What the JAX engine has and this one does not: an ahead-of-time executable
cache (``_run``, ``lower_het``, ``compile_het``) — eager PyTorch compiles
nothing; ``compile_count`` counts the distinct programs (entry point,
operand shapes, BT or not) an engine has run, the serving layer's
warm-start signal — the ``use_kernel`` / ``kernel_interpret`` / ``donate``
switches.

Device-sharded solves (the reference's DESIGN.md §6): ``solve_sharded``,
``dispatch_sharded`` / ``solve_sharded_het`` run the same bodies on every
rank of a ``torch.distributed`` mesh (``launch/mesh.py::Mesh``), each rank
on its contiguous P/D processors (row shards, or column blocks), with a
device-collective transport (``PsumFusion``, ``CompressedPsumTransport``)
as the fusion and the plug-in's sum of squares, the column layout's
boundary terms and its estimate gathered by the collectives of
``core/collectives.py``. Every rank returns the same trace.

Erasure (the reference's DESIGN.md §10): ``solve(y, a, drop_sched=)`` and
``HetParams.drop`` take a (T, P) mask of lost fusion packets (1 = lost,
``ErasureSpec.sample_mask`` draws one). The row layout rescales the
survivors (``_erasure_rescale``); the column layout resets the erased
signal blocks instead. ``drop=None`` runs the drop-free code unchanged,
and an all-zero mask gives its bits: every erasure factor is then an exact
multiplication by 1.0.
"""
from __future__ import annotations

import dataclasses
import math
import threading
from typing import NamedTuple, Protocol, runtime_checkable

import numpy as np
import torch

from ..kernels.amp_fused.ops import (amp_local_grid, col_inner_step,
                                     col_params, col_residual,
                                     pad_col_shards, pad_row_shards)
from ..kernels.quantize.ops import block_quant_fuse
from .collectives import all_gather, pmean, psum
from .compression import QuantConfig, compressed_psum
from .denoisers import (BernoulliGauss, eta_and_deriv, eta_bg_and_deriv,
                        make_mmse_interp)
from .quantize import (GaussMixture, dequantize_midtread, ecsq_entropy,
                       message_mixture, quantize_midtread)
from .rate_alloc import (BTController, col_sigma_q2_for_rate,
                         erasure_rate_factors, rate_for_sigma_q2)
from .rate_distortion import RDModel
from .state_evolution import CSProblem, se_trajectory_col

__all__ = [
    "AmpEngine", "EngineConfig", "EngineTrace", "ErasureSpec", "RowPartition",
    "ColumnPartition", "Transport", "ExactFusion", "EcsqTransport",
    "BlockQuantTransport", "RateController", "FixedSchedule", "DPSchedule",
    "BTRateControl", "BTTables", "bt_delta_for", "ColBTTables",
    "col_bt_delta_for", "ColumnBTRateControl", "ColDPSchedule", "interp",
    "amp_gc_step", "split_problem", "split_problem_cols", "to_f32",
    "HetParams", "stack_bt_tables", "pad_bt_tables", "PsumFusion",
    "CompressedPsumTransport", "rank_slice",
]


# ---------------------------------------------------------------------------
# shared iteration pieces
# ---------------------------------------------------------------------------

def split_problem(a_mat, y, n_proc: int):
    """Row-partition (A, y) across processors: (P, M/P, N), (P, M/P).
    Works on numpy arrays and torch tensors alike (a reshape, no copy)."""
    m, n = a_mat.shape
    assert m % n_proc == 0, f"M={m} not divisible by P={n_proc}"
    mp = m // n_proc
    return a_mat.reshape(n_proc, mp, n), y.reshape(n_proc, mp)


def split_problem_cols(a_mat, n_proc: int):
    """Column-partition A across processors: (..., M, N) -> (..., P, M, N/P).

    Processor p owns the contiguous column block ``A[:, p*N/P:(p+1)*N/P]``
    and the matching slice of the signal (C-MP-AMP); y is shared, not split.
    numpy arrays and torch tensors alike; the result is a contiguous copy.
    """
    *lead, m, n = a_mat.shape
    assert n % n_proc == 0, f"N={n} not divisible by P={n_proc}"
    blocks = a_mat.reshape(*lead, m, n_proc, n // n_proc)
    if isinstance(blocks, torch.Tensor):
        return blocks.movedim(-2, -3).contiguous()
    return np.ascontiguousarray(np.moveaxis(blocks, -2, -3))


def rank_slice(v, rank: int, size: int):
    """Rank ``rank``'s contiguous share of the leading (processor) axis of
    ``v`` over a mesh of ``size``, as ``PartitionSpec(axis, None, None)``
    places it: processors ``[rank * P / size, (rank + 1) * P / size)``.
    numpy arrays and tensors alike (a view)."""
    p = v.shape[0]
    if p % size:
        raise ValueError(f"P={p} is not a multiple of the mesh size {size}")
    k = p // size
    return v[rank * k:(rank + 1) * k]


def to_f32(v, device) -> torch.Tensor:
    """numpy array (or anything ``np.asarray`` takes) or tensor -> float32
    tensor on ``device``. A read-only or strided array is copied first."""
    if not isinstance(v, torch.Tensor):
        arr = np.asarray(v, dtype=np.float32)
        if not (arr.flags.writeable and arr.flags.c_contiguous):
            arr = np.array(arr, order="C")
        v = torch.from_numpy(arr)
    return v.to(device=device, dtype=torch.float32)


@dataclasses.dataclass(frozen=True)
class RowPartition:
    """The source paper's layout: each processor owns M/P measurement rows;
    the fusion sums the per-processor denoiser messages f^p (length N)."""


@dataclasses.dataclass(frozen=True)
class ColumnPartition:
    """C-MP-AMP layout (arXiv:1701.02578): each processor owns N/P signal
    columns; the fusion sums the quantized residual contributions A_p x_p
    (length M). ``EngineConfig.n_iter`` counts *outer rounds* (one fusion
    exchange each); every round runs ``n_inner`` local AMP iterations.

    The Onsager memory survives the fusion boundary: the next round's
    residual starts from ``g^{s+1} + sum_q c_q z_q^last``, where
    ``z_q^last`` is the residual that fed processor q's final denoise and
    ``c_q = sum(eta')/M`` its coefficient. At ``n_inner == 1`` every
    ``z_q^last`` is the previous fused residual, the correction collapses
    to ``(sum_q c_q) g^s`` and C-MP-AMP under exact fusion *is*
    centralized AMP; the engine then carries only that scalar. At
    ``n_inner > 1`` the correction is a second, uncompressed length-M
    exchange. (The reference's docstring and its DESIGN.md §7 give the
    derivation.)
    """

    n_inner: int = 1

    @property
    def carry_fused(self) -> bool:
        """Scalar-carry path: at one inner iteration per round the joint
        boundary correction is a scalar times the previous fused residual."""
        return self.n_inner == 1


def amp_gc_step(f, denoise_var, prior: BernoulliGauss, kappa):
    """GC tail shared by every frontend: denoise + Onsager coefficient.

    f (..., N); denoise_var (...,). The derivative is the closed form
    (``denoisers.eta_bg_and_deriv``)."""
    x_new, deriv = eta_and_deriv(f, denoise_var[..., None], prior)
    return x_new, deriv.mean(dim=-1) / kappa


# ---------------------------------------------------------------------------
# erasure (lossy-wire realism; the reference's DESIGN.md §10)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ErasureSpec:
    """Per-round, per-processor fusion-packet loss model.

    ``sample_mask`` draws the concrete (T, P) 0/1 drop schedule on the host
    with numpy, the reference's generator and draw order, so both packages
    draw the same bits from one seed; the engine takes it as an operand.

    ``bernoulli``: each packet lost i.i.d. with probability ``rate``.
    ``gilbert``: a two-state Gilbert-Elliott channel per processor; the bad
    state drops every packet, its mean sojourn is ``burst_len`` rounds, and
    the transition probabilities make the stationary loss probability
    ``rate`` (p_bg = 1/burst_len, p_gb = rate*p_bg/(1-rate), clipped to 1).
    Chains start in their stationary distribution.
    """

    rate: float = 0.0
    model: str = "bernoulli"          # "bernoulli" | "gilbert"
    burst_len: float = 4.0            # gilbert: mean bad-state rounds
    seed: int = 0

    def __post_init__(self):
        if not 0.0 <= self.rate < 1.0:
            raise ValueError(f"erasure rate {self.rate} not in [0, 1)")
        if self.model not in ("bernoulli", "gilbert"):
            raise ValueError(f"unknown erasure model {self.model!r}")
        if self.burst_len < 1.0:
            raise ValueError(f"burst_len {self.burst_len} < 1")

    def sample_mask(self, n_iter: int, n_proc: int,
                    seed: int | None = None) -> np.ndarray:
        """Draw a (n_iter, n_proc) float32 drop mask (1 = packet lost)."""
        rng = np.random.default_rng(self.seed if seed is None else seed)
        if self.rate == 0.0:
            return np.zeros((n_iter, n_proc), np.float32)
        if self.model == "bernoulli":
            return (rng.random((n_iter, n_proc))
                    < self.rate).astype(np.float32)
        p_bg = 1.0 / self.burst_len
        p_gb = min(self.rate * p_bg / (1.0 - self.rate), 1.0)
        bad = rng.random(n_proc) < self.rate
        mask = np.zeros((n_iter, n_proc), np.float32)
        for t in range(n_iter):
            mask[t] = bad
            flip = rng.random(n_proc)
            bad = np.where(bad, flip >= p_bg, flip < p_gb)
        return mask


def _per_proc(v, n_proc: int):
    """``n_proc`` as a tensor like ``v``: dividing by a tensor is the IEEE
    division (PyTorch on the card multiplies by the reciprocal of a Python
    number, which can miss P / P == 1.0)."""
    return torch.full_like(v, n_proc)


def _survivors(drop, n_proc: int):
    """``(keep, n_surv, scale)`` of a (..., P) 0/1 drop mask: keep =
    1 - drop, n_surv = max(sum keep, 1) (a sum of 0s and 1s, exact in any
    order) and the survivor rescale P / n_surv: exactly P and 1.0 when
    nothing is lost."""
    keep = 1.0 - drop
    n_surv = torch.clamp(keep.sum(-1), min=1.0)
    return keep, n_surv, _per_proc(n_surv, n_proc) / n_surv


def _erasure_rescale(f_q, drop):
    """Per-processor erasure of the row layout's fusion packets (the
    reference's ``_erasure_rescale``): ``drop`` (..., P) marks the lost
    packets of ``f_q`` (..., P, N); the survivors' sum is rescaled by
    P / n_surv, so the fusion stays an unbiased estimate of the full sum.
    Returns ``(f, amp)`` with ``amp = n_surv * scale^2 / P``, the factor on
    the drop-free noise account ``P * sigma_Q^2``: the reference's
    ``sigma_Q^2 * n_surv * scale^2`` with the factors arranged so that an
    all-survivor mask multiplies by exactly 1.0."""
    n_proc = f_q.shape[-2]
    keep, n_surv, scale = _survivors(drop, n_proc)
    f = torch.sum(f_q * keep[..., None], dim=-2) * scale[..., None]
    amp = n_surv * (scale * scale) / _per_proc(n_surv, n_proc)
    return f, amp


# ---------------------------------------------------------------------------
# transports
# ---------------------------------------------------------------------------

@runtime_checkable
class Transport(Protocol):
    """Fusion-message compression: (..., P, N) messages -> fused (..., N).

    ``fuse`` is plain tensor ops with no host sync and returns
    ``(f, extra_var, symbols)`` where ``extra_var`` (...,) is the additional
    denoiser variance injected by compression (the paper's P*sigma_Q^2
    accounting) and ``symbols`` the per-processor quantizer indices for
    empirical-rate accounting (all-zeros when not applicable). ``delta``
    (...,) is the bin size, one per batch entry. ``symbols=False`` says
    that the caller will not read the symbols: a transport may then return
    None in their place and skip making them. ``drop`` (..., P) is the
    erasure mask of this round's packets (``_erasure_rescale``); None runs
    the drop-free code.
    """

    def fuse(self, f_p, delta, symbols=True, drop=None): ...  # pragma: no cover - protocol


@dataclasses.dataclass(frozen=True)
class ExactFusion:
    """Lossless fusion (centralized AMP / the paper's 32-bit baseline)."""

    def fuse(self, f_p, delta, symbols=True, drop=None):
        if drop is None:
            f = torch.sum(f_p, dim=-2)
        else:
            f, _ = _erasure_rescale(f_p, drop)
        return (f, f.new_zeros(f.shape[:-1]),
                torch.zeros_like(f_p) if symbols else None)


@dataclasses.dataclass(frozen=True)
class EcsqTransport:
    """Midtread uniform quantizer per message (paper Sec. 3.2).

    ``delta`` is the bin size chosen by the rate controller; non-finite
    delta means lossless fusion at that iteration. Rate accounting is the
    ECSQ entropy H_Q (analytic) plus the empirical entropy of ``symbols``
    — both computed by the frontends from the returned trace.
    """

    def fuse(self, f_p, delta, symbols=True, drop=None):
        n_proc = f_p.shape[-2]
        lossless = ~torch.isfinite(delta)
        safe_delta = torch.where(lossless, 1.0, delta)
        sd = safe_delta[..., None, None]
        q = quantize_midtread(f_p, sd)
        f_q = torch.where(lossless[..., None, None], f_p,
                          dequantize_midtread(q, sd))
        extra = torch.where(lossless, 0.0, n_proc * safe_delta**2 / 12.0)
        if drop is None:
            return torch.sum(f_q, dim=-2), extra, q
        f, amp = _erasure_rescale(f_q, drop)
        return f, extra * amp, q


@dataclasses.dataclass(frozen=True)
class BlockQuantTransport:
    """Per-block max-abs int8/int4 quantization of each message (the wire
    format of ``core/compression.py``), dequantized and summed over P: on
    the card one launch of the fused block-quantize kernel
    (``kernels/quantize/ops.py::block_quant_fuse``) and nothing else.

    The rate is fixed by the wire width (``bits`` + a bf16 scale per block)
    instead of a controller, so ``delta`` is ignored; the noise accounting
    uses the realized per-block bin sizes: ``extra = P * mean(Delta^2)/12``,
    the mean over the P x blocks of each batch entry. Symbols are the int
    codes as float32, shaped like the messages (None with
    ``symbols=False``). The int4 codes travel unpacked here: this transport
    emulates the wire, it does not pack. Under erasure the same launch
    takes the keep row of each batch entry and returns the survivors' sum
    rescaled by P / n_surv and ``extra = mean(Delta^2)/12 * n_surv *
    scale^2``, the mean still over every processor's blocks.
    """

    bits: int = 8
    block: int = 512

    @property
    def qc(self) -> QuantConfig:
        return QuantConfig(bits=self.bits, block=self.block)

    def fuse(self, f_p, delta, symbols=True, drop=None):
        lead, (n_proc, length) = f_p.shape[:-2], f_p.shape[-2:]
        keep = None
        if drop is not None:
            keep = (1.0 - drop).contiguous()
            if keep.ndim > 1:
                keep = keep.reshape(-1, n_proc)
        f, extra, syms = block_quant_fuse(f_p.reshape(-1, n_proc, length),
                                          self.qc.qmax, self.block, symbols,
                                          keep=keep)
        return (f.reshape(lead + (length,)), extra.reshape(lead),
                None if syms is None else syms.reshape(f_p.shape))


# -- device-collective transports (run on every rank of a mesh) ------------

def _drop_rescale(f_local, drop, mesh):
    """Straggler mitigation of the device transports: zero this rank's
    summand when ``drop`` (this rank's flag, shaped like ``f_local``'s
    leading axes) is set and rescale the survivors by D / n_keep, so the
    fusion stays an unbiased estimate of the full sum. Returns ``(rescaled,
    keep, scale)`` for the callers' noise accounts. With no rank dropped,
    ``scale`` is exactly 1.0 (D / D, a division by a tensor)."""
    keep = 1.0 - drop
    kept = torch.clamp(psum(keep, mesh), min=1.0)
    scale = _per_proc(kept, mesh.size) / kept
    return f_local * keep[..., None] * scale[..., None], keep, scale


@dataclasses.dataclass(frozen=True)
class PsumFusion:
    """Exact-wire fusion over a mesh: each rank sums its P/D messages
    locally (through an emulated per-processor ``local`` transport, e.g.
    ``EcsqTransport`` for the paper's quantize-at-each-processor scenario)
    and the partial sums are ``psum``'d over the mesh.

    ``fuse`` always takes ``drop``, this rank's straggler flag for the
    iteration (zeros when there is none), and the mesh. The local accounts
    saw only this rank's processors: their ``psum`` is the paper's global
    P * sigma_Q^2; under a straggler rescale the survivors' noise is
    amplified by scale^2, dropped ranks contribute none."""

    local: Transport = dataclasses.field(default_factory=ExactFusion)

    def fuse(self, f_p, delta, drop, mesh):
        f_loc, extra_loc, _ = self.local.fuse(f_p, delta, symbols=False)
        f_loc, keep, scale = _drop_rescale(f_loc, drop, mesh)
        f = psum(f_loc, mesh)
        extra = psum(extra_loc * keep, mesh) * (scale * scale)
        return f, extra, None


@dataclasses.dataclass(frozen=True)
class CompressedPsumTransport:
    """Lossy-compressed wire fusion: the sum over the mesh itself runs as
    the two-phase int8/int4 ``compressed_psum`` (``core/compression.py``),
    whose wire carries uint8 payloads: 4x / 8x fewer symbol bytes than a
    float32 all-reduce. The straggler rescale comes first, so the noise
    measured from the realized scales includes it; each rank's account is
    averaged over the mesh (``pmean``), a value every rank shares. One
    instance a call (its messages are quantized as one flat vector)."""

    bits: int = 8
    block: int = 512

    @property
    def qc(self) -> QuantConfig:
        return QuantConfig(bits=self.bits, block=self.block)

    def fuse(self, f_p, delta, drop, mesh):
        f_loc, _, _ = _drop_rescale(torch.sum(f_p, dim=-2), drop, mesh)
        f, noise = compressed_psum(f_loc, mesh, self.qc)
        return f, pmean(noise, mesh).expand(f.shape[:-1]), None


# the transports whose ``fuse`` is a collective over a mesh: only the
# sharded entry points run them, the emulated ones refuse them
_COLLECTIVE_TRANSPORTS = (PsumFusion, CompressedPsumTransport)


# ---------------------------------------------------------------------------
# rate controllers
# ---------------------------------------------------------------------------

@runtime_checkable
class RateController(Protocol):
    """Chooses the quantizer bin size for iteration ``t``.

    ``delta_for`` is plain tensor ops with no host sync; it receives the
    iteration index (a Python int) and the post-LC plug-in estimate
    sigma_hat_{t,D}^2 (a tensor, () or (B,)) and returns
    ``(delta, rate_bits)`` (rate = +inf when the controller does not track
    a coding rate, e.g. fixed schedules whose H_Q is computed offline).
    """

    n_iter: int

    def delta_for(self, t, sigma2_hat): ...  # pragma: no cover - protocol


class FixedSchedule:
    """Predetermined per-iteration bin sizes (np.inf = lossless)."""

    def __init__(self, deltas):
        self.deltas = np.asarray(deltas, np.float32)
        self.n_iter = len(self.deltas)

    def delta_for(self, t, sigma2_hat):
        inf = torch.full_like(sigma2_hat, math.inf)
        return torch.full_like(sigma2_hat, float(self.deltas[t])), inf


class DPSchedule(FixedSchedule):
    """Offline-optimal DP allocation realized as ECSQ bin sizes.

    Converts a ``dp_allocate`` result to the bin sizes hitting the DP's
    predicted per-iteration distortions (paper's "+0.255 bits" ECSQ
    implementation).
    """

    def __init__(self, dp_result, rd: RDModel, n_proc: int):
        sq2 = np.maximum(
            rd.distortion_msg(dp_result.rates, dp_result.sigma2_d[:-1],
                              n_proc), 1e-30)
        super().__init__(np.sqrt(12.0 * sq2))
        self.rates = np.asarray(dp_result.rates)
        self.sigma2_d = np.asarray(dp_result.sigma2_d)

    @classmethod
    def from_arrays(cls, deltas, rates, sigma2_d) -> "DPSchedule":
        """Rebuild from a finished schedule's arrays (``convert.py``)."""
        self = cls.__new__(cls)
        FixedSchedule.__init__(self, deltas)
        self.rates = np.asarray(rates)
        self.sigma2_d = np.asarray(sigma2_d)
        return self


class BTTables(NamedTuple):
    """The BT controller's state as a flat tuple of float32 tensors.

    Everything ``bt_delta_for`` needs — MMSE interpolation table, SE
    targets, rate table, r_max cap curve, and the scalar problem
    parameters (sigma_e2, kappa, prior, P) — lives here as tensors, so the
    decision runs on the device without asking the host anything.
    """

    log_v: torch.Tensor        # (400,) MMSE interp grid, log variance
    log_m: torch.Tensor        # (400,) log mmse values
    targets: torch.Tensor      # (T,) c_ratio * sigma_{t+1,C}^2
    log_s2_grid: torch.Tensor  # (n_s2,) rate-table axis 0
    log2u_grid: torch.Tensor   # (n_u,) rate-table axis 1
    gap_tab: torch.Tensor      # (n_s2, n_u) G = R + log2(u)
    cap_ls2: torch.Tensor      # (512,) cap curve axis
    cap_lsq2: torch.Tensor     # (512,) log sigma_Q^2 at r_max
    sigma_e2: torch.Tensor     # () problem scalars -------------------
    inv_kappa: torch.Tensor    # ()
    n_proc: torch.Tensor       # () float
    eps: torch.Tensor          # () prior
    mu_s: torch.Tensor         # ()
    sigma_s2: torch.Tensor     # ()
    r_max: torch.Tensor        # () delivered-rate cap (erasure-adjusted)
    amp: torch.Tensor          # () erasure survivor-rescale amplification
                               #    E[P/max(k,1)]; exactly 1.0 when lossless

    def to(self, device) -> "BTTables":
        return BTTables(*(f.to(device) for f in self))

    @classmethod
    def dummy(cls, n_iter: int, n_s2: int = 25, n_u: int = 61) -> "BTTables":
        """Benign finite tables for the non-BT instances of a mixed batch:
        where any instance uses BT, ``bt_delta_for`` runs for every
        instance and the non-BT ones' decisions are discarded through
        ``torch.where``, so their tables only have to give finite values.
        CPU tensors; the caller keeps them."""
        f = lambda v: torch.as_tensor(np.asarray(v, np.float32))
        lin = np.linspace(-20.0, 7.0, 400)
        return cls(
            log_v=f(lin), log_m=f(lin), targets=f(np.ones(n_iter)),
            log_s2_grid=f(np.linspace(-20.0, 2.0, n_s2)),
            log2u_grid=f(np.linspace(-12.0, 5.0, n_u)),
            gap_tab=f(np.ones((n_s2, n_u))),
            cap_ls2=f(np.linspace(-20.0, 2.0, 512)), cap_lsq2=f(np.zeros(512)),
            sigma_e2=f(1e-3), inv_kappa=f(1.0), n_proc=f(1.0), eps=f(0.1),
            mu_s=f(0.0), sigma_s2=f(1.0), r_max=f(6.0), amp=f(1.0))


def _search(knots, v, right: bool = False):
    """``torch.searchsorted`` over shared 1-D knots, or over (B, K) knots,
    one row per instance, with ``v`` (B, ...)."""
    if knots.ndim == 1:
        return torch.searchsorted(knots, v, right=right)
    lead = knots.shape[:-1]
    return torch.searchsorted(knots, v.reshape(lead + (-1,)),
                              right=right).reshape(v.shape)


def _take(table, i, batched: bool):
    """``table[i]`` without reading the index on the host: ``torch.take``
    on a shared table (flat offsets), ``take_along_dim`` on a stacked one
    (B, ...) with ``i`` (B, ...) offsets into each instance's own table.
    (Indexing with a 0-dim index tensor reads the index on the host, which
    would stall the solve loop.)"""
    if not batched:
        return torch.take(table, i)
    b = table.shape[0]
    return torch.take_along_dim(table.reshape(b, -1), i.reshape(b, -1),
                                dim=-1).reshape(i.shape)


def interp(x, xp, fp):
    """``numpy.interp`` on tensors: piecewise-linear through the knots
    (xp increasing, fp), constant beyond the ends. Shared 1-D knots take
    ``x`` of any shape; stacked (B, K) knots (one table per instance of a
    heterogeneous batch) take ``x`` (B, ...)."""
    batched = xp.ndim > 1
    x = torch.clamp(x, min=_first(xp, x), max=_last(xp, x))
    i = torch.clamp(_search(xp, x, right=True), 1, xp.shape[-1] - 1)
    x0, f0 = _take(xp, i - 1, batched), _take(fp, i - 1, batched)
    df = _take(fp, i, batched) - f0
    dx = _take(xp, i, batched) - x0
    return f0 + ((x - x0) / dx) * df


def _first(knots, v):
    """knots[0] (shared) or knots[:, 0] shaped against ``v`` (B, ...)."""
    k = knots[..., 0]
    return k.reshape(k.shape + (1,) * (v.ndim - k.ndim))


def _last(knots, v):
    k = knots[..., -1]
    return k.reshape(k.shape + (1,) * (v.ndim - k.ndim))


def _bt_mmse(tb: BTTables, v):
    lv = torch.clamp(torch.log(torch.clamp(v, min=1e-30)),
                     min=_first(tb.log_v, v), max=_last(tb.log_v, v))
    return torch.exp(interp(lv, tb.log_v, tb.log_m))


def _bt_predict_next(tb: BTTables, sigma2_d, sigma_q2):
    # tb.amp is exactly 1.0 on a lossless link, so the multiply is a
    # bit-exact no-op there (IEEE: 1.0 * x == x)
    eff = tb.amp * (sigma2_d + tb.n_proc * sigma_q2)
    return tb.sigma_e2 + _bt_mmse(tb, eff) * tb.inv_kappa


def _bt_msg_sd(tb: BTTables, sigma2_hat):
    """sqrt(Var F^p) for the message mixture, closed form, on the device."""
    p = tb.n_proc
    w1, mu1 = tb.eps, tb.mu_s / p
    var1 = (tb.sigma_s2 + p * sigma2_hat) / p**2
    var0 = sigma2_hat / p
    mean = w1 * mu1
    var = (w1 * (var1 + (mu1 - mean) ** 2)
           + (1.0 - w1) * (var0 + mean**2))
    return torch.sqrt(var)


def _bt_rate_lookup(tb: BTTables, sigma2_hat, sigma_q2):
    """R(s2, sigma_q2) = bilinear G(log s2, log2 u) - log2 u."""
    delta = torch.sqrt(12.0 * torch.clamp(sigma_q2, min=1e-30))
    lu = torch.log2(delta / _bt_msg_sd(tb, sigma2_hat))
    ls = torch.log(sigma2_hat)
    gi, gj = tb.log_s2_grid, tb.log2u_grid
    batched = gi.ndim > 1
    i = torch.clamp(_search(gi, ls) - 1, 0, gi.shape[-1] - 2)
    j = torch.clamp(_search(gj, lu) - 1, 0, gj.shape[-1] - 2)
    gi0, gj0 = _take(gi, i, batched), _take(gj, j, batched)
    wi = torch.clamp((ls - gi0) / (_take(gi, i + 1, batched) - gi0), 0.0, 1.0)
    wj = torch.clamp((lu - gj0) / (_take(gj, j + 1, batched) - gj0), 0.0, 1.0)
    # flat offsets into each (n_s2, n_u) table
    n_u = gj.shape[-1]
    flat = i * n_u + j
    t00 = _take(tb.gap_tab, flat, batched)
    t01 = _take(tb.gap_tab, flat + 1, batched)
    t10 = _take(tb.gap_tab, flat + n_u, batched)
    t11 = _take(tb.gap_tab, flat + n_u + 1, batched)
    gap = ((1 - wi) * ((1 - wj) * t00 + wj * t01)
           + wi * ((1 - wj) * t10 + wj * t11))
    return gap - torch.clamp(lu, min=_first(gj, lu), max=_last(gj, lu))


def _bt_cap_sq2(tb: BTTables, sigma2_hat):
    """sigma_Q^2 achieving rate r_max (dedicated dense 1D curve)."""
    ls = torch.clamp(torch.log(sigma2_hat), min=_first(tb.cap_ls2, sigma2_hat),
                     max=_last(tb.cap_ls2, sigma2_hat))
    return torch.exp(interp(ls, tb.cap_ls2, tb.cap_lsq2))


BT_GROW_STEPS = 30     # bracket growth: hi *= 4 while predicted < target
BT_BISECT_STEPS = 80   # bisection for the largest admissible sigma_Q^2


def bt_delta_for(tb: BTTables, t: int, sigma2_hat):
    """One BT decision on the device: (tables, t, sigma2_hat) -> (delta, rate).

    A fixed count of tensor ops — 30 bracket-growth steps and 80 bisection
    steps whatever the data — so nothing here reads a tensor's value on the
    host. ``sigma2_hat`` is () or (B,). The tables are shared (1-D
    knots, () scalars) or stacked, one set per instance of a heterogeneous
    batch (``stack_bt_tables``: a leading B axis on every field, with
    ``sigma2_hat`` (B,)); each instance then decides from its own tables,
    the same bits as a call with its tables alone.
    """
    sigma2_hat = torch.clamp(sigma2_hat, min=1e-30)
    target = tb.targets[..., t]
    base = _bt_predict_next(tb, sigma2_hat, 0.0)

    hi = sigma2_hat / tb.n_proc + 1e-12
    for _ in range(BT_GROW_STEPS):
        ok = (_bt_predict_next(tb, sigma2_hat, hi) < target) & (hi <= 1e6)
        hi = torch.where(ok, hi * 4.0, hi)

    lo = torch.zeros_like(hi)
    for _ in range(BT_BISECT_STEPS):
        mid = 0.5 * (lo + hi)
        ok = _bt_predict_next(tb, sigma2_hat, mid) <= target
        lo, hi = torch.where(ok, mid, lo), torch.where(ok, hi, mid)
    rate_bis = _bt_rate_lookup(tb, sigma2_hat, lo)

    sq2_cap = _bt_cap_sq2(tb, sigma2_hat)
    use_cap = (base >= target) | (rate_bis > tb.r_max)
    sq2 = torch.where(use_cap, sq2_cap, lo)
    rate = torch.where(use_cap, tb.r_max, rate_bis)
    return torch.sqrt(12.0 * sq2), rate


def stack_bt_tables(tables):
    """Stack per-instance ``BTTables`` (or ``ColBTTables``) into one tuple
    with a leading batch axis on every field, on the first one's device.
    Every entry needs the same ``targets`` length (``pad_bt_tables``) and
    grid sizes."""
    return type(tables[0])(*(torch.stack(fields) for fields in zip(*tables)))


def pad_bt_tables(tb, n_iter: int):
    """Extend (or cut) the SE target vector to ``n_iter`` (a bucket's
    T_max) by repeating the last target; iterations past the instance's
    ``t_active`` are frozen out, so the padding is never acted on."""
    cur = tb.targets.shape[0]
    if cur >= n_iter:
        return tb._replace(targets=tb.targets[:n_iter])
    pad = tb.targets[-1:].expand(n_iter - cur)
    return tb._replace(targets=torch.cat([tb.targets, pad]))


class _TablesOnDevice:
    """A controller whose tables are built on the host as CPU tensors
    (``self.tables``) and copied once to each device a solve runs on."""

    def tables_on(self, device):
        device = torch.device(device)
        tb = self._on_device.get(device)
        if tb is None:
            tb = self._on_device[device] = self.tables.to(device)
        return tb


class BTRateControl(_TablesOnDevice):
    """BT back-tracking (paper Sec. 3.3) as device tensor ops.

    Re-expresses ``rate_alloc.BTController`` as fixed-count loops:

      * the MMSE SE map is a log-log interpolation table (same 400-point
        grid as ``make_mmse_interp``),
      * the bracket-growth ``while`` and the 80-step bisection for the
        largest admissible sigma_Q^2 run a fixed number of steps,
      * the rate model (ECSQ entropy or RD function) is a bilinear table
        over (log sigma_t^2, log2 u), u = Delta/sd(F^p), built from the
        same ``rate_alloc`` helpers the host controller calls, with a
        fixed-count bisection for the r_max cap inversion.

    Tables are built once at construction (host side, numpy) into a
    ``BTTables`` of CPU tensors (``self.tables``) and copied to the solve's
    device on first use; the per-iteration decision then runs entirely on
    that device via ``bt_delta_for``.
    """

    def __init__(self, prob: CSProblem, n_proc: int, n_iter: int,
                 c_ratio: float = 1.05, r_max: float = 6.0,
                 rate_model: str = "ecsq", rd: RDModel | None = None,
                 mmse_fn=None, n_s2_grid: int = 25, n_u_grid: int = 61,
                 erasure_rate: float = 0.0, recovery: str = "retransmit"):
        host = BTController(prob, n_proc, n_iter, c_ratio, r_max,
                            rate_model, rd, mmse_fn,
                            erasure_rate=erasure_rate, recovery=recovery)
        self.host = host
        self.prob = prob
        self.n_proc = n_proc
        self.n_iter = n_iter
        self.c_ratio = c_ratio
        self.r_max = r_max
        self.erasure_rate = erasure_rate
        self.recovery = recovery
        # delivered-rate cap under the recovery policy (== r_max when
        # lossless); the tables work in delivered-rate space
        eff_r_max = host._r_cap

        # (1) MMSE interp table — same grid as make_mmse_interp, evaluated
        # through the host controller's own mmse_fn so both agree.
        grid_v = np.geomspace(1e-9, 1e3, 400)
        grid_m = np.maximum(np.asarray(host.mmse_fn(grid_v), np.float64),
                            1e-300)

        # (2) per-iteration targets c * sigma_{t+1,C}^2
        targets = c_ratio * host.sigma2_c[1:]

        # (3) rate table R(log s2, log2 u), u = Delta / sd(F^p | s2)
        s2_lo = max(prob.sigma_e2 * 1e-2, 1e-9)
        s2_hi = prob.sigma0_2 * 8.0
        s2_grid = np.geomspace(s2_lo, s2_hi, n_s2_grid)
        log2u_grid = np.linspace(-12.0, 5.0, n_u_grid)
        tab = np.empty((n_s2_grid, n_u_grid))
        sds = np.empty(n_s2_grid)
        for i, s2 in enumerate(s2_grid):
            sds[i] = math.sqrt(message_mixture(prob.prior, float(s2),
                                               n_proc).variance)
            for j, lu in enumerate(log2u_grid):
                delta = sds[i] * 2.0**lu
                tab[i, j] = rate_for_sigma_q2(delta**2 / 12.0, float(s2),
                                              prob, n_proc, host.rate_model,
                                              host.rd)
        # store the excess over the high-rate line, G = R + log2(u): G is
        # nearly flat where the quantizer is fine (R ~ h - log2 Delta), so
        # bilinear interpolation of G is far more accurate than of R itself
        gap_tab = tab + log2u_grid[None, :]

        # (4) dedicated 1D cap curve sigma_Q^2(r_max; s2): per-row inversion
        # of the table (G is ~flat in u, so in-row accuracy ~ the host
        # inverter's own tolerance), cubic-resampled along log s2 — the
        # r_max-binding branch is where BT spends most iterations, so it
        # gets its own high-accuracy path instead of the bilinear lookup.
        from scipy.interpolate import CubicSpline
        cap_lsq2 = np.empty(n_s2_grid)
        for i in range(n_s2_grid):
            g_row = CubicSpline(log2u_grid, tab[i] + log2u_grid)
            lo, hi = log2u_grid[0], log2u_grid[-1]
            for _ in range(60):
                mid = 0.5 * (lo + hi)
                if g_row(mid) - mid > eff_r_max:
                    lo = mid
                else:
                    hi = mid
            lu_star = 0.5 * (lo + hi)
            cap_lsq2[i] = (2.0 * math.log(sds[i] * 2.0**lu_star)
                           - math.log(12.0))
        dense_ls2 = np.linspace(math.log(s2_grid[0]), math.log(s2_grid[-1]),
                                512)
        cap_dense = CubicSpline(np.log(s2_grid), cap_lsq2)(dense_ls2)

        f32 = lambda v: torch.as_tensor(np.asarray(v, np.float32))
        self.tables = BTTables(
            log_v=f32(np.log(grid_v)), log_m=f32(np.log(grid_m)),
            targets=f32(targets),
            log_s2_grid=f32(np.log(s2_grid)), log2u_grid=f32(log2u_grid),
            gap_tab=f32(gap_tab),
            cap_ls2=f32(dense_ls2), cap_lsq2=f32(cap_dense),
            sigma_e2=f32(prob.sigma_e2), inv_kappa=f32(1.0 / prob.kappa),
            n_proc=f32(float(n_proc)), eps=f32(prob.prior.eps),
            mu_s=f32(prob.prior.mu_s), sigma_s2=f32(prob.prior.sigma_s**2),
            r_max=f32(eff_r_max), amp=f32(host._amp),
        )
        self._on_device: dict = {}

    @classmethod
    def from_tables(cls, tables: BTTables) -> "BTRateControl":
        """A controller around finished tables (``convert.py``): no host
        controller, no table build."""
        self = cls.__new__(cls)
        self.host = None
        self.tables = tables.to("cpu")
        self.n_iter = int(tables.targets.shape[0])
        self.n_proc = int(round(float(tables.n_proc)))
        self._on_device = {}
        return self

    def delta_for(self, t, sigma2_hat):
        return bt_delta_for(self.tables_on(sigma2_hat.device), t, sigma2_hat)


# ---------------------------------------------------------------------------
# column-layout rate control (C-MP-AMP)
# ---------------------------------------------------------------------------

class ColBTTables(NamedTuple):
    """The column BT controller's state as float32 tensors.

    The quantized payload is the residual contribution r^p = A_p x_p, whose
    entries are ~ N(0, v_r) (``quantize.residual_mixture``), so the rate
    model is a *one-dimensional* table: H_Q of a unit Gaussian as a function
    of the normalized bin u = Delta / sd(r^p).
    """

    log_v: torch.Tensor        # (400,) MMSE interp grid, log variance
    log_m: torch.Tensor        # (400,) log mmse values
    targets: torch.Tensor      # (S,) c_ratio * tau_C^{s} (lossless column SE)
    log2u_grid: torch.Tensor   # (n_u,) rate-table axis
    hq_tab: torch.Tensor       # (n_u,) H_Q(u) of the unit Gaussian
    u_cap: torch.Tensor        # () log2 u achieving the delivered-rate cap
    sigma_e2: torch.Tensor     # () problem scalars -------------------
    inv_kappa: torch.Tensor    # ()
    n_proc: torch.Tensor       # () float
    eps: torch.Tensor          # () prior
    mu_s: torch.Tensor         # ()
    sigma_s2: torch.Tensor     # ()
    r_max: torch.Tensor        # () delivered-rate cap (erasure-adjusted)
    surv: torch.Tensor         # () survival probability 1 - erasure_rate;
                               #    exactly 1.0 on a lossless link

    def to(self, device) -> "ColBTTables":
        return ColBTTables(*(f.to(device) for f in self))

    @classmethod
    def dummy(cls, n_iter: int, n_u: int = 256) -> "ColBTTables":
        """Benign finite tables for the non-BT instances of a mixed column
        batch (the contract of ``BTTables.dummy``)."""
        f = lambda v: torch.as_tensor(np.asarray(v, np.float32))
        lin = np.linspace(-20.0, 7.0, 400)
        return cls(
            log_v=f(lin), log_m=f(lin), targets=f(np.ones(n_iter)),
            log2u_grid=f(np.linspace(-12.0, 5.0, n_u)), hq_tab=f(np.ones(n_u)),
            u_cap=f(0.0), sigma_e2=f(1e-3), inv_kappa=f(1.0), n_proc=f(1.0),
            eps=f(0.1), mu_s=f(0.0), sigma_s2=f(1.0), r_max=f(6.0),
            surv=f(1.0))


def col_bt_delta_for(tb: ColBTTables, t: int, v_prev):
    """One column-BT decision on the device: (tables, round, v_hat_{s-1}) ->
    (delta, rate), closed form, about 25 tensor ops and no bisection.

    From the previous round's fused-residual plug-in v_hat the predicted
    block MSE is d = mmse(v_hat); the largest admissible quantizer MSE keeps
    the predicted variance of this round's fused residual,
    ``sigma_e^2 + d / kappa + P * sigma_Q^2``, within the target
    ``c * tau_C^s`` (quantization noise lands additively on g). The r_max
    cap inverts the 1-D Gaussian H_Q table. Round 0 is lossless for free
    (its exchanged contributions are all zero): delta = inf, rate = 0 —
    ``t`` is a Python int, so that is a Python branch and reads nothing on
    the host. ``v_prev`` is () or (B,); the tables are shared or stacked
    per instance, as in ``bt_delta_for``.
    """
    if t == 0:
        return torch.full_like(v_prev, math.inf), torch.zeros_like(v_prev)
    v_prev = torch.clamp(v_prev, min=1e-30)
    d = _bt_mmse(tb, v_prev)
    sm = tb.eps * (tb.mu_s**2 + tb.sigma_s2)
    v_r = torch.clamp(sm - d, min=1e-30) * tb.inv_kappa / tb.n_proc
    sd_r = torch.sqrt(v_r)
    # erasure reset semantics (tb.surv == 1.0 is a bit-exact no-op)
    d_in = tb.surv * d + (1.0 - tb.surv) * sm
    base = tb.sigma_e2 + d_in * tb.inv_kappa
    sq2_adm = torch.clamp(tb.targets[..., t] - base, min=0.0) / (tb.n_proc * tb.surv)
    sq2_cap = (torch.exp2(tb.u_cap) * sd_r) ** 2 / 12.0
    # the cap binds when the admissible bin is finer than r_max affords
    sq2 = torch.minimum(torch.maximum(sq2_adm, sq2_cap), v_r)
    lu = 0.5 * torch.log2(12.0 * sq2 / v_r)
    lu_c = torch.clamp(lu, min=_first(tb.log2u_grid, lu),
                       max=_last(tb.log2u_grid, lu))
    rate = torch.minimum(interp(lu_c, tb.log2u_grid, tb.hq_tab), tb.r_max)
    return torch.sqrt(12.0 * sq2), rate


class ColumnBTRateControl(_TablesOnDevice):
    """BT back-tracking for the column layout as device tensor ops.

    Tables are built once at construction (host side, numpy): the MMSE
    interp grid (same 400-point log-log grid as ``BTRateControl``), the
    per-round targets from the lossless column SE (``se_trajectory_col``),
    and the 1-D unit-Gaussian ECSQ entropy table H_Q(u) with its r_max
    inversion. ``n_inner == 1`` only (the measured plug-in pins the block
    MSE only there); multi-inner-round schedules use ``dp_allocate_col``.
    """

    def __init__(self, prob: CSProblem, n_proc: int, n_iter: int,
                 c_ratio: float = 1.05, r_max: float = 6.0,
                 n_inner: int = 1, mmse_fn=None, n_u_grid: int = 256,
                 erasure_rate: float = 0.0, recovery: str = "retransmit"):
        if n_inner != 1:
            raise ValueError(
                "column BT tracks the measured plug-in, which pins the block "
                "MSE only at n_inner=1; use dp_allocate_col for multi-inner-"
                "round rate schedules")
        self.prob = prob
        self.n_proc = n_proc
        self.n_iter = n_iter
        self.c_ratio = c_ratio
        self.r_max = r_max
        self.erasure_rate = erasure_rate
        self.recovery = recovery
        self.mmse_fn = mmse_fn or make_mmse_interp(prob.prior)
        budget_f, boost, _ = erasure_rate_factors(erasure_rate, recovery)
        # delivered-rate cap under the recovery policy (== r_max lossless)
        eff_r_max = r_max * budget_f * boost

        grid_v = np.geomspace(1e-9, 1e3, 400)
        grid_m = np.maximum(np.asarray(self.mmse_fn(grid_v), np.float64),
                            1e-300)
        tau_c, _ = se_trajectory_col(prob, n_proc, n_iter, n_inner,
                                     mmse_fn=self.mmse_fn,
                                     erasure_rate=erasure_rate)
        log2u_grid = np.linspace(-12.0, 5.0, n_u_grid)
        unit = GaussMixture(w=(1.0,), mu=(0.0,), var=(1.0,))
        hq = ecsq_entropy(2.0 ** log2u_grid, unit)
        # H_Q(u) is strictly decreasing: invert for the cap-rate bin
        u_cap = float(np.interp(eff_r_max, hq[::-1], log2u_grid[::-1]))

        f32 = lambda v: torch.as_tensor(np.asarray(v, np.float32))
        self.tables = ColBTTables(
            log_v=f32(np.log(grid_v)), log_m=f32(np.log(grid_m)),
            targets=f32(c_ratio * tau_c),
            log2u_grid=f32(log2u_grid), hq_tab=f32(hq), u_cap=f32(u_cap),
            sigma_e2=f32(prob.sigma_e2), inv_kappa=f32(1.0 / prob.kappa),
            n_proc=f32(float(n_proc)), eps=f32(prob.prior.eps),
            mu_s=f32(prob.prior.mu_s), sigma_s2=f32(prob.prior.sigma_s**2),
            r_max=f32(eff_r_max), surv=f32(1.0 - erasure_rate),
        )
        self._on_device: dict = {}

    @classmethod
    def from_tables(cls, tables: ColBTTables) -> "ColumnBTRateControl":
        """A controller around finished tables (``convert.py``)."""
        self = cls.__new__(cls)
        self.tables = tables.to("cpu")
        self.n_iter = int(tables.targets.shape[0])
        self.n_proc = int(round(float(tables.n_proc)))
        self._on_device = {}
        return self

    def delta_for(self, t, v_prev):
        return col_bt_delta_for(self.tables_on(v_prev.device), t, v_prev)


class ColDPSchedule(FixedSchedule):
    """``dp_allocate_col`` result realized as per-round ECSQ bin sizes for
    the column layout (the column counterpart of ``DPSchedule``). Round 0
    is lossless (inf): its contributions are all zero."""

    def __init__(self, dp_result, prob: CSProblem, n_proc: int,
                 ecsq_gap: bool = True):
        sq2 = np.atleast_1d(col_sigma_q2_for_rate(
            dp_result.rates[1:], dp_result.sigma2_d[1:-1], prob, n_proc,
            ecsq_gap))
        super().__init__(np.concatenate([[np.inf], np.sqrt(12.0 * sq2)]))
        self.rates = np.asarray(dp_result.rates)
        self.d_traj = np.asarray(dp_result.sigma2_d)

    @classmethod
    def from_arrays(cls, deltas, rates, d_traj) -> "ColDPSchedule":
        """Rebuild from a finished schedule's arrays (``convert.py``)."""
        self = cls.__new__(cls)
        FixedSchedule.__init__(self, deltas)
        self.rates = np.asarray(rates)
        self.d_traj = np.asarray(d_traj)
        return self


# ---------------------------------------------------------------------------
# the engine
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class EngineConfig:
    n_proc: int = 30
    n_iter: int = 10                  # iterations (row) / outer rounds (col)
    collect_symbols: bool = True      # trace quantizer indices (T, P, N|M)
    collect_xs: bool = True           # trace per-iteration estimates (T, N)
    layout: RowPartition | ColumnPartition = RowPartition()
    a_dtype: str = "float32"          # A storage/streaming dtype:
                                      # "bfloat16" halves the bytes of the
                                      # dominant operand, sums stay float32
    device: str = "cuda"              # where the solve runs. The default is
                                      # the card; without one the engine
                                      # raises, it never carries on on the
                                      # CPU. Tests pass "cpu".

    @property
    def is_col(self) -> bool:
        return isinstance(self.layout, ColumnPartition)

    @property
    def a_tdtype(self) -> torch.dtype:
        assert self.a_dtype in ("float32", "bfloat16"), self.a_dtype
        return torch.bfloat16 if self.a_dtype == "bfloat16" else torch.float32

    @property
    def torch_device(self) -> torch.device:
        dev = torch.device(self.device)
        if dev.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                f"EngineConfig.device={self.device!r} but no CUDA device is "
                "available; pass device='cpu' to run on the CPU")
        return dev


class HetParams(NamedTuple):
    """Per-instance operands of a heterogeneous batch (``solve_het``), each
    a tensor with a leading batch axis B (shapes below are per instance).
    With the per-instance sensing shards, these are what the serving layer
    varies inside one batched solve; everything structural (padded M and N,
    P, T_max, transport) is the bucket's instead."""

    sched: torch.Tensor     # (T,) fixed/DP bin sizes (inf = lossless)
    t_active: torch.Tensor  # () int: iterations to run (masked early exit)
    m_real: torch.Tensor    # () float32: true measurement count (plug-in norm)
    n_real: torch.Tensor    # () int: true signal length (column mask)
    eps: torch.Tensor       # () float32 prior sparsity
    mu_s: torch.Tensor      # () float32 prior mean
    sigma_s: torch.Tensor   # () float32 prior std
    use_bt: torch.Tensor    # () bool: BT controller vs the schedule
    bt: "BTTables | ColBTTables"   # stacked tables (dummy where !use_bt)
    drop: torch.Tensor | None = None   # (T, P) erasure mask, 1 = packet
    #                                    lost; None when no instance of the
    #                                    batch loses packets

    def to(self, device) -> "HetParams":
        """Every field on ``device`` (the schedule and priors as float32)."""
        f32 = lambda v: v.to(device=device, dtype=torch.float32)
        return self._replace(
            sched=f32(self.sched), t_active=self.t_active.to(device),
            m_real=f32(self.m_real), n_real=self.n_real.to(device),
            eps=f32(self.eps), mu_s=f32(self.mu_s), sigma_s=f32(self.sigma_s),
            use_bt=self.use_bt.to(device), bt=self.bt.to(device),
            drop=None if self.drop is None else f32(self.drop))


def _drop_at(hp: HetParams, t: int):
    """Round t's erasure rows (B, P) of a het batch, or None: a view by a
    Python int, no index tensor."""
    return None if hp.drop is None else hp.drop[:, t]


@dataclasses.dataclass
class EngineTrace:
    """Per-iteration record of one engine solve (arrays are numpy on exit)."""

    x: np.ndarray                 # final estimate (N,) / (B, N)
    sigma2_hat: np.ndarray        # plug-in sigma_{t,D}^2, post-LC (T,)
    deltas: np.ndarray            # realized bin sizes (T,)
    extra_var: np.ndarray         # transport-injected variance P*sigma_Q^2 (T,)
    rates: np.ndarray             # controller-chosen rate (T,), inf = untracked
    symbols: np.ndarray | None    # quantizer indices (T, P, N) row / (T, P, M) col
    xs: np.ndarray | None         # per-iteration estimates (T, N)

    def mse(self, s0: np.ndarray) -> np.ndarray:
        """Per-iteration MSE against ground truth (batched-aware)."""
        assert self.xs is not None, "solve with collect_xs=True"
        return np.mean((self.xs - np.asarray(s0)[..., None, :]) ** 2, axis=-1)


class _Outs(NamedTuple):
    """Device-side record of a solve, preallocated and filled in place.
    Scalars are (..., T); xs (..., T, N); symbols (..., T, P, L) with L the
    message length: N in the row layout, M in the column layout."""

    s2: torch.Tensor
    deltas: torch.Tensor
    extra: torch.Tensor
    rates: torch.Tensor
    xs: torch.Tensor | None
    symbols: torch.Tensor | None


class AmpEngine:
    """One MP-AMP solver core with pluggable transports and on-device rate
    control. See module docstring."""

    def __init__(self, prior: BernoulliGauss, cfg: EngineConfig,
                 transport: Transport | None = None,
                 controller=None):
        self.prior = prior
        self.cfg = cfg
        self.device = cfg.torch_device          # raises without a card
        self.transport = transport if transport is not None else ExactFusion()
        if controller is None:
            controller = FixedSchedule(np.full(cfg.n_iter, np.inf))
        self.controller = controller
        # executed solves: the per-engine load signal; distinct programs
        # run (entry point, operand shapes, BT or not): the counterpart of
        # the reference's compile count, what a prewarm moves to start-up
        self.dispatch_count = 0
        self.compile_count = 0
        self._programs: set = set()
        self._count_lock = threading.Lock()

    def _dispatched(self, program: tuple) -> None:
        with self._count_lock:
            self.dispatch_count += 1
            if program not in self._programs:
                self._programs.add(program)
                self.compile_count += 1

    def counters(self) -> dict:
        """A consistent ``{"compiles", "dispatches"}`` pair."""
        with self._count_lock:
            return {"compiles": self.compile_count,
                    "dispatches": self.dispatch_count}

    # -- shared iteration body ----------------------------------------------

    def _local(self, x, z_p, onsager, a_p, y_p, m, mesh=None):
        """LC: the whole (batch, processor) stack through one fused op.
        ``m`` is the measurement count M that normalizes sigma2_hat; on a
        mesh the sum of squares over this rank's processors is ``psum``'d
        first, so every rank divides the same global sum by the global M."""
        z_new, f_p, ss = amp_local_grid(a_p, x, y_p, z_p, onsager,
                                        self.cfg.n_proc)
        if mesh is not None:
            ss = psum(ss, mesh)
        return z_new, f_p, ss / m

    def _fuse(self, f_p, delta, drop=None, mesh=None):
        """Transport dispatch; ``drop`` (..., P) is this round's erasure
        mask, None the drop-free code. On a mesh (a device-collective
        transport) ``drop`` is this rank's straggler flag, always given."""
        if mesh is None:
            if isinstance(self.transport, _COLLECTIVE_TRANSPORTS):
                raise TypeError(
                    f"{type(self.transport).__name__} is a device-collective"
                    " transport: solve via solve_sharded/solve_sharded_het, "
                    "not the emulated entry points")
            return self.transport.fuse(f_p, delta,
                                       symbols=self.cfg.collect_symbols,
                                       drop=drop)
        return self.transport.fuse(f_p, delta, drop, mesh)

    def _gc(self, f_p, sigma2_hat, delta, kappa, drop=None, mesh=None):
        """GC: compress + fuse + denoise. Returns (x, onsager, extra, syms)."""
        f, extra, syms = self._fuse(f_p, delta, drop, mesh)
        x_new, onsager_new = amp_gc_step(f, sigma2_hat + extra, self.prior,
                                         kappa)
        return x_new, onsager_new, extra, syms

    def _body(self, t: int, carry, sched_delta, a_p, y_p, kappa, m,
              outs: _Outs, drop=None, mesh=None):
        """One iteration; writes its record into ``outs`` at index t.
        ``drop`` (P,) is the iteration's erasure mask or None (on a mesh:
        this rank's flag). No host sync: nothing here reads a tensor's
        value."""
        x, z_p, onsager = carry
        z_p, f_p, s2 = self._local(x, z_p, onsager, a_p, y_p, m, mesh)
        if isinstance(self.controller, FixedSchedule):
            # fixed schedules arrive as a device operand; their rate is not
            # tracked (the record holds inf from allocation)
            delta, rate = sched_delta.expand(s2.shape), None
        else:
            delta, rate = self.controller.delta_for(t, s2)
        x_new, onsager_new, extra, syms = self._gc(f_p, s2, delta, kappa,
                                                   drop, mesh)
        self._record(outs, t, s2, delta, extra, rate)
        if outs.xs is not None:
            outs.xs[..., t, :] = x_new
        if outs.symbols is not None:
            outs.symbols[..., t, :, :] = syms
        return x_new, z_p, onsager_new

    def _sched_operand(self):
        if isinstance(self.controller, FixedSchedule):
            deltas = self.controller.deltas[:self.cfg.n_iter]
            assert len(deltas) == self.cfg.n_iter, \
                f"schedule has {len(self.controller.deltas)} entries, " \
                f"need {self.cfg.n_iter}"
            return np.asarray(deltas, np.float32)
        return np.zeros(self.cfg.n_iter, np.float32)

    def _alloc_outs(self, lead, n, msg_len) -> _Outs:
        cfg, dev = self.cfg, self.device
        t, p = cfg.n_iter, cfg.n_proc
        new = lambda *shape: torch.empty(lead + shape, dtype=torch.float32,
                                         device=dev)
        rates = torch.full(lead + (t,), math.inf, dtype=torch.float32,
                           device=dev)
        return _Outs(new(t), new(t), new(t), rates,
                     new(t, n) if cfg.collect_xs else None,
                     new(t, p, msg_len) if cfg.collect_symbols else None)

    @staticmethod
    def _record(outs: _Outs, t: int, s2, delta, extra, rate) -> None:
        """Write iteration t's scalars into the device record. Every value
        is a device tensor: writing a Python number into a CUDA tensor
        copies it from the host, and that copy waits for the device.
        ``rate`` None (untracked) leaves the inf the record starts with."""
        outs.s2[..., t] = s2
        outs.deltas[..., t] = delta
        outs.extra[..., t] = extra
        if rate is not None:
            outs.rates[..., t] = rate

    def _solve_core(self, a_p, y_p, sched, m: int, n: int, drop=None,
                    mesh=None):
        """The T-iteration loop on device operands. a_p (P, Mp, N) or
        (B, P, Mp, N); y_p (P, Mp) or (B, P, Mp); sched (T,); drop the
        (T, P) erasure mask or None. On a mesh a_p/y_p hold this rank's
        P/D processors and drop is its (T,) straggler flags. ``drop[t]``
        with a Python int t is a view: no index tensor, no host read."""
        cfg, kappa = self.cfg, m / n
        lead = tuple(y_p.shape[:-2])
        carry = (torch.zeros(lead + (n,), dtype=torch.float32,
                             device=self.device),
                 torch.zeros_like(y_p),
                 torch.zeros(lead, dtype=torch.float32, device=self.device))
        outs = self._alloc_outs(lead, n, n)
        for t in range(cfg.n_iter):
            carry = self._body(t, carry, sched[t], a_p, y_p, kappa, m, outs,
                               None if drop is None else drop[t], mesh)
        return carry[0], outs

    # -- column layout (C-MP-AMP) ---------------------------------------------

    def _check_col_controller(self):
        if not isinstance(self.controller, (FixedSchedule,
                                            ColumnBTRateControl)):
            raise TypeError(
                "the column layout takes a FixedSchedule/ColDPSchedule or a "
                "ColumnBTRateControl (row-wise controllers predict through "
                f"the wrong SE), got {type(self.controller).__name__}")

    def _col_prior_params(self, m: int) -> torch.Tensor:
        """The fused inner step's ``par``, ``[m_eff, eps, mu_s, sigma_s^2]``
        (4,) on the solve's device, built once per solve before its loop
        (the inner step's denoiser is the Bernoulli-Gauss closed form)."""
        pr = self.prior
        if not isinstance(pr, BernoulliGauss):
            raise TypeError("the column layout's inner step denoises with "
                            "the Bernoulli-Gauss closed form; got "
                            f"{type(pr).__name__}")
        return col_params(float(m), pr.eps, pr.mu_s, pr.sigma_s**2,
                          self.device)

    def _col_inner(self, x, g, z_p, a_cp, par, n_mask=None):
        """``layout.n_inner`` local AMP iterations at each processor on the
        fused residual ``g``, each one fused inner step (``col_inner_step``):

            sigma_p^2 = ||z_p||^2 / M,  f_p = x_p + A_p^T z_p,
            x_p <- eta(f_p, sigma_p^2),
            z_p <- g - A_p (x_p - x_p^0) + c_p z_p,  c_p = sum(eta') / M

        (the last step skips the z update). ``z_p`` is the round's starting
        residual stack (..., P, M); ``par`` the step's ``[M, eps, mu_s,
        sigma_s^2]``, (4,) or one row per instance; ``n_mask`` the real
        columns of each slice, or None. Returns ``(x, c_p, z_last)``,
        ``z_last`` the residual that fed the final denoise."""
        n_inner = self.cfg.layout.n_inner
        x0, c_p = x, None
        for t in range(n_inner):
            x, c_p, z_p = col_inner_step(a_cp, x, x0, z_p, g, n_mask, par,
                                         update_z=t + 1 < n_inner)
        return x, c_p, z_p

    def _col_round(self, x, mem, coef, delta, a_cp, y, m_eff, par,
                   n_mask=None, drop=None, mesh=None):
        """One round: residual contributions, fuse, the boundary Onsager
        memory, the inner stage. Returns the new carry pieces and the
        round's record ``(v_hat, extra, syms)``. ``m_eff`` normalises the
        plug-in (a number, or (B,) real measurement counts).

        ``drop`` (..., P), this round's erasure mask, is a *reset*, not a
        rescale (the reference's DESIGN.md §10): an erased contribution
        leaves its whole signal block unexplained in the fused residual, so
        the block's estimate is zeroed before K2 forms r_p (which then
        vanishes exactly) and the inner stage restarts it from 0 against
        the fused residual. The boundary Onsager coefficient scales with
        the survivors (their share when ``carry_fused``, else each
        processor's keep flag): an erased block's correction never crossed
        the wire. The transport runs drop-free (its survivor rescale must
        not act on the zeroed contributions), and ``extra`` counts only the
        delivered packets' noise (share of survivors). With nothing lost
        every factor is an exact 1.0.

        On a mesh ``x``, ``a_cp`` and the per-processor carry are this
        rank's P/D blocks, ``drop`` (...,) is its flag (always given), the
        survivors' share and the boundary terms are ``psum``'d, and the
        transport gets a zero flag."""
        p = self.cfg.n_proc
        share, fuse_drop = None, None
        if drop is not None:
            keep = 1.0 - drop
            if mesh is None:
                x = x * keep[..., None]
                kept = keep.sum(-1)
                share = kept / _per_proc(kept, p)
            else:
                x = x * keep[..., None, None]
                kept = psum(keep, mesh)
                share = kept / _per_proc(kept, mesh.size)
                keep = keep[..., None]
                fuse_drop = torch.zeros_like(drop)
            coef = coef * (share if self.cfg.layout.carry_fused else keep)
        r_p = col_residual(a_cp, x)
        r, extra, syms = self._fuse(r_p, delta, fuse_drop, mesh)
        if share is not None:
            extra = extra * share
        g = y - r
        # boundary Onsager correction sum_q c_q z_q^last (ColumnPartition);
        # a scalar times the previous g on the n_inner == 1 path
        if self.cfg.layout.carry_fused:
            g = g + coef[..., None] * mem
        else:
            corr = torch.einsum("...p,...pm->...m", coef, mem)
            g = g + (corr if mesh is None else psum(corr, mesh))
        # g is the same on every rank after the fusion: no psum needed
        v_hat = torch.sum(g * g, dim=-1) / m_eff
        z0 = g.unsqueeze(-2).expand(x.shape[:-1] + g.shape[-1:]).contiguous()
        x_new, c_p, z_last = self._col_inner(x, g, z0, a_cp, par, n_mask)
        if self.cfg.layout.carry_fused:
            coef_new = torch.sum(c_p, dim=-1)
            if mesh is not None:
                coef_new = psum(coef_new, mesh)
            return x_new, g, coef_new, v_hat, extra, syms
        return x_new, z_last, c_p, v_hat, extra, syms

    @staticmethod
    def _col_gather_x(x, mesh):
        """(..., P', Np) signal slices -> the flat (..., N) estimate; on a
        mesh the slices of every rank are gathered first (rank order is
        processor order)."""
        if mesh is not None:
            x = all_gather(x, mesh).movedim(0, -3)
            x = x.reshape(x.shape[:-3] + (-1, x.shape[-1]))
        return x.reshape(x.shape[:-2] + (-1,))

    def _col_body(self, t: int, carry, sched_delta, a_cp, y, m_eff, par,
                  outs: _Outs, drop=None, mesh=None):
        """One outer round; writes its record into ``outs`` at index t.
        The carry is ``(x (..., P, Np), mem, coef, v_prev)``: the signal
        slices, the Onsager boundary memory (the previous g (..., M) and
        the summed coefficient (...,) when ``carry_fused``, else the
        per-processor residuals (..., P, M) and coefficients (..., P)) and
        the previous round's plug-in ``||g||^2 / M``, the column
        controller's input. No host sync."""
        x, mem, coef, v_prev = carry
        if isinstance(self.controller, FixedSchedule):
            delta, rate = sched_delta.expand(v_prev.shape), None
        else:
            delta, rate = self.controller.delta_for(t, v_prev)
        x_new, mem, coef, v_hat, extra, syms = self._col_round(
            x, mem, coef, delta, a_cp, y, m_eff, par, drop=drop, mesh=mesh)
        if t == 0:
            # round 0 quantizes all-zero contributions exactly: no noise
            # enters g, whatever bin the schedule names
            extra = torch.zeros_like(extra)
        self._record(outs, t, v_hat, delta, extra, rate)
        if outs.xs is not None:
            outs.xs[..., t, :] = self._col_gather_x(x_new, mesh)
        if outs.symbols is not None:
            outs.symbols[..., t, :, :] = syms
        return x_new, mem, coef, v_hat

    def _col_solve_core(self, a_cp, y, sched, par, m: int, n: int,
                        drop=None, mesh=None):
        """The outer-round loop on device operands. a_cp (P, M, Np) or
        (B, P, M, Np); y (M,) or (B, M); sched (T,); par the inner step's
        operand (``_col_prior_params``); drop the (T, P) erasure mask or
        None. On a mesh a_cp holds this rank's P/D blocks and drop is its
        (T,) flags."""
        cfg, p = self.cfg, a_cp.shape[-3]
        lead = tuple(y.shape[:-1])
        zeros = lambda *shape: torch.zeros(lead + shape, dtype=torch.float32,
                                           device=self.device)
        x = zeros(p, a_cp.shape[-1])
        if cfg.layout.carry_fused:
            mem, coef = torch.zeros_like(y), zeros()
        else:
            mem, coef = zeros(p, m), zeros(p)
        carry = (x, mem, coef, torch.sum(y * y, dim=-1) / m)
        outs = self._alloc_outs(lead, n, m)
        for t in range(cfg.n_iter):
            carry = self._col_body(t, carry, sched[t], a_cp, y, m, par, outs,
                                   None if drop is None else drop[t], mesh)
        return self._col_gather_x(carry[0], mesh), outs

    # -- operands -------------------------------------------------------------

    def _f32(self, v) -> torch.Tensor:
        return to_f32(v, self.device)

    def _a_operand(self, a_p: torch.Tensor) -> torch.Tensor:
        return a_p.to(device=self.device, dtype=self.cfg.a_tdtype).contiguous()

    def _split(self, y, a_mat):
        """Row-split (A, y) into device operands; alignment (none is
        needed) would happen once here, never inside the loop."""
        a_p, y_p = split_problem(self._f32(a_mat), self._f32(y),
                                 self.cfg.n_proc)
        a_p, y_p = pad_row_shards(a_p, y_p)
        return self._a_operand(a_p), y_p.contiguous()

    def _split_col(self, y, a_mat):
        """Column-split A (y is shared) into device operands."""
        a_cp, y = pad_col_shards(
            split_problem_cols(self._f32(a_mat), self.cfg.n_proc),
            self._f32(y))
        return self._a_operand(a_cp), y.contiguous()

    def _trace(self, x, outs: _Outs) -> EngineTrace:
        host = lambda v: None if v is None else v.cpu().numpy()
        return EngineTrace(
            x=host(x), sigma2_hat=host(outs.s2), deltas=host(outs.deltas),
            extra_var=host(outs.extra), rates=host(outs.rates),
            symbols=host(outs.symbols), xs=host(outs.xs))

    # -- entry points -----------------------------------------------------------

    def _drop_operand(self, drop_sched):
        """A (T, P) erasure mask on the device, or None."""
        if drop_sched is None:
            return None
        drop = self._f32(drop_sched)
        want = (self.cfg.n_iter, self.cfg.n_proc)
        if tuple(drop.shape) != want:
            raise ValueError(f"drop_sched: need {want}, got "
                             f"{tuple(drop.shape)}")
        return drop

    def dispatch_single(self, a_p, y_p, m: int, n: int, sched=None,
                        drop_sched=None):
        """Launch one solve from pre-split operands, returning the raw
        device-side ``(x, outs)`` without waiting for the device.
        ``sched`` overrides the engine controller's schedule operand
        (lossless/fixed/DP deltas ride here); ``drop_sched`` is a (T, P)
        erasure mask (``ErasureSpec.sample_mask``) or None; ``a_p`` may be
        a long-lived device tensor already in ``cfg.a_dtype`` — it is used
        as it is. Row layout only, as in the reference."""
        if self.cfg.is_col:
            raise ValueError("dispatch_single is a row-layout entry point")
        if not isinstance(a_p, torch.Tensor):
            a_p = self._f32(a_p)
        a_p = self._a_operand(a_p)
        y_p = self._f32(y_p).contiguous()
        if sched is None:
            sched = self._sched_operand()
        sched = self._f32(sched)
        assert sched.shape == (self.cfg.n_iter,), \
            (tuple(sched.shape), self.cfg.n_iter)
        drop = self._drop_operand(drop_sched)
        self._dispatched(("row", tuple(a_p.shape), m, n))
        return self._solve_core(a_p, y_p, sched, m, n, drop)

    def solve(self, y, a_mat, drop_sched=None) -> EngineTrace:
        """Full T-iteration solve with no host sync between iteration 0
        and T; the trace comes to the host once, at the end. Under a
        ``ColumnPartition`` layout it is the C-MP-AMP solve of ``n_iter``
        outer rounds. ``drop_sched`` (T, P) marks erased fusion packets
        (``ErasureSpec.sample_mask``): the row layout rescales the
        survivors, the column layout resets the erased signal blocks;
        None runs the drop-free solve."""
        m, n = a_mat.shape
        if self.cfg.is_col:
            self._check_col_controller()
            a_cp, y_d = self._split_col(y, a_mat)
            drop = self._drop_operand(drop_sched)
            self._dispatched(("col", tuple(a_cp.shape), m, n))
            return self._trace(*self._col_solve_core(
                a_cp, y_d, self._f32(self._sched_operand()),
                self._col_prior_params(m), m, n, drop))
        a_p, y_p = self._split(y, a_mat)
        return self._trace(*self.dispatch_single(a_p, y_p, m, n,
                                                 drop_sched=drop_sched))

    def solve_many(self, ys, a_mats) -> EngineTrace:
        """Batched solve of B independent CS instances.

        ys (B, M); a_mats (B, M, N) or a single shared (M, N) matrix.
        Symbol collection is typically disabled for batches (memory).
        """
        ys, a_mats = self._f32(ys), self._f32(a_mats)
        shared_a = a_mats.ndim == 2
        b = ys.shape[0]
        p = self.cfg.n_proc
        m, n = a_mats.shape[-2:]
        if not shared_a:
            assert a_mats.shape[0] == b
        if self.cfg.is_col:
            self._check_col_controller()
            a_b, y_b = pad_col_shards(split_problem_cols(a_mats, p), ys)
            self._dispatched(("col", tuple(a_b.shape), m, n))
            return self._trace(*self._col_solve_core(
                self._a_operand(a_b), y_b.contiguous(),
                self._f32(self._sched_operand()), self._col_prior_params(m),
                m, n))
        assert m % p == 0, f"M={m} not divisible by P={p}"
        mp_ = m // p
        a_b = a_mats.reshape(a_mats.shape[:-2] + (p, mp_, n))
        y_b = ys.reshape(b, p, mp_).contiguous()
        a_b, _ = pad_row_shards(a_b, None)
        self._dispatched(("row", tuple(a_b.shape), m, n))
        x, outs = self._solve_core(self._a_operand(a_b), y_b,
                                   self._f32(self._sched_operand()), m, n)
        return self._trace(x, outs)

    # -- heterogeneous batches (the serving path) -------------------------------

    def _body_het(self, t: int, carry, a_p, y_p, hp: HetParams, prior,
                  n_mask, has_bt: bool, outs: _Outs, mesh=None, drops=None):
        """One masked iteration of a row bucket with per-instance operands.

        ``_body``'s LC/GC split; the differences: sigma2_hat normalises by
        each instance's real M, the denoiser runs on each instance's prior
        (``prior`` = its (eps, mu_s, sigma_s^2) as (B, 1) columns), the
        Onsager sum covers only real columns, the bin comes from the
        instance's schedule or its BT tables (``has_bt`` is a Python bool:
        a batch without a BT request runs no controller), and an instance
        freezes once ``t >= t_active``, its record 0 (inf for the rate)
        from there on. ``torch.where`` on device tensors throughout: no
        host sync. On a mesh ``drops`` (B, T) holds this rank's straggler
        flags."""
        x, z_p, onsager = carry
        z_new, f_p, s2 = self._local(x, z_p, onsager, a_p, y_p, hp.m_real,
                                     mesh)
        sched_t = hp.sched[:, t]
        rate = None
        if has_bt:
            bt_delta, bt_rate = bt_delta_for(hp.bt, t, s2)
            delta = torch.where(hp.use_bt, bt_delta, sched_t)
            rate = torch.where(hp.use_bt, bt_rate, math.inf)
        else:
            delta = sched_t
        # each instance's erasure row (B, P); a lossless request of the
        # batch has zeros there, an exact no-op
        drop = _drop_at(hp, t) if mesh is None else drops[:, t]
        f, extra, syms = self._fuse(f_p, delta, drop, mesh)
        val, deriv = eta_bg_and_deriv(f, (s2 + extra)[:, None], *prior)
        x_new = val * n_mask
        onsager_new = torch.sum(deriv * n_mask, dim=-1) / hp.m_real
        act = t < hp.t_active
        x1 = torch.where(act[:, None], x_new, x)
        z1 = torch.where(act[:, None, None], z_new, z_p)
        ons1 = torch.where(act, onsager_new, onsager)
        self._record(outs, t, torch.where(act, s2, 0.0),
                     torch.where(act, delta, 0.0),
                     torch.where(act, extra, 0.0),
                     None if rate is None else torch.where(act, rate, math.inf))
        if outs.xs is not None:
            outs.xs[..., t, :] = x1
        if outs.symbols is not None:
            outs.symbols[..., t, :, :] = syms
        return x1, z1, ons1

    def _het_core(self, a_b, y_b, hp: HetParams, has_bt: bool, mesh=None):
        """The row bucket's T_max-iteration loop on device operands: a_b
        (B, P, mp_pad, n_pad), y_b (B, P, mp_pad), ``hp`` on the device. On
        a mesh a_b/y_b hold this rank's P/D processors and ``hp.drop`` is
        (B, T, D), one flag a rank."""
        b, _, _, n = a_b.shape
        dev = self.device
        n_mask = (torch.arange(n, device=dev)[None, :]
                  < hp.n_real[:, None]).to(torch.float32)
        prior = (hp.eps[:, None], hp.mu_s[:, None], (hp.sigma_s**2)[:, None])
        carry = (torch.zeros((b, n), dtype=torch.float32, device=dev),
                 torch.zeros_like(y_b),
                 torch.zeros(b, dtype=torch.float32, device=dev))
        outs = self._alloc_outs((b,), n, n)
        drops = None if mesh is None else self._rank_drops(hp, b, mesh)
        for t in range(self.cfg.n_iter):
            carry = self._body_het(t, carry, a_b, y_b, hp, prior, n_mask,
                                   has_bt, outs, mesh, drops)
        return carry[0], outs

    def _rank_drops(self, hp: HetParams, b: int, mesh):
        """This rank's (B, T) straggler flags of a sharded het solve:
        ``hp.drop[..., rank]`` (a view), zeros when nobody drops."""
        if hp.drop is None:
            return torch.zeros((b, self.cfg.n_iter), dtype=torch.float32,
                               device=self.device)
        return hp.drop[..., mesh.rank]

    def _col_body_het(self, t: int, carry, a_cp, y, hp: HetParams, par,
                      n_mask, has_bt: bool, outs: _Outs, mesh=None,
                      drops=None):
        """One masked C-MP-AMP round of a column bucket with per-instance
        operands: ``_col_body``'s carry plus the ``t_active`` freeze; ``par``
        (B, 4) and ``n_mask`` (B, Np) feed the inner step (K3) each
        instance's own prior, real M and real columns."""
        x, mem, coef, v_prev = carry
        sched_t = hp.sched[:, t]
        rate = None
        if has_bt:
            bt_delta, bt_rate = col_bt_delta_for(hp.bt, t, v_prev)
            delta = torch.where(hp.use_bt, bt_delta, sched_t)
            rate = torch.where(hp.use_bt, bt_rate, math.inf)
        else:
            delta = sched_t
        x_new, mem_new, coef_new, v_hat, extra, syms = self._col_round(
            x, mem, coef, delta, a_cp, y, hp.m_real, par, n_mask,
            _drop_at(hp, t) if mesh is None else drops[:, t], mesh)
        if t == 0:
            extra = torch.zeros_like(extra)     # zero round-0 payload
        act = t < hp.t_active
        lead = lambda v: act.reshape(act.shape + (1,) * (v.ndim - 1))
        x1 = torch.where(lead(x), x_new, x)
        mem1 = torch.where(lead(mem), mem_new, mem)
        coef1 = torch.where(lead(coef), coef_new, coef)
        v1 = torch.where(act, v_hat, v_prev)
        self._record(outs, t, torch.where(act, v_hat, 0.0),
                     torch.where(act, delta, 0.0),
                     torch.where(act, extra, 0.0),
                     None if rate is None else torch.where(act, rate, math.inf))
        if outs.xs is not None:
            outs.xs[..., t, :] = self._col_gather_x(x1, mesh)
        if outs.symbols is not None:
            outs.symbols[..., t, :, :] = syms
        return x1, mem1, coef1, v1

    def _col_het_core(self, a_b, y_b, hp: HetParams, has_bt: bool,
                      mesh=None):
        """The column bucket's T_max-round loop: a_b (B, P, m_pad, np_pad),
        y_b (B, m_pad); every processor owns n_real / P real columns at the
        head of its slice. On a mesh a_b holds this rank's P/D blocks."""
        b, p, m_pad, np_pad = a_b.shape
        dev = self.device
        n_mask = (torch.arange(np_pad, device=dev)[None, :]
                  < (hp.n_real // self.cfg.n_proc)[:, None]).to(torch.float32)
        par = col_params(hp.m_real, hp.eps, hp.mu_s, hp.sigma_s**2, dev)
        zeros = lambda *shape: torch.zeros((b,) + shape, dtype=torch.float32,
                                           device=dev)
        if self.cfg.layout.carry_fused:
            mem, coef = torch.zeros_like(y_b), zeros()
        else:
            mem, coef = zeros(p, m_pad), zeros(p)
        carry = (zeros(p, np_pad), mem, coef,
                 torch.sum(y_b * y_b, dim=-1) / hp.m_real)
        outs = self._alloc_outs((b,), self.cfg.n_proc * np_pad, m_pad)
        drops = None if mesh is None else self._rank_drops(hp, b, mesh)
        for t in range(self.cfg.n_iter):
            carry = self._col_body_het(t, carry, a_b, y_b, hp, par, n_mask,
                                       has_bt, outs, mesh, drops)
        return self._col_gather_x(carry[0], mesh), outs

    def dispatch_het(self, a_b, y_b, params: HetParams,
                     has_bt: bool | None = None):
        """Launch the heterogeneous solve of one padded batch, returning the
        raw device-side ``(x, outs)`` without waiting for the device (build
        the trace with ``trace_of``). Row buckets: a_b (B, P, mp_pad,
        n_pad), y_b (B, P, mp_pad); column buckets: a_b (B, P, m_pad,
        np_pad), y_b (B, m_pad). ``a_b`` may be a device tensor already in
        ``cfg.a_dtype``: it is used as it is. ``has_bt`` None reads
        ``params.use_bt`` (pass it to keep that read off the host path)."""
        if has_bt is None:
            has_bt = bool(torch.as_tensor(params.use_bt).any())
        a_b = self._a_operand(a_b if isinstance(a_b, torch.Tensor)
                              else self._f32(a_b))
        y_b = self._f32(y_b).contiguous()
        hp = params.to(self.device)
        b, p = a_b.shape[:2]
        assert p == self.cfg.n_proc, (p, self.cfg.n_proc)
        assert hp.sched.shape == (b, self.cfg.n_iter), \
            (tuple(hp.sched.shape), b, self.cfg.n_iter)
        if hp.drop is not None and tuple(hp.drop.shape) != (b, self.cfg.n_iter, p):
            raise ValueError(f"HetParams.drop: need {(b, self.cfg.n_iter, p)}"
                             f", got {tuple(hp.drop.shape)}")
        if self.cfg.is_col:
            assert tuple(y_b.shape) == (b, a_b.shape[2]), \
                (tuple(y_b.shape), tuple(a_b.shape))
            self._dispatched(("col_het", tuple(a_b.shape), has_bt))
            return self._col_het_core(a_b, y_b, hp, has_bt)
        assert tuple(y_b.shape) == tuple(a_b.shape[:3]), \
            (tuple(y_b.shape), tuple(a_b.shape))
        self._dispatched(("het", tuple(a_b.shape), has_bt))
        return self._het_core(a_b, y_b, hp, has_bt)

    def trace_of(self, x_outs) -> EngineTrace:
        """Bring a ``dispatch_het`` / ``dispatch_single`` result to the host."""
        return self._trace(*x_outs)

    def solve_het(self, a_b, y_b, params: HetParams,
                  has_bt: bool | None = None) -> EngineTrace:
        """Solve a heterogeneous batch of B padded CS instances.

        Row buckets pad each processor's rows with zero rows *within its
        own shard* (so the row -> processor partition matches the unpadded
        solve) and the columns with zero columns; column buckets pad each
        processor's slice of columns and the shared rows. Results for
        instance i are valid on its first ``n_real[i]`` columns (column
        buckets: the first ``n_real[i] / P`` of each slice) and
        ``t_active[i]`` iterations."""
        return self.trace_of(self.dispatch_het(a_b, y_b, params, has_bt))

    # -- device-sharded solves (the mesh as an engine axis) -------------------

    def _sharded_axis(self, mesh) -> int:
        """Check that this engine can solve on ``mesh``; returns P / D."""
        if not isinstance(self.transport, _COLLECTIVE_TRANSPORTS):
            raise TypeError(
                "solve_sharded needs a device-collective transport "
                "(PsumFusion / CompressedPsumTransport), got "
                f"{type(self.transport).__name__}")
        if self.cfg.collect_symbols:
            raise ValueError("symbols are per-device in sharded mode; build "
                             "the engine with collect_symbols=False")
        if self.cfg.n_proc % mesh.size:
            raise ValueError(f"P={self.cfg.n_proc} must be a multiple of the "
                             f"mesh '{mesh.axis}' axis ({mesh.size})")
        if torch.device(mesh.device) != self.device:
            raise ValueError(f"the engine runs on {self.device}, this rank "
                             f"of the mesh on {mesh.device}")
        return self.cfg.n_proc // mesh.size

    def _rank_part(self, v, mesh, k: int):
        """This rank's contiguous ``k`` processors of ``v`` (leading axis
        P); ``v`` already of ``k`` is taken as this rank's own."""
        if v.shape[0] == self.cfg.n_proc:
            return rank_slice(v, mesh.rank, mesh.size)
        if v.shape[0] != k:
            raise ValueError(f"leading axis {v.shape[0]}: need P="
                             f"{self.cfg.n_proc} or this rank's P/D={k}")
        return v

    def _rank_drop_sched(self, drop_sched, mesh):
        """This rank's (T,) straggler flags of a (T, D) schedule, or zeros:
        a device transport always takes its flag."""
        if drop_sched is None:
            return torch.zeros(self.cfg.n_iter, dtype=torch.float32,
                               device=self.device)
        drop = self._f32(drop_sched)
        want = (self.cfg.n_iter, mesh.size)
        if tuple(drop.shape) != want:
            raise ValueError(f"drop_sched: need {want}, got "
                             f"{tuple(drop.shape)}")
        return drop[:, mesh.rank].contiguous()

    def solve_sharded(self, y, a_mat, mesh, drop_sched=None) -> EngineTrace:
        """Device-sharded solve on every rank of ``mesh``: row-partitioned
        (A, y), each rank on its contiguous P/D processors, the fusion on
        the wire (the engine's device-collective transport). Every rank
        passes the whole problem (numpy or host tensors: only its part is
        copied to its device) and gets the same trace.

        The body, controller and trace are ``solve``'s; only the fusion sum
        and the plug-in's sum of squares cross the mesh. ``drop_sched``
        (T, D) marks straggler ranks per iteration: the transport rescales
        the survivors instead of stalling. Under a ``ColumnPartition`` the
        mesh carries column blocks, the fusion sums residual contributions,
        and a dropped rank is reset (its blocks restart from zero), not
        rescaled."""
        k = self._sharded_axis(mesh)
        m, n = a_mat.shape
        host = lambda v: v if isinstance(v, torch.Tensor) else \
            torch.from_numpy(np.ascontiguousarray(v, dtype=np.float32))
        drops = self._rank_drop_sched(drop_sched, mesh)
        sched = self._f32(self._sched_operand())
        if self.cfg.is_col:
            self._check_col_controller()
            a_cp = split_problem_cols(
                host(a_mat).reshape(m, n), self.cfg.n_proc)
            a_cp = self._a_operand(self._f32(self._rank_part(a_cp, mesh, k)))
            y_d = self._f32(y).contiguous()
            self._dispatched(("col_sharded", tuple(a_cp.shape), m, n))
            return self._trace(*self._col_solve_core(
                a_cp, y_d, sched, self._col_prior_params(m), m, n, drops,
                mesh))
        a_p, y_p = split_problem(host(a_mat), host(y), self.cfg.n_proc)
        a_p = self._a_operand(self._f32(self._rank_part(a_p, mesh, k)))
        y_p = self._f32(self._rank_part(y_p, mesh, k)).contiguous()
        self._dispatched(("sharded", tuple(a_p.shape), m, n))
        return self._trace(*self._solve_core(a_p, y_p, sched, m, n, drops,
                                             mesh))

    def check_sharded(self, a_shape: tuple, y_shape: tuple,
                      params: HetParams, mesh) -> int:
        """Every check ``dispatch_sharded`` makes of its operands, on their
        shapes alone (a mesh worker runs it before any rank starts the
        solve's collectives); returns P / D."""
        k = self._sharded_axis(mesh)
        n_p, t = self.cfg.n_proc, self.cfg.n_iter
        if len(a_shape) != 3 or a_shape[0] not in (n_p, k):
            raise ValueError(f"a_p: need (P={n_p} or this rank's P/D={k}, "
                             f"rows, columns), got {a_shape}")
        if self.cfg.is_col:
            want_y, ok_y = f"({a_shape[1]},)", tuple(y_shape) == a_shape[1:2]
        else:
            want_y = f"(P={n_p} or P/D={k}, {a_shape[1]})"
            ok_y = (len(y_shape) == 2 and y_shape[0] in (n_p, k)
                    and y_shape[1] == a_shape[1])
        if not ok_y:
            raise ValueError(f"y_p: need {want_y}, got {tuple(y_shape)}")
        if tuple(np.shape(params.sched)) != (t,):
            raise ValueError(f"params.sched: need ({t},), got "
                             f"{tuple(np.shape(params.sched))}")
        if params.drop is not None and \
                tuple(np.shape(params.drop)) != (t, mesh.size):
            raise ValueError(f"params.drop: need {(t, mesh.size)}, got "
                             f"{tuple(np.shape(params.drop))}")
        return k

    def dispatch_sharded(self, a_p, y_p, params: HetParams, mesh,
                         has_bt: bool | None = None):
        """Processor-sharded het solve of ONE padded instance (no batch
        axis) on every rank of ``mesh``, returning the raw ``(x, outs)``
        without waiting for the device (``trace_of`` builds the trace, the
        same on every rank). The serving layer's placement for large single
        requests: the mesh axis is the paper's P, the fusion a (possibly
        compressed) collective.

        Row: a_p (P, mp_pad, n_pad), y_p (P, mp_pad); column: a_p (P,
        m_pad, np_pad) and the shared y_p (m_pad,). ``a_p`` (and a row
        ``y_p``) may hold all P processors, of which each rank takes its
        contiguous P/D, or this rank's P/D alone; a device tensor already
        in ``cfg.a_dtype`` is used as it is. ``params`` are the instance's
        operands without a batch axis; ``params.drop`` is (T, D), one
        straggler flag a rank, or None."""
        k = self.check_sharded(tuple(a_p.shape), tuple(np.shape(y_p)),
                               params, mesh)
        if has_bt is None:
            has_bt = bool(torch.as_tensor(params.use_bt).any())
        as_t = lambda v: v if isinstance(v, torch.Tensor) else \
            torch.as_tensor(np.asarray(v))
        one = lambda v: as_t(v)[None]
        hp = params._replace(
            sched=one(params.sched), t_active=one(params.t_active),
            m_real=one(params.m_real), n_real=one(params.n_real),
            eps=one(params.eps), mu_s=one(params.mu_s),
            sigma_s=one(params.sigma_s), use_bt=one(params.use_bt),
            bt=type(params.bt)(*(one(v) for v in params.bt)),
            drop=None if params.drop is None else one(params.drop))
        hp = hp.to(self.device)
        a_loc = self._rank_part(a_p, mesh, k)
        a_loc = self._a_operand(a_loc if isinstance(a_loc, torch.Tensor)
                                else self._f32(a_loc))[None]
        if self.cfg.is_col:
            y_b = self._f32(y_p).contiguous()[None]
            self._dispatched(("col_sharded_het", tuple(a_loc.shape), has_bt))
            x, outs = self._col_het_core(a_loc, y_b, hp, has_bt, mesh)
        else:
            y_b = self._f32(self._rank_part(y_p, mesh, k)).contiguous()[None]
            self._dispatched(("sharded_het", tuple(a_loc.shape), has_bt))
            x, outs = self._het_core(a_loc, y_b, hp, has_bt, mesh)
        return x[0], _Outs(*(None if v is None else v[0] for v in outs))

    def solve_sharded_het(self, a_p, y_p, params: HetParams, mesh,
                          has_bt: bool | None = None) -> EngineTrace:
        """``dispatch_sharded`` brought to the host."""
        return self.trace_of(self.dispatch_sharded(a_p, y_p, params, mesh,
                                                   has_bt))

    def solve_host_loop(self, y, a_mat, host_schedule=None) -> EngineTrace:
        """Per-iteration host loop over the same LC/GC pieces.

        Exists for arbitrary Python rate-controller callables (and as the
        host-sync baseline). ``host_schedule`` is
        ``(t, sigma2_hat) -> delta``; defaults to the engine's controller
        evaluated on the host. Synchronises once per iteration, by design.
        Row layout only, as in the reference.
        """
        cfg = self.cfg
        if cfg.is_col:
            raise ValueError("solve_host_loop is a row-layout entry point")
        m, n = a_mat.shape
        kappa = m / n
        a_p, y_p = self._split(y, a_mat)

        if host_schedule is None:
            ctrl = self.controller
            if isinstance(ctrl, FixedSchedule):
                host_schedule = lambda t, s2: float(ctrl.deltas[t])
            else:
                host_schedule = lambda t, s2: float(ctrl.delta_for(
                    t, torch.tensor(s2, dtype=torch.float32,
                                    device=self.device))[0])

        x = torch.zeros(n, dtype=torch.float32, device=self.device)
        z_p = torch.zeros_like(y_p)
        onsager = torch.zeros((), dtype=torch.float32, device=self.device)
        s2s, deltas, extras, xs, syms = [], [], [], [], []
        for t in range(cfg.n_iter):
            z_p, f_p, s2 = self._local(x, z_p, onsager, a_p, y_p, m)
            delta_t = float(host_schedule(t, float(s2)))   # the host sync
            x, onsager, extra, q = self._gc(
                f_p, s2, torch.full_like(s2, delta_t), kappa)
            s2s.append(float(s2))
            deltas.append(delta_t)
            extras.append(float(extra))
            if cfg.collect_xs:
                xs.append(x.cpu().numpy())
            if cfg.collect_symbols:
                syms.append(q.cpu().numpy())
        return EngineTrace(
            x=x.cpu().numpy(), sigma2_hat=np.asarray(s2s),
            deltas=np.asarray(deltas), extra_var=np.asarray(extras),
            rates=np.full(cfg.n_iter, np.inf, np.float32),
            symbols=np.asarray(syms) if cfg.collect_symbols else None,
            xs=np.asarray(xs) if cfg.collect_xs else None,
        )

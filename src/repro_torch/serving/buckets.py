"""Shape bucketing for the AMP solve service (the JAX package's
``repro.serving.buckets``, pure Python, kept as it is; its DESIGN.md §5-§7
describe the design).

Heterogeneous solve requests arrive with arbitrary (N, M, P, T). The
service pads every request up to a small set of canonical shapes — the
*buckets* — and solves each bucket's requests as one batch of
``AmpEngine.solve_het``: one launch of each kernel an iteration for the
whole batch, and a bounded set of distinct programs (operand shapes) to
warm up. The bucket key is exactly the set of *structural* parameters
(things that change tensor shapes or the program); everything else (prior,
SNR, schedule, BT tables, iteration count) rides as per-instance operands
with a leading batch axis.

Padding semantics (must preserve single-solve results bit-near-exactly):

  * columns: N -> n_pad with zero columns of A; the engine masks the
    denoiser/Onsager to the real columns, so padded entries stay 0.
  * rows: padded *per processor shard* (each processor keeps exactly its
    unpadded rows plus zeros), so the row->processor partition — and with
    it each f^p message and its quantization error — matches the unpadded
    solve. Zero rows keep z = 0 forever and sigma2_hat normalizes by the
    real M.
  * iterations: T -> t_max with masked early-exit (t_active per instance).
  * batch: B -> next power of two (recompile amortization); the batcher
    fills the pad slots by repeating real requests and drops the copies.

For block-quantized transports, ``n_quantum`` must divide the transport
block size: then ceil(n_pad/block) == ceil(n/block) and the per-block
scales (hence the injected-noise accounting) match the unpadded solve.

Placement (DESIGN.md §6; the port serves on one device, where it is always
``"local"``): on a multi-device mesh the bucket additionally
records *where* it runs — ``"local"`` (single device), ``"data"``
(batch axis sharded across devices, processors emulated per-device) or
``"proc"`` (mesh axis = the paper's P, compressed fusion on the wire).
``placement_for`` chooses by a simple size threshold: requests whose
sensing matrix reaches ``policy.shard_elems`` elements are worth paying
collective latency per iteration; everything smaller batches better.

Layout (DESIGN.md §7): the bucket also records *how* the problem is
partitioned — ``"row"`` (the paper's scheme) or ``"col"`` (C-MP-AMP,
each processor owns N/P signal columns and the fusion exchanges length-M
residual contributions).  ``placement_for`` routes tall requests whose
aspect ratio N/M reaches ``policy.col_aspect`` to the column layout: in
that regime the row scheme would put the full length-N denoiser messages
on the wire while the column scheme exchanges only length-M residuals.
Column padding mirrors the row semantics with the axes swapped: the
quantized payload axis (M) takes ``n_quantum`` (keeping the transport
scale-block layout pad-invariant) and the per-processor column slices
take ``mp_quantum``.
"""
from __future__ import annotations

import dataclasses

__all__ = ["BucketPolicy", "BucketKey", "bucket_for", "pad_batch_size",
           "batch_width_ladder", "placement_for", "round_up",
           "TRANSPORT_BLOCK"]

# scale-block length of the block-quantized transports (QuantConfig.block
# as instantiated by serving/service.py); "ecsq" has no block structure
TRANSPORT_BLOCK = {"block8": 512, "block4": 512}


@dataclasses.dataclass(frozen=True)
class BucketPolicy:
    """Rounding quanta that trade padding waste against compile-cache size."""

    n_quantum: int = 256     # signal length padded to a multiple
    mp_quantum: int = 16     # per-processor measurement rows padded to a multiple
    t_quantum: int = 4       # scan length padded to a multiple
    max_batch: int = 128     # dispatch threshold for continuous batching
    shard_elems: int = 1 << 21  # A size (M*N) at which a single request
    #                             runs processor-sharded instead of batching
    col_aspect: float = 4.0  # N/M at which a request routes to the column
    #                          layout (tall-N regime, DESIGN.md §7)


@dataclasses.dataclass(frozen=True)
class BucketKey:
    """Structural shape of one compiled solve (the compile-cache key).

    ``n_pad``/``mp_pad`` are layout-dependent: row buckets pad the signal
    length and the per-processor measurement rows (M_pad = P * mp_pad);
    column buckets pad the per-processor column slices (n_pad = P * the
    padded slice) and ``mp_pad`` holds the padded *full* measurement
    count (rows are shared, not split, in the column layout)."""

    n_pad: int               # padded signal length
    mp_pad: int              # padded rows per processor (row) / padded M (col)
    n_proc: int              # processor count (partition structure)
    t_max: int               # scan length (iterations / outer rounds)
    transport: str           # "ecsq" | "block8" | "block4"
    placement: str = "local"  # "local" | "data" | "proc" (DESIGN.md §6)
    layout: str = "row"       # "row" | "col" (DESIGN.md §7)

    @property
    def m_pad(self) -> int:
        return self.mp_pad if self.layout == "col" \
            else self.n_proc * self.mp_pad


def round_up(v: int, q: int) -> int:
    """Smallest multiple of ``q`` >= ``v`` (shape/batch padding quantum)."""
    return -(-v // q) * q


def bucket_for(n: int, m: int, n_proc: int, n_iter: int, transport: str,
               policy: BucketPolicy, placement: str = "local",
               layout: str = "row") -> BucketKey:
    """Map a request's structural parameters to its bucket."""
    block = TRANSPORT_BLOCK.get(transport)
    if block is not None:
        # otherwise padding the quantized axis can add scale blocks the
        # unpadded solve does not have, silently skewing quant_noise_var
        # (module docstring); the quantized axis is N for row layouts
        # (messages) and M for column layouts (residual contributions),
        # and both take n_quantum
        assert block % policy.n_quantum == 0, \
            f"n_quantum={policy.n_quantum} must divide the {transport} " \
            f"scale block ({block}) to keep noise accounting pad-invariant"
    if layout == "col":
        assert n % n_proc == 0, f"N={n} not divisible by P={n_proc} (col)"
        return BucketKey(
            n_pad=n_proc * round_up(n // n_proc, policy.mp_quantum),
            mp_pad=round_up(m, policy.n_quantum),
            n_proc=n_proc,
            t_max=round_up(n_iter, policy.t_quantum),
            transport=transport,
            placement=placement,
            layout=layout,
        )
    assert m % n_proc == 0, f"M={m} not divisible by P={n_proc}"
    return BucketKey(
        n_pad=round_up(n, policy.n_quantum),
        mp_pad=round_up(m // n_proc, policy.mp_quantum),
        n_proc=n_proc,
        t_max=round_up(n_iter, policy.t_quantum),
        transport=transport,
        placement=placement,
        layout=layout,
    )


def placement_for(n: int, m: int, n_proc: int, n_devices: int,
                  policy: BucketPolicy) -> tuple[str, str]:
    """Placement *and* layout for a request: ``(placement, layout)``.

    Size-threshold placement (DESIGN.md §6): large single solves shard
    the processors across the mesh; everything else batches
    data-parallel.  Processor sharding additionally needs P to split
    evenly over the devices (each device emulates P/D processors, keeping
    the partition — and the noise accounting — independent of the mesh
    size); requests that don't satisfy it fall back to data-parallel.

    Aspect-ratio layout (DESIGN.md §7): tall requests (N/M >=
    ``policy.col_aspect``) whose N splits evenly over the processors run
    column-partitioned — the fusion then exchanges length-M residual
    contributions instead of length-N messages.
    """
    layout = "col" if (n >= policy.col_aspect * m
                       and n % n_proc == 0) else "row"
    if n_devices <= 1:
        return "local", layout
    if n * m >= policy.shard_elems and n_proc % n_devices == 0:
        return "proc", layout
    return "data", layout


def pad_batch_size(b: int, policy: BucketPolicy) -> int:
    """Next power of two >= b (capped at max_batch), so the vmapped solve
    compiles for O(log max_batch) distinct batch sizes per bucket."""
    assert 1 <= b <= policy.max_batch
    p = 1
    while p < b:
        p <<= 1
    return min(p, policy.max_batch)


def batch_width_ladder(policy: BucketPolicy, n_devices: int = 1) -> tuple:
    """Every batch width the service can actually dispatch for one bucket:
    the ``pad_batch_size`` power-of-two ladder, rounded to device
    multiples under the data-parallel placement. This is the width grid
    ``SolveService.prewarm`` compiles — exactly the reachable programs, no
    more."""
    widths, w = set(), 1
    while True:
        wp = round_up(w, n_devices) if n_devices > 1 else w
        widths.add(min(wp, policy.max_batch))
        if w >= policy.max_batch:
            break
        w <<= 1
    return tuple(sorted(widths))

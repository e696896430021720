"""Tensor parallelism over the "model" mesh axis: the collectives with their
autograd rules that the LM forward runs on its "model" slices (the reference
has no counterpart: GSPMD partitions its graph and inserts them).

A rank of the "model" axis holds the slices of each leaf that the rules
give it (``sharding.model_dims`` / ``shard_params``). The forward of a block
is then one *region* on every rank:

    x ──enter──> column products on the rank's heads / mlp columns / experts
      ──> row products (partial sums, float32) ──leave──> x'

  * ``enter``: under 'tp' the identity forward, a sum over "model" backward
    (``copy_to_model``); under 'tp_sp' the rank's S/m rows of the residual
    gathered over the sequence forward, the gradient reduce-scattered
    backward (``gather_seq``).
  * ``leave``: under 'tp' a sum over "model" forward, the identity backward
    (``reduce_from_model``); under 'tp_sp' a reduce-scatter over the
    sequence forward, an all-gather backward (``scatter_seq``). The partial
    sums travel in float32 and are rounded to the activations' dtype once,
    after the sum, as a product at model = 1 rounds once (``row_mm``).
  * Inside the region every rank computes its share: a gradient found there
    is partial and the backward of ``enter`` sums it. So a leaf that is
    whole on every rank but used inside the region (a K/V projection whose
    heads do not divide, the qk-norm weights, the MoE router, RWKV's mix and
    decay LoRAs) enters through ``rep``: the identity forward and a sum of
    its gradient over "model" backward, which makes the gradient whole on
    every rank.
  * Under 'tp_sp' the norms run on the rank's rows, so their weights' and
    the final norm's gradients are partial too (``norm_weight``), as
    Megatron's sequence parallelism sums them.
  * The head_dim fallback (the rules slice the head_dim where the heads do
    not divide: ``head_dim_sliced``): q, k and v come out of the column
    products as the rank's contiguous head_dim columns and are gathered
    over "model" (``gather_head_dim``; backward: the ranks' partial
    gradients summed, reduce-scattered), so RoPE, whose split-half rotation
    pairs column i with i + Dh/2, qk-norm and the attention run on whole
    heads on every rank; each rank then keeps its head_dim columns of the
    context (``own_head_dim``) for the row-parallel output product. The
    other reading (partial q.k^T summed over the ranks before the softmax)
    would move B * H * S^2 float32 scores a layer against the gather's
    3 B * S * H * Dh. RWKV-6 gathers r, k and u and keeps v's columns: its
    recurrence is exact per value column (``models/rwkv6.py``), and its
    head norm sums its moment over "model" (``all_reduce``: a sum both
    ways, for a value each rank uses on its own columns).

The vocab is sliced under every strategy (``embed``: the rank's rows of
the table, a zero row elsewhere, summed over "model"; ``loss_inputs`` and
``model_api.chunked_xent_loss``: the logits of the rank's vocab rows, the
log-sum-exp of every rank's, the gold logit from the rank that owns it).
Under 'fsdp' every other weight is whole and the "model" ranks hold other
rows of the batch: the embedding gathers the tokens over "model" and
reduce-scatters the embeddings back to the rank's rows, the loss gathers
the hidden states, and each rank's loss is the mean over its "model"
group's rows (the same on each), whose gradients the step then sums over
"model" for the whole leaves.

Every rank issues the same collectives in the same order, also in the
recompute of a checkpointed layer; every sum gives every rank the same
bits (``core/collectives.py``), so replicated activations and parameters
stay identical across the "model" ranks.

Serving ('tp' regions without autograd: plain collectives) adds what a
decode step against a KV cache sharded along its sequence needs
(``launch/steps.py::ServeStep``): ``KVSlice``, a rank's rows of the cache
and the mesh of the rules' "kv_seq" axes; ``fold_attention``, the ranks'
attention partials (K5's slice form: the output normalised over the rank's
rows and their log-sum-exp) folded into the attention over every row; and
``greedy_ids``, the greedy token over the vocab slices of the "model" ranks.
"""
from __future__ import annotations

import dataclasses

import torch

from .core.collectives import all_gather, psum, reduce_scatter

__all__ = ["TensorParallel", "copy_to_model", "reduce_from_model",
           "all_reduce", "gather_seq", "scatter_seq", "gather_stack",
           "row_mm", "KVSlice", "fold_attention", "greedy_ids",
           "gather_dim"]

STRATEGIES = ("tp", "tp_sp", "fsdp")


def _sum(x, mesh):
    """The sum over ``mesh``, of a low-precision tensor in float32, rounded
    back once."""
    if x.dtype in (torch.bfloat16, torch.float16):
        return psum(x.float(), mesh).to(x.dtype)
    return psum(x, mesh)


def _gather(x, mesh, dim: int):
    """Every rank's ``x`` concatenated along ``dim``, in rank order."""
    g = all_gather(x.contiguous(), mesh)
    return g.movedim(0, dim).flatten(dim, dim + 1)


def _scatter(x, mesh, dim: int):
    """The sum over ``mesh`` of ``x``, this rank keeping its block along
    ``dim`` (low precision summed in float32 and rounded back once)."""
    if x.shape[dim] % mesh.size:
        raise ValueError(f"dimension {dim} of {tuple(x.shape)} does not "
                         f"split over {mesh.size} ranks")
    lo = x.dtype in (torch.bfloat16, torch.float16)
    t = (x.float() if lo else x).movedim(dim, 0).contiguous()
    out = reduce_scatter(t, mesh).movedim(0, dim)
    return out.to(x.dtype) if lo else out


class _Copy(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _sum(g, ctx.mesh), None


class _Reduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        return _sum(x, mesh)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherSeq(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, dim):
        ctx.mesh, ctx.dim = mesh, dim
        return _gather(x, mesh, dim)

    @staticmethod
    def backward(ctx, g):
        return _scatter(g, ctx.mesh, ctx.dim), None, None


class _ScatterSeq(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, dim):
        ctx.mesh, ctx.dim = mesh, dim
        return _scatter(x, mesh, dim)

    @staticmethod
    def backward(ctx, g):
        return _gather(g, ctx.mesh, ctx.dim), None, None


class _GatherStack(torch.autograd.Function):
    """(m, *x.shape), rank r's ``x`` at index r; the result feeds a value
    computed alike on every rank, so the gradient of rank r's part is
    already whole there."""

    @staticmethod
    def forward(ctx, x, mesh):
        ctx.rank = mesh.rank
        return all_gather(x.contiguous(), mesh)

    @staticmethod
    def backward(ctx, g):
        return g[ctx.rank], None


def copy_to_model(x, mesh):
    """Identity forward; the gradient summed over "model" backward."""
    return _Copy.apply(x, mesh)


def reduce_from_model(x, mesh):
    """The sum over "model" forward; the identity backward."""
    return _Reduce.apply(x, mesh)


def all_reduce(x, mesh):
    """The sum over "model" forward, and the sum of the gradient backward:
    for a sum that each rank then uses on its own slice (the gradient
    reaching it is partial on every rank)."""
    return reduce_from_model(copy_to_model(x, mesh), mesh)


def gather_seq(x, mesh, dim: int = 1):
    """All-gather along ``dim`` forward; reduce-scatter backward."""
    return _GatherSeq.apply(x, mesh, dim)


def scatter_seq(x, mesh, dim: int = 1):
    """Reduce-scatter along ``dim`` forward; all-gather backward."""
    return _ScatterSeq.apply(x, mesh, dim)


def gather_stack(x, mesh):
    """Every rank's ``x`` stacked on a new leading axis (rank order), for a
    value every rank then computes alike; the backward keeps the rank's
    own part of the (whole) gradient."""
    return _GatherStack.apply(x, mesh)


def _mm_out_f32(a, b):
    """a (M, K) @ b (K, N), or batched (E, M, K) @ (E, K, N), with a
    float32 result: bf16 operands on the card through cuBLAS's bf16 x bf16
    -> float32 product (one rounding to float32, none to bf16), elsewhere
    by float32 operands (the products of two bf16 numbers are exact in
    float32)."""
    if a.dtype == torch.float32:
        return a @ b
    if a.is_cuda:
        mul = torch.bmm if a.ndim == 3 else torch.mm
        return mul(a, b, out_dtype=torch.float32)
    return a.float() @ b.float()


class _RowMM(torch.autograd.Function):
    """``x @ w`` with a float32 result; the backward is ``matmul``'s in the
    operands' dtype (the cotangent is a bf16 number upcast where
    ``leave``'s backward brings it, exactly)."""

    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(x, w)
        return _mm_out_f32(x, w)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        g = g.to(x.dtype)
        dx = g @ w.transpose(-1, -2) if ctx.needs_input_grad[0] else None
        dw = x.transpose(-1, -2) @ g if ctx.needs_input_grad[1] else None
        return dx, dw


def row_mm(x, w):
    """The row-parallel product's partial sum in float32: ``x (..., K) @ w
    (K, ...)`` (w's trailing dims flattened and restored), or batched over
    experts, x (E, M, K) @ w (E, K, N)."""
    if w.ndim == 3 and x.ndim == 3 and w.shape[0] == x.shape[0]:
        return _RowMM.apply(x, w)
    out = _RowMM.apply(x.reshape(-1, x.shape[-1]), w.reshape(w.shape[0], -1))
    return out.reshape(*x.shape[:-1], *w.shape[1:])


class TensorParallel:
    """The "model" axis of a train step: its 1-D mesh, the strategy and
    each leaf's "model" dimension (``sharding.model_dims``; None: whole).
    ``layers`` is what the blocks take (None under 'fsdp', whose blocks
    compute on whole weights)."""

    def __init__(self, mesh, strategy: str, dims: dict):
        if strategy not in STRATEGIES:
            raise ValueError(f"strategy={strategy!r}: one of {STRATEGIES}")
        self.mesh, self.strategy, self.dims = mesh, strategy, dict(dims)
        self.size, self.rank = mesh.size, mesh.rank

    @property
    def sp(self) -> bool:
        return self.strategy == "tp_sp"

    @property
    def layers(self):
        return None if self.strategy == "fsdp" else self

    def sliced(self, path: str) -> bool:
        return self.dims.get(path) is not None

    # -- the region of a block ----------------------------------------------

    def enter(self, h):
        """The region's input from the (normed) residual: 'tp' (B, S, D)
        as it is, 'tp_sp' the rank's (B, S/m, D) gathered to (B, S, D)."""
        return (gather_seq(h, self.mesh) if self.sp
                else copy_to_model(h, self.mesh))

    def leave(self, y, dtype):
        """The region's output from the partial sums ``y`` (float32): their
        sum ('tp'), or this rank's rows of it ('tp_sp'), in ``dtype``."""
        out = (scatter_seq(y, self.mesh) if self.sp
               else reduce_from_model(y, self.mesh))
        return out.to(dtype)

    def rep(self, w):
        """A whole leaf used inside the region: its gradient summed."""
        return copy_to_model(w, self.mesh)

    def norm_weight(self, w):
        """A norm weight: under 'tp_sp' the norm runs on the rank's rows,
        so its gradient is summed."""
        return copy_to_model(w, self.mesh) if self.sp else w

    def local_heads(self, n_global: int, n_local: int) -> range:
        """The global indices of this rank's heads."""
        if n_local * self.size != n_global:
            raise ValueError(f"{n_local} heads a rank of {self.size} is not "
                             f"{n_global}")
        return range(self.rank * n_local, (self.rank + 1) * n_local)

    def head_dim_sliced(self, d_head: int, n_local: int) -> bool:
        """Whether a leaf whose last head dimension is ``n_local`` wide
        holds this rank's slice of a head_dim of ``d_head`` (the rules'
        fallback where the heads do not divide), not whole heads."""
        if n_local == d_head:
            return False
        if n_local * self.size != d_head:
            raise ValueError(f"a head_dim of {n_local} a rank of "
                             f"{self.size} is not {d_head}")
        return True

    def gather_head_dim(self, x):
        """Every rank's head_dim columns (the last dimension) of ``x``
        concatenated, in rank order; the backward reduce-scatters."""
        return gather_seq(x, self.mesh, x.ndim - 1)

    def own_head_dim(self, x):
        """This rank's columns of the last (whole head_dim) dimension."""
        w = x.shape[-1] // self.size
        return x.narrow(x.ndim - 1, self.rank * w, w)

    def whole_heads(self, x, n_heads: int, d_head: int):
        """``x`` (..., H', Dh') with every "model" rank's heads or head_dim
        columns, whichever it holds a slice of: (..., n_heads, d_head)."""
        if x.shape[-2] != n_heads:
            x = gather_seq(x, self.mesh, x.ndim - 2)
        if x.shape[-1] != d_head:
            x = self.gather_head_dim(x)
        return x

    def scatter_cols(self, x):
        """This rank's block of the last dimension of the sum over "model"
        of the partial products ``x`` (float32 kept; backward: the whole
        gradient all-gathered)."""
        return scatter_seq(x, self.mesh, x.ndim - 1)

    # -- the vocab ------------------------------------------------------------

    def _lookup(self, table, tokens):
        v0, vl = self.rank * table.shape[0], table.shape[0]
        local = tokens.long() - v0
        own = (local >= 0) & (local < vl)
        rows = table[local.clamp(0, vl - 1)]
        return rows * own[..., None].to(rows.dtype)

    def embed(self, table, tokens):
        """The embeddings (unscaled) of this rank's part of the activations
        from its vocab rows ``table`` (V/m, D) and ``tokens`` (B, S): 'tp'
        (B, S, D) on every rank, 'tp_sp' the rank's (B, S/m, D), 'fsdp' its
        own rows' (B, S, D), ``tokens`` being those rows."""
        if self.strategy == "fsdp":
            everyone = _gather(tokens, self.mesh, 0)
            return scatter_seq(self._lookup(table, everyone), self.mesh, 0)
        part = self._lookup(table, tokens)
        return (scatter_seq(part, self.mesh) if self.sp
                else reduce_from_model(part, self.mesh))

    def seq_rows(self, s: int) -> range:
        """The sequence positions of this rank's residual rows ('tp_sp')."""
        if s % self.size:
            raise ValueError(f"a sequence of {s} does not split over "
                             f"{self.size} 'model' ranks")
        n = s // self.size
        return range(self.rank * n, (self.rank + 1) * n)

    def loss_inputs(self, hidden, labels, mask):
        """(hidden, labels, mask) as the vocab-parallel loss takes them:
        every row of the rank's group, the hidden state entering the loss's
        region ('tp': as it is; 'tp_sp': its rows gathered over the
        sequence; 'fsdp': the group's rows gathered, labels and mask
        too)."""
        if self.strategy == "fsdp":
            return (gather_seq(hidden, self.mesh, 0),
                    _gather(labels, self.mesh, 0),
                    _gather(mask, self.mesh, 0))
        if self.sp:
            return gather_seq(hidden, self.mesh), labels, mask
        return copy_to_model(hidden, self.mesh), labels, mask


# -- serving ----------------------------------------------------------------------

def gather_dim(x, mesh, dim: int):
    """Every rank's ``x`` concatenated along ``dim`` in rank order (``x``
    itself on a mesh of one): a plain collective, no autograd rule."""
    return x if mesh is None or mesh.size == 1 else _gather(x, mesh, dim)


@dataclasses.dataclass(frozen=True)
class KVSlice:
    """A rank's rows ``row0 .. row0 + rows - 1`` of a decode cache whose
    sequence the rules' "kv_seq" axes shard; ``mesh`` is the 1-D mesh over
    those axes (None: the cache is whole on every rank)."""

    mesh: object
    row0: int
    rows: int

    def holds(self, pos: int) -> bool:
        return self.row0 <= pos < self.row0 + self.rows


def fold_attention(o, lse, mesh):
    """The attention over every rank's rows from each rank's partial, ``o``
    (B, H, Dh) normalised over its rows and ``lse`` (B, H) their
    log-sum-exp (float32; a rank with no row: 0 and -inf): one all-gather
    of both, then with M the largest log-sum-exp and w_r = exp(lse_r - M),
    sum_r w_r o_r / sum_r w_r, summed in rank order, so every rank gets
    the same bits. Float32 (B, H, Dh)."""
    both = torch.cat([o, lse[..., None]], dim=-1)
    g = all_gather(both.contiguous(), mesh)           # (n, B, H, Dh + 1)
    lses = g[..., -1]
    m = lses.max(dim=0).values
    m = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    num = den = None
    for r in range(mesh.size):
        w = torch.exp(lses[r] - m)
        part = g[r, ..., :-1] * w[..., None]
        num = part if num is None else num + part
        den = w if den is None else den + w
    return num / den[..., None]


def greedy_ids(logits, mesh, v0: int):
    """The greedy token of each row of ``logits`` (..., V/m), this rank's
    vocab columns from global index ``v0``, over every "model" rank's: the
    largest logit, the lowest global index on a tie, as ``torch.argmax``
    over the whole row gives (int64, (...))."""
    idx = torch.argmax(logits, dim=-1)
    if mesh is None or mesh.size == 1:
        return idx + v0
    val = torch.take_along_dim(logits, idx[..., None], dim=-1)[..., 0]
    both = torch.stack([val.double(), (idx + v0).double()], dim=-1)
    g = all_gather(both.contiguous(), mesh)            # (m, ..., 2)
    best = torch.argmax(g[..., 0], dim=0)              # the first on a tie
    ids = torch.take_along_dim(g[..., 1], best[None], dim=0)[0]
    return ids.long()

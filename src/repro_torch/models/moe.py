"""Token-choice top-k MoE layer (qwen3-moe, mixtral): the port of the JAX
package's ``models/moe.py``.

Dispatch is the reference's sort-based capacity scheme: the tokens are cut
into groups, each group's routed slots are sorted by expert (a stable sort)
and scattered into a per-expert buffer of ``capacity`` rows (G, E, C, D);
a slot past its expert's capacity goes to a dummy row and is dropped. The
expert SwiGLU runs as products batched over the E experts, and the rows are
gathered back (a dropped slot from a zero row) and combined with the
renormalised top-k gates.

The reference shards groups over data and experts over the model axis;
here, on one device, the groups are a leading axis of the same tensors.

Gradients flow through the dispatch as the reference's do: the scatter
into the buffer takes the gather back's gradient of each kept slot, the
gates and router theirs; a dropped slot (the dummy row, and a zero gate)
gets none. Serving (nothing requires a gradient) multiplies in place to
spare memory; training takes the same products out of place.
"""
from __future__ import annotations

import contextlib

import torch

from ..tensor_parallel import row_mm
from .layers import mm_f32

__all__ = ["moe_mlp", "recorded_keeps", "route"]


def _dispatch_group(x_g, e_idx_g, capacity: int, n_experts: int):
    """Group-local dispatch, the reference's ``_dispatch_group``: x_g
    (T, D), e_idx_g (T, k) -> buf (E*C+1, D), dest (T*k,), keep (T*k,).
    Also takes a leading axis of groups: (G, T, D), (G, T, k) -> (G, ...).

    A routed slot's row is its expert's index times C plus its rank among
    the slots of that expert (stable: in slot order); a slot ranked C or
    later is dropped (``keep`` false) and its row is the dummy row E*C."""
    if e_idx_g.ndim == 2:
        buf, dest, keep = _dispatch_group(x_g[None], e_idx_g[None], capacity,
                                          n_experts)
        return buf[0], dest[0], keep[0]
    g, t, k = e_idx_g.shape
    dev = e_idx_g.device
    ef = e_idx_g.reshape(g, t * k)
    order = torch.argsort(ef, dim=-1, stable=True)
    sorted_e = torch.gather(ef, 1, order)
    # position of each routed slot within its expert
    experts = torch.arange(n_experts, device=dev).expand(g, n_experts)
    start = torch.searchsorted(sorted_e, experts.contiguous(), side="left")
    pos_within = (torch.arange(t * k, device=dev)
                  - torch.gather(start, 1, sorted_e))
    keep_sorted = pos_within < capacity
    dest_sorted = torch.where(keep_sorted, sorted_e * capacity + pos_within,
                              n_experts * capacity)
    # invert the sort: dest[j] for original flat slot j
    dest = torch.empty_like(dest_sorted).scatter_(1, order, dest_sorted)
    keep = torch.empty_like(keep_sorted).scatter_(1, order, keep_sorted)
    tok = torch.gather(x_g, 1, (order // k)[..., None].expand(
        -1, -1, x_g.shape[-1]))
    buf = x_g.new_zeros((g, n_experts * capacity + 1, x_g.shape[-1]))
    buf.scatter_(1, dest_sorted[..., None].expand_as(tok), tok)
    return buf, dest, keep


@contextlib.contextmanager
def recorded_keeps():
    """Every dispatch's ``keep`` (which routed slots fit their expert's
    capacity; a copy, on the tensor's device), in call order, while the
    block runs: what two runs that must drop the same slots compare."""
    global _dispatch_group
    saved, keeps = _dispatch_group, []

    def recording(*args):
        buf, dest, keep = saved(*args)
        keeps.append(keep.detach().clone())
        return buf, dest, keep

    _dispatch_group = recording
    try:
        yield keeps
    finally:
        _dispatch_group = saved


def route(xf, router_w, top_k: int):
    """Router of grouped tokens xf (G, T, D): float32 softmax over the
    experts, then the top k, ties to the lower expert index as
    ``lax.top_k`` takes them (a stable descending sort), the gates
    renormalised to sum to 1. Returns (gates (G, T, k) float32, expert ids
    (G, T, k))."""
    probs = torch.softmax(mm_f32(xf, router_w), dim=-1)
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    gates, e_idx = vals[..., :top_k], idx[..., :top_k]
    gates = gates / torch.clamp(gates.sum(-1, keepdim=True), min=1e-9)
    return gates, e_idx


def moe_mlp(x, router_w, w_gate, w_up, w_down, cfg, n_groups: int = 16,
            tp=None):
    """x: (B, S, D) -> (B, S, D). Expert weights (E, D, F) / (E, F, D);
    the B * S tokens cut into the largest number of groups up to
    ``n_groups`` that divides them.

    ``tp`` (the "model" axis, x the region's input, the expert weights the
    rank's slices): the router, the sort and the capacity run alike on
    every rank, so each drops the same slots; each rank runs its E/m
    experts' rows of the buffer (or every expert on its d_ff/m columns)
    and the gather back gives the other experts' slots zero. Returns the
    rank's partial sum in float32, for ``tp.leave``."""
    b, s, d = x.shape
    e, k = cfg.n_experts, cfg.top_k
    tokens = b * s
    g = max(min(n_groups, tokens), 1)
    while tokens % g:
        g -= 1
    t_g = tokens // g
    capacity = max(int(cfg.capacity_factor * k * t_g / e), 1)

    xf = x.reshape(g, t_g, d)
    gates, e_idx = route(xf, router_w, k)
    buf, dest, keep = _dispatch_group(xf, e_idx, capacity, e)
    # expert FFN (SwiGLU), batched over the experts: (E, G*C, D), of them
    # the rank's el experts from e0 (every one on a d_ff slice: e0 = 0)
    buf = buf[:, :-1].reshape(g, e, capacity, d).transpose(0, 1).reshape(
        e, g * capacity, d)
    el = w_gate.shape[0]
    e0 = tp.rank * el if tp is not None and el < e else 0
    mine = buf.narrow(0, e0, el)
    grad = torch.is_grad_enabled() and any(
        t.requires_grad for t in (x, router_w, w_gate, w_up, w_down))
    act = torch.nn.functional.silu(torch.matmul(mine, w_gate).float(),
                                   inplace=not grad).to(x.dtype)
    up = torch.matmul(mine, w_up)
    act = act * up if grad else act.mul_(up)
    del buf, mine, up
    # each expert's d_ff sliced: the down product's partial sums (float32)
    out = (row_mm(act, w_down) if tp is not None and el == e
           else torch.matmul(act, w_down))              # (el, G*C, D)
    del act
    # gather back (a dropped slot, or another rank's expert, from a zero
    # row) + combine
    flat = out.new_zeros((g, e * capacity + 1, d))
    flat[:, e0 * capacity:(e0 + el) * capacity].view(
        g, el, capacity, d).copy_(out.view(el, g, capacity, d).transpose(0, 1))
    del out
    rows = torch.gather(flat, 1, dest[..., None].expand(-1, -1, d))
    w = (gates.reshape(g, t_g * k) * keep).to(x.dtype)
    y = (rows * w[..., None].to(rows.dtype)).reshape(g, t_g, k, d)
    if tp is not None:
        return y.sum(dim=2, dtype=torch.float32).reshape(b, s, d)
    return y.sum(dim=2).reshape(b, s, d)

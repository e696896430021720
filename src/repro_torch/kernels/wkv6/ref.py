"""Plain PyTorch versions of the WKV6 kernel (``csrc/wkv6.cu``): the RWKV-6
recurrence

    S_t = diag(w_t) S_{t-1} + k_t v_t^T,    y_t = r_t (S_{t-1} + diag(u) k_t v_t^T)

with ``w_t = exp(logw_t)``, for r, k, logw of shape (B, T, H, Dh), a bonus
``u`` (H, Dh) and a state (B, H, Dh, Dh) (rows indexed by the k channel).
v may hold Dv <= Dh value columns of each head (the value-column form, a
rank's share under the head_dim fallback): the state is then (B, H, Dh,
Dv) and y (B, T, H, Dv), the same columns of the whole recurrence's, which
is exact per value column.

``wkv_scan_ref`` runs it step by step; ``wkv_chunked`` in chunks of 32 steps
in the decay-rebased basis (r' = r e^{l_exc}, k' = k e^{-l_inc}, l the
cumulative log-decay inside the chunk), as the JAX package's
``models/rwkv6.py`` does. Both take an initial state and return the final
one. The caller keeps ``logw >= -2`` (the model clamps it), so the rebased
factors stay within e^{+-64}, inside float32. The CUDA kernel is held
against ``wkv_chunked`` on the card; on the CPU these are what runs.

``wkv6_bwd_ref`` is the gradient of the recurrence (the plain version of
the backward kernel, which the reference does not have: it differentiates
its jnp ``wkv_chunked``), step by step from the adjoint recurrence.

Sums run in float32 (float64 for float64 inputs, so that
``torch.autograd.gradcheck`` can hold the gradient to finite differences).
"""
from __future__ import annotations

import torch

__all__ = ["wkv_scan_ref", "wkv_chunked", "wkv6_bwd_ref", "CHUNK"]

CHUNK = 32


def _acc(dtype: torch.dtype) -> torch.dtype:
    """The dtype the sums run in: float64 for float64 inputs, else float32."""
    return torch.float64 if dtype == torch.float64 else torch.float32


def _state0(state0, b, h, dh, device, acc=torch.float32, dv=None):
    if state0 is None:
        return torch.zeros((b, h, dh, dh if dv is None else dv), dtype=acc,
                           device=device)
    return state0.to(acc)


def wkv_scan_ref(r, k, v, logw, u, state0=None):
    """Step-by-step recurrence. Returns (y (B, T, H, Dv) float32, final
    state (B, H, Dh, Dv) float32), Dv = v's last dimension."""
    b, t, h, dh = r.shape
    acc = _acc(r.dtype)
    rf, kf, vf = r.to(acc), k.to(acc), v.to(acc)
    w = torch.exp(logw.to(acc))
    uf = u.to(acc)
    s = _state0(state0, b, h, dh, r.device, acc, v.shape[-1])
    ys = []
    for i in range(t):
        kv = kf[:, i, :, :, None] * vf[:, i, :, None, :]      # (B, H, Dk, Dv)
        ys.append(torch.einsum("bhk,bhkv->bhv", rf[:, i],
                               s + uf[None, :, :, None] * kv))
        s = w[:, i, :, :, None] * s + kv
    return torch.stack(ys, dim=1), s


def wkv_chunked(r, k, v, logw, u, state0=None, chunk: int = CHUNK):
    """Chunked recurrence (matmul form); same contract as ``wkv_scan_ref``.
    A ragged T is padded with k = v = r = 0 and logw = 0: padded steps
    neither add to the state nor decay it."""
    b, t, h, dh = r.shape
    dv = v.shape[-1]
    pad = (-t) % chunk
    if pad:
        padf = lambda a: torch.nn.functional.pad(a, (0, 0, 0, 0, 0, pad))
        r, k, v, logw = padf(r), padf(k), padf(v), padf(logw)
    nc = (t + pad) // chunk
    acc = _acc(r.dtype)
    rf, kf, lw = (a.to(acc).reshape(b, nc, chunk, h, dh)
                  for a in (r, k, logw))
    vf = v.to(acc).reshape(b, nc, chunk, h, dv)
    uf = u.to(acc)
    s = _state0(state0, b, h, dh, r.device, acc, dv)

    l_inc = torch.cumsum(lw, dim=2)             # inclusive cumulative log decay
    l_exc = l_inc - lw                          # exclusive (decay before step t)
    k_resc = kf * torch.exp(-l_inc)             # k' basis
    r_resc = rf * torch.exp(l_exc)              # r' basis
    l_tot = l_inc[:, :, -1]                     # (B, nc, H, Dh)

    # intra-chunk: A[t, j] = sum_d r'_t k'_j, strictly lower triangular
    a_mat = torch.einsum("bnthd,bnjhd->bnhtj", r_resc, k_resc)
    tri = torch.tril(torch.ones((chunk, chunk), dtype=acc, device=r.device),
                     -1)
    a_mat = a_mat * tri
    diag = torch.einsum("bnthd,hd,bnthd->bnth", rf, uf, kf)   # u-bonus, j == t
    y_intra = torch.einsum("bnhtj,bnjhd->bnthd", a_mat, vf)
    y_intra = y_intra + diag[..., None] * vf

    # inter-chunk: r' reads the carried state; then the state moves on by
    # the chunk's decay and its k' e^{l_tot} v^T contributions
    y_inter = []
    for c in range(nc):
        y_inter.append(torch.einsum("bthk,bhkv->bthv", r_resc[:, c], s))
        decay = torch.exp(l_tot[:, c])                     # (B, H, Dh)
        k_fold = k_resc[:, c] * decay[:, None]
        s = decay[..., None] * s + torch.einsum("bthk,bthv->bhkv", k_fold,
                                                vf[:, c])
    y = (y_intra + torch.stack(y_inter, dim=1)).reshape(b, t + pad, h, dv)
    return y[:, :t], s


def wkv6_bwd_ref(r, k, v, logw, u, state0, dy, ds=None):
    """The gradient of ``(y, S_T) = wkv(r, k, v, logw, u, state0)`` for the
    cotangents ``dy`` (B, T, H, Dv) and ``ds`` (B, H, Dh, Dv) of the final
    state (None: zero). Returns (dr, dk, dv, dlogw, du, dstate0), each in
    its input's dtype (dstate0 float32 when ``state0`` is None). With v of
    Dv < Dh value columns, dr, dk, dlogw and du are those columns' shares
    (they sum over value columns: the shares of a partition sum to the
    whole's).

    With S_t = diag(w_t) S_{t-1} + k_t v_t^T and y_t = r_t^T (S_{t-1} +
    diag(u) k_t v_t^T), the adjoint G_t = dL/dS_t runs backward from
    G_T = dS_T as G_{t-1} = diag(w_t) G_t + r_t dy_t^T, and
        dr_t = S_{t-1} dy_t + u k_t (v_t . dy_t)
        dk_t = G_t v_t + u r_t (v_t . dy_t)
        dv_t = G_t^T k_t + (r_t . u k_t) dy_t
        du = sum_t r_t k_t (v_t . dy_t)
        dlogw_t = w_t sum_j G_t[:, j] S_{t-1}[:, j]
        dstate0 = G_0.
    The states S_0 .. S_{T-1} are kept from a forward pass."""
    b, t, h, dh = r.shape
    acc = _acc(r.dtype)
    rf, kf, vf, dyf = (a.to(acc) for a in (r, k, v, dy))
    w = torch.exp(logw.to(acc))
    uf = u.to(acc)
    s = _state0(state0, b, h, dh, r.device, acc, v.shape[-1])
    states = []                                     # S_{t-1}, t = 1 .. T
    for i in range(t):
        states.append(s)
        s = w[:, i, :, :, None] * s + kf[:, i, :, :, None] * vf[:, i, :, None, :]
    g = (torch.zeros_like(s) if ds is None else ds.to(acc))
    dr, dk, dlw = (torch.empty((b, t, h, dh), dtype=acc, device=r.device)
                   for _ in range(3))
    dv = torch.empty(vf.shape, dtype=acc, device=r.device)
    du = torch.zeros((h, dh), dtype=acc, device=r.device)
    for i in reversed(range(t)):
        ri, ki, vi, dyi, s_prev = rf[:, i], kf[:, i], vf[:, i], dyf[:, i], states[i]
        vdy = (vi * dyi).sum(-1, keepdim=True)                   # (B, H, 1)
        dr[:, i] = torch.einsum("bhkv,bhv->bhk", s_prev, dyi) + uf * ki * vdy
        dk[:, i] = torch.einsum("bhkv,bhv->bhk", g, vi) + uf * ri * vdy
        dv[:, i] = (torch.einsum("bhkv,bhk->bhv", g, ki)
                    + (ri * uf * ki).sum(-1, keepdim=True) * dyi)
        du += (ri * ki * vdy).sum(0)
        dlw[:, i] = w[:, i] * (g * s_prev).sum(-1)
        g = w[:, i, :, :, None] * g + ri[..., None] * dyi[..., None, :]
    ds0 = g.to(torch.float32 if state0 is None else state0.dtype)
    return (dr.to(r.dtype), dk.to(k.dtype), dv.to(v.dtype),
            dlw.to(logw.dtype), du.to(u.dtype), ds0)

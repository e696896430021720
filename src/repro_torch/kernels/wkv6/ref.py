"""Plain PyTorch versions of the WKV6 kernel (``csrc/wkv6.cu``): the RWKV-6
recurrence

    S_t = diag(w_t) S_{t-1} + k_t v_t^T,    y_t = r_t (S_{t-1} + diag(u) k_t v_t^T)

with ``w_t = exp(logw_t)``, for r, k, v, logw of shape (B, T, H, Dh), a bonus
``u`` (H, Dh) and a state (B, H, Dh, Dh) (rows indexed by the k channel).

``wkv_scan_ref`` runs it step by step; ``wkv_chunked`` in chunks of 32 steps
in the decay-rebased basis (r' = r e^{l_exc}, k' = k e^{-l_inc}, l the
cumulative log-decay inside the chunk), as the JAX package's
``models/rwkv6.py`` does. Both take an initial state and return the final
one. The caller keeps ``logw >= -2`` (the model clamps it), so the rebased
factors stay within e^{+-64}, inside float32. The CUDA kernel is held
against ``wkv_chunked`` on the card; on the CPU these are what runs.
"""
from __future__ import annotations

import torch

__all__ = ["wkv_scan_ref", "wkv_chunked", "CHUNK"]

CHUNK = 32


def _state0(state0, b, h, dh, device):
    if state0 is None:
        return torch.zeros((b, h, dh, dh), dtype=torch.float32, device=device)
    return state0.float()


def wkv_scan_ref(r, k, v, logw, u, state0=None):
    """Step-by-step recurrence. Returns (y (B, T, H, Dh) float32, final
    state (B, H, Dh, Dh) float32)."""
    b, t, h, dh = r.shape
    rf, kf, vf = r.float(), k.float(), v.float()
    w = torch.exp(logw.float())
    uf = u.float()
    s = _state0(state0, b, h, dh, r.device)
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
    pad = (-t) % chunk
    if pad:
        padf = lambda a: torch.nn.functional.pad(a, (0, 0, 0, 0, 0, pad))
        r, k, v, logw = padf(r), padf(k), padf(v), padf(logw)
    nc = (t + pad) // chunk
    shp = (b, nc, chunk, h, dh)
    rf, kf, vf, lw = (a.float().reshape(shp) for a in (r, k, v, logw))
    uf = u.float()
    s = _state0(state0, b, h, dh, r.device)

    l_inc = torch.cumsum(lw, dim=2)             # inclusive cumulative log decay
    l_exc = l_inc - lw                          # exclusive (decay before step t)
    k_resc = kf * torch.exp(-l_inc)             # k' basis
    r_resc = rf * torch.exp(l_exc)              # r' basis
    l_tot = l_inc[:, :, -1]                     # (B, nc, H, Dh)

    # intra-chunk: A[t, j] = sum_d r'_t k'_j, strictly lower triangular
    a_mat = torch.einsum("bnthd,bnjhd->bnhtj", r_resc, k_resc)
    tri = torch.tril(torch.ones((chunk, chunk), device=r.device), -1)
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
    y = (y_intra + torch.stack(y_inter, dim=1)).reshape(b, t + pad, h, dh)
    return y[:, :t], s

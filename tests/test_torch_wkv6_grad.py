"""The gradient of the port's WKV6 recurrence: ``kernels/wkv6/ref.py::
wkv6_bwd_ref`` (the plain version of the backward kernel, the adjoint
recurrence step by step) against autograd of the port's ``wkv_chunked`` and
against ``jax.grad`` of the reference's ``models/rwkv6.py::wkv_chunked``;
``WKV6Function``'s CPU path against finite differences (float64
``gradcheck``); and the chunked algorithm the CUDA backward runs
(``csrc/wkv6.cu``: chunk start states from a forward pass, then the chunks
in reverse carrying the adjoint G, dlogw's reverse cumulative sum started
at each chunk's end from the row sums P = rowsum(G S), split into NV
value-column slices whose partials a cluster sums in rank order), emulated here in float64 at every NV the
kernel takes, against autograd and against ``jax.grad`` of the reference.

Tolerance: float32 throughout, each gradient within 1e-5 of its largest
magnitude (seen: 7e-7 against autograd of the chunked form, 2e-6 against
jax.grad). The chunked form multiplies factors up to e^{+-64} (log-decay
clamped at -2), so its gradient carries float32 rounding of that range;
the step-by-step adjoint does not.

The CUDA kernel cannot run here; ``chip_smoke.py`` holds it against
autograd of ``wkv_chunked`` on the card.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models.rwkv6 import wkv_chunked as j_chunked
from repro_torch.kernels.wkv6 import ops as tops
from repro_torch.kernels.wkv6.ref import CHUNK, wkv6_bwd_ref, wkv_chunked
from repro_torch.kernels.wkv6.wkv6 import (BWD_DHS, value_splits,
                                           wkv6_bwd_cuda)

TOL = 1e-5
NAMES = ("dr", "dk", "dv", "dlogw", "du", "dstate0")

# (B, T, H, Dh, state0 given, dS_T given): ragged T against the chunk of
# 32, a T under one chunk, rwkv6's head size 64 and the smoke configs' 16
CASES = [(2, 70, 2, 16, True, True), (1, 64, 3, 8, False, False),
         (2, 5, 2, 16, True, False), (1, 100, 2, 64, False, True),
         (1, 33, 1, 32, True, True)]
IDS = [f"B{b}T{t}H{h}Dh{dh}{'_s0' if s0 else ''}{'_dS' if ds else ''}"
       for b, t, h, dh, s0, ds in CASES]


def _inputs(b, t, h, dh, s0, ds, seed, dtype=np.float32):
    """r, k, v, logw (clamped at -2), u, state0 or None, dy, dS_T or None."""
    rng = np.random.default_rng(seed)
    r, k, v = (0.5 * rng.normal(size=(b, t, h, dh)) for _ in range(3))
    logw = np.maximum(-np.exp(0.5 * rng.normal(size=(b, t, h, dh)) - 1.0),
                      -2.0)
    u = 0.3 * rng.normal(size=(h, dh))
    state0 = 0.3 * rng.normal(size=(b, h, dh, dh)) if s0 else None
    dy = rng.normal(size=(b, t, h, dh))
    d_s = rng.normal(size=(b, h, dh, dh)) if ds else None
    return [None if a is None else a.astype(dtype)
            for a in (r, k, v, logw, u, state0, dy, d_s)]


def _t(a):
    return None if a is None else torch.from_numpy(a)


def _close(got, want, what):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    scale = max(np.abs(want).max(), 1e-30)
    err = np.abs(got - want).max()
    assert err <= TOL * scale, (what, err, scale)


def _autograd(r, k, v, logw, u, state0, dy, d_s):
    ins = [x.clone().requires_grad_(True) for x in (r, k, v, logw, u)]
    if state0 is not None:
        ins.append(state0.clone().requires_grad_(True))
    y, s = wkv_chunked(*ins[:5], ins[5] if state0 is not None else None)
    loss = (y * dy).sum() + (0 if d_s is None else (s * d_s).sum())
    return torch.autograd.grad(loss, ins)


@pytest.mark.parametrize("b,t,h,dh,s0,ds", CASES, ids=IDS)
def test_plain_backward_matches_autograd_of_chunked(b, t, h, dh, s0, ds):
    arrays = _inputs(b, t, h, dh, s0, ds, seed=b * t + dh)
    got = wkv6_bwd_ref(*(_t(a) for a in arrays))
    want = _autograd(*(_t(a) for a in arrays))
    for name, g, w in zip(NAMES, got, want):
        assert g.dtype == torch.float32 and g.shape == w.shape, name
        _close(g, w, name)
    # dstate0 is G_0 whether or not state0 was given
    assert got[5].shape == (b, h, dh, dh)


@pytest.mark.parametrize("b,t,h,dh,s0,ds", CASES, ids=IDS)
def test_plain_backward_matches_jax_grad_of_reference(b, t, h, dh, s0, ds):
    arrays = _inputs(b, t, h, dh, s0, ds, seed=b * t + dh + 1)
    r, k, v, logw, u, state0, dy, d_s = arrays
    st = np.zeros((b, h, dh, dh), np.float32) if state0 is None else state0
    dst = np.zeros_like(st) if d_s is None else d_s

    def loss(r, k, v, logw, u, s):
        y, fin = j_chunked(r, k, v, logw, u, s)
        return (y * dy).sum() + (fin * dst).sum()
    want = jax.grad(loss, argnums=tuple(range(6)))(
        *(jnp.asarray(a) for a in (r, k, v, logw, u, st)))
    got = wkv6_bwd_ref(*(_t(a) for a in arrays))
    for name, g, w in zip(NAMES, got, want):
        _close(g, w, name)


def test_each_result_in_its_inputs_dtype():
    arrays = _inputs(1, 40, 2, 16, True, True, seed=3)
    t = [_t(a) for a in arrays]
    r, k, v = (x.to(torch.bfloat16) for x in t[:3])
    got = wkv6_bwd_ref(r, k, v, t[3], t[4].to(torch.bfloat16), t[5], t[6],
                       t[7])
    assert [g.dtype for g in got] == [torch.bfloat16] * 3 + [
        torch.float32, torch.bfloat16, torch.float32]


def test_wkv6_function_cpu_path_gradcheck():
    """Float64 (the plain versions sum in float64 for float64 inputs)."""
    arrays = _inputs(1, 34, 1, 4, True, False, seed=5, dtype=np.float64)
    ins = [torch.from_numpy(a).requires_grad_(True) for a in arrays[:6]]
    assert torch.autograd.gradcheck(tops.WKV6Function.apply, ins)
    # y alone (the final state brings no cotangent), state0 None
    assert torch.autograd.gradcheck(
        lambda *a: tops.WKV6Function.apply(*a, None)[0], ins[:5])


def test_wkv6_function_cpu_path_equals_the_plain_versions():
    """Forward: ``wkv_chunked``'s bits; backward: ``wkv6_bwd_ref``'s, for
    exactly the inputs that need a gradient."""
    arrays = _inputs(2, 45, 2, 16, True, True, seed=7)
    r, k, v, logw, u, state0, dy, d_s = (_t(a) for a in arrays)
    ins = [x.clone().requires_grad_(True) for x in (r, k, v, logw)]
    y, s = tops.WKV6Function.apply(*ins, u, state0)
    y0, s0 = wkv_chunked(r, k, v, logw, u, state0)
    assert torch.equal(y, y0) and torch.equal(s, s0)
    grads = torch.autograd.grad((y * dy).sum() + (s * d_s).sum(), ins)
    want = wkv6_bwd_ref(r, k, v, logw, u, state0, dy, d_s)
    for g, w in zip(grads, want):
        assert torch.equal(g, w)


def test_wkv6_function_under_checkpoint():
    """``torch.utils.checkpoint`` runs the forward again in backward: the
    gradients are the ones without it, bit for bit."""
    arrays = _inputs(1, 50, 2, 16, False, False, seed=9)
    r, k, v, logw, u, _, dy, _ = (_t(a) for a in arrays)

    def f(r, k, v, logw, u):
        return (tops.WKV6Function.apply(r, k, v, logw, u, None)[0]
                * dy).sum()
    outs = []
    for ckpt in (False, True):
        ins = [x.clone().requires_grad_(True) for x in (r, k, v, logw, u)]
        loss = (torch.utils.checkpoint.checkpoint(f, *ins, use_reentrant=False)
                if ckpt else f(*ins))
        outs.append(torch.autograd.grad(loss, ins))
    for a, b in zip(*outs):
        assert torch.equal(a, b)


def _chunked_bwd_emulation(r, k, v, logw, u, state0, dy, d_s, nv=1):
    """The CUDA backward's algorithm per (b, h), float64, in its value-slice
    decomposition: NV slices of VB = Dh / NV value columns, each with its
    own S and G (pass 1 keeps each chunk's start state slice; pass 2 walks
    the chunks in reverse), in the forward's rebased basis (r'' = r
    e^{l_exc - l_tot}, kk = k e^{l_tot - l_inc}, S_dec = e^{l_tot} S0). A
    slice forms the partials X_r = dy S_dec^T + tril(Bm) kk, X_k = v G^T +
    tril(Bm)^T r'' (Bm = dy v^T) and v.dy of a chunk, and of P =
    rowsum(G S) at the chunk's end (G the adjoint there, S the next chunk's
    start state, or S_T); they are summed in the cluster's rank order, and
    the channels' owners apply the factors, run dlogw's reverse cumulative
    sum over the chunk from that P, and carry du."""
    b, t, h, dh = r.shape
    vb = dh // nv
    cols = [slice(j * vb, (j + 1) * vb) for j in range(nv)]
    nc = -(-t // CHUNK)
    pad = nc * CHUNK - t
    padf = lambda a: torch.nn.functional.pad(a.double(), (0, 0, 0, 0, 0, pad))
    r, k, v, logw, dy = map(padf, (r, k, v, logw, dy))
    u = u.double()
    out = [torch.zeros_like(r) for _ in range(4)]
    du = torch.zeros((h, dh), dtype=torch.float64)
    ds0 = torch.zeros((b, h, dh, dh), dtype=torch.float64)
    tri = lambda m: torch.tril(m, -1)
    zero = torch.zeros((dh, dh), dtype=torch.float64)
    for bi in range(b):
        for hi in range(h):
            s = zero if state0 is None else state0[bi, hi].double()
            g = zero if d_s is None else d_s[bi, hi].double()
            s_j = [s[:, c] for c in cols]
            g_j = [g[:, c] for c in cols]
            starts = [[] for _ in cols]
            for c in range(nc):
                sl = slice(c * CHUNK, (c + 1) * CHUNK)
                li = torch.cumsum(logw[bi, sl, hi], 0)
                kk = k[bi, sl, hi] * torch.exp(li[-1] - li)
                for j, cj in enumerate(cols):
                    starts[j].append(s_j[j])
                    s_j[j] = (torch.exp(li[-1])[:, None] * s_j[j]
                              + kk.T @ v[bi, sl, hi][:, cj])
            for c in reversed(range(nc)):
                sl = slice(c * CHUNK, (c + 1) * CHUNK)
                # P at the chunk's end, exactly: rowsum(G S_end) of each
                # slice, summed in rank order (S_end the next chunk's start)
                p = torch.zeros(dh, dtype=torch.float64)
                for j in range(nv):
                    s_end = starts[j][c + 1] if c + 1 < nc else s_j[j]
                    p = p + (s_end * g_j[j]).sum(1)
                rr, kr, vv, dd, lw = (a[bi, sl, hi] for a in (r, k, v, dy,
                                                               logw))
                li = torch.cumsum(lw, 0)
                tot = li[-1]
                erp, ekk = torch.exp(li - lw - tot), torch.exp(tot - li)
                rpp, kk, etot = rr * erp, kr * ekk, torch.exp(tot)
                a_m = tri(rpp @ kk.T) + torch.diag((rr * u[hi] * kr).sum(1))
                xr = torch.zeros((CHUNK, dh), dtype=torch.float64)
                xk, vdy = torch.zeros_like(xr), torch.zeros(CHUNK,
                                                            dtype=torch.float64)
                for j, cj in enumerate(cols):
                    vj, dj = vv[:, cj], dd[:, cj]
                    b_m = dj @ vj.T
                    xr = xr + (dj @ (etot[:, None] * starts[j][c]).T
                               + tri(b_m) @ kk)
                    xk = xk + (vj @ g_j[j].T + tri(b_m).T @ rpp)
                    vdy = vdy + torch.diagonal(b_m)
                    out[2][bi, sl, hi, cj] = kk @ g_j[j] + a_m.T @ dj
                    g_j[j] = etot[:, None] * (g_j[j] + rpp.T @ dj)
                drh, dkh = erp * xr, ekk * xk
                out[0][bi, sl, hi] = drh + u[hi] * kr * vdy[:, None]
                out[1][bi, sl, hi] = dkh + u[hi] * rr * vdy[:, None]
                kd = kr * dkh
                x = kd - rr * drh
                incl = torch.flip(torch.cumsum(torch.flip(x, [0]), 0), [0])
                excl = torch.cat([incl[1:], torch.zeros((1, dh),
                                                        dtype=torch.float64)])
                out[3][bi, sl, hi] = (p - excl) - kd
                du[hi] += (rr * kr * vdy[:, None]).sum(0)
            ds0[bi, hi] = torch.cat(g_j, dim=1)
    return [o[:, :t] for o in out] + [du, ds0]


@pytest.mark.parametrize("b,t,h,dh,s0,ds", CASES[:3], ids=IDS[:3])
def test_kernel_algorithm_matches_autograd(b, t, h, dh, s0, ds):
    arrays = _inputs(b, t, h, dh, s0, ds, seed=b * t + dh + 2)
    got = _chunked_bwd_emulation(*(_t(a) for a in arrays))
    want = _autograd(*(_t(a) for a in arrays))
    for name, g, w in zip(NAMES, got, want):
        _close(g, w, name)


# every NV the kernel takes at each case's head size (its value splits)
SLICE_CASES = [c + (nv,) for c in CASES for nv in value_splits(c[3])]
SLICE_IDS = [f"{i}_NV{c[-1]}" for c in SLICE_CASES
             for i in [IDS[CASES.index(c[:-1])]]]


@pytest.mark.parametrize("b,t,h,dh,s0,ds,nv", SLICE_CASES, ids=SLICE_IDS)
def test_kernel_slices_match_autograd(b, t, h, dh, s0, ds, nv):
    """The slice decomposition, the partials summed in rank order, at every
    NV: autograd of ``wkv_chunked`` within TOL of each gradient's scale."""
    arrays = _inputs(b, t, h, dh, s0, ds, seed=b * t + dh + 3)
    got = _chunked_bwd_emulation(*(_t(a) for a in arrays), nv=nv)
    want = _autograd(*(_t(a) for a in arrays))
    for name, g, w in zip(NAMES, got, want):
        _close(g, w, name)


@pytest.mark.parametrize("b,t,h,dh,s0,ds,nv", SLICE_CASES, ids=SLICE_IDS)
def test_kernel_slices_match_jax_grad_of_reference(b, t, h, dh, s0, ds, nv):
    """The same against ``jax.grad`` of the reference's ``wkv_chunked``."""
    arrays = _inputs(b, t, h, dh, s0, ds, seed=b * t + dh + 4)
    r, k, v, logw, u, state0, dy, d_s = arrays
    st = np.zeros((b, h, dh, dh), np.float32) if state0 is None else state0
    dst = np.zeros_like(st) if d_s is None else d_s

    def loss(r, k, v, logw, u, s):
        y, fin = j_chunked(r, k, v, logw, u, s)
        return (y * dy).sum() + (fin * dst).sum()
    want = jax.grad(loss, argnums=tuple(range(6)))(
        *(jnp.asarray(a) for a in (r, k, v, logw, u, st)))
    got = _chunked_bwd_emulation(*(_t(a) for a in arrays), nv=nv)
    for name, g, w in zip(NAMES, got, want):
        _close(g, w, name)


def test_cuda_backward_refuses_cpu_tensors_and_other_head_sizes():
    arrays = [_t(a) for a in _inputs(1, 8, 1, 16, False, False, seed=1)]
    with pytest.raises(ValueError, match="CUDA"):
        wkv6_bwd_cuda(*arrays)
    assert BWD_DHS == (4, 8, 16, 32, 64)
    with pytest.raises(ValueError, match="Dh=48"):
        wkv6_bwd_cuda(*[_t(a) for a in _inputs(1, 8, 1, 48, False, False,
                                                seed=1)])

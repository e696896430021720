"""K6's value-column form on the CPU (the plain versions the kernels of
``csrc/wkv6.cu`` are held to on the card): under the "model" axis's head_dim
fallback a rank runs the WKV6 recurrence on its Dv = Dh / m value columns of
v, with r, k, logw and u whole (``models/rwkv6.py``).

  * ``wkv_chunked`` and ``wkv_scan_ref`` on Dv columns (and the state's
    columns) equal those columns of the whole head's y and final state;
  * ``wkv6_bwd_ref`` on Dv columns: its dv and dstate0 are the whole head's
    columns, and the m slices' dr, dk, dlogw and du, summed in rank order,
    equal the whole head's; they equal autograd of ``wkv_chunked`` too;
  * ``WKV6Function``'s CPU path takes the form (float64 ``gradcheck``), and
    the meta forms give its shapes;
  * the CUDA wrappers refuse a Dv that does not divide Dh.

Float64 throughout, so the sums in other orders part by ~1e-15 of scale;
held to 1e-12.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import meta
from repro_torch.kernels.wkv6 import ops as tops
from repro_torch.kernels.wkv6.ref import (wkv6_bwd_ref, wkv_chunked,
                                          wkv_scan_ref)
from repro_torch.kernels.wkv6.wkv6 import (value_splits, wkv6_bwd_cuda,
                                           wkv6_cuda)

TOL = 1e-12
# (B, T, H, Dh, m): rwkv6-3b's Dh 64 over 2 and 16 ranks (Dv 32, 4), the
# smoke configs' 16 over 8 (Dv 2), a ragged T
CASES = [(2, 40, 2, 64, 2), (1, 37, 2, 64, 16), (2, 33, 2, 16, 8),
         (1, 70, 1, 32, 4)]
IDS = [f"B{b}T{t}H{h}Dh{dh}m{m}" for b, t, h, dh, m in CASES]


def _inputs(b, t, h, dh, seed):
    g = torch.Generator().manual_seed(seed)
    rnd = lambda *s: torch.randn(*s, generator=g, dtype=torch.float64)
    r, k, v = (0.5 * rnd(b, t, h, dh) for _ in range(3))
    logw = torch.clamp(-torch.exp(0.5 * rnd(b, t, h, dh) - 1.0), min=-2.0)
    return (r, k, v, logw, 0.3 * rnd(h, dh), 0.3 * rnd(b, h, dh, dh),
            rnd(b, t, h, dh), rnd(b, h, dh, dh))


def _close(got, want, what):
    scale = want.abs().max()
    assert (got - want).abs().max() <= TOL * scale, what


@pytest.mark.parametrize("b,t,h,dh,m", CASES, ids=IDS)
def test_forward_on_value_columns_is_the_whole_heads_columns(b, t, h, dh, m):
    r, k, v, logw, u, s0, _, _ = _inputs(b, t, h, dh, seed=t + dh)
    dv = dh // m
    for fn in (wkv_chunked, wkv_scan_ref):
        y, s = fn(r, k, v, logw, u, s0)
        for j in range(m):
            cols = slice(j * dv, (j + 1) * dv)
            yj, sj = fn(r, k, v[..., cols], logw, u, s0[..., cols])
            assert yj.shape == (b, t, h, dv) and sj.shape == (b, h, dh, dv)
            _close(yj, y[..., cols], f"{fn.__name__} y {j}")
            _close(sj, s[..., cols], f"{fn.__name__} state {j}")


@pytest.mark.parametrize("b,t,h,dh,m", CASES, ids=IDS)
def test_backward_partials_sum_to_the_whole_heads(b, t, h, dh, m):
    r, k, v, logw, u, s0, dy, ds = _inputs(b, t, h, dh, seed=t + dh + 1)
    dv = dh // m
    whole = wkv6_bwd_ref(r, k, v, logw, u, s0, dy, ds)
    sums = None
    for j in range(m):
        cols = slice(j * dv, (j + 1) * dv)
        part = wkv6_bwd_ref(r, k, v[..., cols], logw, u, s0[..., cols],
                            dy[..., cols], ds[..., cols])
        _close(part[2], whole[2][..., cols], f"dv {j}")
        _close(part[5], whole[5][..., cols], f"dstate0 {j}")
        shared = [part[i] for i in (0, 1, 3, 4)]
        sums = shared if sums is None else [a + p for a, p in
                                            zip(sums, shared)]
    for name, got, i in zip(("dr", "dk", "dlogw", "du"), sums, (0, 1, 3, 4)):
        _close(got, whole[i], name)
    # ... and autograd of the chunked form agrees with the summed partials
    ins = [x.clone().requires_grad_(True) for x in (r, k, v, logw, u, s0)]
    y, s = wkv_chunked(*ins)
    want = torch.autograd.grad((y * dy).sum() + (s * ds).sum(), ins)
    for name, got, i in zip(("dr", "dk", "dlogw", "du"), sums, (0, 1, 3, 4)):
        assert (got - want[i]).abs().max() <= 1e-10 * want[i].abs().max(), \
            name


def test_wkv6_function_takes_value_columns():
    """``WKV6Function``'s CPU path on Dv columns (the plain versions): its
    y and final state, and every input's gradient against autograd of
    ``wkv_chunked``."""
    r, k, v, logw, u, s0, dy, ds = _inputs(1, 37, 2, 8, seed=5)
    cols = slice(4, 8)
    args = (r, k, v[..., cols].contiguous(), logw, u,
            s0[..., cols].contiguous())
    ins = [x.clone().requires_grad_(True) for x in args]
    y, s = tops.WKV6Function.apply(*ins)
    assert y.shape == (1, 37, 2, 4) and s.shape == (1, 2, 8, 4)
    loss = lambda y, s: (y * dy[..., cols]).sum() + (s * ds[..., cols]).sum()
    got = torch.autograd.grad(loss(y, s), ins)
    ref = [x.clone().requires_grad_(True) for x in args]
    want = torch.autograd.grad(loss(*wkv_chunked(*ref)), ref)
    for g, w in zip(got, want):
        assert (g - w).abs().max() <= 1e-10 * w.abs().max()


def test_meta_forms_take_value_columns():
    mk = lambda *s: torch.empty(*s, device="meta")
    r, v = mk(2, 64, 40, 64), mk(2, 64, 40, 4)
    with meta.tally() as tally:
        y, s = tops.wkv6(r, r, v, r, mk(40, 64), None)
        grads = meta.wkv6_bwd(r, r, v, r, mk(40, 64), None, mk(2, 64, 40, 4))
    assert y.shape == (2, 64, 40, 4) and s.shape == (2, 40, 64, 4)
    assert [tuple(g.shape) for g in grads[:5]] == [
        (2, 64, 40, 64), (2, 64, 40, 64), (2, 64, 40, 4), (2, 64, 40, 64),
        (40, 64)]
    assert tally["wkv6"]["calls"] == 1 and tally["wkv6_bwd"]["calls"] == 1
    # fewer value columns: fewer bytes, of y and of v
    with meta.tally() as whole:
        tops.wkv6(r, r, r, r, mk(40, 64), None)
    assert tally["wkv6"]["bytes"] < whole["wkv6"]["bytes"]


def test_value_splits_of_the_fallbacks_widths():
    """The NV the kernels take for a rank's value columns: slices of a
    multiple of 8, or one slice (Dv = 4 padded to 8 in shared memory)."""
    assert value_splits(32) == [1, 2, 4]
    assert value_splits(16) == [1, 2]
    assert value_splits(4) == [1]


def test_cuda_wrappers_refuse_a_dv_that_does_not_divide_dh():
    r, k, v, logw, u, _, dy, _ = (x.float() for x in _inputs(1, 8, 1, 16,
                                                             seed=2))
    v12 = v[..., :12].contiguous()
    for call in (lambda: wkv6_cuda(r, k, v12, logw, u),
                 lambda: wkv6_bwd_cuda(r, k, v12, logw, u, None,
                                       dy[..., :12].contiguous())):
        with pytest.raises(ValueError, match="Dv"):
            call()
    with pytest.raises(ValueError, match="CUDA"):
        wkv6_cuda(r, k, v[..., :8].contiguous(), logw, u)
    assert np.isfinite(float(r.sum()))

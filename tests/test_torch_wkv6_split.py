"""How the port's WKV6 kernel (``csrc/wkv6.cu``) splits its work and rounds
its products, checked on the CPU, where the kernel cannot run.

* ``wkv_plan`` / ``value_slices`` give every value column of a head to
  exactly one block, in slices of a multiple of 8 columns (the tensor
  cores' step) or the whole head (NV = 1), and take the largest split whose
  blocks the card holds at once.
* The kernel's arithmetic, emulated in float32 PyTorch: each value slice
  recomputes the chunk's scan, rebasing and A; the cumulative log-decay is
  the warp's shuffle scan (Hillis-Steele, five steps, in that order of
  additions); the factors are rebased as the kernel rebases them (r'' =
  r e^{l_exc - l_tot}, kk = k e^{l_tot - l_inc}, S_dec = e^{l_tot} S), with
  its exponential (``__expf``: 2^(x log2 e), the product rounded to
  float32); the four products are TF32 tensor-core products with the
  3-term split (x = hi + lo, each rounded to TF32 by round to nearest, ties
  away, on the float32 bits; lo*hi + hi*lo + hi*hi summed in float32, a
  k-step of 8 at a time). That emulation equals the plain chunked version
  ``ref.wkv_chunked`` and the JAX package's Pallas kernel in interpret
  mode within 3e-4, the reference's own tolerance
  (``tests/test_torch_wkv6.py``), on ragged lengths, with and without an
  initial state.
  One-term TF32 (hi*hi alone) misses that tolerance.
* ``bwd_plan`` (the backward's: a thread-block cluster of NV blocks a
  (b, h)) gives every value column, and every channel, to exactly one
  block of the cluster, takes the largest split whose clusters the card
  runs at once, and raises when a block cannot run.
* The CUDA wrapper raises for CPU tensors and for a split it cannot take.

``chip_smoke.py`` holds the kernel itself against ``wkv_chunked`` on the
card.
"""
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import example, given, settings
from hypothesis import strategies as st

from repro.kernels.wkv6.ops import wkv6 as j_wkv6
from repro.models.rwkv6 import wkv_chunked as j_chunked
from repro_torch.kernels.wkv6.ref import CHUNK, wkv_chunked
from repro_torch.kernels.wkv6.wkv6 import (BWD_DHS, MAX_DH, bwd_plan,
                                           value_slices, value_splits,
                                           wkv6_cuda, wkv_plan)

TOL = 3e-4
# (B, T, H, Dh): ragged T against the chunk of 32, rwkv6's head size 64,
# a head under 8 columns (padded to the tensor cores' step) and one of 12
SHAPES = [(2, 64, 3, 16), (1, 100, 2, 64), (2, 32, 4, 8), (1, 70, 2, 64),
          (2, 5, 2, 16), (1, 45, 2, 4), (1, 40, 1, 12)]
IDS = [f"B{b}T{t}H{h}Dh{dh}" for b, t, h, dh in SHAPES]


def _inputs(b, t, h, dh, seed, state=False):
    """As ``tests/test_torch_wkv6.py`` draws them: float32 numpy, logw
    clamped at -2 as the model clamps it."""
    rng = np.random.default_rng(seed)
    r, k, v = (0.5 * rng.normal(size=(b, t, h, dh)) for _ in range(3))
    logw = np.maximum(-np.exp(0.5 * rng.normal(size=(b, t, h, dh)) - 1.0), -2.0)
    u = 0.3 * rng.normal(size=(h, dh))
    out = [a.astype(np.float32) for a in (r, k, v, logw, u)]
    out.append((0.3 * rng.normal(size=(b, h, dh, dh))).astype(np.float32)
               if state else None)
    return out


def _close(got, want, what):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=TOL,
                               atol=TOL, err_msg=what)


# ---------------------------------------------------------------------------
# the plan
# ---------------------------------------------------------------------------

@settings(max_examples=300, deadline=None)
@given(dh=st.integers(1, MAX_DH // 4).map(lambda x: 4 * x),
       bh=st.integers(1, 400), n_slots=st.integers(1, 2000))
@example(dh=64, bh=160, n_slots=396)
@example(dh=4, bh=1, n_slots=1000)
def test_plan_covers_every_value_column_once(dh, bh, n_slots):
    nv = wkv_plan(1, bh, dh, n_slots)
    assert nv in value_splits(dh)
    seen = np.zeros(dh, int)
    for lo, hi in value_slices(dh, nv):
        assert hi - lo == dh // nv
        assert (hi - lo) % 8 == 0 or nv == 1
        seen[lo:hi] += 1
    assert np.all(seen == 1)
    # one wave: every block resident, unless even NV = 1 overflows
    assert bh * nv <= n_slots or nv == 1
    # and the largest such split
    assert all(bh * m > n_slots for m in value_splits(dh) if m > nv)


def test_plan_reads_the_slots_of_each_slice_width():
    """The blocks an SM holds depend on the slice width (its shared
    memory): a plan is held to the slots of the width it takes."""
    slots = {64: 264, 32: 396, 16: 528, 8: 660}
    assert wkv_plan(4, 40, 64, slots.__getitem__) == 2     # 320 <= 396
    assert wkv_plan(4, 40, 64, 132) == 1                   # 160 > 132
    assert wkv_plan(1, 2, 64, 132) == 8                    # slices of 8
    assert value_splits(64) == [1, 2, 4, 8]
    assert value_splits(12) == [1] and value_splits(4) == [1]


def test_value_slices_refuse_a_split_the_kernel_cannot_take():
    with pytest.raises(ValueError, match="NV=3"):
        value_slices(64, 3)
    with pytest.raises(ValueError, match="NV=2"):
        value_slices(8, 2)          # slices of 4 columns


# the backward's plan: a cluster of NV blocks a (b, h); n_clusters(nv) is
# what the card runs at once of such clusters (0: it cannot run one)
@settings(max_examples=300, deadline=None)
@given(dh=st.sampled_from(BWD_DHS), bh=st.integers(1, 400),
       counts=st.lists(st.integers(0, 300), min_size=4, max_size=4),
       one=st.integers(1, 300))
@example(dh=64, bh=80, counts=[132, 132, 66, 33], one=132)
@example(dh=4, bh=1, counts=[0, 0, 0, 0], one=1)
def test_bwd_plan_one_wave_and_every_column_owned_once(dh, bh, counts, one):
    n = dict(zip(value_splits(dh), [one] + counts[1:]))
    nv = bwd_plan(1, bh, dh, n.__getitem__)
    assert nv in value_splits(dh) and nv <= 8      # a portable cluster
    vb = dh // nv
    seen = np.zeros(dh, int)
    for lo, hi in value_slices(dh, nv):
        assert hi - lo == vb and (vb % 8 == 0 or nv == 1)
        seen[lo:hi] += 1
    # every value column, and every channel (block j owns the channels of
    # its columns' indices), to exactly one block of the cluster
    assert np.all(seen == 1)
    assert sorted(ch // vb for ch in range(dh)) == sorted(
        j for j in range(nv) for _ in range(vb))
    # one wave: every cluster resident, unless even NV = 1 overflows
    assert bh <= n[nv] or nv == 1
    # and the largest such split
    assert all(bh > n[m] for m in value_splits(dh) if m > nv)


def test_bwd_plan_reads_the_clusters_of_each_split():
    # the layout's shared memory at Dh = 64 (bf16): ~147 KB at NV = 1, ~105
    # KB at 2, ~88 KB at 4, ~79 KB at 8, so 1, 2, 2, 2 blocks an SM
    clusters = {1: 132, 2: 132, 4: 66, 8: 33}
    assert bwd_plan(2, 40, 64, clusters.__getitem__) == 2   # 80 <= 132 > 66
    assert bwd_plan(1, 40, 64, clusters.__getitem__) == 4   # 40 <= 66
    assert bwd_plan(1, 4, 64, clusters.__getitem__) == 8
    assert bwd_plan(4, 40, 64, clusters.__getitem__) == 1   # two waves of one
    assert bwd_plan(1, 1, 64, {1: 1, 2: 0, 4: 0, 8: 0}.__getitem__) == 1


def test_bwd_plan_raises_when_a_block_cannot_run():
    with pytest.raises(RuntimeError, match="cannot run"):
        bwd_plan(1, 1, 64, lambda nv: 0)
    with pytest.raises(RuntimeError, match="Dh=16"):
        bwd_plan(2, 8, 16, {1: 0, 2: 5}.__getitem__)


# ---------------------------------------------------------------------------
# the kernel's arithmetic
# ---------------------------------------------------------------------------

def tf32(x: torch.Tensor) -> torch.Tensor:
    """cvt.rna.tf32.f32: round to 10 mantissa bits, to nearest, ties away
    from zero, on the float32 bits."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def split(x: torch.Tensor):
    hi = tf32(x)
    return hi, tf32(x - hi)


def mma3(c, a, b):
    """c + a @ b (float32, ``(..., m, k) @ (..., k, n)``) as the kernel forms
    it: a k-step of 8 at a time, lo*hi, hi*lo, hi*hi. The product of two
    TF32 numbers is exact in float32; the sums round in float32."""
    a_hi, a_lo = split(a)
    b_hi, b_lo = split(b)
    for s in range(0, a.shape[-1], 8):
        ks = slice(s, s + 8)
        c = c + a_lo[..., ks] @ b_hi[..., ks, :]
        c = c + a_hi[..., ks] @ b_lo[..., ks, :]
        c = c + a_hi[..., ks] @ b_hi[..., ks, :]
    return c


LOG2E = torch.tensor(1.4426950408889634, dtype=torch.float32)


def fast_exp(x: torch.Tensor) -> torch.Tensor:
    """``__expf``: ex2.approx of x log2(e), the product rounded to float32
    (its ~2-ulp approximation is not modelled)."""
    return torch.exp2(x * LOG2E)


def warp_scan(lw: torch.Tensor) -> torch.Tensor:
    """Inclusive sum over dim -2 (the 32 lanes) by the shuffle scan:
    step ``off`` adds lane t - off's value to lane t >= off."""
    x = lw
    for off in (1, 2, 4, 8, 16):
        nxt = x.clone()
        nxt[..., off:, :] = x[..., off:, :] + x[..., :-off, :]
        x = nxt
    return x


def wkv_emulated(r, k, v, logw, u, state0, nv):
    """The kernel's arithmetic in float32 PyTorch, block by block: for each
    value slice j of the NV, the scan, rebasing, u-bonus and A of every
    chunk again; A = tril_strict(r'' kk^T) + diag(sum_d r u k);
    y = r'' S_dec then += A v; S <- S_dec + kk^T v. The same values as the
    reference's r' k'^T, r' S and (k' e^{l_tot})^T v, with e^{+-l_tot}
    moved between the operands. Same contract as ``ref.wkv_chunked``."""
    b, t, h, dh = r.shape
    pad = (-t) % CHUNK
    padf = lambda a: torch.nn.functional.pad(a.float(), (0, 0, 0, 0, 0, pad))
    # (B, H, chunks, C, Dh)
    r, k, v, logw = (padf(a).reshape(b, -1, CHUNK, h, dh).permute(0, 3, 1, 2, 4)
                     for a in (r, k, v, logw))
    s_all = (torch.zeros((b, h, dh, dh)) if state0 is None
             else state0.float().clone())
    y = torch.empty((b, h, r.shape[2], CHUNK, dh))
    tri = torch.tril(torch.ones((CHUNK, CHUNK), dtype=torch.bool), -1)
    eye = torch.eye(CHUNK, dtype=torch.bool)
    for lo, hi in value_slices(dh, nv):
        s = s_all[..., lo:hi].clone()
        for c in range(r.shape[2]):
            rc, kc, lw = r[:, :, c], k[:, :, c], logw[:, :, c]
            vc = v[:, :, c, :, lo:hi]
            l_inc = warp_scan(lw)
            l_tot = l_inc[..., -1:, :]
            r2 = rc * fast_exp((l_inc - lw) - l_tot)              # r''
            kk = kc * fast_exp(l_tot - l_inc)
            etot = fast_exp(l_tot[..., 0, :])                     # (B, H, Dh)
            diag = (rc * u.float()[:, None] * kc).sum(-1)         # (B, H, C)
            a = mma3(torch.zeros((b, h, CHUNK, CHUNK)), r2,
                     kk.transpose(-1, -2))
            a = torch.where(tri, a, torch.where(eye, diag[..., None], 0.0))
            s_dec = etot[..., None] * s
            yc = mma3(torch.zeros((b, h, CHUNK, hi - lo)), r2, s_dec)
            y[:, :, c, :, lo:hi] = mma3(yc, a, vc)
            s = mma3(s_dec, kk.transpose(-1, -2), vc)
        s_all[..., lo:hi] = s
    y = y.permute(0, 2, 3, 1, 4).reshape(b, -1, h, dh)[:, :t]
    return y, s_all


@pytest.mark.parametrize("with_state", [False, True], ids=["zero", "state"])
@pytest.mark.parametrize("b,t,h,dh", SHAPES, ids=IDS)
def test_emulated_kernel_matches_the_plain_version(b, t, h, dh, with_state):
    """Every NV the kernel takes at this Dh, against ``wkv_chunked``: y and
    the final state."""
    arrays = _inputs(b, t, h, dh, seed=7 * t + dh, state=with_state)
    tt = [None if a is None else torch.from_numpy(a) for a in arrays]
    y_r, s_r = wkv_chunked(*tt)
    for nv in value_splits(dh):
        y, s = wkv_emulated(*tt, nv)
        _close(y, y_r, f"y, NV={nv}")
        _close(s, s_r, f"state, NV={nv}")


@pytest.mark.parametrize("b,t,h,dh", SHAPES, ids=IDS)
def test_emulated_kernel_matches_the_tpu_kernel(b, t, h, dh):
    """Against ``wkv6_pallas`` in interpret mode (zero state, y alone), at
    the largest NV for this Dh."""
    arrays = _inputs(b, t, h, dh, seed=b * t + dh)[:5]
    y, _ = wkv_emulated(*(torch.from_numpy(a) for a in arrays), None,
                        value_splits(dh)[-1])
    want = j_wkv6(*(jnp.asarray(a) for a in arrays), use_pallas=True,
                  interpret=True)
    _close(y, want, "y")


@pytest.mark.parametrize("nv", [1, 2, 4, 8])
def test_emulated_kernel_matches_the_reference_with_a_state(nv):
    """rwkv6's head size with a non-zero state and a ragged T, against the
    JAX package's chunked form (y and the final state)."""
    arrays = _inputs(1, 70, 2, 64, seed=nv, state=True)
    y, s = wkv_emulated(*(torch.from_numpy(a) for a in arrays), nv)
    jy, js = j_chunked(*(jnp.asarray(a) for a in arrays))
    _close(y, jy, "y")
    _close(s, js, "state")


def test_one_term_tf32_misses_the_tolerance(monkeypatch):
    """The tolerance tells the schemes apart: with hi*hi alone (one-term
    TF32) the same emulation leaves 3e-4, so the 3-term split is needed."""
    arrays = [torch.from_numpy(a) for a in _inputs(1, 100, 2, 64, seed=3,
                                                   state=True)]
    y_r, _ = wkv_chunked(*arrays)
    monkeypatch.setattr(sys.modules[__name__], "mma3",
                        lambda c, a, b: c + tf32(a) @ tf32(b))
    y, _ = wkv_emulated(*arrays, 2)
    excess = ((y - y_r).abs() - TOL * y_r.abs()).max()
    assert excess > TOL, float(excess)


def test_tf32_rounds_to_nearest_ties_away():
    one = 1.0
    ulp = 2.0 ** -10                    # TF32's spacing at 1
    x = torch.tensor([one + ulp / 2, -(one + ulp / 2), one + ulp / 4,
                      one + 3 * ulp / 4, 3.0e38, 1e-30], dtype=torch.float32)
    want = torch.tensor([one + ulp, -(one + ulp), one, one + ulp,
                         float(tf32(torch.tensor([3.0e38]))[0]),
                         float(tf32(torch.tensor([1e-30]))[0])])
    assert torch.equal(tf32(x), want)
    hi, lo = split(torch.tensor([np.pi], dtype=torch.float32))
    assert abs(float(hi) + float(lo) - np.pi) < 2.0 ** -21 * np.pi
    # a bf16 number is a TF32 number: its lo is zero
    vb = torch.randn(64).to(torch.bfloat16).float()
    assert torch.equal(tf32(vb), vb)


# ---------------------------------------------------------------------------
# the wrapper
# ---------------------------------------------------------------------------

def test_cuda_wrapper_raises_for_cpu_tensors_and_bad_splits():
    arrays = _inputs(1, 40, 2, 16, 0)[:5]
    r, k, v, logw, u = (torch.from_numpy(a) for a in arrays)
    with pytest.raises(ValueError, match="CUDA"):
        wkv6_cuda(r, k, v, logw, u)
    with pytest.raises(ValueError, match="CUDA"):
        wkv6_cuda(r, k, v, logw, u, nv=2)
    with pytest.raises(ValueError, match="Dh"):
        wkv6_cuda(*(a.new_zeros((1, 4, 1, 6)) for a in (r, k, v, logw)), u)

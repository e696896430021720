"""How the port's single-read LC step (``csrc/amp_local.cu``) splits its
work, checked on the CPU, where the kernels cannot run.

* ``split_plan`` (row bands of K1) and ``col_band_plan`` (row bands of the
  column row pass) put every row of every shard in exactly one band.
* The band kernel's arithmetic, emulated in float32 PyTorch (each band reads
  a row once for its dot product and its share of f, keeps band partials of
  f and ss; the combine adds them in its fixed order and x / P; a shard of
  one band writes f itself), equals the plain
  step ``amp_local_ref_grid`` and the JAX package's Pallas kernel in
  interpret mode, within 1e-5 of the output's scale: float32 sums in another
  order.
* Which kernels a step takes (``single_read``) depends on (N, dtype) alone.
* The CUDA wrapper raises for CPU tensors on either route.

``chip_smoke.py`` holds the kernels themselves against the plain step on the
card.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from repro.kernels.amp_fused import ops as jops
from repro.kernels.amp_fused.amp_fused import amp_local_pallas_grid
from repro_torch.kernels.amp_fused import ops as tops
from repro_torch.kernels.amp_fused.amp_fused import (SINGLE_READ_MAX_N,
                                                     amp_local_cuda_grid,
                                                     combine_groups,
                                                     rows_per_stage,
                                                     single_read, split_plan)
from repro_torch.kernels.amp_fused.col import col_band_plan
from repro_torch.kernels.amp_fused.ref import amp_local_ref_grid

RTOL = 1e-5
N_PROC = 10
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _close(got, want, what):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    scale = np.abs(want).max()
    err = np.abs(got - want).max()
    assert err <= RTOL * scale, f"{what}: {err:.3e} > {RTOL} * {scale:.3e}"


def _covers_once(band_rows, n_bands, m):
    """Bands [i * band_rows, min(m, (i + 1) * band_rows)) cover 0..m-1 once,
    none empty."""
    assert band_rows >= 1 and n_bands >= 1
    seen = np.zeros(m, int)
    for i in range(n_bands):
        lo, hi = i * band_rows, min(m, (i + 1) * band_rows)
        assert hi > lo, (i, band_rows, n_bands, m)
        seen[lo:hi] += 1
    assert np.all(seen == 1)


@settings(max_examples=200, deadline=None)
@given(batch=st.integers(1, 16), p=st.integers(1, 64),
       mp=st.integers(1, 5000), n=st.integers(1, SINGLE_READ_MAX_N),
       dtype=st.sampled_from(sorted(DTYPES)),
       n_sm=st.sampled_from([1, 8, 132]))
def test_split_plan_puts_every_row_in_one_band(batch, p, mp, n, dtype, n_sm):
    band_rows, n_bands = split_plan(batch, p, mp, n, DTYPES[dtype], n_sm)
    _covers_once(band_rows, n_bands, mp)
    # about one block an SM: no more blocks than SMs unless the shards alone
    # outnumber them
    assert batch * p * n_bands <= max(n_sm, batch * p)
    # the partial f's (written and read once) stay under a tenth of A
    if n_bands > 1:
        esize = 2 if dtype == "bfloat16" else 4
        assert 4 * n_bands * n <= 0.1 * mp * n * esize


@pytest.mark.parametrize("batch,p,mp,n,dtype,want", [
    (1, 30, 100, 10000, "float32", (25, 4)),     # the paper's row shape
    (1, 1, 3000, 10000, "float32", (23, 131)),   # centralized: no underfill
    (8, 30, 100, 10000, "float32", (100, 1)),    # shards outnumber the SMs
    (1, 1, 1, 1001, "bfloat16", (1, 1)),         # one row
])
def test_split_plan_at_the_paper_shapes(batch, p, mp, n, dtype, want):
    assert split_plan(batch, p, mp, n, DTYPES[dtype], 132) == want


@settings(max_examples=200, deadline=None)
@given(batch=st.integers(1, 16), p=st.integers(1, 64),
       n=st.integers(1, SINGLE_READ_MAX_N), n_bands=st.integers(1, 200),
       n_sm=st.sampled_from([1, 8, 132]))
def test_combine_groups_are_a_power_of_two_within_bounds(batch, p, n, n_bands,
                                                         n_sm):
    g = combine_groups(batch, p, n, n_bands, n_sm)
    assert g in (1, 2, 4, 8) and g <= n_bands
    if batch * p * n >= n_sm * 2048:      # the columns fill the card alone
        assert g == 1


def test_combine_groups_at_the_paper_shapes():
    assert combine_groups(1, 30, 10000, 4) == 1     # 300 000 columns
    assert combine_groups(1, 1, 10000, 131) == 8    # P = 1: 10 000 columns


@settings(max_examples=200, deadline=None)
@given(n_stack=st.integers(1, 300), m=st.integers(1, 5000),
       n_sm=st.sampled_from([1, 8, 132]))
def test_col_band_plan_puts_every_row_in_one_band(n_stack, m, n_sm):
    band_rows, n_bands = col_band_plan(n_stack, m, n_sm)
    _covers_once(band_rows, n_bands, m)
    assert n_stack * n_bands <= max(2 * n_sm, n_stack)


def _band_step(a, x, y, z, ons, n_proc, n_sm):
    """The single-read kernels' arithmetic in float32 PyTorch, band by band
    and stage by stage: a (B, P, Mp, N), x (B, N), y/z (B, P, Mp), ons (B,).
    Each row is read once; its dot product gives z'_i, then the band's f
    partial takes z'_i A_i and its ss partial z'_i^2. The combine adds the
    f partials of bands g, g + G, ... in band order (G = ``combine_groups``),
    then the groups' sums in group order, then x / P; with one band the band
    kernel
    adds x / P to its partial itself. ss: the partials of a batch entry in
    (p, band) order, as the combine's single warp adds them (lane-strided,
    then a butterfly), which float32 rounding cannot tell from plain order
    at this tolerance."""
    bsz, p, mp, n = a.shape
    a32 = a.float()
    band_rows, n_bands = split_plan(bsz, p, mp, n, a.dtype, n_sm)
    r_stage = rows_per_stage(n)
    z_new = torch.empty(bsz, p, mp)
    f = torch.empty(bsz, p, n)
    ss = torch.empty(bsz)
    for b in range(bsz):
        ss_b = torch.zeros(())
        for q in range(p):
            parts = []
            for s in range(n_bands):
                r0 = s * band_rows
                nrows = min(band_rows, mp - r0)
                part, ss_part = torch.zeros(n), torch.zeros(())
                for k in range(-(-nrows // r_stage)):
                    for i in range(r0 + k * r_stage,
                                   r0 + min(nrows, (k + 1) * r_stage)):
                        row = a32[b, q, i]
                        zn = (y[b, q, i] - torch.dot(row, x[b])) \
                            + ons[b] * z[b, q, i]
                        z_new[b, q, i] = zn
                        ss_part = ss_part + zn * zn
                        part = part + zn * row
                parts.append(part)
                ss_b = ss_b + ss_part
            if n_bands == 1:
                f[b, q] = x[b] / n_proc + parts[0]
                continue
            groups = combine_groups(bsz, p, n, n_bands, n_sm)
            tot = torch.zeros(n)
            for g in range(groups):
                acc = torch.zeros(n)
                for s in range(g, n_bands, groups):
                    acc = acc + parts[s]
                tot = tot + acc
            f[b, q] = x[b] / n_proc + tot
        ss[b] = ss_b
    return z_new, f, ss


def _inputs(p, mp, n, dtype, seed):
    rng = np.random.default_rng(seed + p * mp * n)
    a = (rng.normal(size=(p, mp, n)) / np.sqrt(p * mp)).astype(np.float32)
    x = rng.normal(size=n).astype(np.float32)
    y = rng.normal(size=(p, mp)).astype(np.float32)
    z = rng.normal(size=(p, mp)).astype(np.float32)
    a_t = torch.from_numpy(a).to(DTYPES[dtype])
    a_j = jnp.asarray(a).astype(dtype)
    np.testing.assert_array_equal(np.asarray(a_j.astype(jnp.float32)),
                                  a_t.float().numpy())
    return a_t, a_j, x, y, z


EMU_SHAPES = [(4, 25, 1000), (1, 300, 512), (3, 1, 77), (2, 37, 1001),
              (1, 5, 4100)]


@pytest.mark.parametrize("p,mp,n", EMU_SHAPES)
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_band_partials_and_combine_match_plain_and_pallas(p, mp, n, dtype):
    a_t, a_j, x, y, z = _inputs(p, mp, n, dtype, seed=3)
    ons = 0.37
    want = amp_local_ref_grid(a_t, *map(torch.from_numpy, (x, y, z)), ons,
                              N_PROC)
    ap, yp = jops.pad_row_shards(a_j, jnp.asarray(y))
    zp = jnp.pad(jnp.asarray(z), ((0, 0), (0, ap.shape[1] - mp)))
    xp_ = jnp.pad(jnp.asarray(x), (0, ap.shape[2] - n))
    bm, bn = jops.row_tiles(ap.shape[1], ap.shape[2])
    z_j, f_j, ss_j = amp_local_pallas_grid(ap, xp_, yp, zp, ons, N_PROC,
                                           interpret=True, bm=bm, bn=bn)
    for n_sm in (1, 132):      # one band a shard, and as many as the plan makes
        got = _band_step(a_t[None], torch.from_numpy(x)[None],
                         torch.from_numpy(y)[None], torch.from_numpy(z)[None],
                         torch.tensor([ons]), N_PROC, n_sm)
        for name, g, w, j in zip(("z_new", "f_p", "ss"), got, want,
                                 (np.asarray(z_j)[:, :mp],
                                  np.asarray(f_j)[:, :n], ss_j)):
            _close(g[0], w, f"{name} vs plain, n_sm={n_sm}")
            _close(g[0], j, f"{name} vs Pallas, n_sm={n_sm}")


def test_band_step_with_a_shared_batch_matches_plain():
    """B=3 with one A for all (a batch stride of 0 in the kernel): the plan
    counts blocks over the whole batch, each instance its own Onsager term."""
    a_t, _, x, y, z = _inputs(4, 40, 600, "float32", seed=5)
    rng = np.random.default_rng(9)
    xb = torch.from_numpy(np.stack([x, -x, 0.5 * x]))
    yb = torch.from_numpy(np.stack([y, y[::-1].copy(), -y]))
    zb = torch.from_numpy(np.stack([z, -z, z]))
    ons = torch.from_numpy(rng.uniform(0.1, 0.9, 3).astype(np.float32))
    want = amp_local_ref_grid(a_t, xb, yb, zb, ons, N_PROC)
    got = _band_step(a_t.expand(3, -1, -1, -1), xb, yb, zb, ons, N_PROC, 132)
    for name, g, w in zip(("z_new", "f_p", "ss"), got, want):
        _close(g, w, name)


def test_single_read_rule_depends_on_n_and_dtype_only():
    """The route is a pure function of (N, dtype): no device, no shape of
    the stack, no state. Rows up to 16384 elements take the single read in
    either dtype (a thread keeps x and f for its columns in float32
    registers); one element more takes the two-pass kernels."""
    assert SINGLE_READ_MAX_N == 16384
    for dtype in DTYPES.values():
        assert single_read(1, dtype) and single_read(10000, dtype)
        assert single_read(SINGLE_READ_MAX_N, dtype)
        assert not single_read(SINGLE_READ_MAX_N + 1, dtype)
        assert not single_read(20000, dtype)
        # asking again, or in another order, gives the same answer
        assert [single_read(n, dtype) for n in (20000, 16384, 7)] == \
            [False, True, True]
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        single_read(100, torch.float16)
    assert rows_per_stage(4096) == 4 and rows_per_stage(4097) == 1
    assert tops.row_tiles(100, 20000) == (8, 512)          # two-pass tiles


@pytest.mark.parametrize("n", [1000, SINGLE_READ_MAX_N + 8],
                         ids=["single_read", "two_pass"])
def test_cuda_wrapper_refuses_cpu_tensors_on_either_route(n):
    a = torch.zeros(1, 2, n)
    x, y, z = torch.zeros(n), torch.zeros(1, 2), torch.zeros(1, 2)
    with pytest.raises(ValueError, match="CUDA tensors"):
        amp_local_cuda_grid(a, x, y, z, 0.5, 1)

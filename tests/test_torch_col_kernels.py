"""The column-layout local computation of the port (plain PyTorch versions,
which are what run on the CPU) against the JAX package: its jnp oracles
``col_residual_ref`` / ``col_inner_step_ref`` and its Pallas kernels
``col_residual_pallas`` / ``col_inner_pallas`` in interpret mode.

Tolerance 1e-5 relative to the output's scale (``max |ref|``): float32 on
both sides, contractions summed in a different order (the Pallas kernels
accumulate tile by tile), and the denoiser's derivative is the same closed
form on both sides. With bfloat16 A both sides are given the same
bf16-rounded matrix and accumulate in float32, so the same bound holds.

The CUDA kernels cannot run here; ``chip_smoke.py`` holds them against these
same plain versions on the card.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.amp_fused import ops as jops
from repro.kernels.amp_fused.ref import col_inner_step_ref as j_inner
from repro.kernels.amp_fused.ref import col_residual_ref as j_resid
from repro_torch.kernels.amp_fused import ops as tops
from repro_torch.kernels.amp_fused.col import col_inner_cuda, col_residual_cuda
from repro_torch.kernels.amp_fused.ref import (col_inner_step_ref,
                                               col_params, col_residual_ref)

RTOL = 1e-5
PRIOR = (0.08, 0.1, 1.0)          # eps, mu_s, sigma_s^2


def _close(got, want, what):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    scale = np.abs(want).max()
    err = np.abs(got - want).max()
    assert err <= RTOL * scale, f"{what}: {err:.3e} > {RTOL} * {scale:.3e}"


def _operands(p, m, np_, a_dtype="float32", b=None, shared=False, seed=0):
    """numpy operands; A also as the same stored matrix on both sides."""
    rng = np.random.default_rng(seed + p * m * np_)
    lead = () if b is None else (b,)
    a_lead = () if (b is None or shared) else (b,)
    a = (rng.normal(size=a_lead + (p, m, np_)) / np.sqrt(m)).astype(np.float32)
    x = (rng.normal(size=lead + (p, np_)) * 0.1).astype(np.float32)
    x0 = (rng.normal(size=lead + (p, np_)) * 0.1).astype(np.float32)
    z = rng.normal(size=lead + (p, m)).astype(np.float32)
    g = rng.normal(size=lead + (m,)).astype(np.float32)
    a_j = jnp.asarray(a).astype(a_dtype)
    a_t = torch.from_numpy(a).to(getattr(torch, a_dtype))
    np.testing.assert_array_equal(np.asarray(a_j.astype(jnp.float32)),
                                  a_t.float().numpy())
    return a_j, a_t, x, x0, z, g


def _t(*arrays):
    return [None if v is None else torch.from_numpy(v) for v in arrays]


SHAPES = [(4, 256, 512), (3, 101, 77), (8, 100, 64)]


@pytest.mark.parametrize("p,m,np_", SHAPES)
@pytest.mark.parametrize("a_dtype", ["float32", "bfloat16"])
def test_col_residual_matches_jax_ref_and_pallas(p, m, np_, a_dtype):
    a_j, a_t, x, _, _, _ = _operands(p, m, np_, a_dtype)
    got = tops.col_residual(a_t, torch.from_numpy(x))
    assert got.dtype == torch.float32 and got.shape == (p, m)
    _close(got, j_resid(a_j, jnp.asarray(x)), "r vs jnp ref")
    ap, _ = jops.pad_col_shards(a_j, jnp.zeros(m, jnp.float32))
    pal = jops.col_residual(ap, jnp.asarray(x), use_pallas=True, interpret=True)
    _close(got, np.asarray(pal)[:, :m], "r vs pallas interpret")


@pytest.mark.parametrize("p,m,np_", SHAPES[:2])
@pytest.mark.parametrize("update_z", [False, True])
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("a_dtype", ["float32", "bfloat16"])
def test_col_inner_step_matches_jax_ref_and_pallas(p, m, np_, update_z,
                                                   masked, a_dtype):
    a_j, a_t, x, x0, z, g = _operands(p, m, np_, a_dtype,
                                      seed=update_z + 2 * masked)
    mask = np.ones(np_, np.float32)
    if masked:
        mask[np_ // 2:] = 0.0
    pri = (float(m),) + PRIOR
    xt, ct, zt = tops.col_inner_step(a_t, *_t(x, x0, z, g, mask),
                                     col_params(*pri), update_z=update_z)
    assert xt.shape == (p, np_) and ct.shape == (p,) and zt.shape == (p, m)
    if not update_z:
        assert np.array_equal(zt.numpy(), z)
    xr, cr, zr = j_inner(a_j, *map(jnp.asarray, (x, x0, z, g, mask)), *pri,
                         update_z)
    _close(xt, xr, "x' vs jnp ref")
    _close(ct, cr, "c_p vs jnp ref")
    _close(zt, zr, "z' vs jnp ref")
    ap, gp = jops.pad_col_shards(a_j, jnp.asarray(g))
    zp = jnp.pad(jnp.asarray(z), ((0, 0), (0, ap.shape[1] - m)))
    xk, ck, zk = jops.col_inner_step(ap, jnp.asarray(x), jnp.asarray(x0), zp,
                                     gp, jnp.asarray(mask), *pri,
                                     update_z=update_z, use_pallas=True,
                                     interpret=True)
    _close(xt, xk, "x' vs pallas interpret")
    _close(ct, ck, "c_p vs pallas interpret")
    _close(zt, np.asarray(zk)[:, :m], "z' vs pallas interpret")


def test_two_chained_inner_steps_match_pallas():
    """``update_z`` then a final step: the composition the engine runs at
    ``n_inner = 2``, against the same chain of Pallas kernels."""
    p, m, np_ = 4, 192, 256
    a_j, a_t, x, _, z, g = _operands(p, m, np_, seed=7)
    pri = (float(m), 0.08, 0.0, 1.0)
    x1, _, z1 = tops.col_inner_step(a_t, *_t(x, x, z, g), None,
                                    col_params(*pri), update_z=True)
    x2, c2, z2 = tops.col_inner_step(a_t, x1, torch.from_numpy(x), z1,
                                     torch.from_numpy(g), None,
                                     col_params(*pri), update_z=False)
    assert z2 is z1
    ap, gp = jops.pad_col_shards(a_j, jnp.asarray(g))
    zp = jnp.pad(jnp.asarray(z), ((0, 0), (0, ap.shape[1] - m)))
    ones = jnp.ones(np_, jnp.float32)
    k1, _, kz1 = jops.col_inner_step(ap, jnp.asarray(x), jnp.asarray(x), zp,
                                     gp, ones, *pri, update_z=True,
                                     use_pallas=True, interpret=True)
    k2, kc2, kz2 = jops.col_inner_step(ap, k1, jnp.asarray(x), kz1, gp, ones,
                                       *pri, update_z=False, use_pallas=True,
                                       interpret=True)
    _close(x2, k2, "x after two steps")
    _close(c2, kc2, "c_p after two steps")
    _close(z2, np.asarray(kz2)[:, :m], "z_last after two steps")


@pytest.mark.parametrize("shared", [False, True], ids=["per_instance_a", "shared_a"])
def test_batched_matches_per_instance_jax(shared):
    """B=3 written out as a leading dimension == the JAX reference called
    once per instance (what ``vmap`` computes), A per instance or shared."""
    p, m, np_, b = 4, 64, 96, 3
    a_j, a_t, x, x0, z, g = _operands(p, m, np_, b=b, shared=shared)
    pri = (float(m),) + PRIOR
    r = tops.col_residual(a_t, torch.from_numpy(x))
    xt, ct, zt = tops.col_inner_step(a_t, *_t(x, x0, z, g), None,
                                     col_params(*pri), update_z=True)
    assert r.shape == (b, p, m) and ct.shape == (b, p) and zt.shape == (b, p, m)
    for i in range(b):
        a_i = a_j if shared else a_j[i]
        _close(r[i], j_resid(a_i, jnp.asarray(x[i])), f"r[{i}]")
        xr, cr, zr = j_inner(a_i, *map(jnp.asarray, (x[i], x0[i], z[i], g[i])),
                             None, *pri, True)
        _close(xt[i], xr, f"x'[{i}]")
        _close(ct[i], cr, f"c_p[{i}]")
        _close(zt[i], zr, f"z'[{i}]")


def test_zero_residual_takes_the_variance_floor():
    """With z = 0 the plug-in variance is 0: the TPU kernel floors it at
    1e-30 and stays finite; the plain version does the same."""
    p, m, np_ = 2, 64, 128
    a_j, a_t, x, x0, _, g = _operands(p, m, np_, seed=3)
    z = np.zeros((p, m), np.float32)
    pri = (float(m),) + PRIOR
    xt, ct, _ = tops.col_inner_step(a_t, *_t(x, x0, z, g), None,
                                    col_params(*pri), update_z=False)
    assert bool(torch.isfinite(xt).all() and torch.isfinite(ct).all())
    ap, gp = jops.pad_col_shards(a_j, jnp.asarray(g))
    xk, ck, _ = jops.col_inner_step(
        ap, jnp.asarray(x), jnp.asarray(x0),
        jnp.zeros((p, ap.shape[1]), jnp.float32), gp,
        jnp.ones(np_, jnp.float32), *pri, update_z=False, use_pallas=True,
        interpret=True)
    _close(xt, xk, "x' at the floor")
    _close(ct, ck, "c_p at the floor")


def test_plain_versions_compose_as_documented():
    """``col_inner_step_ref`` is exactly the formula of its docstring, with
    the same ``col_residual_ref`` contraction; ``par`` holds the prior as
    float32 tensors."""
    from repro_torch.core.denoisers import eta_bg_and_deriv
    p, m, np_ = 3, 50, 40
    _, a_t, x, x0, z, g = _operands(p, m, np_, seed=11)
    x, x0, z, g = _t(x, x0, z, g)
    s2 = torch.sum(z * z, -1, keepdim=True) / m
    f = x + torch.einsum("pmn,pm->pn", a_t, z)
    val, der = eta_bg_and_deriv(f, s2, *(torch.tensor(v) for v in PRIOR))
    c = der.sum(-1) / m
    z_new = g - col_residual_ref(a_t, val - x0) + c[:, None] * z
    xn, cn, zn = col_inner_step_ref(a_t, x, x0, z, g, None,
                                    col_params(float(m), *PRIOR), True)
    assert torch.equal(xn, val) and torch.equal(cn, c)
    torch.testing.assert_close(zn, z_new, rtol=0, atol=1e-6)


def test_alignment_helpers():
    """Nothing is padded for the CUDA kernels: ``pad_col_shards`` returns
    its inputs; ``col_tiles`` follows the vector width Np allows: whole rows
    of 16 KB a stage of the row pass's ring (one warp a row, 8 rows a
    block, where the ring cannot take the rows), and the A^T z tile."""
    a = torch.zeros(3, 101, 77)
    y = torch.zeros(101)
    a2, y2 = tops.pad_col_shards(a, y)
    assert a2 is a and y2 is y
    assert tops.col_tiles(400) == (10, 512)
    assert tops.col_tiles(400, torch.bfloat16) == (20, 1024)
    assert tops.col_tiles(77) == (8, 128)
    assert tops.col_tiles(8192) == (8, 512)       # a row over 16 KB
    assert tops.col_tiles(8192, torch.bfloat16) == (1, 1024)


def test_cuda_wrappers_refuse_cpu_tensors():
    _, a_t, x, x0, z, g = _operands(2, 16, 8)
    with pytest.raises(ValueError, match="CUDA tensors"):
        col_residual_cuda(a_t, torch.from_numpy(x))
    with pytest.raises(ValueError, match="CUDA tensors"):
        col_inner_cuda(a_t, *_t(x, x0, z, g), None, col_params(16.0, *PRIOR),
                       True)

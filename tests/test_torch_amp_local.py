"""The fused LC step of the port (plain PyTorch version, which is what runs
on the CPU) against the JAX package: its jnp reference
``amp_local_ref_grid`` and its Pallas kernel in interpret mode.

Tolerance 1e-5 relative to the output's scale: float32 on both sides, but
the contractions are summed in a different order (the Pallas kernel
accumulates tile by tile). With bfloat16 A both sides are given the same
bf16-rounded matrix and accumulate in float32, so the same bound holds.

The CUDA kernels cannot run here; they are held against these same plain
versions on the card by ``chip_smoke.py``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.amp_fused import ops as jops
from repro.kernels.amp_fused.amp_fused import amp_local_pallas_grid
from repro.kernels.amp_fused.ref import amp_local_ref as j_ref
from repro.kernels.amp_fused.ref import amp_local_ref_grid as j_ref_grid
from repro_torch.kernels.amp_fused import ops as tops
from repro_torch.kernels.amp_fused.amp_fused import (amp_local_cuda_grid,
                                                     vec_width)
from repro_torch.kernels.amp_fused.ref import (amp_local_f_ref,
                                               amp_local_ref_grid,
                                               amp_local_z_ref)

RTOL = 1e-5
N_PROC = 10          # the x/P divisor; independent of the stack's P


def _close(got, want, what):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    scale = np.abs(want).max()
    err = np.abs(got - want).max()
    assert err <= RTOL * scale, f"{what}: {err:.3e} > {RTOL} * {scale:.3e}"


def _inputs(p, mp, n, a_dtype, b=None, shared=False, seed=0):
    rng = np.random.default_rng(seed + p * mp * n)
    lead = () if b is None else (b,)
    a_lead = () if (b is None or shared) else (b,)
    a = (rng.normal(size=a_lead + (p, mp, n)) / np.sqrt(p * mp)).astype(np.float32)
    x = rng.normal(size=lead + (n,)).astype(np.float32)
    y = rng.normal(size=lead + (p, mp)).astype(np.float32)
    z = rng.normal(size=lead + (p, mp)).astype(np.float32)
    ons = (0.37 if b is None
           else rng.uniform(0.1, 0.9, size=b).astype(np.float32))
    a_j = jnp.asarray(a).astype(a_dtype)
    a_t = torch.from_numpy(a).to(getattr(torch, a_dtype))
    # both sides hold the same stored matrix, bit for bit
    np.testing.assert_array_equal(np.asarray(a_j.astype(jnp.float32)),
                                  a_t.float().numpy())
    return a_j, a_t, x, y, z, ons


SHAPES = [(1, 128, 512), (4, 64, 500), (4, 25, 1000), (1, 37, 1001)]


@pytest.mark.parametrize("p,mp,n", SHAPES)
@pytest.mark.parametrize("a_dtype", ["float32", "bfloat16"])
def test_plain_matches_jax_ref(p, mp, n, a_dtype):
    a_j, a_t, x, y, z, ons = _inputs(p, mp, n, a_dtype)
    z0, f0, ss0 = j_ref_grid(a_j, jnp.asarray(x), jnp.asarray(y),
                             jnp.asarray(z), ons, N_PROC)
    z1, f1, ss1 = tops.amp_local_grid(a_t, torch.from_numpy(x),
                                      torch.from_numpy(y),
                                      torch.from_numpy(z), ons, N_PROC)
    assert z1.dtype == f1.dtype == ss1.dtype == torch.float32
    assert z1.shape == (p, mp) and f1.shape == (p, n) and ss1.shape == ()
    _close(z1, z0, "z_new")
    _close(f1, f0, "f_p")
    _close(ss1, ss0, "ss")


@pytest.mark.parametrize("p,mp,n", SHAPES)
@pytest.mark.parametrize("a_dtype", ["float32", "bfloat16"])
def test_plain_matches_pallas_interpret(p, mp, n, a_dtype):
    """Against the TPU kernel itself, run as the JAX package's own tests
    run it on the CPU: tile-padded operands, ``interpret=True``."""
    a_j, a_t, x, y, z, ons = _inputs(p, mp, n, a_dtype)
    ap, yp = jops.pad_row_shards(a_j, jnp.asarray(y))
    zp = jnp.pad(jnp.asarray(z), ((0, 0), (0, ap.shape[1] - mp)))
    xp_ = jnp.pad(jnp.asarray(x), (0, ap.shape[2] - n))
    bm, bn = jops.row_tiles(ap.shape[1], ap.shape[2])
    z0, f0, ss0 = amp_local_pallas_grid(ap, xp_, yp, zp, ons, N_PROC,
                                        interpret=True, bm=bm, bn=bn)
    z1, f1, ss1 = tops.amp_local_grid(a_t, torch.from_numpy(x),
                                      torch.from_numpy(y),
                                      torch.from_numpy(z), ons, N_PROC)
    _close(z1, np.asarray(z0)[:, :mp], "z_new")
    _close(f1, np.asarray(f0)[:, :n], "f_p")
    _close(ss1, ss0, "ss")


@pytest.mark.parametrize("shared", [False, True], ids=["per_instance_a", "shared_a"])
@pytest.mark.parametrize("a_dtype", ["float32", "bfloat16"])
def test_batched_matches_per_instance_jax(shared, a_dtype):
    """B=3 written out as a leading dimension == the JAX reference called
    once per instance (what ``vmap`` computes), A per instance or shared,
    Onsager coefficient per instance."""
    p, mp, n, b = 4, 25, 1000, 3
    a_j, a_t, x, y, z, ons = _inputs(p, mp, n, a_dtype, b=b, shared=shared)
    z1, f1, ss1 = tops.amp_local_grid(a_t, torch.from_numpy(x),
                                      torch.from_numpy(y),
                                      torch.from_numpy(z),
                                      torch.from_numpy(ons), N_PROC)
    assert z1.shape == (b, p, mp) and f1.shape == (b, p, n) and ss1.shape == (b,)
    for i in range(b):
        z0, f0, ss0 = j_ref_grid(a_j if shared else a_j[i], jnp.asarray(x[i]),
                                 jnp.asarray(y[i]), jnp.asarray(z[i]),
                                 float(ons[i]), N_PROC)
        _close(z1[i], z0, f"z_new[{i}]")
        _close(f1[i], f0, f"f_p[{i}]")
        _close(ss1[i], ss0, f"ss[{i}]")


def test_z_and_f_passes_compose():
    """The two plain passes compose to the grid function exactly (the CUDA
    step is held against the grid function on the card)."""
    _, a_t, x, y, z, ons = _inputs(4, 25, 1000, "float32")
    x, y, z = map(torch.from_numpy, (x, y, z))
    z1, ss1 = amp_local_z_ref(a_t, x, y, z, ons)
    f1 = amp_local_f_ref(a_t, z1, x, N_PROC)
    z2, f2, ss2 = amp_local_ref_grid(a_t, x, y, z, ons, N_PROC)
    assert torch.equal(z1, z2) and torch.equal(f1, f2) and torch.equal(ss1, ss2)


@pytest.mark.parametrize("m,n", [(128, 512), (50, 333)])
def test_amp_local_step_v1_signature(m, n):
    rng = np.random.default_rng(m * n)
    a = (rng.normal(size=(m, n)) / np.sqrt(m)).astype(np.float32)
    x = rng.normal(size=n).astype(np.float32)
    y = rng.normal(size=m).astype(np.float32)
    z = rng.normal(size=m).astype(np.float32)
    z0, f0 = j_ref(jnp.asarray(a), jnp.asarray(x), jnp.asarray(y),
                   jnp.asarray(z), 0.37, N_PROC)
    z1, f1 = tops.amp_local_step(*map(torch.from_numpy, (a, x, y, z)), 0.37,
                                 N_PROC)
    _close(z1, z0, "z_new")
    _close(f1, f0, "f")


def test_alignment_helpers():
    """Nothing is padded for the CUDA kernels: ``pad_row_shards`` returns
    its inputs; the vector width falls back to 1 when N does not allow
    16-byte loads (odd N), and ``row_tiles`` follows it: rows a stage of the
    band kernel holds (1, or 4 for N <= 4096), columns one sweep of its 512
    threads covers."""
    a = torch.zeros(3, 25, 1001)
    y = torch.zeros(3, 25)
    a2, y2 = tops.pad_row_shards(a, y)
    assert a2 is a and y2 is y
    assert tops.pad_row_shards(a, None) == (a, None)
    assert vec_width(1000, torch.float32) == 4
    assert vec_width(1001, torch.float32) == 1
    assert vec_width(1000, torch.bfloat16) == 8
    assert vec_width(1004, torch.bfloat16) == 1
    bm, bn = tops.row_tiles(100, 10000)
    assert (bm, bn) == (1, 2048)
    assert tops.row_tiles(100, 10000, torch.bfloat16) == (1, 4096)
    assert tops.row_tiles(25, 1001) == (4, 512)


def test_cuda_wrapper_refuses_cpu_tensors():
    """The kernel wrapper never computes on the CPU: it raises. (Only
    ``ops`` chooses the plain version, and only for CPU tensors.)"""
    _, a_t, x, y, z, ons = _inputs(1, 8, 16, "float32")
    with pytest.raises(ValueError, match="CUDA tensors"):
        amp_local_cuda_grid(a_t, *map(torch.from_numpy, (x, y, z)), ons, 1)

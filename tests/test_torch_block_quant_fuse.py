"""The block-quantized fusion of the port (``kernels/quantize``:
``block_quant_fuse``, its plain version ``block_quant_fuse_ref`` and the
plan of its CUDA kernel) against the JAX package's
``BlockQuantTransport.fuse`` and its TPU kernel ``quantize_pallas``.

Tolerance. Symbols are integers: they must be *equal*. The fused sum over
P and the noise variance (a mean) are float32 sums that the reference takes
in XLA's order and the port in p order (then over the columns of scale
blocks): 1e-6 relative to the largest |f| of the entry, and 1e-6 relative
for extra. A batch entry of the port is the same bits alone or in a batch.

The CUDA kernel cannot run here; ``chip_smoke.py`` holds it against
``block_quant_fuse_ref`` on the card, f and symbols bit for bit.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

import repro.core.engine as je
from repro.kernels.quantize import ops as jqops
from repro_torch.kernels.quantize import ops as tqops
from repro_torch.kernels.quantize.quantize import (MAX_CLUSTER, MAX_WARPS,
                                                   SMEM_LIMIT,
                                                   block_quant_fuse_cuda,
                                                   fuse_cluster, fuse_plan)
from repro_torch.kernels.quantize.ref import block_quant_fuse_ref

BITS = {127: 8, 7: 4}


def _messages(b, p, length, seed, scale=1.0):
    """Normal messages; in entry 0 processor 0 sends zeros, processor 1 is
    at 1e4 times the scale and processor 2 at 1e-3; the last entry is a copy
    of the first."""
    rng = np.random.default_rng(seed)
    x = (rng.normal(size=(b, p, length)) * scale).astype(np.float32)
    x[0, 0] = 0.0
    if p > 2:
        x[0, 1] *= 1e4
        x[0, 2] *= 1e-3
    if b > 1:
        x[-1] = x[0]
    return x


def _reference(x, qmax, block):
    """The JAX package's fusion, one batch entry at a time."""
    jt = je.BlockQuantTransport(BITS[qmax], block)
    outs = [jt.fuse(jnp.asarray(xi), jnp.float32(np.inf)) for xi in x]
    return (np.stack([np.asarray(o[0]) for o in outs]),
            np.array([float(o[1]) for o in outs]),
            np.stack([np.asarray(o[2]) for o in outs]))


def _assert_matches(x, qmax, block):
    f, extra, sym = block_quant_fuse_ref(torch.from_numpy(x), qmax, block)
    jf, jextra, jsym = _reference(x, qmax, block)
    b, p, length = x.shape
    assert f.shape == (b, length) and extra.shape == (b,)
    assert sym.shape == x.shape and sym.dtype == torch.float32
    np.testing.assert_array_equal(sym.numpy(), jsym)
    for i in range(b):
        scale = max(float(np.abs(jf[i]).max()), 1e-30)
        err = float(np.abs(f[i].numpy() - jf[i]).max())
        assert err <= 1e-6 * scale, (i, err, scale)
    np.testing.assert_allclose(extra.numpy(), jextra, rtol=1e-6)
    return f, extra, sym


@pytest.mark.parametrize("length", [1001, 1024])
@pytest.mark.parametrize("qmax,block", [(127, 512), (127, 256), (7, 512),
                                        (7, 256)])
@pytest.mark.parametrize("p", [1, 6, 33, 70])
def test_plain_fusion_matches_reference(p, qmax, block, length):
    """B = 1 and 3 (the third entry a copy of the first), P across one and
    more warp groups, a ragged L and a block multiple, both blocks and both
    widths; an all-zero message and messages at 1e4 and 1e-3."""
    for b in (1, 3):
        x = _messages(b, p, length, seed=p * length + qmax + block + b,
                      scale=0.3)
        f, extra, sym = _assert_matches(x, qmax, block)
        if b == 3:
            assert torch.equal(f[2], f[0]) and torch.equal(sym[2], sym[0])
            assert float(extra[2]) == float(extra[0])


@pytest.mark.parametrize("scale", [1e-3, 1e4])
def test_plain_fusion_at_extreme_scales_and_all_zero(scale):
    x = _messages(2, 5, 700, seed=11, scale=scale)
    x[1] = 0.0                          # an entry of all-zero messages
    f, extra, sym = _assert_matches(x, 127, 256)
    assert not bool(f[1].any()) and not bool(sym[1].any())
    assert 0.0 < float(extra[0]) and float(extra[1]) < 1e-50


@pytest.mark.parametrize("qmax", [127, 7])
def test_plain_fusion_symbols_match_pallas_interpret(qmax):
    """The symbols against the TPU kernel itself, run as the JAX package's
    own tests run it on the CPU (tile-padded, ``interpret=True``; block
    512)."""
    b, p, length = 2, 7, 3000
    x = _messages(b, p, length, seed=qmax)
    jq, _, _ = jqops.quantize(jnp.asarray(x.reshape(b * p, length)),
                              qmax=qmax, use_pallas=True, interpret=True)
    _, _, sym = block_quant_fuse_ref(torch.from_numpy(x), qmax, 512)
    np.testing.assert_array_equal(
        sym.numpy(), np.asarray(jq)[:b * p, :length].reshape(b, p, length)
        .astype(np.float32))


@pytest.mark.parametrize("symbols", [True, False])
def test_batched_fusion_is_single_fusions_bit_for_bit(symbols):
    x = torch.from_numpy(_messages(4, 30, 1500, seed=3))
    f, extra, sym = tqops.block_quant_fuse(x, 127, 512, symbols)
    assert (sym is None) != symbols
    for i in range(4):
        f1, e1, s1 = tqops.block_quant_fuse(x[i:i + 1], 127, 512)
        assert torch.equal(f[i], f1[0]) and torch.equal(extra[i], e1[0])
        if symbols:
            assert torch.equal(sym[i], s1[0])


def test_the_fusion_is_the_standalone_quantizer_summed():
    """The plain fusion against the standalone plain kernels it fuses:
    the same symbols, and their dequantized values summed."""
    x = torch.from_numpy(_messages(1, 9, 2500, seed=5))
    f, _, sym = tqops.block_quant_fuse(x, 127, 256)
    q, scale = tqops.quantize(x[0], 127, 256)
    assert torch.equal(sym[0], q.to(torch.float32))
    deq = tqops.dequantize(q, scale, 256)
    want = torch.zeros_like(deq[0])
    for row in deq:
        want = want + row
    assert torch.equal(f[0], want)


@settings(max_examples=40, deadline=None)
@given(b=st.integers(1, 8), p=st.integers(1, 256),
       length=st.integers(1, 40000),
       block=st.sampled_from([32, 96, 256, 384, 512, 1024, 4096]))
def test_fuse_plan_covers_every_block_once(b, p, length, block):
    """Every (b, p, scale block j) is quantized once: by one warp in each
    rank of its cluster, the ranks' column slices tiling the block."""
    plan = fuse_plan(b, p, length, block)
    nbj = -(-length // block)
    c = plan.cluster
    assert plan.grid == (nbj * c, b) and 1 <= c <= MAX_CLUSTER
    assert c == 1 or nbj * b * c <= 132
    assert plan.slice * c == block and plan.slice % 32 == 0
    assert 1 <= plan.warps <= min(p, MAX_WARPS)
    assert plan.smem_bytes == ((plan.warps + 1) * plan.slice + p
                               + 2 * c * plan.warps) * 4
    assert plan.smem_bytes <= SMEM_LIMIT
    seen = np.zeros((b, p, nbj, c), np.int64)
    for bx in range(nbj * c):
        for by in range(b):
            for w in range(plan.warps):
                for bb, pp, j, lo, hi in plan.work(bx, by, w, p):
                    assert hi - lo == plan.slice and lo % plan.slice == 0
                    seen[bb, pp, j, lo // plan.slice] += 1
    assert (seen == 1).all()


def test_fuse_plan_clusters_shrinks_warps_and_raises_past_one():
    row = fuse_plan(1, 30, 10000, 512)
    assert (row.cluster, row.slice, row.warps, row.grid) == (4, 128, 30,
                                                              (80, 1))
    assert fuse_cluster(256) == 2 and fuse_cluster(96) == 1
    # a batch keeps the grid in one wave: fewer blocks a cluster
    assert fuse_plan(2, 30, 10000, 512).cluster == 2
    assert fuse_plan(4, 30, 10000, 512).cluster == 1
    assert fuse_plan(4, 30, 10000, 512, sms=400).cluster == 4
    assert fuse_plan(1, 70, 10000, 512).warps == MAX_WARPS
    long = fuse_plan(1, 30, 100000, 65536)
    assert long.warps < 30 and long.smem_bytes <= SMEM_LIMIT
    with pytest.raises(ValueError, match="shared"):
        fuse_plan(1, 2, 300000, 232448)
    with pytest.raises(ValueError, match="multiple of 32"):
        fuse_plan(1, 2, 100, 48)


def test_fuse_cuda_refuses_cpu_tensors():
    """The kernel wrapper never computes on the CPU: it raises."""
    with pytest.raises(ValueError, match="CUDA"):
        block_quant_fuse_cuda(torch.zeros(1, 3, 64), 127, 32)
    with pytest.raises(ValueError, match="B, P, L"):
        block_quant_fuse_cuda(torch.zeros(3, 64), 127, 32)

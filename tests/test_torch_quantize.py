"""Block quantization of the port (plain PyTorch, which is what runs on the
CPU) against the JAX package: ``core/compression.py``, the kernels' plain
version ``kernels/quantize`` against ``quantize_blocks`` and against the
TPU kernel ``quantize_pallas`` in interpret mode, and ``BlockQuantTransport``
in the row layout, down to whole solves.

Tolerance. Symbols and bf16 scales are integers and bit patterns: they must
be *equal* (the 1.004 nudge, the bf16 rounding of the scale, IEEE division
and round-half-even are the contract), and so must the dequantized values.
A fused sum over P and the noise variance (a mean) are float32 sums taken
in a different order: 1e-6. Whole quantized solves are held as
``tests/test_torch_engine.py::assert_traces_agree`` holds them.

The CUDA kernels cannot run here; ``chip_smoke.py`` holds them against these
same plain versions on the card, bit for bit.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

import repro.core.compression as jc
import repro.core.engine as je
from repro.core.denoisers import BernoulliGauss as JBG
from repro.kernels.quantize import ops as jqops
from repro.kernels.quantize.ref import quantize_ref as j_quantize_ref
import repro_torch.core.compression as tc
import repro_torch.core.engine as te
from repro_torch.core.denoisers import BernoulliGauss as TBG
from repro_torch.kernels.quantize import ops as tqops
from repro_torch.kernels.quantize.quantize import (dequantize_cuda,
                                                   dequantize_sum_cuda,
                                                   quantize_cuda)
from test_torch_engine import assert_traces_agree, make_problem

P, T = 6, 8


def _messages(r, n, seed, scale=1.0):
    """Normal rows at three scales, one all-zero row, one large row."""
    rng = np.random.default_rng(seed)
    x = (rng.normal(size=(r, n)) * scale).astype(np.float32)
    x[0] = 0.0
    if r > 2:
        x[1] *= 1e4
        x[2] *= 1e-3
    return x


def _bits(scale) -> np.ndarray:
    """The bf16 scales' bit patterns, from either framework."""
    if isinstance(scale, torch.Tensor):
        return scale.view(torch.int16).numpy()
    return np.asarray(scale).view(np.int16)


@pytest.mark.parametrize("n", [2048, 1000, 4095])
@pytest.mark.parametrize("bits,block", [(8, 512), (8, 256), (4, 512), (4, 256)])
def test_quantize_blocks_bit_identical_to_reference(bits, block, n):
    x = _messages(5, n, seed=n + bits + block, scale=7.0)
    jq, js = jc.quantize_blocks(jnp.asarray(x), jc.QuantConfig(bits, block))
    qc = tc.QuantConfig(bits, block)
    tq, ts = tc.quantize_blocks(torch.from_numpy(x), qc)
    assert tq.dtype == torch.int8 and ts.dtype == torch.bfloat16
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(_bits(ts), _bits(js))
    jd = jc.dequantize_blocks(jq, js, jc.QuantConfig(bits, block), orig_len=n)
    td = tc.dequantize_blocks(tq, ts, qc, orig_len=n)
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
    # the kernels' plain version gives the same, unpadded
    oq, os_ = tqops.quantize(torch.from_numpy(x), qc.qmax, block)
    assert oq.shape == (5, n) and os_.shape == (5, -(-n // block))
    assert torch.equal(oq, tq[:, :n])
    np.testing.assert_array_equal(_bits(os_), _bits(ts))
    assert torch.equal(tqops.dequantize(oq, os_, block), td)


@pytest.mark.parametrize("shape", [(3, 4096), (100, 1000), (257, 2049)])
@pytest.mark.parametrize("qmax", [127, 7])
def test_plain_bit_identical_to_pallas_interpret(shape, qmax):
    """Against the TPU kernel itself, as the JAX package's own tests run it
    on the CPU (tile-padded, ``interpret=True``; its block is 512)."""
    r, n = shape
    x = _messages(r, n, seed=r * n + qmax, scale=7.0)
    jq, js, orig = jqops.quantize(jnp.asarray(x), qmax=qmax, use_pallas=True,
                                  interpret=True)
    jd = jqops.dequantize(jq, js, orig, use_pallas=True, interpret=True)
    tq, ts = tqops.quantize(torch.from_numpy(x), qmax, 512)
    nb = -(-n // 512)
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq)[:r, :n])
    np.testing.assert_array_equal(_bits(ts), _bits(np.asarray(js)[:r, :nb]))
    np.testing.assert_array_equal(tqops.dequantize(tq, ts, 512).numpy(),
                                  np.asarray(jd))
    # and the reference's jnp oracle of that kernel, on the padded input
    xp = np.pad(x, ((0, 0), (0, nb * 512 - n)))
    rq, rs = j_quantize_ref(jnp.asarray(xp), qmax, 512)
    np.testing.assert_array_equal(tq.numpy(), np.asarray(rq)[:, :n])
    np.testing.assert_array_equal(_bits(ts), _bits(rs))


@settings(max_examples=20, deadline=None)
@given(seed=st.integers(0, 2**31 - 1), n=st.integers(1, 2048))
def test_int4_pack_roundtrip_and_reference_bytes(seed, n):
    rng = np.random.default_rng(seed)
    q = rng.integers(-7, 8, 2 * n).astype(np.int8)
    packed = tc.pack_int4(torch.from_numpy(q))
    assert packed.dtype == torch.uint8 and packed.shape == (n,)
    assert torch.equal(tc.unpack_int4(packed), torch.from_numpy(q))
    np.testing.assert_array_equal(packed.numpy(),
                                  np.asarray(jc.pack_int4(jnp.asarray(q))))


@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("scale", [1e-3, 1.0, 1e4])
def test_quant_error_bound(bits, scale):
    rng = np.random.default_rng(0)
    x = torch.from_numpy((rng.normal(size=(3, 2048)) * scale).astype(np.float32))
    qc = tc.QuantConfig(bits=bits, block=256)
    q, s = tc.quantize_blocks(x, qc)
    err = (tc.dequantize_blocks(q, s, qc, orig_len=2048) - x).abs()
    bound = s.float().repeat_interleave(256, -1) * 0.5
    assert bool((err <= bound + 1e-12 * scale).all())
    assert int(q.abs().max()) <= qc.qmax


def test_quant_handles_zeros_and_padding():
    qc = tc.QuantConfig(bits=8, block=256)
    x = torch.zeros((1, 100))            # shorter than a block
    q, s = tc.quantize_blocks(x, qc)
    assert q.shape == (1, 256) and s.shape == (1, 1)
    assert float(tc.dequantize_blocks(q, s, qc, orig_len=100).abs().max()) == 0.0
    oq, os_ = tqops.quantize(x, 127, 256)
    assert oq.shape == (1, 100) and not bool(oq.any())


@pytest.mark.parametrize("orig_len", [4095, 4093])
def test_int4_odd_length_pad_roundtrip(orig_len):
    """int4 with a length that is no block multiple: the block padding plus
    nibble packing round-trips to |err| <= Delta/2 on the real elements."""
    rng = np.random.default_rng(7)
    x = torch.from_numpy(rng.normal(size=(1, orig_len)).astype(np.float32))
    qc = tc.QuantConfig(bits=4, block=256)
    q, s = tc.quantize_blocks(x, qc)
    q_wire = tc.unpack_int4(tc.pack_int4(q))
    assert torch.equal(q_wire, q)
    xr = tc.dequantize_blocks(q_wire, s, qc, orig_len=orig_len)
    assert xr.shape == (1, orig_len)
    bound = s.float().repeat_interleave(256, -1)[:, :orig_len] * 0.5
    assert bool(((xr - x).abs() <= bound + 1e-12).all())


def test_stochastic_rounding_is_unbiased():
    """Stochastic rounding draws other numbers than the reference's, so it
    is held to its distribution: every symbol is the floor or the ceiling
    of x / Delta, and the mean over draws is x to within its sampling
    error. Without a generator the rounding is the deterministic one."""
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.normal(size=(2, 512)).astype(np.float32))
    qc = tc.QuantConfig(bits=4, block=512, stochastic=True)
    gen = torch.Generator().manual_seed(0)
    draws = 400
    qs, scale = [], None
    for _ in range(draws):
        q, scale = tc.quantize_blocks(x, qc, generator=gen)
        qs.append(q.float())
    q = torch.stack(qs)
    ratio = x / scale.float().repeat_interleave(512, -1)
    assert bool(((q == ratio.floor()) | (q == ratio.ceil())).all())
    mean = q.mean(0)
    frac = ratio - ratio.floor()
    sd = torch.sqrt(frac * (1 - frac) / draws) + 1e-6
    assert float(((mean - ratio).abs() / sd).max()) < 5.0
    det, _ = tc.quantize_blocks(x, tc.QuantConfig(bits=4, block=512))
    assert torch.equal(tc.quantize_blocks(x, qc)[0], det)


def test_quant_noise_var_matches_reference_per_batch_entry():
    x = _messages(2 * P, 1000, seed=5).reshape(2, P, 1000)
    qc = tc.QuantConfig(8, 256)
    _, s = tc.quantize_blocks(torch.from_numpy(x), qc)
    got = tc.quant_noise_var(s, qc, batch_dims=1)
    assert got.shape == (2,)
    for i in range(2):
        _, js = jc.quantize_blocks(jnp.asarray(x[i]), jc.QuantConfig(8, 256))
        want = float(jc.quant_noise_var(js, jc.QuantConfig(8, 256)))
        np.testing.assert_allclose(float(got[i]), want, rtol=1e-6)
        np.testing.assert_allclose(float(tc.quant_noise_var(s[i], qc)), want,
                                   rtol=1e-6)


@pytest.mark.parametrize("length", [1024, 600])
@pytest.mark.parametrize("bits,block", [(8, 512), (4, 256)])
def test_block_quant_fuse_matches_reference(bits, block, length):
    """Same messages: symbols exact, fused sum and noise variance to 1e-6;
    a batch of messages gives each entry its own noise variance."""
    f_p = _messages(3 * P, length, seed=bits * length, scale=0.3)
    f_p = f_p.reshape(3, P, length)
    f_p[2] = f_p[0]
    jt, tt = je.BlockQuantTransport(bits, block), te.BlockQuantTransport(bits, block)
    fb, eb, qb = tt.fuse(torch.from_numpy(f_p), None)
    assert fb.shape == (3, length) and eb.shape == (3,) and qb.shape == f_p.shape
    for i in range(3):
        fj, ej, qj = jt.fuse(jnp.asarray(f_p[i]), jnp.float32(np.inf))
        f1, e1, q1 = tt.fuse(torch.from_numpy(f_p[i]), torch.tensor(np.inf))
        assert q1.dtype == torch.float32
        np.testing.assert_array_equal(q1.numpy(), np.asarray(qj))
        np.testing.assert_allclose(f1.numpy(), np.asarray(fj), rtol=1e-6,
                                   atol=1e-6)
        np.testing.assert_allclose(float(e1), float(ej), rtol=1e-6)
        assert torch.equal(qb[i], q1) and torch.equal(fb[i], f1)
        np.testing.assert_allclose(float(eb[i]), float(e1), rtol=1e-6)
    assert float(eb[2]) == float(eb[0]) and float(eb[0]) != float(eb[1])


@pytest.mark.parametrize("bits,block", [(8, 256), (4, 512)])
def test_row_block_quant_solve_matches_reference(bits, block):
    s0, a, y = make_problem(1)
    want = je.AmpEngine(JBG(0.1), je.EngineConfig(n_proc=P, n_iter=T),
                        je.BlockQuantTransport(bits, block)).solve(y, a)
    got = te.AmpEngine(TBG(0.1), te.EngineConfig(n_proc=P, n_iter=T,
                                                 device="cpu"),
                       te.BlockQuantTransport(bits, block)).solve(y, a)
    assert got.symbols.shape == (T, P, a.shape[1])
    assert np.all(got.extra_var > 0)
    assert np.abs(got.symbols).max() <= (1 << (bits - 1)) - 1
    assert_traces_agree(want, got, s0)


def test_cuda_wrappers_refuse_cpu_tensors():
    """The kernel wrappers never compute on the CPU: they raise. (Only
    ``ops`` chooses the plain version, and only for CPU tensors.)"""
    x = torch.zeros(2, 64)
    with pytest.raises(ValueError, match="CUDA"):
        quantize_cuda(x, 127, 32)
    with pytest.raises(ValueError, match="CUDA"):
        quantize_cuda(x, 7, 32, packed=True)
    with pytest.raises(ValueError, match="CUDA"):
        dequantize_cuda(torch.zeros(2, 64, dtype=torch.int8),
                        torch.zeros(2, 2, dtype=torch.bfloat16), 32)
    with pytest.raises(ValueError, match="CUDA"):
        dequantize_cuda(torch.zeros(2, 32, dtype=torch.uint8),
                        torch.zeros(2, 2, dtype=torch.bfloat16), 32,
                        packed=True)
    with pytest.raises(ValueError, match="CUDA"):
        dequantize_sum_cuda(torch.zeros(2, 64, dtype=torch.int8),
                            torch.zeros(2, 2, dtype=torch.bfloat16), 32)


# -- the wire forms of compressed_psum (K4a packed, K4b packed, K4b's sum) ----

@pytest.mark.parametrize("r,n", [(2, 5120), (1, 1024), (7, 1001), (4, 3072)])
@pytest.mark.parametrize("block", [512, 256])
def test_packed_quantize_is_reference_quantize_then_pack(r, n, block):
    """K4a's packed form (its plain version, what the kernel is held to on
    the card bit for bit): the reference's ``quantize_blocks`` (qmax 7)
    then ``pack_int4``, byte for byte, scales bit for bit; an odd row's
    last byte carries the zero of the padding in its high nibble."""
    x = _messages(r, n, seed=n + block, scale=3.0)
    packed, scale = tqops.quantize(torch.from_numpy(x), 7, block, packed=True)
    assert packed.dtype == torch.uint8 and packed.shape == (r, (n + 1) // 2)
    qj, sj = jc.quantize_blocks(jnp.asarray(x), jc.QuantConfig(4, block))
    qj = np.asarray(qj)[:, :n + (n % 2)]
    np.testing.assert_array_equal(packed.numpy(),
                                  np.asarray(jc.pack_int4(jnp.asarray(qj))))
    np.testing.assert_array_equal(_bits(scale), _bits(sj))


@pytest.mark.parametrize("r,n", [(2, 5120), (7, 1001), (4, 3072)])
@pytest.mark.parametrize("block", [512, 256])
def test_packed_dequantize_is_reference_unpack_then_dequantize(r, n, block):
    """K4b's packed form: the reference's ``unpack_int4`` then
    ``dequantize_blocks``, the same float32 values."""
    x = _messages(r, n, seed=3 * n + block)
    packed, scale = tqops.quantize(torch.from_numpy(x), 7, block, packed=True)
    got = tqops.dequantize(packed, scale, block, packed=True, n=n)
    assert got.shape == (r, n)
    pad = (-packed.shape[1]) % (block // 2)
    pj = jnp.asarray(np.pad(packed.numpy(), ((0, 0), (0, pad))))
    sj = jnp.asarray(scale.view(torch.int16).numpy()).view(jnp.bfloat16)
    want = jc.dequantize_blocks(jc.unpack_int4(pj), sj,
                                jc.QuantConfig(4, block), orig_len=n)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("packed", [False, True])
@pytest.mark.parametrize("d,c", [(2, 5120), (4, 2048), (8, 1024), (1, 1024)])
def test_dequantize_sum_is_reference_dequantize_then_sum(d, c, packed):
    """K4b's summing form (phase 1 of ``compressed_psum``): the reference's
    ``dequantize_blocks(q_r, scale_r).sum(axis=0)`` within 1e-6 relative
    (XLA sums in its own order; the port in rank order d = 0, 1, ...), and
    bit for bit the port's own rows summed in that order."""
    x = _messages(d, c, seed=d * c, scale=2.0)
    qmax = 7 if packed else 127
    q, scale = tqops.quantize(torch.from_numpy(x), qmax, 512, packed=packed)
    got = tqops.dequantize_sum(q, scale, 512, packed=packed)
    rows = tqops.dequantize(q, scale, 512, packed=packed)
    want_port = rows[0]
    for i in range(1, d):
        want_port = want_port + rows[i]
    assert torch.equal(got, want_port)
    qc = jc.QuantConfig(4 if packed else 8, 512)
    qj, sj = jc.quantize_blocks(jnp.asarray(x), qc)
    want = np.asarray(jc.dequantize_blocks(qj, sj, qc).sum(axis=0))
    np.testing.assert_allclose(got.numpy(), want,
                               rtol=1e-6, atol=1e-6 * np.abs(want).max())

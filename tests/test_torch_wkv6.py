"""The WKV6 recurrence of the port (its plain versions, which are what run on
the CPU) against the JAX package: the TPU kernel ``wkv6_pallas`` in
interpret mode (through its ``ops.wkv6``, zero initial state, y alone) and
the jnp ``wkv_chunked`` / ``wkv_scan_ref`` of ``models/rwkv6.py`` with a
non-zero initial state (y and the final state), on ragged lengths.

Tolerance 3e-4 absolute and relative, the reference's own
(``tests/test_models.py::test_wkv_chunked_matches_scan``): float32 on both
sides, but the chunked form multiplies factors up to e^{+-64} (log-decay
clamped at -2 over 32 steps) and sums in another order than the scan.

The CUDA kernel cannot run here; ``chip_smoke.py`` holds it against
``wkv_chunked`` on the card.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.wkv6.ops import wkv6 as j_wkv6
from repro.models.rwkv6 import wkv_chunked as j_chunked
from repro.models.rwkv6 import wkv_scan_ref as j_scan
from repro_torch.kernels.wkv6 import ops as tops
from repro_torch.kernels.wkv6.ref import wkv_chunked, wkv_scan_ref
from repro_torch.kernels.wkv6.wkv6 import wkv6_cuda

TOL = 3e-4

# (B, T, H, Dh): the reference kernel test's shapes, a ragged T against the
# chunk of 32 and rwkv6's head size 64
SHAPES = [(2, 64, 3, 16), (1, 100, 2, 64), (2, 32, 4, 8), (1, 70, 2, 64),
          (2, 5, 2, 16)]
IDS = [f"B{b}T{t}H{h}Dh{dh}" for b, t, h, dh in SHAPES]


def _inputs(b, t, h, dh, seed, state=False):
    """r, k, v, logw (clamped at -2, as the model does), u and optionally a
    non-zero initial state, as float32 numpy."""
    rng = np.random.default_rng(seed)
    r, k, v = (0.5 * rng.normal(size=(b, t, h, dh)) for _ in range(3))
    logw = np.maximum(-np.exp(0.5 * rng.normal(size=(b, t, h, dh)) - 1.0), -2.0)
    u = 0.3 * rng.normal(size=(h, dh))
    out = [a.astype(np.float32) for a in (r, k, v, logw, u)]
    if state:
        out.append((0.3 * rng.normal(size=(b, h, dh, dh))).astype(np.float32))
    return out


def _close(got, want, what):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=TOL,
                               atol=TOL, err_msg=what)


@pytest.mark.parametrize("b,t,h,dh", SHAPES, ids=IDS)
def test_plain_matches_the_tpu_kernel(b, t, h, dh):
    arrays = _inputs(b, t, h, dh, seed=b * t + dh)
    y, s = tops.wkv6(*(torch.from_numpy(a) for a in arrays))
    want = j_wkv6(*(jnp.asarray(a) for a in arrays), use_pallas=True,
                  interpret=True)
    assert y.dtype == torch.float32 and y.shape == (b, t, h, dh)
    assert s.shape == (b, h, dh, dh)
    _close(y, want, "y")


@pytest.mark.parametrize("b,t,h,dh", SHAPES, ids=IDS)
def test_plain_matches_the_reference_with_a_state(b, t, h, dh):
    """Non-zero state0: y and the final state of the port's chunked and scan
    versions against the reference's, and against each other."""
    arrays = _inputs(b, t, h, dh, seed=t + 3, state=True)
    tt = [torch.from_numpy(a) for a in arrays]
    jj = [jnp.asarray(a) for a in arrays]
    y_c, s_c = wkv_chunked(*tt)
    y_s, s_s = wkv_scan_ref(*tt)
    jy_c, js_c = j_chunked(*jj)
    jy_s, js_s = j_scan(*jj)
    _close(y_c, jy_c, "chunked y")
    _close(s_c, js_c, "chunked state")
    _close(y_s, jy_s, "scan y")
    _close(s_s, js_s, "scan state")
    _close(y_c, y_s, "chunked vs scan y")
    _close(s_c, s_s, "chunked vs scan state")


def test_plain_takes_bf16_inputs_as_the_model_gives_them():
    """r, k, v in bf16 (the projections' dtype), logw float32: the same bf16
    numbers on both sides."""
    r, k, v, logw, u, s0 = _inputs(2, 45, 2, 16, seed=5, state=True)
    jr, jk, jv = (jnp.asarray(a).astype(jnp.bfloat16) for a in (r, k, v))
    tr, tk, tv = (torch.from_numpy(np.array(a.view(jnp.int16))).view(torch.bfloat16)
                  for a in (jr, jk, jv))
    y, s = tops.wkv6(tr, tk, tv, torch.from_numpy(logw), torch.from_numpy(u),
                     torch.from_numpy(s0))
    jy, js = j_chunked(jr, jk, jv, jnp.asarray(logw), jnp.asarray(u),
                       jnp.asarray(s0))
    _close(y, jy, "y")
    _close(s, js, "state")


def test_padded_steps_leave_the_state_alone():
    """A ragged T is padded with k = v = r = 0, logw = 0: the state after T
    steps equals the state after the same T steps with no padding."""
    arrays = [torch.from_numpy(a) for a in _inputs(1, 33, 2, 8, seed=9,
                                                   state=True)]
    _, s_ragged = wkv_chunked(*arrays)                  # 33 -> 64 padded
    _, s_exact = wkv_chunked(*arrays, chunk=33)         # one chunk, no pad
    _close(s_ragged, s_exact, "state")


def test_cuda_wrapper_takes_cuda_tensors_only():
    """The kernel's wrapper raises for CPU tensors (the dispatch sends those
    to the plain version; it never gives way to it)."""
    r, k, v, logw, u = (torch.from_numpy(a) for a in _inputs(1, 40, 2, 16, 0))
    with pytest.raises(ValueError, match="CUDA"):
        wkv6_cuda(r, k, v, logw, u)
    with pytest.raises(ValueError, match="Dh"):
        wkv6_cuda(*(a.new_zeros((1, 4, 1, 256)) for a in (r, k, v, logw)), u)

"""Decode attention of the port (its plain version, which is what runs on the
CPU) against the JAX package: the TPU kernel ``decode_attn_pallas`` in
interpret mode (through its ``ops.decode_attention``) and the jnp oracle
``decode_attn_ref``; plus the host side of the CUDA kernel (its split plan,
its input checks) and the split/combine arithmetic it does on the card.

Tolerance. float32 inputs: 2e-5 absolute and relative, as the reference's
own kernel test (softmax sums in a different order). bfloat16 inputs: both
the port and the TPU kernel return q's dtype, so they may differ by one
bf16 ulp of the value (2^-7 relative) where the float32 results fall on
either side of a rounding edge; against the float32 oracle the port is off
by its own rounding, half an ulp (2^-8 relative), plus the float32 term.

The CUDA kernel cannot run here; ``chip_smoke.py`` holds it against the same
plain version on the card.
"""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.decode_attn.ops import decode_attention as j_decode_attention
from repro.kernels.decode_attn.ref import decode_attn_ref as j_decode_attn_ref
from repro_torch.kernels.decode_attn import ops as tops
from repro_torch.kernels.decode_attn.decode_attn import (TILE, decode_attn_cuda,
                                                        split_plan)
from repro_torch.kernels.decode_attn.ref import decode_attn_ref, valid_rows

F32_TOL = 2e-5

# (B, H, KV, Dh, S, pos, window): the reference kernel test's shapes, then
# gemma3's head shape on a ragged cache (G=4, Dh=256, window 128) at three
# positions, and the edges pos = 0 and pos < window
SHAPES = [(2, 8, 2, 64, 1024, 700, 0), (1, 4, 4, 32, 512, 511, 0),
          (2, 6, 2, 64, 1000, 600, 128),
          (2, 4, 1, 256, 600, 599, 128), (2, 4, 1, 256, 600, 300, 0),
          (1, 4, 1, 256, 600, 0, 128), (2, 4, 1, 256, 600, 70, 128)]
IDS = [f"B{b}H{h}KV{kv}Dh{dh}S{s}pos{p}w{w}" for b, h, kv, dh, s, p, w in SHAPES]


def _inputs(b, h, kv, dh, s, seed):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(b, h, dh)).astype(np.float32),
            rng.normal(size=(b, s, kv, dh)).astype(np.float32),
            rng.normal(size=(b, s, kv, dh)).astype(np.float32))


def _as_bf16(*arrays):
    """The same bf16 numbers on both sides: jnp bf16 arrays and torch bf16
    tensors of the same bits."""
    js = [jnp.asarray(a).astype(jnp.bfloat16) for a in arrays]
    ts = [torch.from_numpy(np.array(j.view(jnp.int16))).view(torch.bfloat16)
          for j in js]
    return js, ts


@pytest.mark.parametrize("b,h,kv,dh,s,pos,win", SHAPES, ids=IDS)
def test_plain_matches_reference_float32(b, h, kv, dh, s, pos, win):
    q, k, v = _inputs(b, h, kv, dh, s, seed=b * s + pos)
    got = tops.decode_attention(torch.from_numpy(q), torch.from_numpy(k),
                                torch.from_numpy(v), pos, win).numpy()
    pal = np.asarray(j_decode_attention(jnp.asarray(q), jnp.asarray(k),
                                        jnp.asarray(v), jnp.int32(pos), win,
                                        use_pallas=True, interpret=True))
    ref = np.asarray(j_decode_attn_ref(jnp.asarray(q), jnp.asarray(k),
                                       jnp.asarray(v), pos, win))
    assert got.dtype == np.float32 and got.shape == (b, h, dh)
    np.testing.assert_allclose(got, pal, rtol=F32_TOL, atol=F32_TOL)
    np.testing.assert_allclose(got, ref, rtol=F32_TOL, atol=F32_TOL)


@pytest.mark.parametrize("b,h,kv,dh,s,pos,win", SHAPES[3:], ids=IDS[3:])
def test_plain_matches_reference_bf16(b, h, kv, dh, s, pos, win):
    (jq, jk, jv), (tq, tk, tv) = _as_bf16(*_inputs(b, h, kv, dh, s,
                                                   seed=pos + 7))
    got = tops.decode_attention(tq, tk, tv, pos, win)
    assert got.dtype == torch.bfloat16 and got.shape == (b, h, dh)
    got = got.float().numpy()
    pal = j_decode_attention(jq, jk, jv, jnp.int32(pos), win,
                             use_pallas=True, interpret=True)
    assert pal.dtype == jnp.bfloat16
    pal = np.asarray(pal.astype(jnp.float32))
    ref = np.asarray(j_decode_attn_ref(jq, jk, jv, pos, win))
    assert np.all(np.abs(got - pal) <= 2.0 ** -7 * np.abs(pal) + 1e-6)
    assert np.all(np.abs(got - ref) <= 2.0 ** -8 * np.abs(ref) + F32_TOL)


def test_window_and_position_edges_match_a_direct_softmax():
    """pos = 0 sees row 0 alone; a window wider than pos sees 0..pos; pos
    past the cache sees every row (float64 direct softmax)."""
    q, k, v = _inputs(1, 2, 1, 16, 40, seed=3)
    for pos, win, rows in ((0, 0, [0]), (0, 8, [0]), (5, 8, range(6)),
                           (20, 8, range(13, 21)), (60, 0, range(40))):
        rows = list(rows)
        sc = np.einsum("hd,td->ht", q[0].astype(np.float64),
                       k[0, rows, 0].astype(np.float64)) / math.sqrt(16)
        p = np.exp(sc - sc.max(-1, keepdims=True))
        want = (p / p.sum(-1, keepdims=True)) @ v[0, rows, 0]
        got = decode_attn_ref(torch.from_numpy(q), torch.from_numpy(k),
                              torch.from_numpy(v), pos, win)[0].numpy()
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
        lo, hi = valid_rows(40, pos, win)
        assert list(range(lo, hi + 1)) == rows


@pytest.mark.parametrize("n_groups", [1, 8, 32, 1024])
@pytest.mark.parametrize("lo,hi", [(0, 0), (0, 31), (0, 1031), (520, 1031),
                                   (0, 32767), (5, 70)])
def test_split_plan_covers_the_rows_once(n_groups, lo, hi):
    rows, nsplit = split_plan(n_groups, lo, hi, n_sm=132)
    assert rows % TILE == 0 and rows >= TILE and nsplit >= 1
    starts = [lo + i * rows for i in range(nsplit)]
    assert starts[-1] <= hi                     # no split is empty
    assert starts[-1] + rows > hi               # and together they cover hi
    if n_groups >= 2 * 132:                     # enough blocks already
        assert nsplit == 1


def _split_combine(q, k, v, pos, window, n_sm):
    """The CUDA kernel's arithmetic, step for step, in float32 torch: each
    split walks its rows a tile at a time keeping (m, l, acc); the combine
    folds the partials in split order. Plus one split that saw no row
    (m = -inf), which must add nothing."""
    b, h, dh = q.shape
    s, kv = k.shape[1], k.shape[2]
    g = h // kv
    lo, hi = valid_rows(s, pos, window)
    rows, nsplit = split_plan(b * kv, lo, hi, n_sm)
    qg = q.reshape(b, kv, g, dh)
    parts = []
    for i in range(nsplit):
        m = torch.full((b, kv, g), float("-inf"))
        l = torch.zeros((b, kv, g))
        acc = torch.zeros((b, kv, g, dh))
        t_end = min(hi + 1, lo + (i + 1) * rows)
        for t0 in range(lo + i * rows, t_end, TILE):
            t1 = min(t0 + TILE, t_end)
            sc = torch.einsum("bkgd,btkd->bkgt", qg, k[:, t0:t1]) / math.sqrt(dh)
            m_new = torch.maximum(m, sc.amax(-1))
            p = torch.exp(sc - m_new[..., None])
            corr = torch.where(torch.isfinite(m), torch.exp(m - m_new),
                               torch.zeros_like(m))
            l = l * corr + p.sum(-1)
            acc = acc * corr[..., None] + torch.einsum("bkgt,btkd->bkgd", p,
                                                       v[:, t0:t1])
            m = m_new
        parts.append((m, l, acc))
    parts.append((torch.full((b, kv, g), float("-inf")), torch.zeros((b, kv, g)),
                  torch.zeros((b, kv, g, dh))))
    m_all = torch.stack([p[0] for p in parts]).amax(0)
    l_all = torch.zeros_like(m_all)
    acc_all = torch.zeros((b, kv, g, dh))
    for m, l, acc in parts:
        w = torch.where(torch.isfinite(m), torch.exp(m - m_all),
                        torch.zeros_like(m))
        l_all = l_all + l * w
        acc_all = acc_all + acc * w[..., None]
    return (acc_all / l_all.clamp_min(1e-30)[..., None]).reshape(b, h, dh)


@pytest.mark.parametrize("b,h,kv,dh,s,pos,win", SHAPES, ids=IDS)
def test_split_and_combine_arithmetic_matches_plain(b, h, kv, dh, s, pos, win):
    q, k, v = (torch.from_numpy(a) for a in _inputs(b, h, kv, dh, s, seed=11))
    want = decode_attn_ref(q, k, v, pos, win)
    for n_sm in (1, 132):
        got = _split_combine(q, k, v, pos, win, n_sm)
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=F32_TOL,
                                   atol=F32_TOL)


def test_cuda_wrapper_takes_cuda_tensors_only():
    """The kernel's wrapper raises for CPU tensors (the dispatch sends those
    to the plain version; it never gives way to it)."""
    q, k, v = (torch.from_numpy(a) for a in _inputs(1, 4, 1, 64, 40, seed=0))
    with pytest.raises(ValueError, match="CUDA"):
        decode_attn_cuda(q, k, v, 10)
    with pytest.raises(ValueError, match="pos"):
        decode_attn_ref(q, k, v, -1)

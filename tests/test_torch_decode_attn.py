"""Decode attention of the port (its plain version, which is what runs on the
CPU) against the JAX package: the TPU kernel ``decode_attn_pallas`` in
interpret mode (through its ``ops.decode_attention``) and the jnp oracle
``decode_attn_ref``; plus the host side of the CUDA kernel (its split plan,
its layout and shared memory, its input checks) and the arithmetic it does
on the card: teams of lanes over batches of rows, the fold of the teams and
the fold of the splits by the last block.

Tolerance. float32 inputs: 2e-5 absolute and relative, as the reference's
own kernel test (softmax sums in a different order). bfloat16 inputs: both
the port and the TPU kernel return q's dtype, so they may differ by one
bf16 ulp of the value (2^-7 relative) where the float32 results fall on
either side of a rounding edge; against the float32 oracle the port is off
by its own rounding, half an ulp (2^-8 relative), plus the float32 term.

The CUDA kernel cannot run here; ``chip_smoke.py`` holds it against the same
plain version on the card.
"""
import ast
import math
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.decode_attn.ops import decode_attention as j_decode_attention
from repro.kernels.decode_attn.ref import decode_attn_ref as j_decode_attn_ref
from repro_torch.configs import get_config
from repro_torch.kernels.decode_attn import ops as tops
from repro_torch.kernels.decode_attn.decode_attn import (
    BATCH, CONSUMERS, HEADER_BYTES, HEADS, MAX_SPLITS, MIN_ROWS, SMEM_LIMIT,
    decode_attn_cuda, head_slices, layout, shared_bytes, split_plan)
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


def _plan_ok(n_units, lo, hi, n_slots):
    """The plan's invariants: runs of ``rows`` cover ``lo..hi`` once, none
    empty; the blocks fit the slots (or one split a unit); at most
    MAX_SPLITS runs, and at least MIN_ROWS rows a run where there are
    several."""
    rows, nsplit = split_plan(n_units, lo, hi, n_slots)
    assert rows >= 1 and nsplit >= 1
    starts = [lo + i * rows for i in range(nsplit)]
    assert starts[-1] <= hi                     # no split is empty
    assert starts[-1] + rows > hi               # and together they cover hi
    assert n_units * nsplit <= max(n_slots, n_units)
    assert nsplit <= MAX_SPLITS
    if nsplit > 1:
        assert rows >= MIN_ROWS
    return rows, nsplit


@pytest.mark.parametrize("n_groups", [1, 8, 32, 1024])
@pytest.mark.parametrize("lo,hi", [(0, 0), (0, 31), (0, 1031), (520, 1031),
                                   (0, 32767), (5, 70)])
def test_split_plan_covers_the_rows_once(n_groups, lo, hi):
    for n_slots in (1, 132, 264):
        rows, nsplit = _plan_ok(n_groups, lo, hi, n_slots)
        if 2 * n_groups > n_slots:              # enough blocks already
            assert nsplit == 1
    # one wave of an H100 with one block an SM: gemma3-1b's decode shapes
    # (8 units) take 16 splits: 65 rows a global layer, 32 a local one, 2048
    # at a cache of 32768
    if n_groups == 8 and (lo, hi) in ((0, 1031), (520, 1031), (0, 32767)):
        assert split_plan(8, lo, hi, 132) == (
            {1032: 65, 512: 32, 32768: 2048}[hi - lo + 1], 16)


def _da_cases():
    """``DA_CASES`` of chip_smoke.py (which needs a card to import), read
    from its source: (name, B, H, KV, Dh, S, pos, window, q dtype, cache
    dtype, NaN outside the rows)."""
    src = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    for node in ast.parse(src.read_text()).body:
        if isinstance(node, ast.Assign) and getattr(node.targets[0], "id",
                                                    None) == "DA_CASES":
            return [tuple(getattr(torch, v.attr) if isinstance(v, ast.Attribute)
                          else ast.literal_eval(v) for v in case.elts)
                    for case in node.value.elts]
    raise AssertionError("chip_smoke.py has no DA_CASES")


def _dense_decode_shapes():
    """(name, B, H, KV, Dh, S, pos, window, q dtype, cache dtype, False) of
    every dense config's decode step at B = 8, caches of 1032 and 32768
    rows, global and (where the config has a window) local layers, bf16 and
    float32 caches."""
    out = []
    for arch in ("gemma3-1b", "glm4-9b", "granite-3-8b", "yi-34b"):
        cfg = get_config(arch)
        for s in (1032, 32768):
            for win in {0, getattr(cfg, "window", 0) or 0}:
                for dt in (torch.bfloat16, torch.float32):
                    out.append((f"{arch}_S{s}_w{win}", 8, cfg.n_heads,
                                cfg.n_kv_heads, cfg.d_head, s, s - 1, win, dt,
                                dt, False))
    return out


PLAN_CASES = _da_cases() + _dense_decode_shapes()


@pytest.mark.parametrize("case", PLAN_CASES, ids=[c[0] for c in PLAN_CASES])
def test_plan_and_shared_memory_fit_every_case(case):
    """For every card check of chip_smoke.py and every dense config's decode
    shape: a block's shared memory fits the H100's 227 KB, its teams'
    partials fit the ring, a row fits a team, and the plan covers the rows
    once within one or two blocks an SM."""
    _, b, h, kv, dh, s, pos, win, _, c_dtype, _ = case
    esize = torch.empty((), dtype=c_dtype).element_size()
    lanes, stage_rows, stages = layout(dh, esize)
    assert shared_bytes(dh, esize) <= SMEM_LIMIT
    assert lanes in (8, 16, 32) and stage_rows == CONSUMERS // lanes * BATCH
    assert dh * esize // 16 <= lanes * (esize // 2)   # a row, a team
    ring = shared_bytes(dh, esize) - HEADER_BYTES
    assert CONSUMERS // lanes * HEADS * (dh + 2) * 4 <= ring
    lo, hi = valid_rows(s, pos, win)
    for per_sm in (1, 2):
        _plan_ok(b * kv * head_slices(h // kv), lo, hi, 132 * per_sm)


def _split_combine(q, k, v, pos, window, n_slots, elem_bytes=4):
    """The CUDA kernel's arithmetic, step for step, in float32 torch: the
    plan's runs; in each run the teams of the layout for ``elem_bytes``
    caches take BATCH rows of each stage and keep (m, l, acc); the teams are
    folded in team order, and the runs' partials in split order. Plus one
    split that saw no row (m = -inf), which must add nothing."""
    b, h, dh = q.shape
    s, kv = k.shape[1], k.shape[2]
    g = h // kv
    lo, hi = valid_rows(s, pos, window)
    lanes, stage_rows, _ = layout(dh, elem_bytes)
    nteams = CONSUMERS // lanes
    rows, nsplit = split_plan(b * kv * head_slices(g), lo, hi, n_slots)
    qg = q.reshape(b, kv, g, dh)
    empty = (torch.full((b, kv, g), float("-inf")), torch.zeros((b, kv, g)),
             torch.zeros((b, kv, g, dh)))

    def fold(parts):
        m_all = torch.stack([p[0] for p in parts]).amax(0)
        m_safe = torch.where(torch.isfinite(m_all), m_all,
                             torch.zeros_like(m_all))
        l_all, acc_all = torch.zeros_like(m_all), torch.zeros((b, kv, g, dh))
        for m, l, acc in parts:
            w = torch.where(torch.isfinite(m), torch.exp(m - m_safe),
                            torch.zeros_like(m))
            l_all = l_all + l * w
            acc_all = acc_all + acc * w[..., None]
        return m_all, l_all, acc_all

    parts = []
    for i in range(nsplit):
        t0 = lo + i * rows
        n = min(hi + 1, t0 + rows) - t0
        teams = [empty] * nteams
        for st in range(0, n, stage_rows):
            for tm in range(nteams):
                r0 = st + tm * BATCH
                if r0 >= n:
                    continue
                r1 = min(r0 + BATCH, n)
                m, l, acc = teams[tm]
                sc = torch.einsum("bkgd,btkd->bkgt", qg,
                                  k[:, t0 + r0:t0 + r1]) * (1 / math.sqrt(dh))
                m_new = torch.maximum(m, sc.amax(-1))
                m_safe = torch.where(torch.isfinite(m_new), m_new,
                                     torch.zeros_like(m_new))
                corr = torch.where(torch.isfinite(m), torch.exp(m - m_safe),
                                   torch.zeros_like(m))
                p = torch.exp(sc - m_safe[..., None])
                teams[tm] = (m_new, l * corr + p.sum(-1),
                             acc * corr[..., None] + torch.einsum(
                                 "bkgt,btkd->bkgd", p, v[:, t0 + r0:t0 + r1]))
        parts.append(fold(teams))
    _, l_all, acc_all = fold(parts + [empty])
    return (acc_all / l_all.clamp_min(1e-30)[..., None]).reshape(b, h, dh)


@pytest.mark.parametrize("b,h,kv,dh,s,pos,win", SHAPES, ids=IDS)
def test_split_and_combine_arithmetic_matches_plain(b, h, kv, dh, s, pos, win):
    q, k, v = (torch.from_numpy(a) for a in _inputs(b, h, kv, dh, s, seed=11))
    want = decode_attn_ref(q, k, v, pos, win)
    for n_slots in (1, 132):
        for elem_bytes in (2, 4):
            got = _split_combine(q, k, v, pos, win, n_slots, elem_bytes)
            np.testing.assert_allclose(got.numpy(), want.numpy(),
                                       rtol=F32_TOL, atol=F32_TOL)


# (B, H, KV, Dh, S, pos, window, n_slots, what the plan must show)
PLAN_EDGES = [
    (8, 4, 1, 256, 1032, 1031, 0, 132, "ragged"),     # 16 runs of 65 rows
    (8, 4, 1, 256, 1032, 700, 400, 132, "ragged"),    # 16 runs of 25 rows
    (2, 4, 1, 256, 1032, 1031, 0, 1, "one split"),
    (8, 14, 2, 128, 300, 299, 0, 4, "one split"),     # G=7: 2 slices
    (1, 4, 1, 256, 600, 599, 0, 132, "over 16"),      # 32 runs of 19 rows
    (1, 8, 2, 64, 900, 880, 0, 132, "over 16"),       # 2 units x 27 runs
]


@pytest.mark.parametrize("b,h,kv,dh,s,pos,win,n_slots,what", PLAN_EDGES)
def test_kernel_arithmetic_at_plan_edges(b, h, kv, dh, s, pos, win, n_slots,
                                         what):
    """Runs that are not a multiple of 32 rows, a single split a unit, more
    than 16 splits: the kernel's arithmetic still equals the plain version,
    for both cache widths' layouts."""
    lo, hi = valid_rows(s, pos, win)
    rows, nsplit = split_plan(b * kv * head_slices(h // kv), lo, hi, n_slots)
    if what == "ragged":
        assert rows % 32 and nsplit > 1
    elif what == "one split":
        assert nsplit == 1
    else:
        assert nsplit > 16
    q, k, v = (torch.from_numpy(a) for a in _inputs(b, h, kv, dh, s, seed=5))
    want = decode_attn_ref(q, k, v, pos, win)
    for elem_bytes in (2, 4):
        got = _split_combine(q, k, v, pos, win, n_slots, elem_bytes)
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

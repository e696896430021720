"""The port's streaming attention (``layers.streaming_attention``, the
prefill of prompts over 2048 tokens) against the JAX package's, on the CPU:
float32 inputs, the reference's own bound (rtol 2e-4, atol 2e-5,
``tests/test_models.py``); ragged lengths (the port keeps its chunks and
lets the last be ragged, the reference shrinks them until they divide S),
local and global, and the block pairs it skips. Then whole prefills
past 2048 tokens against the reference's: gemma3 (its local band and its
global layer) and qwen2-vl (M-RoPE). Not an MoE model: over 4200 tokens
its router meets near ties (the second and third experts' probabilities
2e-7 apart in mixtral's smoke model), where a bf16 difference upstream
picks another expert for a token, and a handful of tokens then differ by
more than the hidden tolerance (the same model with a dense MLP agrees).
"""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models.layers import streaming_attention as j_streaming
from repro_torch.models import layers
from torch_lm import check_prefill_hidden, pair

RTOL, ATOL = 2e-4, 2e-5


def _inputs(b, s, kv, g, dh, seed):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(b, s, kv, g, dh)).astype(np.float32),
            rng.normal(size=(b, s, kv, dh)).astype(np.float32),
            rng.normal(size=(b, s, kv, dh)).astype(np.float32))


# B, S, KV, G, Dh, is_local, window, q_chunk, kv_chunk
CASES = [
    (2, 128, 2, 3, 16, False, 0, 512, 1024),      # one block pair
    (2, 128, 2, 3, 16, True, 17, 32, 32),         # band, skipped pairs
    (1, 100, 1, 2, 8, False, 0, 32, 48),          # ragged (reference: 25, 25)
    (1, 100, 1, 2, 8, True, 30, 32, 48),
    (2, 97, 2, 1, 8, True, 5, 16, 16),            # prime S (reference: 1, 1)
    (1, 130, 1, 4, 16, True, 40, 13, 26),
    (1, 96, 1, 2, 8, False, 40, 16, 32),          # a window on a global layer
]


@pytest.mark.parametrize("case", CASES, ids=lambda c: "-".join(map(str, c)))
def test_streaming_attention_matches_reference(case):
    b, s, kv, g, dh, is_local, window, qc, kc = case
    q, k, v = _inputs(b, s, kv, g, dh, seed=s + window)
    scale = 1.0 / math.sqrt(dh)
    want = j_streaming(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                       jnp.asarray(is_local), window, scale, qc, kc)
    got = layers.streaming_attention(*map(torch.as_tensor, (q, k, v)),
                                     is_local, window, scale, qc, kc)
    assert got.dtype == torch.float32 and got.shape == q.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                               atol=ATOL)


def test_scores_bf16_matches_reference():
    """bf16 inputs with the scores rounded to bf16 (``scores_bf16``): the
    two round the same float32 scores, so they agree to a bf16 ulp of
    the scores (2^-8 relative), which the softmax passes on."""
    q, k, v = (torch.as_tensor(a).to(torch.bfloat16)
               for a in _inputs(2, 64, 2, 2, 16, seed=5))
    j = lambda t: jnp.asarray(t.float().numpy(), jnp.bfloat16)
    want = j_streaming(j(q), j(k), j(v), jnp.asarray(True), 20, 0.25, 16, 16,
                       scores_bf16=True)
    got = layers.streaming_attention(q, k, v, True, 20, 0.25, 16, 16,
                                     scores_bf16=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=2.0 ** -7)


@pytest.mark.parametrize("is_local", [False, True])
def test_skipped_blocks_are_never_read(is_local):
    """A block pair wholly in the causal future, or wholly before the band,
    is skipped: NaN in every key and value it would read leaves the output
    of the query rows that skip it finite and bit for bit what it is
    without the NaN. 64 rows, chunks of 16, band 8: rows 0..31 never need
    keys 32..63; with the band, rows 32..63 never need keys 0..15."""
    q, k, v = map(torch.as_tensor, _inputs(1, 64, 1, 2, 8, seed=3))
    args = (is_local, 8, 0.3, 16, 16)
    clean = layers.streaming_attention(q, k, v, *args)
    cases = [(slice(32, None), slice(None, 32))]          # the causal future
    if is_local:
        cases.append((slice(None, 16), slice(32, None)))  # before the band
    for poisoned, rows in cases:
        k2, v2 = k.clone(), v.clone()
        k2[:, poisoned], v2[:, poisoned] = float("nan"), float("nan")
        got = layers.streaming_attention(q, k2, v2, *args)
        assert bool(torch.isfinite(got[:, rows]).all())
        assert torch.equal(got[:, rows], clean[:, rows])


@pytest.mark.parametrize("window", [0, 300])
def test_prime_length_keeps_its_chunks(window, monkeypatch):
    """At a prime length past 2048 (2053) the chunks stay 512 x 1024 with
    a ragged last one: the block pairs computed are exactly those holding
    an unmasked (query, key) entry, at most 5 x 3 (the reference's rule
    would shrink both chunks to one row, 2.1 M pairs), and the result is
    the masked softmax's, computed whole in float64, to the reference's
    bound."""
    s, qc, kc = 2053, 512, 1024
    q, k, v = map(torch.as_tensor, _inputs(1, s, 1, 2, 8, seed=6))
    calls = []
    einsum = torch.einsum
    monkeypatch.setattr(torch, "einsum",
                        lambda *a: calls.append(a[0]) or einsum(*a))
    got = layers.streaming_attention(q, k, v, window > 0, window, 0.3, qc, kc)
    monkeypatch.undo()
    qi, kj = np.arange(s)[:, None], np.arange(s)[None, :]
    ok = (kj <= qi) & ((kj > qi - window) if window else True)
    live = sum(bool(ok[i:i + qc, j:j + kc].any())
               for i in range(0, s, qc) for j in range(0, s, kc))
    assert live <= 5 * 3 and len(calls) == 2 * live, (len(calls), live)
    q64, k64, v64 = (t.double().numpy() for t in (q, k, v))
    sc = np.einsum("sgd,td->gst", q64[0, :, 0], k64[0, :, 0]) * 0.3
    sc = np.where(ok, sc, -np.inf)
    p = np.exp(sc - sc.max(-1, keepdims=True))
    want = np.einsum("gst,td->sgd", p / p.sum(-1, keepdims=True),
                     v64[0, :, 0])
    np.testing.assert_allclose(got[0, :, 0].numpy(), want, rtol=RTOL,
                               atol=ATOL)


def test_causal_attention_streams_past_2048():
    """``causal_attention`` materialises the scores up to 2048 positions
    and streams past: at 2050 both forms agree to the reference's bound."""
    q, k, v = map(torch.as_tensor, _inputs(1, 2050, 1, 2, 8, seed=4))
    assert layers.DENSE_MAX == 2048
    for window in (0, 300):
        qi = torch.arange(2050)[:, None]
        kj = torch.arange(2050)[None, :]
        ok = (kj <= qi) & ((kj > qi - window) if window else True)
        want = layers.dense_attention(q, k, v, ok)
        got = layers.causal_attention(q, k, v, window)
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=RTOL,
                                   atol=ATOL)


@pytest.mark.parametrize("arch", ["gemma3-1b", "qwen2-vl-7b"])
def test_long_prefill_matches_reference(arch):
    """A prompt of 2100 tokens through the smoke model (chunks 512 x 1024,
    the last ragged; the reference's 420 x 700)."""
    check_prefill_hidden(pair(arch, arch), s=2100)

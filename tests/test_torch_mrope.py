"""The port's M-RoPE (``layers.mrope_positions``, ``mrope_cache``, the
(B, S, Dh/2) tables of ``apply_rope``) and qwen2-vl-7b against the JAX
package, on the CPU, and the reference's decode-position fault.

Positions are small integers in float32: exact. The tables are float32
sin/cos of the same products: within 1e-6. qwen2-vl takes prompts of 24
tokens (16 vision-stub embeddings of ones, then text), and its decode is
held to the reference's prefill over the same tokens (``torch_lm.Pair.
intent``): the reference's own decode step puts text at the raw index,
not where its prefill puts it (the last test).
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import lm_logits as j_lm_logits
from repro.models.layers import apply_rope as j_apply_rope
from repro.models.layers import mrope_cache as j_mrope_cache
from repro.models.layers import mrope_positions as j_mrope_positions
from repro_torch import convert
from repro_torch.launch import serve
from repro_torch.models import get_model
from repro_torch.models import layers
from torch_lm import (LOGIT_TOL, check_decode_asks_the_host_nothing,
                      check_decode_logits, check_generate,
                      check_own_consistency, check_prefill_hidden, pair,
                      ref_prefill_logits, ref_prefill_state, tokens)

ARCH = "qwen2-vl-7b"
CACHE_TOL = 1e-6


def _pair():
    return pair(ARCH, ARCH, prompt=24, intent=True)


@pytest.mark.parametrize("b,s,nv", [(2, 20, 16), (1, 2048, 1024), (3, 7, 0),
                                    (2, 30, 10), (1, 16, 16)])
def test_mrope_positions_match_reference(b, s, nv):
    want = np.asarray(j_mrope_positions(b, s, nv))
    got = layers.mrope_positions(b, s, nv)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("nv", [0, 16, 1024])
def test_a_decode_position_continues_the_prefill(nv):
    """Index p alone (a decode step: ``pos0 = p``, S = 1) sits where a
    prefill over p + 1 tokens puts it, vision grid and text alike."""
    n = nv + 40
    full = layers.mrope_positions(2, n, nv)
    for p in range(0, n, 7):
        one = layers.mrope_positions(2, 1, nv, pos0=p)
        assert torch.equal(one[..., 0], full[..., p]), p


@pytest.mark.parametrize("d_head", [128, 16])
def test_mrope_cache_matches_reference(d_head):
    sections = layers.mrope_sections(d_head)
    assert d_head != 128 or sections == (16, 24, 24)
    pos3 = j_mrope_positions(2, 1100, 1024)
    jsin, jcos = j_mrope_cache(pos3, d_head, 1e6, sections)
    sin, cos = layers.mrope_cache(torch.as_tensor(np.array(pos3)), d_head,
                                  1e6, sections)
    np.testing.assert_allclose(sin.numpy(), np.asarray(jsin), rtol=0,
                               atol=CACHE_TOL)
    np.testing.assert_allclose(cos.numpy(), np.asarray(jcos), rtol=0,
                               atol=CACHE_TOL)


def test_apply_rope_takes_per_token_tables():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 9, 3, 16)).astype(np.float32)
    ang = rng.uniform(0, 6, size=(2, 9, 8)).astype(np.float32)
    want = j_apply_rope(jnp.asarray(x), jnp.sin(ang), jnp.cos(ang))
    got = layers.apply_rope(torch.as_tensor(x), torch.sin(torch.as_tensor(ang)),
                            torch.cos(torch.as_tensor(ang)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-6)


def test_prefill_hidden_matches_reference():
    check_prefill_hidden(_pair())


def test_decode_logits_match_reference_prefill():
    check_decode_logits(_pair())


def test_port_decode_matches_its_own_prefill():
    """From an empty state through the vision grid's positions (no stub
    embeddings: tokens all the way) into the text."""
    check_own_consistency(_pair(), n=24)


def test_generate_matches_reference():
    check_generate(_pair())


def test_decode_loop_asks_the_host_nothing(monkeypatch):
    check_decode_asks_the_host_nothing(_pair(), monkeypatch)


def test_prompt_shorter_than_the_vision_stub_raises():
    """The vision embeddings overwrite the first n_vision embeddings, so a
    prompt must hold them (the reference fails on such a prompt too, in
    ``dynamic_update_slice``)."""
    model = _pair().model
    with pytest.raises(ValueError, match="cannot hold 16 vision"):
        serve.generate(model, tokens(model.cfg, 1, 15, seed=0), 2)


def test_reference_decode_puts_text_at_the_raw_index():
    """The reference's M-RoPE prefill places text token i >= n_vision at
    position g + (i - n_vision) (``layers.py:117-121``, g = sqrt(n_vision));
    its decode step puts all three components at the raw index ``pos``
    (``transformer.py:171-173``), n_vision - g positions away (12 at the
    smoke config's 16 vision tokens, 992 at the full 1024). With q and k
    weights sharpened 8x, so that positions matter, its decode after a
    prompt of 24 departs from its own prefill over the same tokens by more
    than 10 % of the logits' scale, where the port's decode (positions by
    its prefill's rule) stays within the 2 % of ``torch_lm``."""
    pr = _pair()
    m, cfg = pr.m, pr.cfg
    params = dict(pr.params)
    for name in ("layers/wq", "layers/wk"):
        params[name] = (params[name].astype(jnp.float32) * 8).astype(
            jnp.bfloat16)
    sharp = dataclasses.replace(pr, params=params)
    p, n = 24, 4
    toks = tokens(cfg, 2, p + n, seed=0)
    want = ref_prefill_logits(sharp, toks)[:, p:]
    scale = np.abs(want).max()
    state = ref_prefill_state(sharp, jnp.asarray(toks[:, :p], jnp.int32),
                              p + n)
    ref = []
    for i in range(n):
        h, state = m.decode_step(params, jnp.asarray(toks[:, p + i:p + i + 1],
                                                     jnp.int32),
                                 state, p + i, cfg)
        ref.append(np.asarray(j_lm_logits(params, h, cfg))[:, 0])
    ref_err = np.abs(np.stack(ref, 1) - want).max() / scale
    model = get_model(pr.model.cfg, device="cpu",
                      state=convert.lm_params_from_arrays(
                          {k: np.asarray(v) for k, v in params.items()},
                          pr.model.cfg))
    with torch.inference_mode():
        st = serve.prefill(model, torch.as_tensor(toks[:, :p]), p + n,
                           serve.stub_inputs(model, 2, p))
        got = []
        for i in range(n):
            h, st = model.decode_step(torch.as_tensor(toks[:, p + i:p + i + 1]),
                                      st, p + i)
            got.append(model.logits(h)[:, 0].numpy())
    port_err = np.abs(np.stack(got, 1) - want).max() / scale
    assert ref_err > 0.1 and port_err <= LOGIT_TOL, (ref_err, port_err)

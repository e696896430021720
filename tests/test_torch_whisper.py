"""The port's Whisper (``models/whisper.py``, whisper-small) and
``layers.cross_attention`` against the JAX package, on the CPU: the
encoder over the stubbed frames, the family checks of ``torch_lm`` (frames
of ones, as the reference's serve loop passes them), and the
cross-attention of prefill. A decode step's cross-attention runs the
decode-attention kernel's plain version at ``pos = n_frames - 1`` here,
the reference's full softmax over the frames: the decode logits check
holds it.
"""

import jax.numpy as jnp
import numpy as np
import torch

from repro.configs import get_config as j_get_config
from repro.models.layers import cross_attention as j_cross_attention
from repro.models.whisper import whisper_encode as j_encode
from repro_torch.configs import get_config
from repro_torch.models import layers, whisper
from torch_lm import (H_TOL, assert_scaled,
                      check_decode_asks_the_host_nothing,
                      check_decode_logits, check_generate,
                      check_own_consistency, check_prefill_hidden, jf32, pair)

ARCH = "whisper-small"


def _pair():
    return pair(ARCH, ARCH)


def _bf16(a):
    j = jnp.asarray(a, jnp.bfloat16)
    return j, torch.from_numpy(np.array(j.view(jnp.int16))).view(torch.bfloat16)


def test_encoder_matches_reference():
    pr = _pair()
    frames = np.random.default_rng(0).normal(
        size=(2, pr.cfg.n_audio_frames, pr.cfg.d_model))
    jf, tf = _bf16(frames)
    want = j_encode(pr.params, jf, pr.cfg)
    with torch.inference_mode():
        got = whisper.whisper_encode(pr.model, tf, pr.model.cfg)
    assert got.shape == tuple(want.shape)
    assert_scaled(got.float().numpy(), jf32(want), H_TOL, "encoder")


def test_cross_attention_matches_reference():
    """``layers.cross_attention`` against the reference's, GQA (glm4's
    smoke heads: 4 query heads on 2 KV heads) over 30 encoder rows."""
    cfg = j_get_config("glm4-9b").smoke_config()
    tcfg = get_config("glm4-9b").smoke_config()
    rng = np.random.default_rng(1)
    d, h, kv, dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    arrays = [rng.normal(size=s) * std for s, std in (
        ((2, 9, d), 1.0), ((2, 30, kv, dh), 1.0), ((2, 30, kv, dh), 1.0),
        ((d, h, dh), 0.1), ((h, dh, d), 0.1))]
    (jx, tx), (jk, tk), (jv, tv), (jq, tq), (jo, to) = map(_bf16, arrays)
    want = j_cross_attention(jx, (jk, jv), jq, jo, cfg)
    got = layers.cross_attention(tx, (tk, tv), tq, to, tcfg)
    assert_scaled(got.float().numpy(), jf32(want), H_TOL, "cross")


def test_prefill_hidden_matches_reference():
    check_prefill_hidden(_pair())


def test_decode_logits_match_reference():
    check_decode_logits(_pair())


def test_port_decode_matches_its_own_prefill():
    check_own_consistency(_pair())


def test_generate_matches_reference_serve_loop():
    check_generate(_pair())


def test_decode_loop_asks_the_host_nothing(monkeypatch):
    check_decode_asks_the_host_nothing(_pair(), monkeypatch)

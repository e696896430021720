"""The port's LM serving path against the JAX package, on the CPU: prefill,
decode and greedy ``generate`` of the smoke configs of gemma3-1b (dense,
5:1 local:global, qk-norm, dual RoPE), granite-3-8b (dense, GQA) and
rwkv6-3b (the WKV recurrence), plus gemma3 at its real vocab of 262144,
which takes the sqrt(d) embedding scale. Both packages get the same
parameters (``torch_lm.pair``); the tolerances are ``torch_lm``'s. The
other families are held the same way in ``test_torch_{moe,rglru,mrope,
whisper}.py``, the streaming attention in ``test_torch_streaming.py``.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro_torch.configs import get_config, list_archs
from repro_torch.launch.serve import generate
from repro_torch.models import get_model
from torch_lm import (check_decode_asks_the_host_nothing,
                      check_decode_logits, check_generate,
                      check_own_consistency, check_prefill_hidden, pair,
                      tokens)

CASES = {
    "gemma3-1b": lambda c: c.smoke_config(),
    "granite-3-8b": lambda c: c.smoke_config(),
    "rwkv6-3b": lambda c: c.smoke_config(),
    # the real vocab (> 200 000) takes the sqrt(d) embedding scale (its
    # rounding to bf16 is held bit for bit below)
    "gemma3-1b-vocab": lambda c: dataclasses.replace(
        c.smoke_config(), vocab=262144, n_layers=2),
}


def _pair(case):
    return pair(case, case.split("-vocab")[0], CASES[case])


@pytest.mark.parametrize("case", list(CASES))
def test_prefill_hidden_matches_reference(case):
    check_prefill_hidden(_pair(case))


@pytest.mark.parametrize("case", list(CASES))
def test_decode_logits_match_reference(case):
    """Prefill a prompt, then 8 decode steps fed the same tokens on both
    sides: the logits of every step."""
    check_decode_logits(_pair(case))


@pytest.mark.parametrize("case", list(CASES))
def test_port_decode_matches_its_own_prefill(case):
    """Token-by-token decode from an empty state against one prefill over
    the same tokens (the reference's consistency test, on the port)."""
    check_own_consistency(_pair(case))


@pytest.mark.parametrize("case", list(CASES))
def test_generate_matches_reference_serve_loop(case):
    """``generate`` against the reference's serve loop (prefill, then greedy
    decode from the prompt's last token at position P, argmax of float32
    logits)."""
    check_generate(_pair(case))


@pytest.mark.parametrize("case", ["gemma3-1b", "rwkv6-3b"])
def test_decode_loop_asks_the_host_nothing(case, monkeypatch):
    """While ``serve.decode`` runs, nothing reads a tensor's value on the
    host and no Python number is written into a tensor."""
    check_decode_asks_the_host_nothing(_pair(case), monkeypatch)


def test_generate_keeps_the_logits_it_chose_from():
    model = _pair("gemma3-1b").model
    out = generate(model, tokens(model.cfg, 2, 12, seed=5), 4,
                   keep_logits=True)
    assert out.logits.shape == (2, 4, model.cfg.vocab_padded)
    np.testing.assert_array_equal(out.logits.argmax(-1).numpy(), out.tokens)


@pytest.mark.parametrize("arch", list_archs())
def test_config_matches_reference(arch):
    """Every registered config, at full size and smoke size, field for
    field the JAX package's (the same ten archs in both registries)."""
    from repro.configs import get_config as j_get_config
    from repro.configs import list_archs as j_list_archs
    assert list_archs() == j_list_archs()
    cfg, ref = get_config(arch), j_get_config(arch)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(ref)
    assert (dataclasses.asdict(cfg.smoke_config())
            == dataclasses.asdict(ref.smoke_config()))


@pytest.mark.parametrize("arch", list_archs())
def test_params_carried_bit_for_bit(arch):
    """``convert.lm_params_from_arrays`` gives every module parameter the
    reference's bits: stacked paths slice by slice (``layers/*``,
    ``macro/*/*``, ``enc/*/*``, ``dec/*/*``), the others whole."""
    from repro_torch.models.model_api import _depth, _names
    pr = pair(arch, arch)
    cfg = pr.model.cfg
    got = dict(pr.model.named_parameters())
    assert len(got) == sum(len(_names(p, cfg)) for p in pr.params)
    for path, a in pr.params.items():
        a = np.asarray(a.view(jnp.int16) if a.dtype == jnp.bfloat16 else a)
        stacked = _depth(path.split("/")[0], cfg) is not None
        for i, name in enumerate(_names(path, cfg)):
            t = got[name].detach()
            t = t.view(torch.int16) if t.dtype == torch.bfloat16 else t
            np.testing.assert_array_equal(t.numpy(), a[i] if stacked else a,
                                          err_msg=name)


@pytest.mark.parametrize("d", [64, 72, 1152])
def test_scaled_embedding_is_bit_identical_to_reference(d):
    """The sqrt(d) embedding scale of a vocab over 200 000 meets a bf16
    table: JAX rounds the Python scalar to bf16 first (sqrt(1152) = 33.94
    becomes 34.0), and so must the port, bit for bit."""
    from repro.models.layers import embed_tokens as j_embed
    from repro_torch.models.layers import embed_tokens as t_embed
    rng = np.random.default_rng(d)
    table = jnp.asarray(rng.normal(size=(300, d)), jnp.bfloat16)
    toks = rng.integers(0, 300, (2, 17))
    want = np.asarray(j_embed(table, jnp.asarray(toks), scale=True)
                      .view(jnp.int16))
    t_table = torch.from_numpy(np.array(table.view(jnp.int16))).view(
        torch.bfloat16)
    got = t_embed(t_table, torch.as_tensor(toks), scale=True)
    np.testing.assert_array_equal(got.view(torch.int16).numpy(), want)


@pytest.mark.parametrize("arch", list_archs())
def test_not_ported_families_and_long_prompts_raise(arch):
    """Every family trains: mode "train" gives the hidden and no caches
    (qwen2-vl over a prompt that holds its vision embeddings; a shorter
    one raises, as in prefill). A mode no forward knows raises. Prompts
    over 2048 tokens, which raised before the streaming attention was
    ported, run (gemma3: 2050 tokens, its local band and its global
    layer)."""
    cfg = get_config(arch).smoke_config()
    model = get_model(cfg, device="cpu")
    n = max(4, cfg.n_vision_tokens + 2)
    aux = {name: torch.ones(m.shape, dtype=m.dtype)
           for name, m in model.aux_inputs(1, n).items()}
    tokens = torch.zeros((1, n), dtype=torch.long)
    h, caches = model(tokens, mode="train", **aux)
    assert caches is None and h.shape == (1, n, cfg.d_model)
    assert bool(torch.isfinite(h.float()).all())
    with pytest.raises(ValueError, match="mode='generate'"):
        model(tokens, mode="generate", **aux)
    if cfg.n_vision_tokens:
        with pytest.raises(ValueError, match="cannot hold"):
            model(tokens[:, :4], mode="train", **aux)
    if arch == "gemma3-1b":
        with torch.inference_mode():
            h, (k, _) = model(torch.zeros((1, 2050), dtype=torch.long),
                              mode="prefill")
        assert h.shape == (1, 2050, cfg.d_model) and k.shape[2] == 2050
        assert bool(torch.isfinite(h.float()).all())

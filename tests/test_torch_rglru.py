"""The port's RG-LRU model (``models/rglru.py``, recurrentgemma-2b) against
the JAX package, on the CPU: the scan, a prefill that carries a state in,
the family checks of ``torch_lm`` (prompts of 40 tokens, past the smoke
config's window of 32), and the reference's serve-loop fault.

The scan is float32 in both packages but associates in another order (the
port: Hillis-Steele doubling; the reference: ``lax.associative_scan``):
within 1e-5 of its scale.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import lm_logits as j_lm_logits
from repro.models.rglru import rg_lru_scan as j_scan
from repro_torch.models import rglru
from torch_lm import (H_TOL, LOGIT_TOL, assert_scaled,
                      check_decode_asks_the_host_nothing,
                      check_decode_logits, check_generate,
                      check_own_consistency, check_prefill_hidden, jf32, pair,
                      ref_prefill_logits, tokens)

SCAN_TOL = 1e-5
ARCH = "recurrentgemma-2b"


def _pair():
    return pair(ARCH, ARCH, prompt=40)


@pytest.mark.parametrize("t", [1, 2, 5, 64, 100, 257])
def test_rg_lru_scan_matches_reference(t):
    rng = np.random.default_rng(t)
    x = rng.normal(size=(2, t, 16)).astype(np.float32)
    a_log = -rng.uniform(0.0, 3.0, size=(2, t, 16)).astype(np.float32)
    gate = rng.uniform(size=(2, t, 16)).astype(np.float32)
    jh, jlast = j_scan(jnp.asarray(x), jnp.asarray(a_log), jnp.asarray(gate))
    h, last = rglru.rg_lru_scan(*map(torch.as_tensor, (x, a_log, gate)))
    assert h.dtype == torch.float32 and h.shape == (2, t, 16)
    assert_scaled(h.numpy(), np.asarray(jh), SCAN_TOL, "h")
    assert torch.equal(last, h[:, -1])


def test_prefill_from_a_carried_state_matches_reference():
    """Two prefills, the second from the first's state (the carry-in fold
    exp(cumsum(log a)) h_prev and the conv buffer), against the
    reference's."""
    pr = _pair()
    toks = tokens(pr.cfg, 2, 20, seed=8)
    _, jst = pr.m.forward(pr.params, jnp.asarray(toks[:, :10], jnp.int32),
                          pr.cfg, mode="prefill")
    jh, _ = pr.m.forward(pr.params, jnp.asarray(toks[:, 10:], jnp.int32),
                         pr.cfg, mode="prefill", state=jst)
    with torch.inference_mode():
        _, st = pr.model(torch.as_tensor(toks[:, :10]), mode="prefill")
        h, _ = pr.model(torch.as_tensor(toks[:, 10:]), mode="prefill",
                        state=st)
    assert_scaled(h.float().numpy(), jf32(jh), H_TOL, "hidden")


def test_prefill_hidden_matches_reference():
    check_prefill_hidden(_pair())


def test_decode_logits_match_reference():
    check_decode_logits(_pair())


def test_port_decode_matches_its_own_prefill():
    check_own_consistency(_pair(), n=40)


def test_generate_matches_reference_serve_loop():
    check_generate(_pair())


def test_decode_loop_asks_the_host_nothing(monkeypatch):
    check_decode_asks_the_host_nothing(_pair(), monkeypatch)


def test_reference_serve_loop_decodes_into_a_cache_with_no_room():
    """The reference's serve loop hands rglru's prefill state straight to
    decode (``launch/serve.py:54-55``): its K/V caches hold only the
    prompt's rows (``rglru_forward`` makes the state with ``init_state(cfg,
    b, t)``), so ``dynamic_update_slice`` clamps every decode write onto
    the last prompt row. recurrentgemma smoke, prompt 8, 2 steps fed the
    next tokens: that loop's logits against one prefill over the same 10
    tokens are ~1e-2 off at a scale of ~1.4; the same loop (eager, as the
    prefill) with the prompt's K/V in a cache of 10 rows is within 1e-6 of
    scale. The port's
    ``serve.prefill`` places them so, and its decode continues its own
    prefill."""
    from repro_torch.launch import serve
    pr = _pair()
    m, cfg = pr.m, pr.cfg
    n = 2
    toks = tokens(cfg, 1, 8 + n, seed=0)
    want = ref_prefill_logits(pr, toks)[:, 8:]
    scale = np.abs(want).max()
    _, st = m.forward(pr.params, jnp.asarray(toks[:, :8], jnp.int32), cfg,
                      mode="prefill")
    assert st["k"].shape[2] == 8                     # no room past the prompt
    init = m.init_state(cfg, 1, 8 + n)
    placed = {**st, "k": init["k"].at[:, :, :8].set(st["k"]),
              "v": init["v"].at[:, :, :8].set(st["v"])}
    errs = {}
    for name, state in (("serve_loop", st), ("max_len", placed)):
        out = []
        for i in range(n):
            h, state = m.decode_step(pr.params,
                                     jnp.asarray(toks[:, 8 + i:9 + i],
                                                 jnp.int32), state, 8 + i,
                                     cfg)
            out.append(np.asarray(j_lm_logits(pr.params, h, cfg))[:, 0])
        logits = np.stack(out, 1)
        errs[name] = np.abs(logits - want).max() / scale
    assert errs["serve_loop"] > 3e-3 and errs["max_len"] < 1e-6, errs
    with torch.inference_mode():
        state = serve.prefill(pr.model, torch.as_tensor(toks[:, :8]), 8 + n)
        assert state["k"].shape[2] == 8 + n
        for i in range(n):
            h, state = pr.model.decode_step(
                torch.as_tensor(toks[:, 8 + i:9 + i]), state, 8 + i)
            assert_scaled(pr.model.logits(h)[:, 0].numpy(), want[:, i],
                          LOGIT_TOL, f"step {i}")

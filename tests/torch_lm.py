"""Shared harness of the port's LM tests: one model of a family built in
both packages from the same parameters (the reference's
``init_params(PRNGKey(0))``, carried across by
``convert.lm_params_from_arrays``), and the four checks every family is
held to on the CPU — prefill hidden, teacher-forced decode logits, the
port's decode against its own prefill, and greedy ``generate`` against the
reference's serve loop.

Tolerance. Everything is bfloat16 with float32 norms and softmax, and the
two frameworks round at different places (XLA fuses elementwise chains
before it rounds; the port's plain decode attention keeps the
probabilities in float32 where the reference rounds them to bf16 before
PV). So agreement is at bf16 level, not float32:
  * prefill hidden (after the final norm): within 2^-5 of its scale
    (max |h|), a few bf16 ulps (2^-8 relative) of the largest entries;
  * logits: within 2 % of their scale (max |logits|) — float32 products of
    the bf16 hidden and the bf16 table, so they carry the hidden's error;
  * the port's own prefill against its own decode: the reference's own
    bound for its consistency test (``tests/test_models.py``: rtol 0.05,
    atol 0.15) is loose next to logits of scale ~1.6, so the same 2 % of
    scale is used;
  * generated ids: identical up to the first step where they differ; there
    the reference's top two logits must be within the logits' tolerance (a
    near tie), after which the two continuations are free to differ.

Where the reference's serve loop departs from its own prefill (ROADMAP
Queue 3), the port is held to the prefill: rglru's decode state gets its
prompt K/V in a cache of ``max_len`` rows on both sides, and qwen2-vl's
decode is held to the reference's prefill over the same tokens
(``Pair.intent``).
"""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.configs import get_config as j_get_config
from repro.models import get_model as j_get_model
from repro.models import lm_logits as j_lm_logits
from repro_torch import convert
from repro_torch.configs import get_config
from repro_torch.launch.serve import generate, prefill, stub_inputs
from repro_torch.models import get_model

H_TOL = 2.0 ** -5       # of max |hidden|
LOGIT_TOL = 0.02        # of max |logits|
GEN = 8


@dataclasses.dataclass
class Pair:
    m: object            # the reference's ModelBundle
    params: dict         # its parameters
    cfg: object          # the (reference) config
    model: object        # the port's module, same parameters, on the CPU
    step: object         # the reference's jitted decode step
    prompt: int          # prompt length of the decode / generate checks
    intent: bool         # decode held to the reference's prefill

    def ref_aux(self, b, s):
        return {k: jnp.ones((b,) + v.shape[1:], v.dtype)
                for k, v in self.m.aux_inputs(b, s).items()}

    def port_aux(self, b, s):
        return stub_inputs(self.model, b, s)


_BUILT: dict = {}


def pair(key, arch, make_cfg=lambda c: c.smoke_config(), prompt: int = 12,
         intent: bool = False) -> Pair:
    """The pair of models ``key`` names (built once per test process; the
    prompt and ``intent`` are the caller's)."""
    if key not in _BUILT:
        cfg = make_cfg(j_get_config(arch))
        tcfg = make_cfg(get_config(arch))
        assert dataclasses.asdict(cfg) == dataclasses.asdict(tcfg)
        m = j_get_model(cfg)
        params = m.init_params(jax.random.PRNGKey(0))
        state = convert.lm_params_from_arrays(
            {k: np.asarray(v) for k, v in params.items()}, tcfg, "cpu")
        model = get_model(tcfg, device="cpu", state=state)
        step = jax.jit(lambda p, t, s, i: m.decode_step(p, t, s, i, cfg))
        _BUILT[key] = Pair(m, params, cfg, model, step, prompt, intent)
    return dataclasses.replace(_BUILT[key], prompt=prompt, intent=intent)


def tokens(cfg, b, n, seed):
    return np.random.default_rng(seed).integers(0, cfg.vocab, (b, n))


def jf32(x):
    return np.asarray(x.astype(jnp.float32))


def assert_scaled(got, want, tol, what):
    scale = np.abs(want).max()
    err = np.abs(got - want).max()
    assert err <= tol * scale, f"{what}: {err:.4g} > {tol} * {scale:.4g}"


def ref_prefill_state(pr: Pair, prompts, max_len):
    """The reference's prefill placed into a decode state as its serve loop
    places it, except that rglru's prompt K/V go into a cache of
    ``max_len`` rows (as the dense family's do)."""
    m, cfg = pr.m, pr.cfg
    b, p = prompts.shape
    _, caches = m.forward(pr.params, prompts, cfg, mode="prefill",
                          **pr.ref_aux(b, p))
    if cfg.family == "rwkv6":
        return caches
    state = m.init_state(cfg, b, max_len)
    if cfg.family in ("dense", "moe"):
        k, v = caches
    else:
        k, v = caches["k"], caches["v"]
        state = {**state, **{n: t for n, t in caches.items()
                             if n not in ("k", "v")}}
    state["k"] = state["k"].at[:, :, :p].set(k)
    state["v"] = state["v"].at[:, :, :p].set(v)
    return state


def ref_prefill_logits(pr: Pair, seq):
    """The reference's float32 logits of one prefill over ``seq``."""
    b, s = seq.shape
    h, _ = pr.m.forward(pr.params, jnp.asarray(seq, jnp.int32), pr.cfg,
                        mode="prefill", **pr.ref_aux(b, s))
    return np.asarray(j_lm_logits(pr.params, h, pr.cfg))


def check_prefill_hidden(pr: Pair, s: int = 40):
    cfg = pr.cfg
    toks = tokens(cfg, 2, s, seed=1)
    jh, _ = pr.m.forward(pr.params, jnp.asarray(toks, jnp.int32), cfg,
                         mode="prefill", **pr.ref_aux(2, s))
    with torch.inference_mode():
        th, _ = pr.model(torch.as_tensor(toks), mode="prefill",
                         **pr.port_aux(2, s))
    assert th.dtype == torch.bfloat16 and th.shape == (2, s, cfg.d_model)
    assert_scaled(th.float().numpy(), jf32(jh), H_TOL, "hidden")


def check_decode_logits(pr: Pair):
    """Prefill a prompt, then 8 decode steps fed the same tokens on both
    sides: the logits of every step, against the reference's decode steps
    (or, with ``intent``, its prefill over the prompt and the fed tokens)."""
    cfg, p = pr.cfg, pr.prompt
    toks = tokens(cfg, 2, p + GEN, seed=2)
    prompts, fed = toks[:, :p], toks[:, p:]
    if pr.intent:
        want = ref_prefill_logits(pr, toks)[:, p:]
    else:
        jstate = ref_prefill_state(pr, jnp.asarray(prompts, jnp.int32),
                                   p + GEN)
        want = []
        for i in range(GEN):
            jh, jstate = pr.step(pr.params,
                                 jnp.asarray(fed[:, i:i + 1], jnp.int32),
                                 jstate, p + i)
            want.append(np.asarray(j_lm_logits(pr.params, jh, cfg))[:, 0])
        want = np.stack(want, 1)
    model = pr.model
    with torch.inference_mode():
        tstate = prefill(model, torch.as_tensor(prompts), p + GEN,
                         pr.port_aux(2, p))
        for i in range(GEN):
            th, tstate = model.decode_step(torch.as_tensor(fed[:, i:i + 1]),
                                           tstate, p + i)
            assert_scaled(model.logits(th)[:, 0].numpy(), want[:, i],
                          LOGIT_TOL, f"step {i} logits")


def check_own_consistency(pr: Pair, model=None, n: int = 8):
    """Token-by-token decode from an empty state against one prefill over
    the same tokens (the reference's consistency test, on the port; no stub
    inputs, but whisper's cross K/V, which decode cannot make, come from a
    prefill of the first token)."""
    model = model or pr.model
    cfg = model.cfg
    toks = torch.as_tensor(tokens(cfg, 1, n, seed=3))
    with torch.inference_mode():
        aux = pr.port_aux(1, n) if cfg.family == "whisper" else {}
        full, _ = model(toks, mode="prefill", **aux)
        want = model.logits(full).numpy()
        state = model.init_state(1, n)
        if cfg.family == "whisper":
            _, caches = model(toks[:, :1], mode="prefill", **aux)
            state["ck"], state["cv"] = caches["ck"], caches["cv"]
        for i in range(n):
            h, state = model.decode_step(toks[:, i:i + 1], state, i)
            assert_scaled(model.logits(h)[:, 0].numpy(), want[:, i],
                          LOGIT_TOL, f"position {i}")


def check_generate(pr: Pair, b: int = 3):
    """``generate`` against the reference's serve loop (prefill, then greedy
    decode from the prompt's last token at position P, argmax of float32
    logits; with ``intent``, each step's logits from a prefill over
    everything fed so far)."""
    cfg, p = pr.cfg, pr.prompt
    prompts = tokens(cfg, b, p, seed=4)
    if not pr.intent:
        state = ref_prefill_state(pr, jnp.asarray(prompts, jnp.int32),
                                  p + GEN)
    tok = prompts[:, -1:]
    seq = prompts
    ids, gaps, scales = [], [], []
    for i in range(GEN):
        seq = np.concatenate([seq, tok], axis=1)
        if pr.intent:
            logits = ref_prefill_logits(pr, seq)[:, -1]
        else:
            h, state = pr.step(pr.params, jnp.asarray(tok, jnp.int32), state,
                               p + i)
            logits = np.asarray(j_lm_logits(pr.params, h, cfg))[:, -1]
        top2 = np.sort(logits, axis=-1)[:, -2:]
        gaps.append(top2[:, 1] - top2[:, 0])
        scales.append(np.abs(logits).max())
        tok = np.argmax(logits, -1)[:, None]
        ids.append(tok[:, 0])
    ids, gaps = np.stack(ids, 1), np.stack(gaps, 1)
    out = generate(pr.model, prompts, GEN)
    assert out.tokens.shape == (b, GEN) and out.logits is None
    for row in range(b):
        diff = np.flatnonzero(out.tokens[row] != ids[row])
        if diff.size:
            first = diff[0]
            assert gaps[row, first] <= LOGIT_TOL * scales[first], (
                row, first, out.tokens[row], ids[row], gaps[row])


def check_decode_asks_the_host_nothing(pr: Pair, monkeypatch, steps=4):
    """While ``serve.decode`` runs, nothing reads a tensor's value on the
    host (on the card each such call would wait for the device) and no
    Python number is written into a tensor (a copy from the host)."""
    from repro_torch.launch import serve
    cfg, p = pr.cfg, pr.prompt
    prompts = torch.as_tensor(tokens(cfg, 2, p, seed=6))
    with torch.inference_mode():
        state = serve.prefill(pr.model, prompts, p + steps, pr.port_aux(2, p))
        setitem = torch.Tensor.__setitem__

        def checked_setitem(self, index, value):
            if isinstance(value, (int, float)):
                raise AssertionError("a Python number written into a tensor")
            return setitem(self, index, value)

        def boom(name):
            def raiser(self, *a, **k):
                raise AssertionError(f"host sync inside the loop: {name}")
            return raiser
        with monkeypatch.context() as mp:
            for name in ("item", "tolist", "__bool__", "__float__", "__int__",
                         "cpu", "numpy", "__index__"):
                mp.setattr(torch.Tensor, name, boom(name))
            mp.setattr(torch.Tensor, "__setitem__", checked_setitem)
            ids = serve.decode(pr.model, state, prompts[:, -1:], p, steps)
    assert ids.shape == (2, steps)

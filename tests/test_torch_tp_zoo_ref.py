"""The port's "model" axis across the zoo against the JAX package's train
step on the same mesh: one subprocess with 2 host devices runs the
reference's ``build_train_step`` (GSPMD partitions it) at (data=1,
model=2) under 'tp' on 3-head variants of the smoke configs of gemma3-1b,
recurrentgemma and whisper (3 heads on 2: the rules' head_dim fallback;
recurrentgemma's LRU columns and whisper's MLP over "model" too), and
under 'tp_sp' on qwen3-moe's smoke config with 3 experts of a d_ff of 129
(neither divides 2: whole experts on every rank, the layer on the whole
token set; at the config's capacity factor and at 1.0, where slots are
dropped), one step each from its ``init_params(PRNGKey(0))`` cast to
float32; a world of two gloo ranks runs the port's step on the same
parameters, tokens and frames (``tests/torch_train_tp.py::ref_cases``).

Tolerances as ``test_torch_train_tp_ref.py``'s: the loss 1e-5 relative,
the gradient norm 2e-4 relative, the updated parameters within 2 lr of the
reference's and at least 95 % of them within lr / 100 (a share of all of a
case's parameters, not of each leaf: the reference rounds recurrentgemma's
and whisper's projections to bf16 whatever the parameters' dtype, so a
gradient within that rounding of zero may flip its sign and AdamW's first
step, and in a norm's 64 weights each flip is 1.6 % of the leaf). The
MoE cases' gradient norm within 2e-3 relative, ``test_torch_train_step.py``'s
limit for a step whose products the reference rounds to bf16: its expert
products do so whatever the parameters' dtype (``preferred_element_type``
bf16 in ``moe_mlp``) and the port's take the parameters' float32, so
already the two worlds of one part by 2.6e-4 on this batch (at capacity
1.25; the port's (1, 2) 'tp_sp' lies 5.7e-5 from its world of one,
``test_torch_moe_tp_sp.py`` holds that at 1e-6).
"""
import concurrent.futures
import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.configs import get_config as j_get_config
from repro.models import get_model as j_get_model

from conftest import run_multidev

import torch_spmd
import torch_train_tp as T

CASES = ("gemma3-1b/h3", "recurrentgemma-2b/h3", "whisper-small/h3",
         *T.MOE_WHOLE)
STRATEGY = {case: "tp_sp" if case in T.MOE_WHOLE else "tp"
            for case in CASES}
LR = 3e-4
LOSS_RTOL, NORM_RTOL, MOE_NORM_RTOL = 1e-5, 2e-4, 2e-3
NEAR, NEAR_SHARE = LR / 100, 0.95

REFERENCE = r'''
import sys, dataclasses
import numpy as np, jax, jax.numpy as jnp
from repro.compat import make_mesh
from repro.configs import get_config
from repro.configs.base import ShapeSpec
from repro.data import SyntheticLMData
from repro.launch.steps import build_train_step, TrainStepConfig
from repro.models import get_model
from repro.optim import adamw_init

out_path, cases, seq, batch, groups = sys.argv[1:6]
seq, batch, groups = int(seq), int(batch), int(groups)
mesh = make_mesh((1, 2), ('data', 'model'))
out = {}
for case in cases.split(','):
    arch, _, variant = case.partition('/')
    cfg = get_config(arch).smoke_config()
    strategy = 'tp'
    if variant == 'h3':
        cfg = dataclasses.replace(cfg, n_heads=3, n_kv_heads=1)
    elif variant in ('whole', 'whole_cf1'):
        cfg = dataclasses.replace(cfg, n_experts=3, d_ff=129)
        if variant == 'whole_cf1':
            cfg = dataclasses.replace(cfg, capacity_factor=1.0)
        strategy = 'tp_sp'
    shape = ShapeSpec('r', seq, batch, 'train')
    params = jax.tree.map(lambda a: a.astype(jnp.float32),
                          get_model(cfg).init_params(jax.random.PRNGKey(0)))
    opt = adamw_init(params)
    b = SyntheticLMData(cfg.vocab, seq, batch, seed=1).batch_np(0)
    tok, lab = jnp.asarray(b[:, :-1]), jnp.asarray(b[:, 1:])
    aux = {}
    if cfg.family == 'whisper':
        a = np.random.default_rng(2).normal(
            size=(batch, cfg.n_audio_frames, cfg.d_model))
        aux = {'frames': jnp.asarray(a.astype(np.float32))}
    fn, sh, _ = build_train_step(cfg, mesh, shape,
                                 TrainStepConfig(strategy=strategy,
                                                 moe_groups=groups))
    step = jax.jit(fn, in_shardings=(sh['params'], sh['opt_state'],
                                     sh['tokens'], sh['labels'], sh['aux']))
    p, _, m = step(params, opt, tok, lab, aux)
    out[case + '|loss'] = np.asarray(m['loss'])
    out[case + '|grad_norm'] = np.asarray(m['grad_norm'])
    out.update({case + '|tp/' + k: np.asarray(v) for k, v in p.items()})
np.savez(out_path, **out)
print('ok')
'''


def _init(case: str) -> dict:
    """The reference's ``init_params(PRNGKey(0))`` of ``case`` in float32,
    as numpy (the subprocess draws the same)."""
    arch, _, variant = case.partition("/")
    cfg = j_get_config(arch).smoke_config()
    if variant == "h3":
        cfg = dataclasses.replace(cfg, n_heads=3, n_kv_heads=1)
    elif variant.startswith("whole"):
        cfg = dataclasses.replace(cfg, n_experts=3, d_ff=129)
    params = j_get_model(cfg).init_params(jax.random.PRNGKey(0))
    return {k: np.asarray(v.astype(jnp.float32)) for k, v in params.items()}


@pytest.fixture(scope="module")
def both(tmp_path_factory):
    """The reference's subprocess and the port's worlds, at once."""
    tmp = tmp_path_factory.mktemp("tp_zoo_ref")
    path = os.path.join(str(tmp), "ref.npz")
    code = ("import sys; sys.argv = ['ref', %r, %r, '%d', '%d', '%d']\n"
            % (path, ",".join(CASES), T.SEQ, T.BATCH, T.MOE_GROUPS)
            ) + REFERENCE
    with concurrent.futures.ThreadPoolExecutor(len(CASES) + 1) as ex:
        ref = ex.submit(run_multidev, code, 2, timeout=300)
        port = {}
        for i, case in enumerate(CASES):
            (tmp / f"w{i}").mkdir()
            port[case] = ex.submit(torch_spmd.run_world, T.ref_cases, 2,
                                   tmp / f"w{i}", _init(case),
                                   (STRATEGY[case],), case)
        ref.result(timeout=330)
        port = {c: f.result(timeout=torch_spmd.TIMEOUT_S + 30)
                for c, f in port.items()}
    with np.load(path) as z:
        return {k: z[k] for k in z.files}, port


@pytest.mark.parametrize("case", CASES)
def test_loss_and_grad_norm_match_reference(both, case):
    ref, port = both
    loss, norm = (float(ref[f"{case}|{k}"]) for k in ("loss", "grad_norm"))
    norm_rtol = MOE_NORM_RTOL if case in T.MOE_WHOLE else NORM_RTOL
    for r in port[case]:
        got = r[STRATEGY[case]]
        assert abs(got["loss"] - loss) <= LOSS_RTOL * loss, (got, loss)
        assert abs(got["grad_norm"] - norm) <= norm_rtol * norm, (got, norm)


@pytest.mark.parametrize("case", CASES)
def test_updated_params_match_reference(both, case):
    ref, port = both
    for r in port[case]:
        near = total = 0
        for k, got in r[STRATEGY[case]]["params"].items():
            want = ref[f"{case}|tp/{k}"]
            d = np.abs(got - want)
            assert d.max() <= 2 * LR * (1 + 1e-3), (k, d.max())
            near += int((d <= NEAR).sum())
            total += d.size
        assert near / total >= NEAR_SHARE, near / total

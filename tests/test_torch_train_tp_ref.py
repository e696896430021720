"""The port's "model" axis against the JAX package's train step on the same
mesh: one subprocess with 2 host devices runs the reference's
``build_train_step`` on granite-3-8b's smoke config at (data=1, model=2)
under 'tp', 'tp_sp' and 'fsdp' (GSPMD partitions it; no "pod" axis, the
mesh its partitioner is not known to fail on, ROADMAP.md Queue 3), one step
each from its ``init_params(PRNGKey(0))`` cast to float32; a world of two
gloo ranks runs the port's step on the same parameters and tokens
(``tests/torch_train_tp.py::ref_cases``).

Tolerances (float32 parameters; both LM heads round the hidden state to
bf16, the reference's ``hc.astype(bf16)``, and their backwards the
gradient, a rounding that float32 sums in other orders move): the loss
1e-5 relative and the gradient norm 2e-4 relative (the reference's own
'tp' and 'fsdp' steps part by 5.4e-6 and 7.8e-5 on this batch); the
updated parameters within 2 lr of the reference's and at least 95 % of
each leaf within lr / 100, as ``test_torch_train_step.py`` holds the
world of one (AdamW's first step moves every weight by about +-lr whatever
its gradient's size, so where a gradient lies within rounding of zero its
sign, and the step, may flip; 2 lr is the most a flip can do).
"""
import os

import numpy as np
import pytest

from conftest import run_multidev

import torch_spmd
import torch_train_tp as T

STRATEGIES = ("tp", "tp_sp", "fsdp")
LR = 3e-4
LOSS_RTOL, NORM_RTOL = 1e-5, 2e-4
NEAR, NEAR_SHARE = LR / 100, 0.95

REFERENCE = r'''
import sys
import numpy as np, jax, jax.numpy as jnp
from repro.compat import make_mesh
from repro.configs import get_config
from repro.configs.base import ShapeSpec
from repro.data import SyntheticLMData
from repro.launch.steps import build_train_step, TrainStepConfig
from repro.models import get_model
from repro.optim import adamw_init

out_path, arch, seq, batch, groups = sys.argv[1:6]
seq, batch, groups = int(seq), int(batch), int(groups)
cfg = get_config(arch).smoke_config()
shape = ShapeSpec('r', seq, batch, 'train')
mesh = make_mesh((1, 2), ('data', 'model'))
params = jax.tree.map(lambda a: a.astype(jnp.float32),
                      get_model(cfg).init_params(jax.random.PRNGKey(0)))
opt = adamw_init(params)
b = SyntheticLMData(cfg.vocab, seq, batch, seed=1).batch_np(0)
tok, lab = jnp.asarray(b[:, :-1]), jnp.asarray(b[:, 1:])
out = {'init/' + k: np.asarray(v) for k, v in params.items()}
for strategy in ('tp', 'tp_sp', 'fsdp'):
    fn, sh, _ = build_train_step(cfg, mesh, shape,
                                 TrainStepConfig(strategy=strategy,
                                                 moe_groups=groups))
    step = jax.jit(fn, in_shardings=(sh['params'], sh['opt_state'],
                                     sh['tokens'], sh['labels'], sh['aux']))
    p, _, m = step(params, opt, tok, lab, {})
    out[strategy + '|loss'] = np.asarray(m['loss'])
    out[strategy + '|grad_norm'] = np.asarray(m['grad_norm'])
    out.update({strategy + '/' + k: np.asarray(v) for k, v in p.items()})
np.savez(out_path, **out)
print('ok')
'''


@pytest.fixture(scope="module")
def both(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("tp_ref")
    path = os.path.join(str(tmp), "ref.npz")
    code = ("import sys; sys.argv = ['ref', %r, %r, '%d', '%d', '%d']\n"
            % (path, T.REF_ARCH, T.SEQ, T.BATCH, T.MOE_GROUPS)) + REFERENCE
    run_multidev(code, 2, timeout=300)
    with np.load(path) as z:
        ref = {k: z[k] for k in z.files}
    init = {k[len("init/"):]: v for k, v in ref.items()
            if k.startswith("init/")}
    (tmp / "w").mkdir()
    port = torch_spmd.run_world(T.ref_cases, 2, tmp / "w", init, STRATEGIES)
    return ref, port


@pytest.mark.parametrize("strategy", STRATEGIES)
def test_loss_and_grad_norm_match_reference(both, strategy):
    ref, port = both
    for r in port:
        got = r[strategy]
        loss, norm = (float(ref[f"{strategy}|{k}"])
                      for k in ("loss", "grad_norm"))
        assert abs(got["loss"] - loss) <= LOSS_RTOL * loss, (got, loss)
        assert abs(got["grad_norm"] - norm) <= NORM_RTOL * norm, (got, norm)


@pytest.mark.parametrize("strategy", STRATEGIES)
def test_updated_params_match_reference(both, strategy):
    ref, port = both
    for r in port:
        for k, got in r[strategy]["params"].items():
            want = ref[f"{strategy}/{k}"]
            d = np.abs(got - want)
            assert d.max() <= 2 * LR * (1 + 1e-3), (k, d.max())
            assert np.mean(d <= NEAR) >= NEAR_SHARE, (k, np.mean(d <= NEAR))

"""The port's LM training step (``repro_torch.launch.steps``) and loss
(``models.model_api.chunked_xent_loss``) against the JAX package's, on
granite-3-8b's smoke config: the same parameters and AdamW state (the
reference's ``init_params(PRNGKey(0))`` and ``adamw_init``, carried across
by ``convert.train_state_from_arrays``) and the same tokens.

Tolerances (bf16 parameters and gradients, float32 state and sums):
  * the loss: 1e-5 relative (float32 sums in another order);
  * ``chunked_xent_loss``'s gradients (bf16): within 2^-7 of their largest
    magnitude, a bf16 ulp or two of the largest entries;
  * one train step: ``grad_norm`` and ``clip`` 2e-3 relative. The
    gradients are bf16, summed in bf16 where a weight is used many times
    (the tied embedding's rows), so their rounding depends on the order of
    the sums: the reference's own ``grad_norm`` moves by 3.7e-4 on this
    batch between microbatches 1 and 2, and the port's lies 5.6e-4 from
    it at microbatches 1 (2e-5 at 2). Each leaf's first
    moment m (0.1 x the clipped float32 gradient) within 2^-6 of its
    largest magnitude; master weights within 2 lr of the reference's, and
    at least 95 % of each leaf within lr / 100. AdamW's first step moves
    every weight by about +-lr whatever its gradient's size, so where a
    gradient element lies within rounding of zero its sign, and the step,
    may flip: 2 lr is the most a flip can do. bf16 parameters: 2 lr plus
    a bf16 ulp;
  * an 8-step loss trajectory: within 1e-3 of the reference's at every
    step (1.3e-4 seen).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.configs.base import ShapeSpec as JShape
from repro.data import SyntheticLMData as JData
from repro.launch.mesh import make_host_mesh as j_make_host_mesh
from repro.launch.steps import TrainStepConfig as JTrainStepConfig
from repro.launch.steps import build_train_step as j_build_train_step
from repro.models import chunked_xent_loss as j_chunked_xent_loss
from repro.models import get_model as j_get_model
from repro.optim import adamw_init as j_adamw_init
from repro_torch import convert
from repro_torch.configs import ShapeSpec, get_config
from repro_torch.launch.mesh import GridMesh, make_host_mesh
from repro_torch.launch.steps import TrainStepConfig, build_train_step
from repro_torch.models import chunked_xent_loss

ARCH = "granite-3-8b"
SEQ, BATCH = 32, 4
LR = 3e-4
LOSS_RTOL = 1e-5
NORM_RTOL = 2e-3
GRAD_TOL = 2.0 ** -7
M_TOL = 2.0 ** -6
MASTER_NEAR, MASTER_NEAR_SHARE = LR / 100, 0.95
TRAJ_TOL = 1e-3


def _np(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.fixture(scope="module")
def ref():
    """The reference's smoke model, its initial parameters and AdamW state
    (numpy), and its data."""
    cfg = j_get_config(ARCH).smoke_config()
    params = j_get_model(cfg).init_params(jax.random.PRNGKey(0))
    return {"cfg": cfg, "params": params, "opt": j_adamw_init(params),
            "data": JData(cfg.vocab, SEQ, BATCH, seed=0)}


_STEPS: dict = {}


def _ref_step(ref, mb):
    if mb not in _STEPS:
        fn, _, _ = j_build_train_step(
            ref["cfg"], j_make_host_mesh(model=1),
            JShape("t", SEQ, BATCH, "train"),
            JTrainStepConfig(microbatches=mb, moe_groups=1))
        _STEPS[mb] = jax.jit(fn)
    return _STEPS[mb]


def _port(ref, mb, **kw):
    cfg = get_config(ARCH).smoke_config()
    step = build_train_step(cfg, make_host_mesh(model=1, device="cpu"),
                            ShapeSpec("t", SEQ, BATCH, "train"),
                            TrainStepConfig(microbatches=mb, **kw))
    params, opt = convert.train_state_from_arrays(_np(ref["params"]),
                                                  _np(ref["opt"]))
    return step, params, step.shard_opt_state(opt)


def _batch(ref, i):
    b = ref["data"].batch_np(i)
    return b[:, :-1], b[:, 1:]


def _t(a):
    return torch.from_numpy(np.array(a, copy=True, order="C"))


def _rel(a, b):
    return abs(a - b) / abs(b)


# -- the loss -------------------------------------------------------------------

def test_chunked_xent_loss_value_and_gradients_match_reference():
    """Several chunks, a padded vocab (500 of 512) and a label mask."""
    cfg_j = dataclasses.replace(j_get_config(ARCH).smoke_config(), vocab=500)
    cfg_t = dataclasses.replace(get_config(ARCH).smoke_config(), vocab=500)
    assert cfg_t.vocab_padded == 512
    rng = np.random.default_rng(0)
    b, s, d = 2, 32, cfg_t.d_model
    hidden = rng.normal(size=(b, s, d)).astype(np.float32)
    table = (0.05 * rng.normal(size=(512, d))).astype(np.float32)
    labels = rng.integers(0, 500, size=(b, s)).astype(np.int32)
    mask = (rng.random((b, s)) < 0.8).astype(np.float32)

    def j_loss(h, tab):
        return j_chunked_xent_loss({"embed/table": tab}, h, labels, cfg_j,
                                   chunk=8, label_mask=mask)

    jh, jtab = (jnp.asarray(hidden, jnp.bfloat16),
                jnp.asarray(table, jnp.bfloat16))
    want, (gh_j, gt_j) = jax.value_and_grad(j_loss, argnums=(0, 1))(jh, jtab)
    th = _t(np.asarray(jh.astype(jnp.float32))).to(torch.bfloat16)
    tt = _t(np.asarray(jtab.astype(jnp.float32))).to(torch.bfloat16)
    th.requires_grad_(True)
    tt.requires_grad_(True)
    saved = []
    with torch.autograd.graph.saved_tensors_hooks(
            lambda x: saved.append(tuple(x.shape)) or x, lambda x: x):
        got = chunked_xent_loss({"embed/table": tt}, th, _t(labels), cfg_t,
                                chunk=8, label_mask=_t(mask))
    # no chunk's (B, chunk, V) logits are kept for backward: recomputed
    assert not [sh for sh in saved if len(sh) == 3 and sh[-1] == 512], saved
    got.backward()
    assert _rel(float(got.detach()), float(want)) < LOSS_RTOL
    for g_t, g_j in ((th.grad, gh_j), (tt.grad, gt_j)):
        g_j = np.asarray(g_j.astype(jnp.float32))
        assert g_t.dtype == torch.bfloat16
        err = np.abs(g_t.float().numpy() - g_j).max()
        assert err <= GRAD_TOL * np.abs(g_j).max(), err
    # the padded vocab takes no gradient
    assert not tt.grad[500:].any()


# -- one step -------------------------------------------------------------------

@pytest.mark.parametrize("mb", [1, 2])
def test_one_train_step_matches_reference(ref, mb):
    tok, lab = _batch(ref, 0)
    p_j, o_j, m_j = _ref_step(ref, mb)(ref["params"], ref["opt"],
                                       jnp.asarray(tok), jnp.asarray(lab), {})
    step, params, opt = _port(ref, mb)
    p_t, o_t, m_t = step(params, opt, _t(tok), _t(lab))
    assert _rel(float(m_t["loss"]), float(m_j["loss"])) < LOSS_RTOL
    assert _rel(float(m_t["grad_norm"]), float(m_j["grad_norm"])) < NORM_RTOL
    assert _rel(float(m_t["clip"]), float(m_j["clip"])) < NORM_RTOL
    assert float(m_t["quant_noise"]) == 0.0
    assert int(o_t["step"]) == int(o_j["step"]) == 1
    for k in sorted(ref["params"]):
        m_want = np.asarray(o_j["m"][k])
        m_err = np.abs(o_t["m"][k].numpy() - m_want).max()
        assert m_err <= M_TOL * np.abs(m_want).max(), (k, m_err)
        d = np.abs(o_t["master"][k].numpy() - np.asarray(o_j["master"][k]))
        assert d.max() <= 2 * LR * (1 + 1e-3), (k, d.max())
        assert np.mean(d <= MASTER_NEAR) >= MASTER_NEAR_SHARE, k
        assert p_t[k].dtype == torch.bfloat16
        want = np.asarray(p_j[k].astype(jnp.float32))
        dp = np.abs(p_t[k].float().numpy() - want)
        assert np.all(dp <= 2 * LR * (1 + 1e-3) + 2.0 ** -7 * np.abs(want)), k


def test_loss_trajectory_tracks_reference(ref):
    step_j = _ref_step(ref, 2)
    step, params, opt = _port(ref, 2)
    p_j, o_j = ref["params"], ref["opt"]
    got, want = [], []
    for i in range(8):
        tok, lab = _batch(ref, i)
        p_j, o_j, m_j = step_j(p_j, o_j, jnp.asarray(tok), jnp.asarray(lab),
                               {})
        params, opt, m_t = step(params, opt, _t(tok), _t(lab))
        want.append(float(m_j["loss"]))
        got.append(float(m_t["loss"]))
    np.testing.assert_allclose(got, want, rtol=0, atol=TRAJ_TOL)
    assert got[-1] < got[0]


def test_remat_changes_no_bit(ref):
    """Each layer recomputed in backward (``remat``) gives the bits of the
    forward kept whole."""
    tok, lab = _batch(ref, 1)
    outs = []
    for remat in (True, False):
        step, params, opt = _port(ref, 2, remat=remat)
        outs.append(step(params, opt, _t(tok), _t(lab)))
    (p1, o1, m1), (p2, o2, m2) = outs
    for k in p1:
        assert torch.equal(p1[k], p2[k]) and torch.equal(o1["m"][k],
                                                         o2["m"][k]), k
    assert torch.equal(m1["loss"], m2["loss"])


def test_train_step_reads_nothing_on_the_host(ref, monkeypatch):
    """No ``item``/``tolist``/``float``/... of a tensor while the step runs
    (on the card each would wait for the device)."""
    step, params, opt = _port(ref, 2)
    tok, lab = _batch(ref, 2)

    def boom(name):
        def raiser(self, *a, **k):
            raise AssertionError(f"host read inside the train step: {name}")
        return raiser
    with monkeypatch.context() as mp:
        for name in ("item", "tolist", "__bool__", "__float__", "__int__",
                     "cpu", "numpy", "__index__"):
            mp.setattr(torch.Tensor, name, boom(name))
        _, _, m = step(params, opt, _t(tok), _t(lab))
    assert np.isfinite(float(m["loss"]))


# -- what is not ported ------------------------------------------------------------

def _fake_mesh(shape):
    return GridMesh(shape=shape, coords={a: 0 for a in shape}, rank=0,
                    device=torch.device("cpu"), meshes={})


@pytest.mark.parametrize("shape,strategy", [({"data": 1, "model": 2}, "tp"),
                                            ({"data": 1, "model": 1},
                                             "fsdp"),
                                            ({"data": 1, "model": 1},
                                             "tp_sp")])
def test_tensor_parallel_and_other_strategies_raise(shape, strategy):
    cfg = get_config(ARCH).smoke_config()
    with pytest.raises(NotImplementedError, match=r"8\(h\)"):
        build_train_step(cfg, _fake_mesh(shape), ShapeSpec("t", 8, 2,
                                                           "train"),
                         TrainStepConfig(strategy=strategy))


def test_k4_refuses_rows_past_its_index_limit():
    """K4's wrappers index a row in 32-bit ints: a leaf's chunk past
    ``INDEX_LIMIT`` is refused with a clear error, never split. gemma3-1b's
    and granite-3-8b's largest gradient leaves (a world of one's chunk is
    the whole leaf) fit."""
    from repro_torch.kernels.quantize import quantize as kq
    for arch in ("gemma3-1b", "granite-3-8b"):
        step = build_train_step(get_config(arch),
                                make_host_mesh(model=1, device="cpu"),
                                ShapeSpec("t", 8, 1, "train"))
        largest = max(int(np.prod(s)) for s in step.param_shapes.values())
        kq._check_index("leaf", largest)
    with pytest.raises(ValueError, match="index limit"):
        kq._check_index("leaf", kq.INDEX_LIMIT + 1)

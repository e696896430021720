"""Shared harness of the train-zoo parity tests (``test_torch_train_zoo.py``,
``test_torch_train_zoo_rec.py``): one training loss and its gradients on a
family's smoke config, in both packages, from the same parameters (the
reference's ``init_params(PRNGKey(0))``, carried across by
``convert.train_state_from_arrays``), the same tokens and the same stub
inputs (frames, vision embeddings: bf16 made from a numpy seed).

The reference's side is its own loss function (``launch/steps.py:104-107``:
``model.forward(mode="train", remat=True, n_groups=moe_groups, **aux)`` and
``chunked_xent_loss``) under ``jax.value_and_grad``, run op by op
(``jax.disable_jit()``): each operation rounds to bf16 where the source
says so. Under ``jax.jit`` XLA fuses elementwise chains and rounds at other
places, and its gradients part from its own op-by-op ones by up to 0.12 of
a leaf's largest magnitude (mixtral's expert weights: a near-tie routing
decision flips) and 2e-5 in the loss; the port's part from the op-by-op
ones by the same amounts, so the op-by-op run is the one to hold it to.

Tolerances against it:
  * the loss: 1e-5 relative (seen: equal bits, or 8e-8 for qwen3-moe);
  * each gradient leaf: within 2^-5 of its largest magnitude and 2^-6 of
    its norm. Most leaves agree within 2^-7 of their largest magnitude
    (``test_torch_train_step.py``'s bound); the leaves that collect a
    gradient from every token through a chain of elementwise bf16 products
    (rwkv6's token-shift mixes, recurrentgemma's conv weights and biases)
    reach 0.023 of it (2.3e-2 max, 1.1e-2 of the norm), since the two
    frameworks sum the bf16 contributions in another order.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.configs import get_config as j_get_config
from repro.data import SyntheticLMData as JData
from repro.models import chunked_xent_loss as j_chunked_xent_loss
from repro.models import get_model as j_get_model
from repro_torch import convert
from repro_torch.configs import get_config
from repro_torch.launch.steps import loss_fn

SEQ, BATCH, MOE_GROUPS = 48, 2, 2
LOSS_RTOL = 1e-5
GRAD_MAX_TOL = 2.0 ** -5      # of the leaf's largest magnitude
GRAD_NORM_TOL = 2.0 ** -6     # of the leaf's norm


def aux_arrays(m, seed: int = 1) -> dict:
    """The stub inputs of ``aux_inputs`` (B, n, D) as bf16 jnp arrays from
    a numpy seed."""
    rng = np.random.default_rng(seed)
    return {k: jnp.asarray(rng.normal(size=v.shape).astype(np.float32),
                           jnp.bfloat16)
            for k, v in m.aux_inputs(BATCH, SEQ).items()}


def to_torch(a) -> torch.Tensor:
    """A jnp array as a tensor, bf16 by its value (exact)."""
    if a.dtype == jnp.bfloat16:
        return torch.from_numpy(np.asarray(a.astype(jnp.float32))).to(
            torch.bfloat16)
    return torch.from_numpy(np.array(a, copy=True))


def parity(arch: str) -> dict:
    """Loss and gradients of the smoke config of ``arch`` in both
    packages. Returns {"loss": (port, reference), "grads": {path: (port,
    reference) float32 numpy}}."""
    jcfg = j_get_config(arch).smoke_config()
    cfg = get_config(arch).smoke_config()
    m = j_get_model(jcfg)
    params = m.init_params(jax.random.PRNGKey(0))
    batch = JData(jcfg.vocab, SEQ, BATCH, seed=0).batch_np(0)
    tok, lab = batch[:, :-1], batch[:, 1:]
    aux = aux_arrays(m)

    def j_loss(p):
        hidden, _ = m.forward(p, jnp.asarray(tok), jcfg, mode="train",
                              remat=True, n_groups=MOE_GROUPS, **aux)
        return j_chunked_xent_loss(p, hidden, jnp.asarray(lab), jcfg)

    with jax.disable_jit():
        want, grads_j = jax.value_and_grad(j_loss)(params)
    p_t, _ = convert.train_state_from_arrays(jax.tree.map(np.asarray, params))
    keys = sorted(p_t)
    leaves = [p_t[k].requires_grad_(True) for k in keys]
    got = loss_fn(dict(zip(keys, leaves)),
                  torch.from_numpy(np.ascontiguousarray(tok)),
                  torch.from_numpy(np.ascontiguousarray(lab)), cfg,
                  remat=True, n_groups=MOE_GROUPS,
                  aux={k: to_torch(v) for k, v in aux.items()})
    grads_t = torch.autograd.grad(got, leaves)
    return {"loss": (float(got.detach()), float(want)),
            "dtypes": {k: g.dtype for k, g in zip(keys, grads_t)},
            "grads": {k: (g.float().numpy(),
                          np.asarray(grads_j[k].astype(jnp.float32)))
                      for k, g in zip(keys, grads_t)}}


def check_parity(arch: str) -> None:
    out = parity(arch)
    got, want = out["loss"]
    assert abs(got - want) <= LOSS_RTOL * abs(want), (arch, got, want)
    for k, (g, w) in out["grads"].items():
        assert out["dtypes"][k] == torch.bfloat16, k
        assert g.shape == w.shape, k
        d = g - w
        assert np.abs(d).max() <= GRAD_MAX_TOL * np.abs(w).max(), \
            (arch, k, np.abs(d).max(), np.abs(w).max())
        assert np.linalg.norm(d) <= GRAD_NORM_TOL * np.linalg.norm(w), \
            (arch, k, np.linalg.norm(d), np.linalg.norm(w))

"""The port's MoE layer (``models/moe.py``) and the two MoE configs
(qwen3-moe-30b-a3b: 128 experts top-8 at full size, mixtral-8x7b: 8 top-2
with sliding-window attention) against the JAX package, on the CPU.

Dispatch is integer work: ``dest`` and ``keep`` are held exactly. The
layer's output is bf16 products summed in another order: within 2^-5 of
its scale. The families are held by ``torch_lm``'s checks. qwen3-moe's own
prefill drops routed slots past the capacity (1.25) where its decode,
one token a group, drops none, so its decode is held against its prefill
on a copy of the config with ``capacity_factor = E/k`` (no slot can drop),
as the reference's own consistency test leaves it out.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models.moe import _dispatch_group as j_dispatch
from repro.models.moe import moe_mlp as j_moe_mlp
from repro_torch.configs import get_config
from repro_torch.models import moe
from repro_torch.models.layers import rms_norm
from repro_torch.models.transformer import _attention_flagged, _ropes_for
from torch_lm import (check_decode_asks_the_host_nothing,
                      check_decode_logits, check_generate,
                      check_own_consistency, check_prefill_hidden, pair,
                      tokens)

MOE_TOL = 2.0 ** -5      # moe_mlp, of max |y|
ARCHS = ["qwen3-moe-30b-a3b", "mixtral-8x7b"]


def _no_drop(cfg):
    return dataclasses.replace(cfg, capacity_factor=cfg.n_experts / cfg.top_k)


def _record_drops(monkeypatch) -> list:
    """Each later MoE layer's (dropped, routed) slot counts, read off its
    dispatch's ``keep``."""
    drops = []
    dispatch = moe._dispatch_group

    def recording(*args):
        buf, dest, keep = dispatch(*args)
        drops.append(((~keep).sum(), keep.numel()))
        return buf, dest, keep

    monkeypatch.setattr(moe, "_dispatch_group", recording)
    return drops


def _bf16(a):
    """A bf16 jax array and the tensor of the same bits."""
    j = jnp.asarray(a, jnp.bfloat16)
    return j, torch.from_numpy(np.array(j.view(jnp.int16))).view(torch.bfloat16)


@pytest.mark.parametrize("t,k,e,cap", [(12, 2, 4, 3), (12, 2, 4, 6),
                                       (40, 8, 16, 5), (7, 3, 5, 1),
                                       (24, 2, 4, 1000)])
def test_dispatch_group_matches_reference(t, k, e, cap):
    """dest and keep exactly, and the buffer's kept rows bit for bit (the
    dummy row, written by every dropped slot, is not compared). Routing
    with repeated experts, so that capacity bites."""
    rng = np.random.default_rng(t * k + e)
    e_idx = np.stack([rng.choice(e, k, replace=False) for _ in range(t)])
    x = rng.normal(size=(t, 16)).astype(np.float32)
    jbuf, jdest, jkeep = j_dispatch(jnp.asarray(x), jnp.asarray(e_idx), cap, e)
    buf, dest, keep = moe._dispatch_group(torch.as_tensor(x),
                                          torch.as_tensor(e_idx), cap, e)
    np.testing.assert_array_equal(dest.numpy(), np.asarray(jdest))
    np.testing.assert_array_equal(keep.numpy(), np.asarray(jkeep))
    np.testing.assert_array_equal(buf[:-1].numpy(), np.asarray(jbuf)[:-1])
    assert (cap >= t * k) == bool(keep.all())


def test_dispatch_takes_groups_as_a_leading_axis():
    rng = np.random.default_rng(0)
    e_idx = torch.as_tensor(np.stack([[rng.choice(6, 2, replace=False)
                                       for _ in range(9)] for _ in range(3)]))
    x = torch.as_tensor(rng.normal(size=(3, 9, 8)).astype(np.float32))
    buf, dest, keep = moe._dispatch_group(x, e_idx, 2, 6)
    for g in range(3):
        b1, d1, k1 = moe._dispatch_group(x[g], e_idx[g], 2, 6)
        assert torch.equal(d1, dest[g]) and torch.equal(k1, keep[g])
        assert torch.equal(b1[:-1], buf[g, :-1])


def test_router_ties_take_the_lower_expert():
    """``lax.top_k`` takes the lower index of a tie; so must the port (a
    stable sort), whatever ``torch.topk`` would do."""
    router = torch.zeros((4, 6), dtype=torch.bfloat16)   # every prob equal
    gates, e_idx = moe.route(torch.ones((2, 3, 4), dtype=torch.bfloat16),
                             router, 3)
    assert e_idx.tolist() == [[[0, 1, 2]] * 3] * 2
    np.testing.assert_allclose(gates.numpy(), 1 / 3, rtol=1e-6)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("cf", [1.25, 0.5, None], ids=["cf1.25", "cf0.5",
                                                      "no_drop"])
@pytest.mark.parametrize("b,s", [(2, 24), (3, 1)], ids=["prefill", "decode"])
def test_moe_mlp_matches_reference(arch, cf, b, s, monkeypatch):
    cfg = get_config(arch).smoke_config()
    cfg = _no_drop(cfg) if cf is None else dataclasses.replace(
        cfg, capacity_factor=cf)
    d, e, f = cfg.d_model, cfg.n_experts, cfg.d_ff
    rng = np.random.default_rng(b * s)
    arrays = [rng.normal(size=shape) * std for shape, std in (
        ((b, s, d), 1.0), ((d, e), 0.3), ((e, d, f), 0.1), ((e, d, f), 0.1),
        ((e, f, d), 0.1))]
    pairs = [_bf16(a) for a in arrays]
    want = j_moe_mlp(*[p[0] for p in pairs], cfg, 16)
    drops = _record_drops(monkeypatch)
    got = moe.moe_mlp(*[p[1] for p in pairs], cfg, 16)
    want = np.asarray(want.astype(jnp.float32))
    err = np.abs(got.float().numpy() - want).max()
    assert got.shape == (b, s, d) and err <= MOE_TOL * np.abs(want).max()
    (dropped, routed), = drops
    assert routed == b * s * cfg.top_k
    if cf is None or s == 1:
        assert int(dropped) == 0


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_hidden_matches_reference(arch):
    check_prefill_hidden(pair(arch, arch))


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_logits_match_reference(arch):
    check_decode_logits(pair(arch, arch))


@pytest.mark.parametrize("arch", ARCHS)
def test_port_decode_matches_its_own_prefill(arch):
    """On the no-drop copy of the config (the same parameters)."""
    pr = pair(arch, arch)
    model = type(pr.model)(_no_drop(pr.model.cfg),
                           dict(pr.model.named_parameters()))
    check_own_consistency(pr, model)


@pytest.mark.parametrize("arch", ARCHS)
def test_generate_matches_reference_serve_loop(arch):
    check_generate(pair(arch, arch))


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_loop_asks_the_host_nothing(arch, monkeypatch):
    check_decode_asks_the_host_nothing(pair(arch, arch), monkeypatch)


def test_prefill_counts_the_dropped_slots(monkeypatch):
    """The dispatch's ``keep``, read a layer at a time, counts the slots the
    reference dispatch drops: those its ``keep`` marks false, at the
    capacity of the served config."""
    pr = pair("qwen3-moe-30b-a3b", "qwen3-moe-30b-a3b")
    cfg = pr.model.cfg
    toks = torch.as_tensor(tokens(cfg, 2, 24, seed=7))
    drops = _record_drops(monkeypatch)
    with torch.inference_mode():
        pr.model(toks, mode="prefill")
    assert len(drops) == cfg.n_layers
    assert all(r == 2 * 24 * cfg.top_k for _, r in drops)
    # layer 0's input is the embedding after the attention block: recount
    # its routing with the reference's dispatch
    lp = pr.model.layers[0]
    with torch.inference_mode():
        x = pr.model.embed.table[toks]
        ropes = _ropes_for(cfg, 24, "cpu")
        h = rms_norm(x, lp.pre_attn_norm, cfg.norm_eps)
        x = x + _attention_flagged(h, lp, cfg, False, ropes[0], ropes[1])[0]
        h = rms_norm(x, lp.pre_mlp_norm, cfg.norm_eps)
        _, e_idx = moe.route(h.reshape(16, 3, -1), lp.router, cfg.top_k)
    cap = max(int(cfg.capacity_factor * cfg.top_k * 3 / cfg.n_experts), 1)
    kept = sum(int(np.asarray(j_dispatch(jnp.zeros((3, 1)),
                                         jnp.asarray(e_idx[g].numpy()),
                                         cap, cfg.n_experts)[2]).sum())
               for g in range(16))
    assert int(drops[0][0]) == 2 * 24 * cfg.top_k - kept

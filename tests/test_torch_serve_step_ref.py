"""The port's sharded serving step against the reference's
``build_serve_step`` on the same meshes: subprocesses with 2 and 4 host
devices run the reference's prefill and decode steps (GSPMD partitions
them) at (data 1, model 2) and (2, 2), jitted with their shardings, from
the reference's ``init_params(PRNGKey(0))`` cast to float32 (made here and
handed to both sides as numpy), on a prompt of 63 tokens of 4 rows; its prefill caches are placed into ``init_state`` of 64 rows and
one decode step runs at position 63 on the prompt's last token (the serve
loop's first step). Gloo worlds of 2 and 4 ranks run the port's steps on
the same parameters and tokens (``tests/torch_serve_tp.py::ref_cases``),
all at once.
Smoke configs of gemma3-1b, rwkv6 and qwen3-moe.

Tolerances. No case here runs in float32 in both
packages. With float32 parameters the reference still rounds its q / k / v
and output projections to bf16 (``preferred_element_type=jnp.bfloat16``,
``models/transformer.py``) and its decode state is bf16 (``init_state``),
so every check is at ``tests/torch_lm.py``'s ``LOGIT_TOL``, 2 % of the
scale: prefill's last-64 logits, the decode step's logits and the new state
(each rank's rows, every cache row or head).
"""
import concurrent.futures
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.configs import get_config as j_get_config
from repro.models import get_model as j_get_model

from conftest import run_multidev

import torch_serve_tp as S
import torch_spmd

ARCHS = ("gemma3-1b", "rwkv6-3b", "qwen3-moe-30b-a3b")
B, P = 4, 63
LOGIT_TOL = 0.02         # tests/torch_lm.py's (not imported: it needs jax)
MESHES = {2: [(1, 2)], 4: [(2, 2)]}

REFERENCE = r'''
import sys, json
import numpy as np, jax, jax.numpy as jnp
from repro.compat import make_mesh
from repro.configs import get_config
from repro.configs.base import ShapeSpec
from repro.launch.steps import build_serve_step
from repro.models import get_model

out_path, b, p = sys.argv[1], int(sys.argv[2]), int(sys.argv[3])
archs, shapes = sys.argv[4].split(","), json.loads(sys.argv[5])
out = {}
for arch in archs:
    cfg = get_config(arch).smoke_config()
    m = get_model(cfg)
    with np.load(sys.argv[6] + '/' + arch + '.npz') as z:
        params = {k: jnp.asarray(z[k]) for k in z.files}
    tok = np.random.default_rng(3).integers(0, cfg.vocab, (b, p))
    tok = jnp.asarray(tok, jnp.int32)
    for shape in shapes:
        mesh = make_mesh(tuple(shape), ('data', 'model'))
        key = arch + '|' + 'x'.join(map(str, shape))
        fn, sh, ab = build_serve_step(cfg, mesh, ShapeSpec('p', p, b, 'prefill'))
        logits, caches = jax.jit(fn, in_shardings=(
            sh['params'], sh['tokens'], sh['aux']))(params, tok, {})
        out[key + '|prefill'] = np.asarray(logits, np.float32)
        if cfg.family == 'rwkv6':
            state = caches
        else:
            state = m.init_state(cfg, b, p + 1)
            k, v = caches
            state = {'k': state['k'].at[:, :, :p].set(k.astype(state['k'].dtype)),
                     'v': state['v'].at[:, :, :p].set(v.astype(state['v'].dtype))}
        fn, sh, ab = build_serve_step(cfg, mesh, ShapeSpec('d', p + 1, b, 'decode'))
        state = jax.device_put(state, sh['state'])
        logits, new = jax.jit(fn, in_shardings=(
            sh['params'], sh['tokens'], sh['state'], sh['pos']))(
            params, tok[:, -1:], state, p)
        out[key + '|decode'] = np.asarray(logits, np.float32)
        for name, t in new.items():
            out[key + '|state/' + name] = np.asarray(t.astype(jnp.float32))
np.savez(out_path, **out)
print('ok')
'''


def _reference(path, n_dev, params_dir):
    code = ("import sys; sys.argv = ['ref', %r, '%d', '%d', %r, %r, %r]\n"
            % (path, B, P, ",".join(ARCHS),
               str([list(m) for m in MESHES[n_dev]]), params_dir)) + REFERENCE
    run_multidev(code, n_dev, timeout=300)
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


def _reference_init(arch: str) -> dict:
    cfg = j_get_config(arch).smoke_config()
    params = j_get_model(cfg).init_params(jax.random.PRNGKey(0))
    return {k: np.asarray(v.astype(jnp.float32)) for k, v in params.items()}


@pytest.fixture(scope="module")
def both(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("serve_ref")
    params = {a: _reference_init(a) for a in ARCHS}
    for arch, p in params.items():
        np.savez(tmp / f"{arch}.npz", **p)
    with concurrent.futures.ThreadPoolExecutor(2 * len(MESHES)) as ex:
        refs = [ex.submit(_reference, os.path.join(str(tmp), f"r{n}.npz"), n,
                          str(tmp)) for n in MESHES]
        futs = {}
        for n, shapes in MESHES.items():
            path = tmp / f"w{n}"
            path.mkdir()
            futs[n] = ex.submit(torch_spmd.run_world, S.ref_cases, n, path,
                                shapes, ARCHS, params, B, P)
        ref = {}
        for f in refs:
            ref.update(f.result(timeout=330))
        port = {n: f.result(timeout=torch_spmd.TIMEOUT_S + 30)
                for n, f in futs.items()}
    return ref, port


def _scaled(got, want, tol, what):
    scale = np.abs(want).max()
    gap = np.abs(got - want).max()
    assert gap <= tol * scale, f"{what}: {gap:.3g} > {tol} * {scale:.3g}"


PARAMS = [(a, n) for a in ARCHS for n in MESHES]
IDS = [f"{a}-{'x'.join(map(str, MESHES[n][0]))}" for a, n in PARAMS]


@pytest.mark.parametrize("arch,n", PARAMS, ids=IDS)
def test_prefill_logits_match_reference(both, arch, n):
    ref, port = both
    for shape in MESHES[n]:
        key = f"{arch}|{'x'.join(map(str, shape))}"
        for r in port[n]:
            got = r[(arch, shape)]
            lo, nr = got["rows"]
            want = ref[key + "|prefill"][lo:lo + nr]
            _scaled(got["prefill"], want, LOGIT_TOL, "prefill")


@pytest.mark.parametrize("arch,n", PARAMS, ids=IDS)
def test_decode_step_and_state_match_reference(both, arch, n):
    ref, port = both
    for shape in MESHES[n]:
        key = f"{arch}|{'x'.join(map(str, shape))}"
        for r in port[n]:
            got = r[(arch, shape)]
            lo, nr = got["rows"]
            _scaled(got["decode"][0], ref[key + "|decode"][lo:lo + nr],
                    LOGIT_TOL, "decode logits")
            for name, t in got["state"].items():
                want = ref[f"{key}|state/{name}"][:, lo:lo + nr]
                _scaled(t.astype(np.float32), want, LOGIT_TOL, name)

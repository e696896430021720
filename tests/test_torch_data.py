"""The port's synthetic LM data (``repro_torch.data``) against the JAX
package's: the same tokens, exactly, and each rank's rows of the global
batch as the reference's ``make_global_batch`` places them (the logical
axis "batch" over "pod" x "data", pod-major)."""
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.data.pipeline import SyntheticLMData as JData
from repro.launch.mesh import make_host_mesh as j_make_host_mesh
from repro.sharding import make_rules, use_sharding
from repro_torch.data import SyntheticLMData, batch_rows
from repro_torch.launch.mesh import GridMesh, make_host_mesh


@pytest.mark.parametrize("seed,step,lo,hi", [(0, 0, 0, 8), (3, 7, 2, 5),
                                             (1, 123, 0, 1), (9, 2, 6, 8)])
def test_tokens_equal_the_reference(seed, step, lo, hi):
    ref = JData(vocab=1000, seq_len=16, global_batch=8, seed=seed)
    port = SyntheticLMData(vocab=1000, seq_len=16, global_batch=8, seed=seed)
    want = ref.batch_np(step, lo, hi)
    got = port.batch_np(step, lo, hi)
    assert got.dtype == want.dtype == np.int32
    np.testing.assert_array_equal(got, want)
    assert got.min() >= 0 and got.max() < 1000


def test_world_of_one_arrays_equal_the_reference():
    cfg = j_get_config("granite-3-8b").smoke_config()
    ref = JData(vocab=cfg.vocab, seq_len=16, global_batch=4, seed=2)
    jmesh = j_make_host_mesh(model=1)
    with use_sharding(jmesh, make_rules(cfg, jmesh, "train")):
        jt, jl = ref.global_arrays(5, jmesh)
    port = SyntheticLMData(cfg.vocab, 16, 4, seed=2)
    tt, tl = port.global_arrays(5, make_host_mesh(model=1, device="cpu"))
    assert tt.shape == (4, 16) and tt.dtype == torch.int32
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
    np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))


def _rank_mesh(shape: dict, rank: int) -> GridMesh:
    """A rank's view of a mesh of ``shape`` (the coordinates only: what
    ``batch_rows`` reads)."""
    coords, r = {}, rank
    for a in reversed(list(shape)):
        coords[a] = r % shape[a]
        r //= shape[a]
    return GridMesh(shape=dict(shape), coords=coords, rank=rank,
                    device=torch.device("cpu"), meshes={})


@pytest.mark.parametrize("shape", [{"data": 2, "model": 1},
                                   {"data": 4, "model": 1},
                                   {"pod": 2, "data": 2, "model": 1},
                                   {"pod": 2, "data": 1}],
                         ids=lambda s: "x".join(f"{k}{v}"
                                                for k, v in s.items()))
def test_rank_slices_reassemble_the_global_batch(shape):
    data = SyntheticLMData(vocab=300, seq_len=8, global_batch=8, seed=4)
    world = int(np.prod(list(shape.values())))
    full_t, full_l = [], []
    rows = []
    for r in range(world):
        mesh = _rank_mesh(shape, r)
        t, l = data.global_arrays(3, mesh)
        rows.append(batch_rows(8, mesh))
        full_t.append(t.numpy())
        full_l.append(l.numpy())
    assert rows == [(r * 8 // world, (r + 1) * 8 // world)
                    for r in range(world)]
    ref = JData(vocab=300, seq_len=8, global_batch=8, seed=4).batch_np(3)
    np.testing.assert_array_equal(np.concatenate(full_t), ref[:, :-1])
    np.testing.assert_array_equal(np.concatenate(full_l), ref[:, 1:])


def test_undivisible_batch_is_whole_on_every_rank():
    """6 rows over 4 ranks: the reference's divisibility fallback leaves the
    batch replicated."""
    for r in range(4):
        assert batch_rows(6, _rank_mesh({"data": 4, "model": 1}, r)) == (0, 6)

"""The port's checkpoint store (``repro_torch.checkpoint``): the reference's
``tests/test_checkpoint.py`` cases on tensors, and the two packages reading
each other's checkpoints (the same on-disk layout; bf16 leaves as their
uint16 bits), values exact."""
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import load_checkpoint as j_load
from repro.checkpoint import save_checkpoint as j_save
from repro_torch.checkpoint import (CheckpointManager, load_checkpoint,
                                    save_checkpoint)


def _tree(seed=0):
    g = torch.Generator().manual_seed(seed)
    return {
        "params": {"w": torch.randn(8, 4, generator=g),
                   "b": torch.randn(3, generator=g),
                   "layers/wq": torch.randn(4, 6, generator=g).to(
                       torch.bfloat16)},
        "opt": {"m": {"w": torch.randn(8, 4, generator=g)},
                "step": torch.tensor(7, dtype=torch.int32)},
    }


def _equal(a: torch.Tensor, b: torch.Tensor) -> bool:
    return a.dtype == b.dtype and a.shape == b.shape and torch.equal(a, b)


def test_roundtrip(tmp_path):
    tree = _tree()
    save_checkpoint(str(tmp_path), 5, tree, writers=4)
    loaded, step, _ = load_checkpoint(str(tmp_path))
    assert step == 5
    for k in ("w", "b", "layers/wq"):
        assert _equal(loaded["params"][k], tree["params"][k]), k
    assert _equal(loaded["opt"]["m"]["w"], tree["opt"]["m"]["w"])
    assert int(loaded["opt"]["step"]) == 7
    assert loaded["opt"]["step"].dtype == torch.int32


def test_elastic_writer_counts(tmp_path):
    """8 shards restore as 1 shard does."""
    tree = _tree(1)
    save_checkpoint(str(tmp_path / "a"), 1, tree, writers=8)
    save_checkpoint(str(tmp_path / "b"), 1, tree, writers=1)
    la, _, _ = load_checkpoint(str(tmp_path / "a"))
    lb, _, _ = load_checkpoint(str(tmp_path / "b"))
    assert _equal(la["params"]["w"], lb["params"]["w"])
    assert _equal(la["params"]["layers/wq"], lb["params"]["layers/wq"])
    assert sorted(os.listdir(tmp_path / "a" / "step_000000001")) == sorted(
        ["manifest.json"] + [f"shard_{i}_of_8.npz" for i in range(8)])


def test_keep_k_gc(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=2, writers=2)
    for s in (1, 2, 3, 4):
        mgr.save_async(s, _tree(s))
        mgr.wait()
    steps = sorted(d for d in os.listdir(tmp_path) if d.startswith("step_"))
    assert steps == ["step_000000003", "step_000000004"]
    assert mgr.latest_step() == 4


def test_async_save_owns_its_copy(tmp_path):
    """A tensor changed after ``save_async`` returns is saved as it was."""
    tree = _tree(2)
    want = tree["params"]["w"].clone()
    mgr = CheckpointManager(str(tmp_path), keep=1, writers=2)
    mgr.save_async(3, tree)
    tree["params"]["w"].add_(1.0)
    mgr.wait()
    loaded, _, _ = load_checkpoint(str(tmp_path))
    assert _equal(loaded["params"]["w"], want)


def test_partial_write_invisible(tmp_path):
    save_checkpoint(str(tmp_path), 1, _tree())
    os.makedirs(tmp_path / "step_000000009.tmp")
    _, step, _ = load_checkpoint(str(tmp_path))
    assert step == 1
    assert CheckpointManager(str(tmp_path)).latest_step() == 1


def test_load_onto_a_device_and_no_checkpoint(tmp_path):
    with pytest.raises(FileNotFoundError):
        load_checkpoint(str(tmp_path))
    save_checkpoint(str(tmp_path), 2, _tree(), meta={"loss": 1.5})
    loaded, step, meta = load_checkpoint(str(tmp_path), 2, device="cpu")
    assert step == 2 and meta == {"loss": 1.5}
    assert loaded["params"]["w"].device.type == "cpu"


@pytest.mark.parametrize("writers", [1, 4])
def test_reference_reads_a_port_checkpoint(tmp_path, writers):
    tree = _tree(3)
    save_checkpoint(str(tmp_path), 11, tree, writers=writers,
                    meta={"final": True})
    loaded, step, meta = j_load(str(tmp_path))
    assert step == 11 and meta == {"final": True}
    np.testing.assert_array_equal(loaded["params"]["w"],
                                  tree["params"]["w"].numpy())
    wq = loaded["params"]["layers/wq"]
    assert wq.dtype.name == "bfloat16"
    np.testing.assert_array_equal(
        wq.view(np.uint16),
        tree["params"]["layers/wq"].view(torch.int16).numpy().view(np.uint16))
    assert loaded["opt"]["step"].dtype == np.int32
    assert int(loaded["opt"]["step"]) == 7


@pytest.mark.parametrize("writers", [1, 4])
def test_port_reads_a_reference_checkpoint(tmp_path, writers):
    rng = np.random.default_rng(5)
    w = rng.normal(size=(8, 4)).astype(np.float32)
    wq = np.asarray(jnp.asarray(rng.normal(size=(4, 6)), jnp.bfloat16))
    tree = {"params": {"w": w, "layers/wq": wq},
            "opt": {"step": np.asarray(9, np.int32)}}
    j_save(str(tmp_path), 4, tree, writers=writers, meta={"loss": 2.0})
    loaded, step, meta = load_checkpoint(str(tmp_path))
    assert step == 4 and meta == {"loss": 2.0}
    np.testing.assert_array_equal(loaded["params"]["w"].numpy(), w)
    got = loaded["params"]["layers/wq"]
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.view(torch.int16).numpy(),
                                  wq.view(np.int16))
    assert loaded["opt"]["step"].dtype == torch.int32
    assert int(loaded["opt"]["step"]) == 9

"""The port's twin of ``examples/train_lm.py`` (``repro_torch.examples.
train_lm``) on the CPU at a tiny scale of its granite-family model: the
loss falls over the steps; a run preempted at a step and resumed from its
newest checkpoint gives the uninterrupted run's losses and gradient norms
bit for bit and the same final checkpoint (as
``test_torch_trainer.py::test_preemption_resume_bit_identical`` holds the
Trainer); the lines it prints have the reference example's shape (its own
``main`` run over a stub Trainer: the same labels, numbers aside) and its
parameter count is the reference's (``ModelConfig.param_count`` in every
family); ``main`` runs with ``--device cpu``
and raises without a card at its default device.
"""
import importlib.util
import os
import re

import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro_torch.checkpoint import load_checkpoint
from repro_torch.configs import get_config, list_archs
from repro_torch.examples import train_lm

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# (layers, d_model, heads, kv, d_head, d_ff, vocab, seq, batch)
TINY = (2, 64, 4, 2, 16, 128, 512, 32, 4)
STEPS, CKPT_EVERY, FAIL_AT = 12, 5, 8


def _run(path, **kw):
    return train_lm.run(device="cpu", steps=STEPS, scale=TINY,
                        ckpt=str(path), ckpt_every=CKPT_EVERY, log_every=0,
                        **kw)


def test_loss_falls(tmp_path):
    r = _run(tmp_path / "ck", resume=False)
    assert len(r["losses"]) == STEPS
    assert np.all(np.isfinite(r["losses"]))
    first, last = np.mean(r["losses"][:3]), np.mean(r["losses"][-3:])
    assert last < first - 0.2, (first, last)
    assert r["improvement"] == pytest.approx(r["first10"] - r["last10"])
    assert r["improvement"] > 0


def test_preempted_and_resumed_is_bit_identical(tmp_path):
    full = _run(tmp_path / "full", resume=False)
    with pytest.raises(RuntimeError, match="simulated preemption"):
        _run(tmp_path / "resumed", resume=False, fail_at_step=FAIL_AT)
    resumed = _run(tmp_path / "resumed", resume=True)
    assert resumed["history"][0]["step"] == (FAIL_AT // CKPT_EVERY) \
        * CKPT_EVERY
    by_step = {h["step"]: h for h in full["history"]}
    for h in resumed["history"]:
        assert h["loss"] == by_step[h["step"]]["loss"], h
        assert h["grad_norm"] == by_step[h["step"]]["grad_norm"], h
    a, step_a, _ = load_checkpoint(str(tmp_path / "full"))
    b, step_b, _ = load_checkpoint(str(tmp_path / "resumed"))
    assert step_a == step_b == STEPS
    for k in a["params"]:
        assert torch.equal(a["params"][k], b["params"][k]), k
        assert torch.equal(a["opt"]["master"][k], b["opt"]["master"][k]), k


def _reference_example():
    spec = importlib.util.spec_from_file_location(
        "reference_train_lm", os.path.join(ROOT, "examples", "train_lm.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _shape(line: str) -> str:
    """A printed line with its numbers and paths blanked."""
    line = re.sub(r"under \S+", "under PATH", line)
    return re.sub(r"-?\d+(\.\d+)?", "#", line)


def test_printed_summary_has_the_references_shape(tmp_path, monkeypatch,
                                                  capsys):
    ref = _reference_example()
    losses = [5.0 - 0.1 * i for i in range(STEPS)]

    class StubTrainer:
        def __init__(self, *args):
            pass

        def run(self, resume=True):
            return None, None, [{"step": i, "loss": v, "grad_norm": 1.0}
                                for i, v in enumerate(losses)]

    monkeypatch.setattr(ref, "Trainer", StubTrainer)
    monkeypatch.setattr(ref, "make_host_mesh", lambda **kw: None)
    monkeypatch.setattr("sys.argv", ["train_lm.py", "--steps", str(STEPS),
                                     "--ckpt", str(tmp_path / "ref")])
    ref.main()
    want = [ln for ln in capsys.readouterr().out.splitlines() if ln.strip()]

    monkeypatch.setitem(train_lm.SCALES, "10m", TINY)
    got_r = train_lm.main(["--device", "cpu", "--steps", str(STEPS),
                           "--ckpt", str(tmp_path / "port")])
    got = [ln for ln in capsys.readouterr().out.splitlines()
           if ln.strip() and not ln.startswith("step ")]
    assert [_shape(ln) for ln in got] == [_shape(ln) for ln in want]
    summary = lambda lines: re.findall(r"(\w+)=", next(
        ln for ln in lines if ln.startswith("loss:")))
    assert summary(got) == summary(want) == ["first10", "last10"]
    assert {"first10", "last10", "improvement", "n_params"} <= set(got_r)


@pytest.mark.parametrize("scale", list(train_lm.SCALES))
def test_parameter_count_is_the_references(scale):
    ref = _reference_example()
    l, d, h, kv, dh, f, v, *_ = ref.SCALES[scale]
    want = ref.ModelConfig(name=f"lm-{scale}", family="dense", n_layers=l,
                           d_model=d, n_heads=h, n_kv_heads=kv, d_head=dh,
                           d_ff=f, vocab=v).param_count()
    assert train_lm.SCALES[scale] == ref.SCALES[scale]
    assert train_lm.config(scale)[0].param_count() == want


@pytest.mark.parametrize("arch", sorted(list_archs()))
def test_parameter_count_of_every_family_is_the_references(arch):
    """``ModelConfig.param_count`` is the reference's formula in every
    family's branch, at full width and at the smoke config."""
    port, ref = get_config(arch), j_get_config(arch)
    assert port.param_count() == ref.param_count()
    assert port.smoke_config().param_count() == \
        ref.smoke_config().param_count()


def test_default_device_raises_without_a_card(tmp_path):
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train_lm.main(["--steps", "1", "--ckpt", str(tmp_path)])

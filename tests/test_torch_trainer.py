"""The port's training loop (``repro_torch.runtime.Trainer``) end to end on a
reduced model, on the CPU: the reference's ``tests/test_trainer.py``
cases, and the loop's fault handling. On one CPU process the step is
deterministic, so a resumed run is held to the uninterrupted one bit for
bit (the reference allows 2e-2)."""
import math

import numpy as np
import pytest
import torch

from repro_torch.configs import ShapeSpec, get_config
from repro_torch.launch import train as ttrain
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.launch.steps import TrainStepConfig
from repro_torch.runtime import Trainer, TrainerConfig

SHAPE = ShapeSpec("tiny", seq_len=32, global_batch=4, kind="train")


def _trainer(tmp_path, **kw):
    cfg = get_config("granite-3-8b").smoke_config()
    mesh = make_host_mesh(model=1, device="cpu")
    tcfg = TrainerConfig(
        total_steps=kw.pop("total_steps", 12), ckpt_every=5,
        ckpt_dir=str(tmp_path), log_every=0,
        step_cfg=TrainStepConfig(microbatches=2), **kw)
    return Trainer(cfg, SHAPE, mesh, tcfg)


def test_loss_decreases(tmp_path):
    tr = _trainer(tmp_path, total_steps=25)
    _, _, hist = tr.run(resume=False)
    first = np.mean([h["loss"] for h in hist[:5]])
    last = np.mean([h["loss"] for h in hist[-5:]])
    assert last < first - 0.2, (first, last)


def test_preemption_resume_bit_identical(tmp_path):
    """Killed at step 8, resumed from the step-5 checkpoint: the losses of
    the uninterrupted run, bit for bit, and the same final state."""
    p_full, o_full, hist_full = _trainer(tmp_path / "full").run(resume=False)
    tr_a = _trainer(tmp_path / "resumed", fail_at_step=8)
    with pytest.raises(RuntimeError, match="simulated preemption"):
        tr_a.run(resume=False)
    p_b, o_b, hist_b = _trainer(tmp_path / "resumed").run(resume=True)
    assert hist_b[0]["step"] == 5
    full = {h["step"]: h for h in hist_full}
    for h in hist_b:
        assert h["loss"] == full[h["step"]]["loss"], h
        assert h["grad_norm"] == full[h["step"]]["grad_norm"], h
    for k in p_full:
        assert torch.equal(p_b[k], p_full[k]), k
        assert torch.equal(o_b["master"][k], o_full["master"][k]), k
    assert int(o_b["step"]) == int(o_full["step"]) == 12


class _Inject:
    """The trainer's (donating) step with NaN as the loss of the calls in
    ``bad`` (counted from 0), put into the step itself so that its guard
    sees it; records each call's step and a copy of its parameters."""

    def __init__(self, step_fn, bad):
        self.step_fn, self.bad, self.calls = step_fn, set(bad), []

    def __getattr__(self, name):
        return getattr(self.step_fn, name)

    def __call__(self, params, opt, tokens, labels, aux=None, donate=False):
        self.calls.append({"params": {k: v.clone() for k, v in params.items()},
                           "opt_step": int(opt["step"])})
        step, grads = self.step_fn, self.step_fn._grads
        if len(self.calls) - 1 in self.bad:
            def nan_loss(*a):
                loss, g = grads(*a)
                return loss * float("nan"), g
            step._grads = nan_loss
        try:
            return step(params, opt, tokens, labels, aux, donate=donate)
        finally:
            step.__dict__.pop("_grads", None)


def test_nonfinite_step_is_rejected(tmp_path):
    tr = _trainer(tmp_path, total_steps=8)
    inj = tr.step_fn = _Inject(tr.step_fn, bad=[3])
    _, opt, hist = tr.run(resume=False)
    assert [h["step"] for h in hist] == [0, 1, 2, 4, 5, 6, 7]
    assert all(math.isfinite(h["loss"]) for h in hist)
    # the rejected update was dropped: step 4 starts from step 3's state
    for k, p in inj.calls[3]["params"].items():
        assert torch.equal(inj.calls[4]["params"][k], p), k
    assert inj.calls[4]["opt_step"] == inj.calls[3]["opt_step"] == 3
    assert int(opt["step"]) == 7


def test_rollback_after_max_bad_steps(tmp_path):
    """Three bad steps in a row (7, 8, 9) roll back to the step-5
    checkpoint; the steps done again give the same losses as before."""
    tr = _trainer(tmp_path, total_steps=12, max_bad_steps=3)
    inj = tr.step_fn = _Inject(tr.step_fn, bad=[7, 8, 9])
    _, _, hist = tr.run(resume=False)
    steps = [h["step"] for h in hist]
    assert steps == [0, 1, 2, 3, 4, 5, 6, 5, 6, 7, 8, 9, 10, 11], steps
    assert inj.calls[10]["opt_step"] == 5
    assert hist[7]["loss"] == hist[5]["loss"]
    assert hist[8]["loss"] == hist[6]["loss"]


def test_trainer_and_launcher_default_to_the_card(tmp_path, monkeypatch):
    cfg = get_config("granite-3-8b").smoke_config()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Trainer(cfg, SHAPE, tcfg=TrainerConfig(ckpt_dir=str(tmp_path)))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ttrain.main(["--arch", "granite-3-8b", "--smoke",
                     "--ckpt-dir", str(tmp_path)])


def test_launcher_smoke_on_the_cpu(tmp_path):
    """``python -m repro_torch.launch.train --smoke --device cpu``: trains,
    checkpoints, and a second call resumes from the last checkpoint."""
    args = ["--arch", "granite-3-8b", "--smoke", "--device", "cpu",
            "--steps", "10", "--ckpt-dir", str(tmp_path)]
    hist = ttrain.main(args)
    assert [h["step"] for h in hist] == list(range(10))
    assert np.isfinite([h["loss"] for h in hist]).all()
    assert ttrain.main(args) == []       # resumed at step 10: nothing left


def test_launcher_refuses_the_production_mesh(tmp_path):
    """Without ``--smoke`` the reference trains on a mesh with model=16:
    tensor parallelism (ROADMAP.md Queue 1 item 8(h)) is not ported, so the
    launcher refuses before it joins a world."""
    with pytest.raises(NotImplementedError, match=r"8\(h\)"):
        ttrain.main(["--arch", "granite-3-8b", "--device", "cpu",
                     "--ckpt-dir", str(tmp_path)])

"""Fault-tolerant training loop (the port of the JAX package's
``runtime/trainer.py``; its DESIGN.md §4 describes the design).

  * async checkpoints every ``ckpt_every`` steps (keep-k, atomic rename)
    and resume-on-start from the newest complete checkpoint;
  * the step donates its buffers, as the reference's does: parameters and
    optimizer state are updated in place (``TrainStep(..., donate=True)``),
    so one copy of the float32 state is held, not two;
  * non-finite loss or gradient-norm steps are rejected: the donated step
    leaves every tensor as it was when its loss or gradient norm is not
    finite, so the state before it is kept (the reference, whose donated
    buffers are gone, keeps the rejected update instead), and after
    ``max_bad_steps`` in a row the run rolls back to the last checkpoint;
  * deterministic data: a batch is a pure function of (seed, step), so a
    restarted run consumes the same tokens;
  * ``fail_at_step`` simulates a preemption (the fault-tolerance tests).

The loop reads the loss and the gradient norm on the host after each step
(``float``), as the reference does; the step itself reads nothing. It
passes no stub inputs (``aux`` is ``{}``, as the reference's loop passes),
so whisper, which needs frames, raises there as it does in the
reference. On a mesh of several ranks every rank runs the loop; the
optimizer state is gathered from its ZeRO-1 slices for a checkpoint (a
copy on the host, taken before the next step overwrites the state) and
rank 0 writes it.
"""
from __future__ import annotations

import dataclasses
import math
import os
import tempfile
import time

from ..checkpoint import CheckpointManager, load_checkpoint
from ..configs.base import ModelConfig, ShapeSpec
from ..data import SyntheticLMData
from ..launch.mesh import make_host_mesh
from ..launch.steps import TrainStepConfig, build_train_step

__all__ = ["Trainer", "TrainerConfig"]


@dataclasses.dataclass
class TrainerConfig:
    total_steps: int = 100
    ckpt_every: int = 20
    ckpt_keep: int = 3
    ckpt_dir: str = dataclasses.field(default_factory=lambda: os.path.join(
        tempfile.gettempdir(), "repro_torch_ckpt"))
    seed: int = 0
    max_bad_steps: int = 3
    log_every: int = 10
    fail_at_step: int | None = None     # simulated preemption (tests)
    step_cfg: TrainStepConfig = dataclasses.field(
        default_factory=TrainStepConfig)


class Trainer:
    """The training loop of ``cfg`` on ``mesh`` (a ``GridMesh``; by default
    ``make_host_mesh(model=1)`` on the card, which raises without one)."""

    def __init__(self, cfg: ModelConfig, shape: ShapeSpec, mesh=None,
                 tcfg: TrainerConfig | None = None):
        tcfg = TrainerConfig() if tcfg is None else tcfg
        mesh = make_host_mesh(model=1) if mesh is None else mesh
        self.cfg, self.shape, self.mesh, self.tcfg = cfg, shape, mesh, tcfg
        self.step_fn = build_train_step(cfg, mesh, shape, tcfg.step_cfg)
        self.data = SyntheticLMData(cfg.vocab, shape.seq_len,
                                    shape.global_batch, seed=tcfg.seed)
        self.ckpt = CheckpointManager(tcfg.ckpt_dir, keep=tcfg.ckpt_keep)
        self.history: list[dict] = []

    # -- state ---------------------------------------------------------------

    def init_state(self):
        params = self.step_fn.init_params(self.tcfg.seed)
        return params, self.step_fn.init_opt_state(params), 0

    def restore_or_init(self):
        if self.ckpt.latest_step() is None:
            return self.init_state()
        tree, step, _ = load_checkpoint(self.ckpt.path,
                                        device=self.mesh.device)
        return (tree["params"], self.step_fn.shard_opt_state(tree["opt"]),
                step)

    def _save(self, step: int, params, opt, meta: dict) -> None:
        full = self.step_fn.gather_opt_state(opt)
        if self.mesh.rank == 0:
            self.ckpt.save_async(step, {"params": params, "opt": full},
                                 meta=meta)

    # -- loop ----------------------------------------------------------------

    def run(self, resume: bool = True):
        params, opt, start = (self.restore_or_init() if resume
                              else self.init_state())
        bad_streak = 0
        step = start
        t0 = time.time()
        while step < self.tcfg.total_steps:
            if (self.tcfg.fail_at_step is not None
                    and step == self.tcfg.fail_at_step):
                self.ckpt.wait()
                raise RuntimeError(f"simulated preemption at step {step}")
            tokens, labels = self.data.global_arrays(step, self.mesh)
            new_params, new_opt, metrics = self.step_fn(
                params, opt, tokens, labels, {}, donate=True)
            loss = float(metrics["loss"])
            gnorm = float(metrics["grad_norm"])
            if not (math.isfinite(loss) and math.isfinite(gnorm)):
                bad_streak += 1
                if bad_streak >= self.tcfg.max_bad_steps:
                    self.ckpt.wait()
                    params, opt, step = self.restore_or_init()
                    bad_streak = 0
                    continue
                step += 1                 # rejected: params and opt as they were
                continue
            bad_streak = 0
            params, opt = new_params, new_opt
            self.history.append({"step": step, "loss": loss,
                                 "grad_norm": gnorm})
            if self.tcfg.log_every and step % self.tcfg.log_every == 0:
                print(f"step {step:5d} loss {loss:8.4f} gnorm {gnorm:7.3f} "
                      f"({time.time() - t0:.1f}s)", flush=True)
            step += 1
            if step % self.tcfg.ckpt_every == 0:
                self._save(step, params, opt, {"loss": loss})
        self.ckpt.wait()
        self._save(step, params, opt, {"final": True})
        self.ckpt.wait()
        return params, opt, self.history

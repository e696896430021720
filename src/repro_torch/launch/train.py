"""Training launcher (the port of the JAX package's ``launch/train.py``):
--arch <id> --smoke [--steps N] [--device cuda|cpu].

``--smoke`` runs the reduced config end to end on
``make_host_mesh(model=1)``: data, the train step, checkpoints, resume.
Without it the reference trains on ``make_production_mesh``, whose
"model" axis of 16 is tensor parallelism: not ported (ROADMAP.md Queue 1
item 8(h)), so the launcher refuses before it joins a world. The
reference's ``--strategy`` ('tp_sp', 'fsdp') waits for the same item, and
its ``--compression`` is left out: the compressed fusion runs over a "pod"
axis, which the host mesh does not have (``launch/steps.py``; the pod
meshes are built with ``make_mesh``, as the tests and ``chip_smoke.py``
do).

  PYTHONPATH=src python -m repro_torch.launch.train --arch granite-3-8b \\
      --smoke --steps 20 --device cpu
"""
from __future__ import annotations

import argparse
import os
import tempfile

from ..configs import ShapeSpec, get_config
from ..optim import AdamWConfig
from ..runtime import Trainer, TrainerConfig
from .mesh import make_host_mesh
from .steps import TrainStepConfig


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--smoke", action="store_true",
                    help="reduced config + host mesh (CPU-runnable)")
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_ckpt"))
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--device", default="cuda",
                    help="this rank's device: the card (default) or 'cpu'")
    args = ap.parse_args(argv)

    if not args.smoke:
        raise NotImplementedError(
            "the production mesh (data, model) = (16, 16) needs tensor "
            "parallelism, which is not ported (ROADMAP.md Queue 1 item "
            "8(h)); run --smoke")
    cfg = get_config(args.arch).smoke_config()
    shape = ShapeSpec("smoke", 64, 4, "train")
    mesh = make_host_mesh(model=1, device=args.device)

    tcfg = TrainerConfig(
        total_steps=args.steps, ckpt_every=max(args.steps // 5, 10),
        ckpt_dir=args.ckpt_dir,
        step_cfg=TrainStepConfig(
            microbatches=args.microbatches,
            adamw=AdamWConfig(lr=args.lr)))
    trainer = Trainer(cfg, shape, mesh, tcfg)
    _, _, history = trainer.run(resume=True)
    return history


if __name__ == "__main__":
    main()

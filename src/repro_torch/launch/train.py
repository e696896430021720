"""Training launcher (the port of the JAX package's ``launch/train.py``):

  --arch <id> [--shape train_4k] [--steps N] [--strategy tp|tp_sp|fsdp]
  [--compression 8|4] [--microbatches N] [--lr X] [--device cuda|cpu]
  [--multi-pod] | --smoke [--model N]

Without ``--smoke`` it is the multi-host entry point: the process joins
the world its environment names (``mesh.init_cluster``: ``AMP_COORDINATOR``
/ ``AMP_NUM_PROCESSES`` / ``AMP_PROCESS_ID``, NCCL on the card), and trains
the full config at ``--shape`` on ``make_production_mesh``, ("data",
"model") = (16, 16), or with ``--multi-pod`` ("pod", "data", "model") =
(2, 16, 16), its "model" axis tensor parallelism under ``--strategy``
(``launch/steps.py``); a world of another size than 256 (512) ranks is
refused with a ``ValueError`` naming the size it needs. ``--compression``
fuses the gradients over "pod" through the paper's int8 or int4
``compressed_psum``, and is refused (``ValueError``) on a mesh without a
"pod" axis: under ``--smoke`` or without ``--multi-pod``. MoE layers cut
the tokens into 64 groups.

``--smoke`` runs the reduced config at 64 positions and a global batch of
4 on ``make_host_mesh(model=N)`` (``--model``, 1 by default): one process,
or with N > 1 a world of N gloo ranks spawned on ``--device`` (ranks
sharing the card where it is one), every rank running the loop; MoE layers
cut the tokens into 2 groups, as the reference's launcher sets at smoke
size. ``main`` returns rank 0's history. The Trainer passes no stub
inputs, so whisper raises for want of frames, as the reference's does.

  PYTHONPATH=src python -m repro_torch.launch.train --arch granite-3-8b \\
      --smoke --steps 20 --device cpu
  PYTHONPATH=src python -m repro_torch.launch.train --arch gemma3-1b \\
      --smoke --model 2 --strategy tp_sp --steps 20
"""
from __future__ import annotations

import argparse
import os
import tempfile

from ..configs import SHAPES, ShapeSpec, get_config
from ..optim import AdamWConfig
from ..runtime import Trainer, TrainerConfig
from .mesh import (init_cluster, make_host_mesh, make_production_mesh,
                   spawn_world)
from .steps import TrainStepConfig


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", default="train_4k", choices=sorted(
        k for k, v in SHAPES.items() if v.kind == "train"))
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--smoke", action="store_true",
                    help="reduced config + host mesh (CPU-runnable)")
    ap.add_argument("--model", type=int, default=1,
                    help="--smoke: the 'model' axis, a world of this many "
                         "spawned gloo ranks")
    ap.add_argument("--multi-pod", action="store_true",
                    help="the (2, 16, 16) pod mesh (512 ranks)")
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_ckpt"))
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--compression", type=int, default=None, choices=[8, 4],
                    help="gradient-fusion bits over the pod axis")
    ap.add_argument("--strategy", default="tp",
                    choices=["tp", "tp_sp", "fsdp"])
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--device", default="cuda",
                    help="this rank's device: the card (default) or 'cpu'")
    return ap


def _trainer_config(args) -> TrainerConfig:
    return TrainerConfig(
        total_steps=args.steps, ckpt_every=max(args.steps // 5, 10),
        ckpt_dir=args.ckpt_dir,
        step_cfg=TrainStepConfig(
            microbatches=args.microbatches,
            compression_bits=args.compression,
            strategy=args.strategy,
            moe_groups=2 if args.smoke else 64,
            adamw=AdamWConfig(lr=args.lr)))


def _smoke_rank(_serve_mesh, args):
    mesh = make_host_mesh(model=args.model, device=args.device)
    trainer = Trainer(get_config(args.arch).smoke_config(),
                      ShapeSpec("smoke", 64, 4, "train"), mesh,
                      _trainer_config(args))
    return trainer.run(resume=True)[2]


def main(argv=None):
    args = _parser().parse_args(argv)
    if args.model < 1:
        raise ValueError(f"--model {args.model}: at least 1")
    if args.compression is not None and (args.smoke or not args.multi_pod):
        raise ValueError(f"--compression {args.compression} fuses over the "
                         "'pod' axis, which only the --multi-pod mesh has")
    if args.smoke and args.model > 1:
        if args.multi_pod:
            raise ValueError("--multi-pod is the production mesh; --smoke "
                             "runs the host mesh")
        store = tempfile.mkdtemp(prefix="repro_torch_train_")
        return spawn_world(_smoke_rank, args.model, backend="gloo",
                           device=args.device,
                           store_path=os.path.join(store, "store"),
                           args=(args,))[0]
    if args.smoke:
        return _smoke_rank(None, args)
    if args.model != 1:
        raise ValueError("--model is for --smoke; the production mesh has "
                         "model=16")
    init_cluster(backend="nccl" if args.device == "cuda" else "gloo",
                 device=args.device)
    mesh = make_production_mesh(multi_pod=args.multi_pod, device=args.device)
    trainer = Trainer(get_config(args.arch), SHAPES[args.shape], mesh,
                      _trainer_config(args))
    return trainer.run(resume=True)[2]


if __name__ == "__main__":
    main()

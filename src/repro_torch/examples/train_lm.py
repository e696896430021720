"""End-to-end LM training on the port: data pipeline -> model -> AdamW ->
checkpoints (the twin of the JAX package's ``examples/train_lm.py``).

Trains a granite-family decoder (``--scale 10m``: ~10M params, 150 steps;
``--scale 100m``: the ~100M-param configuration) through the port's
stack: synthetic data, the dense transformer, chunked cross-entropy,
ZeRO-1 AdamW, asynchronous checkpoints, NaN-step rejection and resume on
restart.

  PYTHONPATH=src python -m repro_torch.examples.train_lm [--steps 150]
      [--scale 10m] [--ckpt DIR] [--device cpu]
"""
from __future__ import annotations

import argparse
import os
import tempfile

import numpy as np

from ..configs.base import ModelConfig, ShapeSpec
from ..launch.mesh import make_host_mesh
from ..launch.steps import TrainStepConfig
from ..optim import AdamWConfig
from ..runtime import Trainer, TrainerConfig
from .common import check_device

__all__ = ["SCALES", "config", "run", "main"]

SCALES = {
    # name: (layers, d_model, heads, kv, d_head, d_ff, vocab, seq, batch)
    "10m": (6, 320, 8, 4, 40, 1024, 8192, 128, 8),
    "100m": (12, 768, 12, 4, 64, 2048, 32000, 512, 32),
}
STEPS, CKPT_EVERY, LOG_EVERY = 150, 50, 10


def default_ckpt() -> str:
    return os.path.join(tempfile.gettempdir(), "repro_torch_train_lm")


def config(scale) -> tuple[ModelConfig, ShapeSpec]:
    """The dense model and the train shape of ``scale``: a name of
    ``SCALES`` or its 9-tuple."""
    name = scale if isinstance(scale, str) else "custom"
    l, d, h, kv, dh, f, v, seq, batch = (SCALES[scale] if isinstance(
        scale, str) else scale)
    cfg = ModelConfig(name=f"lm-{name}", family="dense", n_layers=l,
                      d_model=d, n_heads=h, n_kv_heads=kv, d_head=dh,
                      d_ff=f, vocab=v)
    return cfg, ShapeSpec("train", seq, batch, "train")


def run(device: str = "cuda", steps: int = STEPS, scale="10m",
        ckpt: str | None = None, ckpt_every: int = CKPT_EVERY,
        log_every: int = LOG_EVERY, resume: bool = True,
        fail_at_step: int | None = None) -> dict:
    """Train ``steps`` steps (resuming from ``ckpt``'s newest checkpoint
    with ``resume``). Returns the model's size, the loss of every step run
    here and the summary: the mean loss of the first and last ten steps
    and their difference."""
    check_device(device)
    ckpt = ckpt or default_ckpt()
    cfg, shape = config(scale)
    mesh = make_host_mesh(model=1, device=device)
    tcfg = TrainerConfig(
        total_steps=steps, ckpt_every=ckpt_every, ckpt_dir=ckpt,
        log_every=log_every, fail_at_step=fail_at_step,
        step_cfg=TrainStepConfig(
            microbatches=2, moe_groups=1,
            adamw=AdamWConfig(lr=1e-3, weight_decay=0.01)))
    trainer = Trainer(cfg, shape, mesh, tcfg)
    _, _, hist = trainer.run(resume=resume)
    losses = [h["loss"] for h in hist]
    first10 = float(np.mean(losses[:10])) if losses else float("nan")
    last10 = float(np.mean(losses[-10:])) if losses else float("nan")
    return {"n_params": cfg.param_count(), "n_layers": cfg.n_layers,
            "d_model": cfg.d_model, "batch": shape.global_batch,
            "seq": shape.seq_len, "steps": steps, "history": hist,
            "losses": losses, "first10": first10, "last10": last10,
            "improvement": first10 - last10, "ckpt": ckpt}


def report_model(r: dict) -> None:
    print(f"model: {r['n_params'] / 1e6:.1f}M params, {r['n_layers']}L "
          f"d={r['d_model']}, batch {r['batch']} x seq {r['seq']}, "
          f"{r['steps']} steps")


def report(r: dict) -> None:
    print(f"\nloss: first10={r['first10']:.3f} last10={r['last10']:.3f} "
          f"(improvement {r['improvement']:.3f})")
    print(f"checkpoints under {r['ckpt']}")


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=STEPS)
    ap.add_argument("--scale", choices=SCALES, default="10m")
    ap.add_argument("--ckpt", type=str, default=default_ckpt())
    ap.add_argument("--device", default="cuda",
                    help="where the model trains (default: the card)")
    args = ap.parse_args(argv)
    cfg, shape = config(args.scale)
    report_model({"n_params": cfg.param_count(), "n_layers": cfg.n_layers,
                  "d_model": cfg.d_model, "batch": shape.global_batch,
                  "seq": shape.seq_len, "steps": args.steps})
    r = run(device=args.device, steps=args.steps, scale=args.scale,
            ckpt=args.ckpt)
    report(r)
    return r


if __name__ == "__main__":
    main()

"""Serving launcher: batched prefill, then greedy decode against the KV cache
(dense) or the recurrent state (rwkv6). The port of the JAX package's
``launch/serve.py``.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch gemma3-1b \\
      [--smoke] [--device cpu] --batch 4 --prompt-len 32 --gen 16 --seed 0

Weights are a random init from the seed (no weights are on disk). As the
reference does, the decode loop starts by feeding the prompt's last token
at position ``prompt_len`` and the cache holds ``prompt_len + gen`` rows.
The next token stays on the device; the generated ids are copied to the
host once, after the loop (the reference copies them every step).
"""
from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np
import torch

from ..configs import get_config
from ..models import get_model

__all__ = ["Generation", "prefill", "decode", "generate", "main"]


@dataclasses.dataclass
class Generation:
    tokens: np.ndarray            # (B, gen) generated ids
    prefill_s: float              # prefill, state placement included
    decode_s: float               # the greedy loop
    logits: torch.Tensor | None   # (B, gen, V) float32 of each step, if kept


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def prefill(model, prompts, max_len: int):
    """Prefill ``prompts`` (B, P) and return the decode state: the dense
    family's cache of ``max_len`` rows with the prompt's K/V in its first P
    rows, or the recurrent family's state after the prompt."""
    b, p = prompts.shape
    if model.cfg.family == "dense":
        _, (k, v) = model(prompts, mode="prefill")
        state = model.init_state(b, max_len)
        state["k"][:, :, :p] = k
        state["v"][:, :, :p] = v
        return state
    _, state = model(prompts, mode="prefill")
    return state


def decode(model, state, tok, start: int, gen: int, logits_out=None):
    """``gen`` greedy steps from token ``tok`` (B, 1) at position ``start``.
    Returns the ids (B, gen) on the device; nothing in the loop waits for
    the device. ``logits_out`` (B, gen, V), if given, receives each step's
    float32 logits."""
    ids = torch.empty((tok.shape[0], gen), dtype=torch.long, device=tok.device)
    for i in range(gen):
        hidden, state = model.decode_step(tok, state, start + i)
        logits = model.logits(hidden)[:, -1]
        if logits_out is not None:
            logits_out[:, i] = logits
        tok = torch.argmax(logits, dim=-1, keepdim=True)
        ids[:, i] = tok[:, 0]
    return ids


@torch.inference_mode()
def generate(model, prompts, gen: int, keep_logits: bool = False) -> Generation:
    """Prefill ``prompts`` (B, P) ints (a tensor or an array), then ``gen``
    greedy decode steps. Times are taken on the host clock, the device
    synchronised at both ends."""
    dev = model.device
    prompts = torch.as_tensor(np.asarray(prompts), dtype=torch.long).to(dev)
    b, p = prompts.shape
    _sync(dev)
    t0 = time.perf_counter()
    state = prefill(model, prompts, p + gen)
    _sync(dev)
    t1 = time.perf_counter()
    logits = (torch.empty((b, gen, model.cfg.vocab_padded),
                          dtype=torch.float32, device=dev)
              if keep_logits else None)
    ids = decode(model, state, prompts[:, -1:], p, gen, logits)
    _sync(dev)
    t2 = time.perf_counter()
    return Generation(tokens=ids.cpu().numpy(), prefill_s=t1 - t0,
                      decode_s=t2 - t1, logits=logits)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if args.smoke:
        cfg = cfg.smoke_config()
    model = get_model(cfg, device=args.device, seed=args.seed)
    b, pl_len, gen = args.batch, args.prompt_len, args.gen
    rng = np.random.default_rng(args.seed)
    prompts = rng.integers(0, cfg.vocab, (b, pl_len))
    out = generate(model, prompts, gen)
    print(f"prefill: {b}x{pl_len} tokens in {out.prefill_s:.2f}s")
    print(f"decode : {gen} steps in {out.decode_s:.2f}s "
          f"({b * gen / max(out.decode_s, 1e-9):.1f} tok/s)")
    print("generated token ids (first row):", out.tokens[0].tolist())
    return out


if __name__ == "__main__":
    main()

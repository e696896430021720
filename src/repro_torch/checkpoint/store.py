"""Sharded checkpoints with async writes, keep-k GC and elastic restore
(the port of the JAX package's ``checkpoint/store.py``, its on-disk format
byte for byte, so each package reads the other's).

Layout per step:
    <dir>/step_000000123/
        manifest.json          # global shapes/dtypes, tree structure, meta
        shard_<i>_of_<n>.npz   # per-writer shard files (leaf slices)

Every leaf is split along its first axis into ``writers`` slices where
that axis divides (else it goes whole to writer 0); the files are written
into ``step_*.tmp`` and the directory is renamed into place after the
manifest, so a crash mid-write never leaves a checkpoint that looks valid.
Tree paths are joined with ``|``. npz cannot hold bfloat16: a bf16 leaf is
stored as its uint16 bits and the manifest records "bfloat16" (the
reference's ``ml_dtypes`` view; here the bits go to and from a torch bf16
tensor, no ``ml_dtypes`` needed). Restore is elastic: the loader
reassembles each leaf from however many shard files exist, onto the device
asked for.
"""
from __future__ import annotations

import json
import os
import shutil
import threading

import numpy as np
import torch

__all__ = ["save_checkpoint", "load_checkpoint", "CheckpointManager"]

_FLAT_SEP = "|"


def _flatten(tree, prefix=""):
    out = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(_flatten(v, f"{prefix}{k}{_FLAT_SEP}"))
    else:
        out[prefix[:-1]] = tree
    return out


def _unflatten(flat):
    tree: dict = {}
    for k, v in flat.items():
        parts = k.split(_FLAT_SEP)
        node = tree
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = v
    return tree


def _to_host(v) -> tuple[np.ndarray, str]:
    """A leaf as (the numpy array stored, its logical dtype name): bf16
    tensors as their uint16 bits."""
    if isinstance(v, torch.Tensor):
        t = v.detach().to("cpu", copy=True)   # the writer owns its copy
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
        a = t.numpy()
    else:
        a = np.asarray(v)
    return a, str(a.dtype)


def _from_storable(a: np.ndarray, dtype_name: str) -> torch.Tensor:
    a = np.ascontiguousarray(a)
    if dtype_name == "bfloat16":
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def _steps(path: str) -> list[int]:
    return sorted(int(d.split("_")[1]) for d in os.listdir(path)
                  if d.startswith("step_") and not d.endswith(".tmp"))


def _write(path: str, step: int, host: dict, dtypes: dict, writers: int,
           meta: dict | None) -> str:
    final = os.path.join(path, f"step_{step:09d}")
    tmp = final + ".tmp"
    os.makedirs(tmp, exist_ok=True)
    manifest = {
        "step": step,
        "writers": writers,
        "meta": meta or {},
        "leaves": {k: {"shape": list(v.shape), "dtype": dtypes[k]}
                   for k, v in host.items()},
    }
    for w in range(writers):
        shard = {}
        for k, v in host.items():
            if v.ndim and v.shape[0] % writers == 0:
                n = v.shape[0] // writers
                shard[k] = v[w * n:(w + 1) * n]
            elif w == 0:  # undivisible / scalar leaves go to writer 0
                shard[k] = v
        np.savez(os.path.join(tmp, f"shard_{w}_of_{writers}.npz"), **shard)
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)
    return final


def _fetch(tree) -> tuple[dict, dict]:
    flat = _flatten(tree)
    host, dtypes = {}, {}
    for k, v in flat.items():
        host[k], dtypes[k] = _to_host(v)
    return host, dtypes


def save_checkpoint(path: str, step: int, tree, writers: int = 4,
                    meta: dict | None = None) -> str:
    """Write ``tree`` (nested dicts of tensors or numpy arrays)
    synchronously. Returns the final directory."""
    host, dtypes = _fetch(tree)
    return _write(path, step, host, dtypes, writers, meta)


def load_checkpoint(path: str, step: int | None = None, device=None):
    """Load (tree of tensors, step, meta): the newest complete step unless
    ``step`` is given; each leaf on ``device`` (the CPU by default)."""
    if step is None:
        steps = _steps(path)
        if not steps:
            raise FileNotFoundError(f"no checkpoints under {path}")
        step = steps[-1]
    d = os.path.join(path, f"step_{step:09d}")
    with open(os.path.join(d, "manifest.json")) as f:
        manifest = json.load(f)
    writers = manifest["writers"]
    parts: dict[str, list] = {k: [] for k in manifest["leaves"]}
    for w in range(writers):
        with np.load(os.path.join(d, f"shard_{w}_of_{writers}.npz")) as z:
            for k in z.files:
                parts[k].append(z[k])
    flat = {}
    for k, info in manifest["leaves"].items():
        arrs = parts[k]
        full = arrs[0] if len(arrs) == 1 else np.concatenate(arrs, axis=0)
        if list(full.shape) != info["shape"]:
            raise ValueError(f"{d}: leaf {k} has shape {full.shape}, the "
                             f"manifest says {info['shape']}")
        t = _from_storable(full, info["dtype"])
        flat[k] = t if device is None else t.to(device)
    return _unflatten(flat), step, manifest["meta"]


class CheckpointManager:
    """Async keep-k checkpointing for the training loop: the tree is copied
    to the host at once, written by a background thread (training goes
    on), and all but the newest ``keep`` steps are deleted after."""

    def __init__(self, path: str, keep: int = 3, writers: int = 4):
        self.path = path
        self.keep = keep
        self.writers = writers
        self._thread: threading.Thread | None = None
        self._error: BaseException | None = None
        os.makedirs(path, exist_ok=True)

    def save_async(self, step: int, tree, meta=None):
        host, dtypes = _fetch(tree)
        self.wait()

        def work():
            try:
                _write(self.path, step, host, dtypes, self.writers, meta)
                self._gc()
            except Exception as e:   # raised again by wait()
                self._error = e

        self._thread = threading.Thread(target=work, daemon=True)
        self._thread.start()

    def wait(self):
        """Join the writer; raise what it raised."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def _gc(self):
        for s in _steps(self.path)[:-self.keep]:
            shutil.rmtree(os.path.join(self.path, f"step_{s:09d}"),
                          ignore_errors=True)

    def latest_step(self) -> int | None:
        steps = _steps(self.path)
        return steps[-1] if steps else None

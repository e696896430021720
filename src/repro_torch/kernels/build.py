"""Build and load the CUDA sources under ``repro_torch/csrc``.

Each ``<name>.cu`` is compiled by ``nvcc`` for ``sm_90a`` into a shared
library with a plain C interface and loaded with ``ctypes`` (no PyTorch
headers, so a build takes seconds). Libraries are built at first use, from
the sources in the package and nothing else, into ``build/`` at the root of
the checkout, under a name that carries a hash of the source and of every
header under ``csrc/`` (``*.cuh``), so an edited source or header is rebuilt
and an unchanged one is not.
Several sources are compiled side by side, one ``nvcc`` process each.

Nothing here runs when a module is imported; a machine without ``nvcc``
can import everything and fails only when it asks for a kernel.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

__all__ = ["NVCC_FLAGS", "build_dir", "ensure_built", "load", "check",
           "build_log"]

CSRC = Path(__file__).resolve().parent.parent / "csrc"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}
build_log: list[dict] = []   # one record per nvcc run: command, seconds, stderr


def build_dir() -> Path:
    return Path(__file__).resolve().parents[3] / "build"


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    exe = shutil.which("nvcc") or os.path.join(cuda_home, "bin", "nvcc")
    if not os.path.exists(exe):
        raise RuntimeError(
            "nvcc not found (looked on PATH and in "
            f"{cuda_home}/bin): the CUDA kernels cannot be built here")
    return exe


def _lib_path(name: str) -> Path:
    key = hashlib.sha1((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        key.update(header.read_bytes())
    key.update(" ".join(NVCC_FLAGS).encode())
    return build_dir() / f"lib{name}_{key.hexdigest()[:12]}.so"


def ensure_built(names) -> dict[str, Path]:
    """Compile every named source that has no library yet, all at once."""
    with _lock:
        paths = {name: _lib_path(name) for name in names}
        todo = {n: p for n, p in paths.items() if not p.exists()}
        if todo:
            nvcc = _nvcc()
            build_dir().mkdir(parents=True, exist_ok=True)
            procs = []
            for name, path in todo.items():
                tmp = path.with_suffix(f".{os.getpid()}.tmp")
                cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp),
                       str(CSRC / f"{name}.cu")]
                procs.append((name, path, tmp, cmd, time.perf_counter(),
                              subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                               stderr=subprocess.PIPE,
                                               text=True)))
            failed = []
            for name, path, tmp, cmd, t0, proc in procs:
                out, err = proc.communicate()
                build_log.append({"name": name, "command": " ".join(cmd),
                                  "seconds": time.perf_counter() - t0,
                                  "returncode": proc.returncode,
                                  "stderr": err})
                if proc.returncode != 0:
                    failed.append(f"{name}: {' '.join(cmd)}\n{out}\n{err}")
                else:
                    os.replace(tmp, path)   # atomic: no half-written library
            if failed:
                raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
        return paths


def load(name: str) -> ctypes.CDLL:
    """The ctypes handle of ``csrc/<name>.cu``, built on first use."""
    lib = _libs.get(name)
    if lib is None:
        path = ensure_built([name])[name]
        with _lock:
            lib = _libs.get(name)
            if lib is None:
                lib = _libs[name] = ctypes.CDLL(str(path))
    return lib


def check(name: str, code: int, what: str) -> None:
    """Raise if an entry point of ``csrc/<name>.cu`` returned a CUDA error
    (each source exports ``<name>_error_string``)."""
    if code != 0:
        fn = getattr(load(name), f"{name}_error_string")
        fn.argtypes, fn.restype = [ctypes.c_int], ctypes.c_char_p
        raise RuntimeError(f"{what}: CUDA error {code} ({fn(code).decode()})")

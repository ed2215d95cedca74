"""Build and load the port's hand-written CUDA kernels.

Each ``src/repro_torch/csrc/<name>.cu`` compiles with ``nvcc`` into a
shared library with a plain C interface, loaded with ``ctypes``.  Builds go
to ``build/torch_kernels/`` at the root of the checkout, named by a hash of
the source and the flags, so an edited source rebuilds and an unchanged one
loads at once.  Beside each library, a ``.log`` file keeps what ``nvcc``
printed: ``ptxas -v``'s registers, shared memory and spills per kernel
(:func:`build_log`).  A missing ``nvcc`` or a failed build raises; nothing
falls back.  Nothing here runs at import: a kernel is built the first time
its wrapper launches it.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess

CSRC = pathlib.Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = pathlib.Path(__file__).resolve().parents[3] / "build" / "torch_kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_loaded: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(nvcc):
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                           "toolkit (nvcc on PATH or /usr/local/cuda/bin)")
    return nvcc


def library_path(name: str) -> pathlib.Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}_{digest}.so"


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, building it first if
    needed."""
    lib = _loaded.get(name)
    if lib is not None:
        return lib
    out = library_path(name)
    if not out.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        proc = subprocess.run(cmd, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(f"nvcc failed for {name}.cu:\n{proc.stdout}")
        out.with_suffix(".log").write_text(proc.stdout)
        os.replace(tmp, out)
    lib = _loaded[name] = ctypes.CDLL(str(out))
    return lib


def build_log(name: str) -> str:
    """What ``nvcc`` printed when it built ``csrc/<name>.cu`` (built first
    if needed)."""
    load(name)
    return library_path(name).with_suffix(".log").read_text()

"""Build and load the port's CUDA kernels.

Each ``giga_tpu_torch/csrc/<name>.cu`` is compiled by ``nvcc`` for Hopper
(``sm_90a``) into a shared library with a plain C interface, under
``build/giga_tpu_torch/`` at the repository root, and loaded with ``ctypes``.
Libraries are named by a hash of their source, so an edited source is
rebuilt and an unchanged one is reused. Nothing is built at import: the
first launch builds what it needs, and ``build_all`` builds every kernel at
once, one ``nvcc`` process per source, all started together.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parents[2] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "giga_tpu_torch"
SOURCES = ("stem_pool", "dense_decode")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_lock = threading.Lock()
_loaded: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")
    return path


def library_path(name: str) -> Path:
    digest = hashlib.sha256((CSRC / f"{name}.cu").read_bytes()).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def _start(name: str):
    """Start nvcc for one source unless its library exists; returns the
    process (or None), the final path and the temporary output path."""
    lib = library_path(name)
    if lib.exists():
        return None, lib, None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    return proc, lib, tmp


def _finish(name: str, proc, lib: Path, tmp: Path) -> None:
    log, _ = proc.communicate()
    lib.with_suffix(".log").write_text(log)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name}.cu:\n{log}")
    os.replace(tmp, lib)


def build_all() -> None:
    """Compile every missing kernel library, the nvcc processes in parallel."""
    with _lock:
        started = [(n, *_start(n)) for n in SOURCES]
        for name, proc, lib, tmp in started:
            if proc is not None:
                _finish(name, proc, lib, tmp)


def build_log(name: str) -> str:
    """nvcc/ptxas output of the last build of ``name`` (registers, spills)."""
    log = library_path(name).with_suffix(".log")
    return log.read_text() if log.exists() else ""


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``name``, built first if needed."""
    with _lock:
        lib = _loaded.get(name)
        if lib is not None:
            return lib
        proc, path, tmp = _start(name)
        if proc is not None:
            _finish(name, proc, path, tmp)
        lib = ctypes.CDLL(str(path))
        _loaded[name] = lib
        return lib


def check(err: int, what: str) -> None:
    """Raise if a C entry point returned a CUDA error code."""
    if err != 0:
        raise RuntimeError(f"{what} failed with CUDA error {err}")

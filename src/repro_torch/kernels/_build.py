"""Builds the port's CUDA sources with nvcc and loads them with ctypes.

Each library is one ``.cu`` file with a plain C interface, compiled for
sm_90a into ``build/repro_torch_kernels/`` at the repository root (listed in
``.gitignore``) on first use, under a name keyed by a hash of the source and
the flags, so an edited source rebuilds and an unchanged one loads. Nothing
here runs at import: ``load`` is called by the wrapper that launches the
kernel, on the first launch. Each source has its own lock, so threads that
load different sources run their nvcc builds at the same time.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from pathlib import Path
from typing import Dict, Tuple

_REPO_ROOT = Path(__file__).resolve().parents[3]
BUILD_DIR = _REPO_ROOT / "build" / "repro_torch_kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_locks_lock = threading.Lock()
_locks: Dict[str, threading.Lock] = {}     # one per source name
_libs: Dict[str, ctypes.CDLL] = {}
# name -> (seconds nvcc took (0.0 when the cached build was loaded), nvcc's
# stderr, which holds ptxas' register / shared-memory / spill report)
build_log: Dict[str, Tuple[float, str]] = {}


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels build on a host with "
                       "the CUDA toolkit (set CUDA_HOME or put nvcc on PATH)")


def load(source: Path) -> ctypes.CDLL:
    """Compiles ``source`` (once per content hash) and returns the library."""
    source = Path(source)
    name = source.stem
    with _locks_lock:
        lock = _locks.setdefault(name, threading.Lock())
    with lock:
        if name in _libs:
            return _libs[name]
        text = source.read_bytes()
        digest = hashlib.sha256(text + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        out = BUILD_DIR / f"lib{name}-{digest}.so"
        if out.exists():
            build_log[name] = (0.0, "")
        else:
            # compile to a private name, then rename: a process building at
            # the same time never loads a half-written library
            fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
            os.close(fd)
            t0 = time.perf_counter()
            proc = subprocess.run([nvcc_path(), *NVCC_FLAGS, "-o", tmp,
                                   str(source)], capture_output=True, text=True)
            secs = time.perf_counter() - t0
            if proc.returncode != 0:
                os.unlink(tmp)
                raise RuntimeError(f"nvcc failed on {source}:\n{proc.stderr}")
            os.replace(tmp, out)
            build_log[name] = (secs, proc.stderr)
        lib = ctypes.CDLL(str(out))
        _libs[name] = lib
        return lib

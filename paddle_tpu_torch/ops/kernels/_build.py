"""Build the port's CUDA sources with ``nvcc`` and load them via ctypes.

Each ``csrc/<name>.cu`` has a plain C interface and compiles on its own
into ``_build/<name>-<hash>.so``, where the hash covers the source, every
shared header ``csrc/*.cuh`` and the flags, so an edited source or header
rebuilds and an unchanged one is reused.
Nothing is built when a module is imported: a kernel's wrapper calls
:func:`load` on its first launch, and ``build_all`` starts one ``nvcc``
per source at once for scripts that want every kernel ready up front.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

_PKG = Path(__file__).resolve().parents[2]
CSRC = _PKG / "csrc"
BUILD = _PKG / "_build"

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_loaded: dict = {}
#: name -> {"seconds": build seconds (0.0 when reused), "log": nvcc's
#: output, with ptxas's registers / shared memory / spills per kernel}
build_info: dict = {}


def nvcc_path() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError(
        "nvcc not found (looked on PATH and /usr/local/cuda/bin); the "
        "port's CUDA kernels build only where the CUDA toolkit is")


def sources() -> list:
    return sorted(p.stem for p in CSRC.glob("*.cu"))


def _target(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    for header in sorted(CSRC.glob("*.cuh")):
        src += header.read_bytes()
    h = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD / f"{name}-{h[:16]}.so"


def _start(name: str):
    """Start nvcc for ``name`` unless its library is already built.
    Returns (target, Popen or None, start time)."""
    so = _target(name)
    if so.exists():
        return so, None, time.perf_counter()
    BUILD.mkdir(parents=True, exist_ok=True)
    tmp = so.with_suffix(f".{os.getpid()}.tmp")
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp),
           str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return so, proc, time.perf_counter()


def _finish(name: str, so: Path, proc, t0: float) -> None:
    if proc is None:
        build_info.setdefault(name, {"seconds": 0.0, "log": ""})
        return
    log, _ = proc.communicate()
    tmp = so.with_suffix(f".{os.getpid()}.tmp")
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed for {name}.cu:\n{log}")
    os.replace(tmp, so)   # atomic: a reader never sees a partial .so
    build_info[name] = {"seconds": time.perf_counter() - t0, "log": log}


def build_all(names=None) -> dict:
    """Build every named source (default: all of ``csrc/``) with one
    nvcc process each, all started together.  Returns ``build_info``."""
    names = sources() if names is None else list(names)
    started = [(n, *_start(n)) for n in names]
    for n, so, proc, t0 in started:
        _finish(n, so, proc, t0)
    return build_info


def load(name: str) -> ctypes.CDLL:
    """The ctypes handle of ``csrc/<name>.cu``, building it first if
    needed.  The caller declares ``argtypes``/``restype``."""
    lib = _loaded.get(name)
    if lib is None:
        so, proc, t0 = _start(name)
        _finish(name, so, proc, t0)
        lib = _loaded[name] = ctypes.CDLL(str(so))
    return lib

"""Build the hand-written CUDA kernels and bind them with ctypes.

Each ``csrc/<name>.cu`` compiles with ``nvcc`` for ``sm_90a`` into a shared
library with a plain C interface, ``build/lib<name>.so`` beside this file
(git-ignored).  The build happens at first use, never at import, and is
redone when the source is newer than the library.  :func:`load_all`
starts one nvcc per source at once; :func:`entry` binds a C function,
building the libraries of ``SIDE_BY_SIDE`` together (the resident queries'
K1, K6, K7 and K9, so a first run's nvcc times overlap).  Each compile is a
``strawboat.kernel.build`` span (attribute ``kernel``) and counts in
``kernel.builds`` (``util/obs.py``).
"""

from __future__ import annotations

import concurrent.futures as cf
import ctypes
import functools
import os
import shutil
import subprocess
import tempfile
import threading
from typing import Dict

from ..util import obs

_HERE = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(_HERE, "csrc")
BUILD = os.path.join(_HERE, "build")

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
)

_lock = threading.Lock()  # guards _locks
_locks: Dict[str, threading.Lock] = {}  # one per library: builds run side by side
_libs: Dict[str, ctypes.CDLL] = {}

# libraries built together when either is first needed
SIDE_BY_SIDE = ("bitunpack", "group_agg", "filter_sum", "keyed_add")


def nvcc_path() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    if home and os.path.exists(os.path.join(home, "bin", "nvcc")):
        return os.path.join(home, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def _compile(name: str, src: str, out: str) -> None:
    os.makedirs(BUILD, exist_ok=True)
    # compile to a temporary name, then rename: a concurrent loader never
    # sees a half-written library
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD)
    os.close(fd)
    try:
        cmd = [nvcc_path(), *NVCC_FLAGS, "-o", tmp, src]
        with obs.span("strawboat.kernel.build", kernel=name):
            obs.count("kernel.builds")
            proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed for {name} ({proc.returncode}):\n"
                f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}"
            )
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def load(name: str) -> ctypes.CDLL:
    """Compile ``csrc/<name>.cu`` if needed and return the loaded library."""
    with _lock:
        lock = _locks.setdefault(name, threading.Lock())
    with lock:
        lib = _libs.get(name)
        if lib is not None:
            return lib
        src = os.path.join(CSRC, f"{name}.cu")
        out = os.path.join(BUILD, f"lib{name}.so")
        if not os.path.exists(out) or os.path.getmtime(out) < os.path.getmtime(src):
            _compile(name, src, out)
        lib = ctypes.CDLL(out)
        _libs[name] = lib
        return lib


def load_all(names) -> None:
    """Build and load several libraries, their nvcc runs started together."""
    names = list(names)
    with cf.ThreadPoolExecutor(max_workers=max(len(names), 1)) as pool:
        for fut in [pool.submit(load, n) for n in names]:
            fut.result()


@functools.cache
def entry(name: str, symbol: str, argtypes: tuple):
    """C function ``symbol`` of ``csrc/<name>.cu`` with ``argtypes``,
    returning ``int`` (built at first use, with ``SIDE_BY_SIDE``'s other
    libraries when ``name`` is one of them)."""
    load_all(SIDE_BY_SIDE if name in SIDE_BY_SIDE else (name,))
    fn = getattr(load(name), symbol)
    fn.argtypes = list(argtypes)
    fn.restype = ctypes.c_int
    return fn

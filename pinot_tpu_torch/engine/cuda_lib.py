"""Build and load the package's hand-written CUDA kernels.

Each `csrc/<name>.cu` compiles with `nvcc` into a shared library with a plain
C interface, loaded with `ctypes`. The library lands in `pinot_tpu_torch/_build/`
under a name keyed by a hash of its source and the compiler flags, so an edited
source rebuilds and an unchanged one loads at once. The compiler's output, with
ptxas's registers, shared memory and spills for every kernel, is kept beside
the library (`build_log`, parsed by `ptxas_usage`). There is no fallback: a
missing `nvcc` or a failed build raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, Optional, Sequence

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC_DIR = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    """The CUDA compiler: $CUDA_HOME/bin/nvcc, else `nvcc` on PATH, else the
    toolkit's default install location. Raises when none exists."""
    candidates = []
    if os.environ.get("CUDA_HOME"):
        candidates.append(os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"))
    found = shutil.which("nvcc")
    if found:
        candidates.append(found)
    candidates.append("/usr/local/cuda/bin/nvcc")
    for c in candidates:
        if os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH): "
                       "the CUDA kernels cannot be built")


def _so_path(name: str) -> str:
    with open(os.path.join(SRC_DIR, f"{name}.cu"), "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return os.path.join(BUILD_DIR, f"lib{name}_{digest}.so")


def _compile(name: str, so: str) -> None:
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{so}.tmp.{os.getpid()}"
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", tmp, os.path.join(SRC_DIR, f"{name}.cu")]
    out = subprocess.run(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
    if out.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name}.cu (rc {out.returncode}):\n"
                           f"{out.stdout.decode(errors='replace')}")
    with open(f"{tmp}.log", "wb") as f:
        f.write(out.stdout)
    os.replace(f"{tmp}.log", f"{so}.log")
    os.replace(tmp, so)   # atomic: a concurrent loader sees a whole file


def build(names: Sequence[str]) -> None:
    """Compile every listed source that is not built yet: one nvcc process
    each, all started together."""
    todo = [(name, _so_path(name)) for name in names if not os.path.exists(_so_path(name))]
    if todo:
        with ThreadPoolExecutor(len(todo)) as pool:
            list(pool.map(lambda job: _compile(*job), todo))


def load(name: str) -> ctypes.CDLL:
    """The loaded library for `csrc/<name>.cu`, built on first use."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            so = _so_path(name)
            if not os.path.exists(so):
                _compile(name, so)
            lib = ctypes.CDLL(so)
            _libs[name] = lib
        return lib


def library_path(name: str) -> str:
    """The built shared library of `csrc/<name>.cu` (built first if need be)."""
    load(name)
    return _so_path(name)


def build_log(name: str) -> str:
    """nvcc's output from building `csrc/<name>.cu` (built first if need be)."""
    with open(f"{library_path(name)}.log", encoding="utf-8", errors="replace") as f:
        return f.read()


_PTXAS_ENTRY = re.compile(r"Compiling entry function '([^']+)'")
_PTXAS_FRAME = re.compile(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                          r"(\d+) bytes spill loads")
_PTXAS_USED = re.compile(r"Used (\d+) registers(?:.*?, (\d+) bytes smem)?")


def ptxas_usage(log: str) -> Dict[str, Dict[str, int]]:
    """Per kernel (mangled name) in a `-Xptxas -v` log: registers per thread,
    static shared memory bytes, stack frame and spill bytes."""
    usage: Dict[str, Dict[str, int]] = {}
    entry: Optional[str] = None
    for line in log.splitlines():
        m = _PTXAS_ENTRY.search(line)
        if m:
            entry = m.group(1)
            usage[entry] = {}
            continue
        if entry is None:
            continue
        m = _PTXAS_FRAME.search(line)
        if m:
            usage[entry].update(stack_bytes=int(m.group(1)), spill_store_bytes=int(m.group(2)),
                                spill_load_bytes=int(m.group(3)))
        m = _PTXAS_USED.search(line)
        if m:
            usage[entry].update(registers=int(m.group(1)),
                                static_smem_bytes=int(m.group(2) or 0))
    return usage

"""Build and load the port's CUDA kernels.

Each source under ``mma_tpu_torch/csrc/`` compiles with ``nvcc`` for
``sm_90a`` into a shared library with a plain C interface, which is
loaded with ``ctypes``. The build happens at first use, from the sources
in the checkout, into ``mma_tpu_torch/_build/`` (git-ignored). A library's
file name carries a hash of its source and flags, so an edited source
never loads a stale build. ``build_all`` starts one ``nvcc`` per source,
all at once.

A missing ``nvcc`` or a failed compile raises: nothing falls back to the
plain PyTorch versions.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from typing import Dict, List, Sequence

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
CSRC_DIR = os.path.join(_PKG_DIR, "csrc")
BUILD_DIR = os.path.join(_PKG_DIR, "_build")
SOURCES = ("fused_mma", "segment_minmax", "sampler")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_libs: Dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(cuda_home, "bin", "nvcc")
    if os.path.exists(path):
        return path
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built on this host")


def library_path(name: str) -> str:
    with open(os.path.join(CSRC_DIR, f"{name}.cu"), "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(NVCC_FLAGS).encode()).hexdigest()[:12]
    return os.path.join(BUILD_DIR, f"lib{name}.{digest}.so")


def _start(name: str):
    """Start compiling ``name`` unless its library exists.

    Returns ``(name, tmp_path, out_path, process)``, or None when built."""
    out = library_path(name)
    if os.path.exists(out):
        return None
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, os.path.join(CSRC_DIR, f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    return name, tmp, out, proc


def _finish(job) -> str:
    name, tmp, out, proc = job
    log, _ = proc.communicate()
    with open(os.path.join(BUILD_DIR, f"{name}.build.log"), "w") as f:
        f.write(log)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name}.cu:\n{log}")
    os.replace(tmp, out)  # atomic: readers see whole files
    return log


def build_all(names: Sequence[str] = SOURCES) -> List[str]:
    """Compile every source not yet built, in parallel; returns the nvcc
    logs (register and shared-memory use from ``-Xptxas -v``)."""
    jobs = [j for j in (_start(n) for n in names) if j is not None]
    return [_finish(j) for j in jobs]


def library(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/{name}.cu``, built on first use."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            build_all([name])
            lib = ctypes.CDLL(library_path(name))
            _libs[name] = lib
        return lib

"""ctypes binding to the port's native graph-op library, with NumPy fallbacks.

The port of the JAX package's ``mma_tpu/graph/native.py``, with the same
entry points, signatures and results. The C++ source is the port's own copy,
``mma_tpu_torch/csrc/graphops.cpp``: at first use it compiles with the host
``g++`` and ``native/Makefile``'s flags into ``mma_tpu_torch/_build/``, under
a file name that carries a hash of the source and the flags (as
``mma_tpu_torch.ops.cuda.build`` names the CUDA libraries), so an edited
source never loads a stale build. Nothing is written under ``native/``.

Without ``g++``, or when the compile fails, every entry point takes the
NumPy fallback, as the JAX package does; :func:`available` says which
backend runs. ``sample_layered`` has no fallback here: it returns None, and
the sampler then takes its own NumPy path.

The native calls release the interpreter lock (ctypes does so around every
foreign call), so a producer thread that samples overlaps the caller.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from typing import Optional, Tuple

import numpy as np

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(_PKG_DIR, "csrc", "graphops.cpp")
BUILD_DIR = os.path.join(_PKG_DIR, "_build")
# native/Makefile's CXXFLAGS.
CXX_FLAGS = ("-O3", "-march=native", "-fPIC", "-shared", "-std=c++17", "-Wall")
# The sampler keeps up to ``fanout`` picks per node in a stack buffer of 64.
MAX_FANOUT = 64

_lib: Optional[ctypes.CDLL] = None
_tried = False
_lock = threading.Lock()


def library_path() -> str:
    with open(SOURCE, "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(CXX_FLAGS).encode()).hexdigest()[:12]
    return os.path.join(BUILD_DIR, f"libgraphops.{digest}.so")


def _build(out: str) -> bool:
    """Compile the source into ``out``; False when there is no ``g++`` or the
    compile fails (the log stays beside the library)."""
    cxx = shutil.which("g++")
    if cxx is None:
        return False
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.{threading.get_ident()}.tmp"
    try:
        res = subprocess.run([cxx, *CXX_FLAGS, "-o", tmp, SOURCE],
                             capture_output=True, text=True, timeout=120)
    except (OSError, subprocess.TimeoutExpired):
        return False
    with open(os.path.join(BUILD_DIR, "graphops.build.log"), "w") as f:
        f.write(res.stdout + res.stderr)
    if res.returncode != 0:
        return False
    os.replace(tmp, out)  # atomic: concurrent builders and readers see whole files
    return True


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
    i64p = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
    f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
    c_i32, c_i64 = ctypes.c_int32, ctypes.c_int64
    sigs = {
        "mma_sort_edges": ([i32p, i32p, c_i64, c_i32, i32p, i32p, i32p], None),
        "mma_build_row_ptr": ([i32p, c_i64, c_i32, i32p], None),
        "mma_degrees": ([i32p, c_i64, c_i32, f32p], None),
        "mma_symmetrize": ([i32p, i32p, c_i64, c_i32, i32p, i32p], c_i64),
        "mma_balanced_row_cuts": ([i32p, c_i32, c_i32, i32p], None),
        "mma_partition_ldg": ([i64p, i32p, c_i32, c_i32, ctypes.c_float, i32p], None),
        "mma_sample_layered": ([
            i64p, i32p, c_i64,              # row_ptr, src_sorted, n_nodes
            i32p, c_i64,                    # seeds, n_seeds
            i32p, c_i32,                    # fanouts, n_hops
            ctypes.c_uint64, c_i32,         # rng_seed, n_threads
            i32p, i64p, i32p, i32p,         # out_nodes, hop_counts, src, dst
            c_i64, c_i64,                   # node_cap, edge_cap
        ], c_i64),
    }
    for name, (argtypes, restype) in sigs.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = restype
    return lib


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _tried
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        path = library_path()
        if not os.path.exists(path) and not _build(path):
            return None
        try:
            _lib = _bind(ctypes.CDLL(path))
        except (OSError, AttributeError):
            return None
        return _lib


def _check_ids(name: str, num_nodes: int, *ids: np.ndarray) -> None:
    """The native code indexes by these values: refuse any outside
    ``[0, num_nodes)`` before a pointer is passed (both backends)."""
    for a in ids:
        if len(a) and (a.min() < 0 or a.max() >= num_nodes):
            raise ValueError(f"{name}: node ids must lie in [0, {num_nodes}), "
                             f"got [{a.min()}, {a.max()}]")


def available() -> bool:
    """True when the native library runs; False means the NumPy fallbacks."""
    return _load() is not None


def sort_edges(src: np.ndarray, dst: np.ndarray, num_nodes: int
               ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Stable (dst-major, src-minor) sort; returns (src, dst, perm)."""
    src = np.ascontiguousarray(src, np.int32)
    dst = np.ascontiguousarray(dst, np.int32)
    _check_ids("sort_edges", num_nodes, src, dst)
    lib = _load()
    if lib is None or len(src) == 0:
        perm = np.lexsort((src, dst)).astype(np.int32)
        return src[perm], dst[perm], perm
    out_src = np.empty_like(src)
    out_dst = np.empty_like(dst)
    perm = np.empty_like(src)
    lib.mma_sort_edges(src, dst, len(src), num_nodes, out_src, out_dst, perm)
    return out_src, out_dst, perm


def build_row_ptr(dst_sorted: np.ndarray, num_nodes: int) -> np.ndarray:
    dst_sorted = np.ascontiguousarray(dst_sorted, np.int32)
    _check_ids("build_row_ptr", num_nodes, dst_sorted)
    lib = _load()
    if lib is None:
        counts = np.bincount(dst_sorted, minlength=num_nodes)
        row_ptr = np.zeros(num_nodes + 1, np.int32)
        np.cumsum(counts, out=row_ptr[1:])
        return row_ptr
    row_ptr = np.empty(num_nodes + 1, np.int32)
    lib.mma_build_row_ptr(dst_sorted, len(dst_sorted), num_nodes, row_ptr)
    return row_ptr


def degrees(dst: np.ndarray, num_nodes: int) -> np.ndarray:
    dst = np.ascontiguousarray(dst, np.int32)
    _check_ids("degrees", num_nodes, dst)
    lib = _load()
    if lib is None:
        return np.bincount(dst, minlength=num_nodes).astype(np.float32)
    deg = np.empty(num_nodes, np.float32)
    lib.mma_degrees(dst, len(dst), num_nodes, deg)
    return deg


def symmetrize(src: np.ndarray, dst: np.ndarray, num_nodes: int
               ) -> Tuple[np.ndarray, np.ndarray]:
    """Undirected-graph semantics: both directions, no dups/self-loops."""
    src = np.ascontiguousarray(src, np.int32)
    dst = np.ascontiguousarray(dst, np.int32)
    lib = _load()
    if lib is None or len(src) == 0:
        keep = src != dst
        pairs = np.concatenate(
            [np.stack([dst[keep], src[keep]], 1), np.stack([src[keep], dst[keep]], 1)]
        )
        pairs = np.unique(pairs, axis=0)
        return pairs[:, 1].copy(), pairs[:, 0].copy()
    out_src = np.empty(2 * len(src), np.int32)
    out_dst = np.empty(2 * len(src), np.int32)
    m = lib.mma_symmetrize(src, dst, len(src), num_nodes, out_src, out_dst)
    return out_src[:m].copy(), out_dst[:m].copy()


def sample_layered(row_ptr: np.ndarray, src_sorted: np.ndarray, seeds: np.ndarray,
                   fanouts, rng_seed: int, n_threads: int, node_cap: int, edge_cap: int):
    """Multithreaded layered neighbour sample (``mma_sample_layered``).

    Returns ``(nodes, hop_counts, src_local, dst_local)``: global node ids
    in discovery order (seeds, then each hop's new nodes), per-hop new-node
    counts and LOCAL edge endpoints. The same seed gives the same sample at
    any thread count. Returns None when the native library is unavailable
    or a fanout exceeds 64 (the kernel's per-node stack buffer); raises
    ``ValueError`` on cap overflow.
    """
    lib = _load()
    fanouts = np.ascontiguousarray(fanouts, np.int32)
    if lib is None or len(fanouts) == 0 or fanouts.max(initial=0) > MAX_FANOUT:
        return None
    row_ptr = np.ascontiguousarray(row_ptr, np.int64)
    src_sorted = np.ascontiguousarray(src_sorted, np.int32)
    seeds = np.ascontiguousarray(seeds, np.int32)
    _check_ids("sample_layered", len(row_ptr) - 1, seeds)
    out_nodes = np.empty(node_cap, np.int32)
    hop_counts = np.empty(len(fanouts) + 1, np.int64)
    out_src = np.empty(edge_cap, np.int32)
    out_dst = np.empty(edge_cap, np.int32)
    n_edges = lib.mma_sample_layered(
        row_ptr, src_sorted, len(row_ptr) - 1,
        seeds, len(seeds), fanouts, len(fanouts),
        ctypes.c_uint64(rng_seed & (2**64 - 1)), n_threads,
        out_nodes, hop_counts, out_src, out_dst,
        node_cap, edge_cap,
    )
    if n_edges == -1:
        raise ValueError(f"sample overflowed node_cap={node_cap}")
    if n_edges == -2:
        raise ValueError(f"sample overflowed edge_cap={edge_cap}")
    n_nodes = int(hop_counts.sum())
    return out_nodes[:n_nodes], hop_counts, out_src[:n_edges], out_dst[:n_edges]


def partition_ldg(row_ptr: np.ndarray, src_sorted: np.ndarray,
                  num_parts: int, slack: float = 1.05):
    """Locality-aware streaming partition (LDG) over a symmetric CSR.

    Returns an (n,) int32 part assignment, or None when the native library
    is unavailable (callers fall back to contiguous cuts)."""
    lib = _load()
    if lib is None:
        return None
    row_ptr = np.ascontiguousarray(row_ptr, np.int64)
    src_sorted = np.ascontiguousarray(src_sorted, np.int32)
    n = len(row_ptr) - 1
    part = np.empty(n, np.int32)
    lib.mma_partition_ldg(row_ptr, src_sorted, n, num_parts, ctypes.c_float(slack), part)
    return part


def balanced_row_cuts(row_ptr: np.ndarray, num_parts: int) -> np.ndarray:
    """Contiguous row cut points giving ~equal edges per part."""
    row_ptr = np.ascontiguousarray(row_ptr, np.int32)
    n = len(row_ptr) - 1
    lib = _load()
    if lib is None:
        total = int(row_ptr[-1])
        targets = (total * np.arange(1, num_parts)) // num_parts
        cuts = np.searchsorted(row_ptr[:-1], targets, side="left").astype(np.int32)
        return np.concatenate([[0], cuts, [n]]).astype(np.int32)
    cuts = np.empty(num_parts + 1, np.int32)
    lib.mma_balanced_row_cuts(row_ptr, n, num_parts, cuts)
    return cuts

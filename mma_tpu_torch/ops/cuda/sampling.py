"""The launcher of the neighbour sampler's picks kernel (``csrc/sampler.cu``).

:func:`sample_picks` is one hop of the native sampler's draw
(``mma_tpu_torch/graph/native.py::sample_picks``, whose host version is
its plain version) over a frontier held on the card; the relabel around it
is :mod:`mma_tpu_torch.data.device_sampling`.
"""

from __future__ import annotations

import ctypes

import torch

from mma_tpu_torch.ops.cuda import build
from mma_tpu_torch.ops.cuda.fused_mma import _check_launch, _stream
from mma_tpu_torch.utils.profiling import trace

LAUNCHES = {"sample_picks": 0}
MAX_FANOUT = 64

_P = ctypes.c_void_p
_I = ctypes.c_int
_configured = False


def _lib() -> ctypes.CDLL:
    global _configured
    lib = build.library("sampler")
    if not _configured:
        lib.mma_cuda_error_string.argtypes = [_I]
        lib.mma_cuda_error_string.restype = ctypes.c_char_p
        lib.mma_sample_picks.argtypes = [_P, _P, _P, _P, _I, _I, _I, _P, _P, _P, _P]
        lib.mma_sample_picks.restype = _I
        _configured = True
    return lib


def sample_picks(row_ptr: torch.Tensor, src_sorted: torch.Tensor, frontier: torch.Tensor,
                 n_frontier: torch.Tensor, fanout: int, hop: int, rng_seed: torch.Tensor):
    """``(picks, count)`` on the card: ``picks`` ``(len(frontier), fanout)``
    int32, each of the first ``n_frontier`` nodes' sorted distinct picked
    sources, -1 after them; ``count`` ``(len(frontier),)`` int32.
    ``row_ptr`` ``(N + 1,)`` int64 and ``src_sorted`` ``(E,)`` int32 are the
    dst-sorted CSR, ``frontier`` int32 global ids; ``n_frontier`` and
    ``rng_seed`` (the stream's seed, its bits as uint64) one-element int64
    tensors on the card, not read back, so that the launch can be captured
    in a CUDA graph."""
    key = "sample_picks"
    with trace(f"kernel.{key}"):
        want = {"row_ptr": (row_ptr, torch.int64), "src_sorted": (src_sorted, torch.int32),
                "frontier": (frontier, torch.int32), "n_frontier": (n_frontier, torch.int64),
                "rng_seed": (rng_seed, torch.int64)}
        for name, (t, dtype) in want.items():
            if t.device.type != "cuda" or t.dtype != dtype or not t.is_contiguous():
                raise ValueError(f"{key}: {name} must be a contiguous {dtype} tensor on the "
                                 f"card, got {t.dtype} on {t.device}")
        if n_frontier.numel() != 1 or rng_seed.numel() != 1 or frontier.ndim != 1:
            raise ValueError(f"{key}: frontier must be 1-D, n_frontier and rng_seed one value")
        if not 1 <= fanout <= MAX_FANOUT:
            raise ValueError(f"{key}: fanout must lie in [1, {MAX_FANOUT}], got {fanout}")
        n = frontier.shape[0]
        picks = torch.empty((n, fanout), dtype=torch.int32, device=frontier.device)
        count = torch.empty(n, dtype=torch.int32, device=frontier.device)
        lib = _lib()
        with torch.cuda.device(frontier.device):
            err = lib.mma_sample_picks(row_ptr.data_ptr(), src_sorted.data_ptr(),
                                       frontier.data_ptr(), n_frontier.data_ptr(), n, fanout, hop,
                                       rng_seed.data_ptr(), picks.data_ptr(), count.data_ptr(),
                                       _stream())
        _check_launch(lib, err, key)
        LAUNCHES[key] += 1
        return picks, count

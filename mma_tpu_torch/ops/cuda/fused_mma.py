"""Segment-sum and lean MMA edge-program kernels, with their plain versions.

Two hand-written CUDA kernels (``mma_tpu_torch/csrc/fused_mma.cu``) reduce
over the dst-sorted CSR of a :class:`~mma_tpu_torch.graph.Graph`:

- :func:`segment_sum_csr` replaces the JAX package's ``_sum_kernel``:
  ``out[i] = Σ_{e ∈ [row_ptr[i], row_ptr[i+1])} data[e]``.
- :func:`edge_program_lean` replaces ``_program_fwd_lean_kernel``:
  ``S[i] = Σ_{dst_e=i} act(c[i] + h[src_e] @ W_bot) ⊙ tile(h[src_e], K)``.

Each wrapper takes the plain PyTorch version for CPU tensors and launches
its kernel for CUDA tensors; any other device, dtype, shape or layout
raises. ``LAUNCHES`` counts kernel launches, so a run can show that its
path went through the kernels. Gradients are not wired yet: a CUDA input
that requires grad raises.
"""

from __future__ import annotations

import ctypes

import torch

from mma_tpu_torch.ops.cuda import build

LAUNCHES = {"segment_sum": 0, "edge_program_lean": 0}

# Widths the edge-program kernel takes: W_bot's 128-lane tile lives in
# shared memory (F · 512 B) and each thread owns 4 lanes.
MAX_F = 128
MAX_KF = 512

_P = ctypes.c_void_p
_I = ctypes.c_int
_configured = False


def _lib() -> ctypes.CDLL:
    global _configured
    lib = build.library("fused_mma")
    if not _configured:
        lib.mma_cuda_error_string.argtypes = [_I]
        lib.mma_cuda_error_string.restype = ctypes.c_char_p
        lib.mma_segment_sum_csr.argtypes = [_P, _P, _P, _I, _I, _I, _P]
        lib.mma_segment_sum_csr.restype = _I
        lib.mma_edge_program_lean_fwd.argtypes = [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _P]
        lib.mma_edge_program_lean_fwd.restype = _I
        _configured = True
    return lib


def _check_launch(lib: ctypes.CDLL, err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(
            f"{name} kernel launch failed: {lib.mma_cuda_error_string(err).decode()}"
        )


def _check_cuda_inputs(name: str, **tensors: torch.Tensor) -> None:
    """Validate grad/device/contiguity of a kernel's inputs."""
    if any(t.requires_grad for t in tensors.values()):
        raise NotImplementedError("backward kernels land with the training slice")
    devices = {t.device for t in tensors.values()}
    if len(devices) != 1:
        raise ValueError(f"{name}: inputs on several devices {sorted(map(str, devices))}")
    (dev,) = devices
    if dev.type != "cuda":
        raise ValueError(f"{name}: the kernel takes CUDA tensors, got {dev}")
    for arg, t in tensors.items():
        if not t.is_contiguous():
            raise ValueError(f"{name}: {arg} must be contiguous")


def _check_dtype(name: str, arg: str, t: torch.Tensor, dtype: torch.dtype) -> None:
    if t.dtype != dtype:
        raise ValueError(f"{name}: {arg} must be {dtype}, got {t.dtype}")


def _row_ids(row_ptr: torch.Tensor) -> torch.Tensor:
    """Destination row of every edge the CSR covers (``dst`` of a sorted list)."""
    n = row_ptr.shape[0] - 1
    counts = (row_ptr[1:] - row_ptr[:-1]).long()
    return torch.repeat_interleave(
        torch.arange(n, device=row_ptr.device), counts
    )


# ---------------------------------------------------------------- kernel 1

def segment_sum_reference(data: torch.Tensor, row_ptr: torch.Tensor) -> torch.Tensor:
    """Plain version of :func:`segment_sum_csr`: ``(N, C)`` float32."""
    n = row_ptr.shape[0] - 1
    lo, hi = int(row_ptr[0]), int(row_ptr[-1])
    out = torch.zeros((n, data.shape[1]), dtype=torch.float32, device=data.device)
    return out.index_add_(0, _row_ids(row_ptr), data[lo:hi].float())


def _segment_sum_kernel(data: torch.Tensor, row_ptr: torch.Tensor) -> torch.Tensor:
    name = "segment_sum_csr"
    _check_cuda_inputs(name, data=data, row_ptr=row_ptr)
    _check_dtype(name, "data", data, torch.float32)
    _check_dtype(name, "row_ptr", row_ptr, torch.int32)
    if data.ndim != 2 or row_ptr.ndim != 1:
        raise ValueError(f"{name}: data must be (E, C) and row_ptr (N+1,)")
    n, ch = row_ptr.shape[0] - 1, data.shape[1]
    out = torch.empty((n, ch), dtype=torch.float32, device=data.device)
    vec4 = ch % 4 == 0 and data.data_ptr() % 16 == 0
    lib = _lib()
    with torch.cuda.device(data.device):
        err = lib.mma_segment_sum_csr(
            data.data_ptr(), row_ptr.data_ptr(), out.data_ptr(), n, ch, int(vec4),
            torch.cuda.current_stream().cuda_stream,
        )
    _check_launch(lib, err, name)
    LAUNCHES["segment_sum"] += 1
    return out


def segment_sum_csr(data: torch.Tensor, row_ptr: torch.Tensor) -> torch.Tensor:
    """Sum ``data`` (E, C) over each CSR row of ``row_ptr`` → (N, C) float32.

    ``row_ptr`` (N+1,) int32 must be non-decreasing with ``row_ptr[-1] <=
    E`` (a graph builder's CSR; the kernel does not check its values).
    Deterministic; rows without edges give 0.
    """
    if data.device.type == "cpu" and row_ptr.device.type == "cpu":
        return segment_sum_reference(data, row_ptr)
    return _segment_sum_kernel(data, row_ptr)


# ---------------------------------------------------------------- kernel 2

def edge_program_lean_reference(c, w_bot, h, pattern, src, row_ptr):
    """Plain version of :func:`edge_program_lean`: ``(N, K·F)`` float32."""
    f, kf = w_bot.shape
    ids = _row_ids(row_ptr)
    lo, hi = int(row_ptr[0]), int(row_ptr[-1])
    h_src = h[src[lo:hi].long()]  # (E, F)
    logits = c[ids] + h_src @ w_bot  # (E, K·F)
    mask = torch.where(pattern.bool(), torch.sigmoid(logits), logits)
    msg = mask * h_src.repeat(1, kf // f)
    out = torch.zeros((c.shape[0], kf), dtype=torch.float32, device=c.device)
    return out.index_add_(0, ids, msg.float())


def _edge_program_lean_kernel(c, w_bot, h, pattern, src, row_ptr):
    name = "edge_program_lean_fwd"
    _check_cuda_inputs(name, c=c, w_bot=w_bot, h=h, pattern=pattern, src=src,
                       row_ptr=row_ptr)
    for arg, t in (("c", c), ("w_bot", w_bot), ("h", h), ("pattern", pattern)):
        _check_dtype(name, arg, t, torch.float32)
    for arg, t in (("src", src), ("row_ptr", row_ptr)):
        _check_dtype(name, arg, t, torch.int32)
    n, f = h.shape
    kf = w_bot.shape[1]
    if (c.shape != (n, kf) or w_bot.shape != (f, kf) or pattern.shape != (kf,)
            or row_ptr.shape != (n + 1,) or src.ndim != 1):
        raise ValueError(
            f"{name}: shapes c{tuple(c.shape)} w_bot{tuple(w_bot.shape)} "
            f"h{tuple(h.shape)} pattern{tuple(pattern.shape)} src{tuple(src.shape)} "
            f"row_ptr{tuple(row_ptr.shape)} do not fit together"
        )
    if f % 4 or f > MAX_F or kf % f or kf > MAX_KF:
        raise ValueError(
            f"{name}: takes F % 4 == 0, F <= {MAX_F}, K·F <= {MAX_KF}; got F={f}, K·F={kf}"
        )
    if c.data_ptr() % 16:
        raise ValueError(f"{name}: c must be 16-byte aligned")
    out = torch.empty((n, kf), dtype=torch.float32, device=c.device)
    lib = _lib()
    with torch.cuda.device(c.device):
        err = lib.mma_edge_program_lean_fwd(
            c.data_ptr(), h.data_ptr(), w_bot.data_ptr(), pattern.data_ptr(),
            src.data_ptr(), row_ptr.data_ptr(), out.data_ptr(), n, f, kf,
            torch.cuda.current_stream().cuda_stream,
        )
    _check_launch(lib, err, name)
    LAUNCHES["edge_program_lean"] += 1
    return out


def edge_program_lean(c: torch.Tensor, w_bot: torch.Tensor, h: torch.Tensor,
                      pattern: torch.Tensor, src: torch.Tensor,
                      row_ptr: torch.Tensor) -> torch.Tensor:
    """Lean MMA edge program over the dst-sorted CSR.

    ``S[i] = Σ_{e ∈ row i} act(c[i] + h[src_e] @ W_bot) ⊙ tile(h[src_e], K)``
    where ``act`` is σ on lanes with ``pattern == 1`` and the identity
    elsewhere. ``c``: (N, K·F); ``w_bot``: (F, K·F); ``h``: (N, F);
    ``pattern``: (K·F,) float 0/1; ``src``: (E,) int32; ``row_ptr``:
    (N+1,) int32, non-decreasing, with every ``src`` it covers in ``[0, N)``
    (a graph builder's CSR; the kernel does not check the values).
    Aggregator ``k`` owns lanes ``[k·F, (k+1)·F)``. The kernel gathers
    ``h[src]`` itself; no (E, K·F) tensor is stored.
    """
    tensors = (c, w_bot, h, pattern, src, row_ptr)
    if all(t.device.type == "cpu" for t in tensors):
        return edge_program_lean_reference(*tensors)
    return _edge_program_lean_kernel(*tensors)

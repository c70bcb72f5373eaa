"""Segmented min/max kernels of the ZINC convolution, with their plain versions.

Four hand-written CUDA kernels (``mma_tpu_torch/csrc/segment_minmax.cu``)
reduce over the dst-sorted CSR of a :class:`~mma_tpu_torch.graph.Graph`
(``Graph.real_row_ptr``, which skips the padding edges):

- :func:`fused_segment_minmax` pairs kernel 4 (replaces the JAX package's
  ``_minmax_kernel``: per-row min and/or max of edge data, both ops in one
  pass) with kernel 5 (``_minmax_bwd_kernel``: each cotangent routed to the
  first edge equal to the optimum).
- :func:`fused_minmax_edge_program` pairs kernel 6 (``_minmax_prog_kernel``:
  ``x_e = m_e ⊙ (hg_e + c[dst_e])`` with the position-hash dropout mask
  ``m``, then min/max per row; ``x`` is never stored) with kernel 7
  (``_minmax_prog_bwd_kernel``: exact recompute, first-hit routing, ``dhg``
  and the dst-keyed ``dc``).

All four take float32 or bf16 edge operands (the conv's
``compute_dtype="bfloat16"``): kernels 4-5 a bf16 ``data``, kernels 6-7 a
bf16 ``c`` and ``hg`` (both of one dtype). The kernels read the bf16
values and compute in float32, as the JAX package's kernels do on bf16
inputs; the forward outputs stay float32 ``(N, P·C)``. The backward rounds
the cotangent to bf16 before routing it, as the JAX kernels' one-pass
select does (``passes = 1`` for bf16 data), and gives each gradient
(``grad``, ``dhg``, ``dc``) in its input's dtype, each float32 value
rounded once to nearest even. ``LAUNCHES`` counts the bf16 calls under
``"..._bf16"`` keys.

Ops follow aggregator order: output lanes ``[p·C, (p+1)·C)`` hold op ``p``.
Rows without edges give 0 (the reference's ``torch_scatter`` fill), so the
callers' ``where(deg > 0, ·, 0)`` of the JAX package is not needed.

Each kernel has a plain PyTorch version here (``*_reference``); a wrapper
takes it for CPU tensors and launches the kernel for CUDA tensors, and any
other device, dtype, shape or layout raises. ``LAUNCHES`` counts kernel
launches, so a run can show that its path went through the kernels. The
forwards of kernels 4 and 6 run as the ``torch.library`` operators
``mma_tpu_torch::segment_minmax`` and ``minmax_edge_program``
(``mma_tpu_torch.ops.cuda.library``).
"""

from __future__ import annotations

import ctypes
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from mma_tpu_torch.graph.container import Graph
from mma_tpu_torch.ops.cuda import build, library
from mma_tpu_torch.ops.cuda.fused_mma import (
    _bf16,
    _check_cuda_inputs,
    _check_dtype,
    _check_launch,
    _on_cpu,
    _round_bf16,
    _row_ids,
    _stream,
)
from mma_tpu_torch.ops.segment import segment_max, segment_min

# The bf16 variants count under their own "_bf16" keys.
LAUNCHES = {"segment_minmax": 0, "segment_minmax_bwd": 0, "minmax_prog": 0,
            "minmax_prog_bwd": 0, "segment_minmax_bf16": 0, "segment_minmax_bwd_bf16": 0,
            "minmax_prog_bf16": 0, "minmax_prog_bwd_bf16": 0}
# The edge operands of kernels 4-7 and the dtypes they take.
_EDGE_ARGS = ("data", "c", "hg")
_EDGE_DTYPES = (torch.float32, torch.bfloat16)

_P = ctypes.c_void_p
_I = ctypes.c_int
_I64 = ctypes.c_int64
_F = ctypes.c_float
_configured = False


def _lib() -> ctypes.CDLL:
    global _configured
    lib = build.library("segment_minmax")
    if not _configured:
        lib.mma_cuda_error_string.argtypes = [_I]
        lib.mma_cuda_error_string.restype = ctypes.c_char_p
        lib.mma_segment_minmax.argtypes = [_P, _P, _P, _I, _I, _I, _I, _I, _P]
        lib.mma_segment_minmax_bwd.argtypes = [_P, _P, _P, _P, _P, _I, _I64, _I, _I, _I, _P]
        lib.mma_minmax_prog.argtypes = [_P, _P, _P, _P, _P, _I, _I64, _I, _I, _I, _I, _F, _I,
                                        _P]
        lib.mma_minmax_prog_bwd.argtypes = [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I64, _I, _I,
                                            _I, _F, _I, _P]
        for fn in ("mma_segment_minmax", "mma_segment_minmax_bwd", "mma_minmax_prog",
                   "mma_minmax_prog_bwd"):
            getattr(lib, fn).restype = _I
        _configured = True
    return lib


def _check_ops(ops: Sequence[str]) -> Tuple[str, ...]:
    ops = tuple(ops)
    if not 1 <= len(ops) <= 2 or any(o not in ("min", "max") for o in ops):
        raise ValueError(f"ops must be one or two of 'min'/'max', got {ops}")
    return ops


def _max_bits(ops: Tuple[str, ...]) -> int:
    return sum(1 << p for p, o in enumerate(ops) if o == "max")


def _dropout_params(rate: float) -> Tuple[int, float]:
    """``(thresh, scale)`` of the hash mask: a lane is kept when its 31-bit
    hash is ≥ ``int(rate · 2³¹)`` and then scaled by ``f32(1 / (1 - rate))``."""
    if not 0.0 < rate < 1.0:
        raise ValueError(f"dropout rate must lie in (0, 1), got {rate}")
    return int(rate * 2147483648.0), float(np.float32(1.0 / (1.0 - rate)))


# ---------------------------------------------------------------- the hash

_MASK32 = 0xFFFFFFFF


def _mul32(x: torch.Tensor, m: int) -> torch.Tensor:
    """``x · m mod 2³²`` for int64 ``x`` in ``[0, 2³²)``, in 16-bit halves of
    ``m`` so that no int64 product overflows."""
    lo = x * (m & 0xFFFF)
    hi = ((x * (m >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _MASK32


def dropout_keep(seed: torch.Tensor, pos: torch.Tensor, lane: torch.Tensor,
                 rate: float) -> torch.Tensor:
    """The JAX package's ``_dropout_keep`` (``segment_minmax.py:170-192``),
    bit for bit: float32 ``keep / (1 - rate)`` from a murmur3-finalizer hash
    of ``(seed, pos, lane)``, broadcast over ``pos`` and ``lane``.

    The JAX version works in wrapping int32 and uint32; here every value is
    an int64 in ``[0, 2³²)`` (PyTorch has no CPU ``>>`` for uint32), masked
    after each step, with the products taken in halves (:func:`_mul32`).
    """
    thresh, scale = _dropout_params(rate)
    seed = seed.reshape(()).long()
    x = (_mul32(pos.long() & _MASK32, 0x9E3779B9) + _mul32(lane.long() & _MASK32, 0x85EBCA6B)
         + (seed & _MASK32)) & _MASK32
    x = x ^ (x >> 16)
    x = _mul32(x, 0x7FEB352D)
    x = x ^ (x >> 15)
    x = _mul32(x, 0x846CA68B)
    x = x ^ (x >> 16)
    keep = (x & 0x7FFFFFFF) >= thresh
    return torch.where(keep, torch.tensor(scale, dtype=torch.float32, device=x.device),
                       torch.tensor(0.0, dtype=torch.float32, device=x.device))


# ------------------------------------------------------------ plain versions

def _covered(row_ptr: torch.Tensor):
    lo, hi = int(row_ptr[0]), int(row_ptr[-1])
    return lo, hi, _row_ids(row_ptr)


def _reduce_rows(x: torch.Tensor, ids: torch.Tensor, n: int, ops) -> torch.Tensor:
    return torch.cat([(segment_max if op == "max" else segment_min)(x, ids, n) for op in ops],
                     dim=1)


def _route_first_hit(x: torch.Tensor, ids: torch.Tensor, lo: int, out: torch.Tensor,
                     ct: torch.Tensor, ops) -> torch.Tensor:
    """``Σ_p ct_p[row]`` on the first edge of each (row, channel) whose
    value equals ``out_p[row]``, 0 elsewhere: (E_covered, C) float32 from
    the float32 values ``x``."""
    n_cov, ch = x.shape
    pos = torch.arange(lo, lo + n_cov, device=x.device)[:, None].expand(n_cov, ch)
    idx = ids[:, None].expand(n_cov, ch)
    none = torch.full((), lo + n_cov, device=x.device)
    grad = torch.zeros_like(x)
    for p in range(len(ops)):
        target = out[:, p * ch:(p + 1) * ch].index_select(0, ids)
        hit = x == target
        first = torch.full((out.shape[0], ch), lo + n_cov, device=x.device).scatter_reduce_(
            0, idx, torch.where(hit, pos, none), "amin", include_self=True)
        routed = hit & (pos == first.index_select(0, ids))
        grad = grad + torch.where(routed, ct[:, p * ch:(p + 1) * ch].index_select(0, ids), 0.0)
    return grad


def _cotangent(ct: torch.Tensor, edge_dtype: torch.dtype) -> torch.Tensor:
    """The cotangent the backward routes: rounded to bf16 for bf16 edge
    operands, as the JAX kernels' one-pass select rounds it."""
    return _round_bf16(ct) if edge_dtype == torch.bfloat16 else ct


def segment_minmax_reference(data: torch.Tensor, row_ptr: torch.Tensor,
                             ops: Sequence[str]) -> torch.Tensor:
    """Plain version of kernel 4: ``(N, P·C)`` float32 (of float32 or bf16
    ``data``)."""
    ops = _check_ops(ops)
    lo, hi, ids = _covered(row_ptr)
    return _reduce_rows(data[lo:hi].float(), ids, row_ptr.shape[0] - 1, ops)


def segment_minmax_bwd_reference(data: torch.Tensor, row_ptr: torch.Tensor,
                                 ops: Sequence[str], out: torch.Tensor,
                                 ct: torch.Tensor) -> torch.Tensor:
    """Plain version of kernel 5: the (E, C) gradient of ``data``, in its
    dtype."""
    ops = _check_ops(ops)
    lo, hi, ids = _covered(row_ptr)
    grad = torch.zeros(data.shape, dtype=data.dtype, device=data.device)
    grad[lo:hi] = _route_first_hit(data[lo:hi].float(), ids, lo, out,
                                   _cotangent(ct, data.dtype), ops).to(data.dtype)
    return grad


def _messages(c, hg, row_ptr, seed, rate):
    """The float32 messages ``m ⊙ (hg + c[dst])`` of the covered edges (the
    add and the mask product in float32, on bf16 operands too)."""
    lo, hi, ids = _covered(row_ptr)
    x = hg[lo:hi].float() + c.index_select(0, ids).float()
    m = None
    if seed is not None:
        pos = torch.arange(lo, hi, device=hg.device)[:, None]
        lane = torch.arange(hg.shape[1], device=hg.device)[None, :]
        m = dropout_keep(seed, pos, lane, rate)
        x = x * m
    return x, m, lo, hi, ids


def minmax_edge_program_reference(c: torch.Tensor, hg: torch.Tensor, row_ptr: torch.Tensor,
                                  ops: Sequence[str], seed: Optional[torch.Tensor] = None,
                                  rate: float = 0.5) -> torch.Tensor:
    """Plain version of kernel 6: ``(N, P·C)`` float32 (of float32 or bf16
    ``c`` and ``hg``)."""
    ops = _check_ops(ops)
    x, _, _, _, ids = _messages(c, hg, row_ptr, seed, rate)
    return _reduce_rows(x, ids, row_ptr.shape[0] - 1, ops)


def minmax_edge_program_bwd_reference(c: torch.Tensor, hg: torch.Tensor,
                                      row_ptr: torch.Tensor, ops: Sequence[str],
                                      seed: Optional[torch.Tensor], rate: float,
                                      out: torch.Tensor, ct: torch.Tensor
                                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of kernel 7: ``(dhg (E, C), dc (N, C))`` in the dtypes
    of ``hg`` and ``c``."""
    ops = _check_ops(ops)
    x, m, lo, hi, ids = _messages(c, hg, row_ptr, seed, rate)
    g = _route_first_hit(x, ids, lo, out, _cotangent(ct, hg.dtype), ops)
    if m is not None:
        g = g * m
    dhg = torch.zeros(hg.shape, dtype=hg.dtype, device=hg.device)
    dhg[lo:hi] = g.to(hg.dtype)
    dc = torch.zeros(c.shape, dtype=torch.float32, device=c.device).index_add_(0, ids, g)
    return dhg, dc.to(c.dtype)


# ----------------------------------------------------------------- kernels

def _check_rows(name, row_ptr, n_rows, **tensors):
    """Devices, layouts and dtypes: ``row_ptr`` and ``seed`` int32, the edge
    operands (``data``, ``c``, ``hg``) float32 or bf16 and of one dtype,
    the rest float32."""
    _check_dtype(name, "row_ptr", row_ptr, torch.int32)
    for arg, t in tensors.items():
        _check_dtype(name, arg, t, *((torch.int32,) if arg == "seed" else
                                     _EDGE_DTYPES if arg in _EDGE_ARGS else (torch.float32,)))
    edge = {tensors[a].dtype for a in _EDGE_ARGS if a in tensors}
    if len(edge) > 1:
        raise ValueError(f"{name}: c and hg must share a dtype, got {sorted(map(str, edge))}")
    _check_cuda_inputs(name, row_ptr=row_ptr, **tensors)
    if row_ptr.ndim != 1 or row_ptr.shape[0] != n_rows + 1:
        raise ValueError(f"{name}: row_ptr must be ({n_rows + 1},), got {tuple(row_ptr.shape)}")


def _check_pc(name, ops, n_rows, ch, **tensors):
    for arg, t in tensors.items():
        if tuple(t.shape) != (n_rows, len(ops) * ch):
            raise ValueError(f"{name}: {arg} must be {(n_rows, len(ops) * ch)}, "
                             f"got {tuple(t.shape)}")


def _segment_minmax_kernel(data, row_ptr, ops):
    name = "segment_minmax"
    if data.ndim != 2:
        raise ValueError(f"{name}: data must be (E, C)")
    n, ch = row_ptr.shape[0] - 1, data.shape[1]
    _check_rows(name, row_ptr, n, data=data)
    out = torch.empty((n, len(ops) * ch), dtype=torch.float32, device=data.device)
    lib = _lib()
    with torch.cuda.device(data.device):
        err = lib.mma_segment_minmax(data.data_ptr(), row_ptr.data_ptr(), out.data_ptr(), n,
                                     ch, len(ops), _max_bits(ops), _bf16(data), _stream())
    _check_launch(lib, err, name)
    LAUNCHES["segment_minmax_bf16" if _bf16(data) else "segment_minmax"] += 1
    return out


def _segment_minmax_bwd_kernel(data, row_ptr, ops, out, ct):
    name = "segment_minmax_bwd"
    n, ch = row_ptr.shape[0] - 1, data.shape[1]
    _check_rows(name, row_ptr, n, data=data, out=out, ct=ct)
    _check_pc(name, ops, n, ch, out=out, ct=ct)
    grad = torch.empty(data.shape, dtype=data.dtype, device=data.device)
    lib = _lib()
    with torch.cuda.device(data.device):
        err = lib.mma_segment_minmax_bwd(data.data_ptr(), row_ptr.data_ptr(), out.data_ptr(),
                                         ct.data_ptr(), grad.data_ptr(), n, data.shape[0], ch,
                                         len(ops), _bf16(data), _stream())
    _check_launch(lib, err, name)
    LAUNCHES["segment_minmax_bwd_bf16" if _bf16(data) else "segment_minmax_bwd"] += 1
    return grad


def _check_program(name, c, hg, row_ptr, seed, **extra):
    if c.ndim != 2 or hg.ndim != 2 or c.shape[1] != hg.shape[1]:
        raise ValueError(f"{name}: c (N, C) and hg (E, C) must share C, got "
                         f"{tuple(c.shape)} and {tuple(hg.shape)}")
    n = c.shape[0]
    tensors = dict(c=c, hg=hg, **extra)
    if seed is not None:
        if seed.shape != (1,):
            raise ValueError(f"{name}: seed must be (1,) int32, got {tuple(seed.shape)}")
        tensors["seed"] = seed
    _check_rows(name, row_ptr, n, **tensors)
    return n, c.shape[1]


def _minmax_prog_kernel(c, hg, row_ptr, ops, seed, rate):
    name = "minmax_prog"
    n, ch = _check_program(name, c, hg, row_ptr, seed)
    thresh, scale = _dropout_params(rate) if seed is not None else (0, 1.0)
    out = torch.empty((n, len(ops) * ch), dtype=torch.float32, device=c.device)
    lib = _lib()
    with torch.cuda.device(c.device):
        # hg's rows bound the CSR's edges: with N they fix the kernel's
        # tiles from shapes alone (no host sync).
        err = lib.mma_minmax_prog(c.data_ptr(), hg.data_ptr(), row_ptr.data_ptr(),
                                  None if seed is None else seed.data_ptr(), out.data_ptr(),
                                  n, hg.shape[0], ch, len(ops), _max_bits(ops), thresh, scale,
                                  _bf16(hg), _stream())
    _check_launch(lib, err, name)
    LAUNCHES["minmax_prog_bf16" if _bf16(hg) else "minmax_prog"] += 1
    return out


def _minmax_prog_bwd_kernel(c, hg, row_ptr, ops, seed, rate, out, ct):
    name = "minmax_prog_bwd"
    n, ch = _check_program(name, c, hg, row_ptr, seed, out=out, ct=ct)
    _check_pc(name, ops, n, ch, out=out, ct=ct)
    thresh, scale = _dropout_params(rate) if seed is not None else (0, 1.0)
    dhg = torch.empty(hg.shape, dtype=hg.dtype, device=c.device)
    dc = torch.empty(c.shape, dtype=c.dtype, device=c.device)
    lib = _lib()
    with torch.cuda.device(c.device):
        err = lib.mma_minmax_prog_bwd(c.data_ptr(), hg.data_ptr(), row_ptr.data_ptr(),
                                      None if seed is None else seed.data_ptr(),
                                      out.data_ptr(), ct.data_ptr(), dhg.data_ptr(),
                                      dc.data_ptr(), n, hg.shape[0], ch, len(ops), thresh,
                                      scale, _bf16(hg), _stream())
    _check_launch(lib, err, name)
    LAUNCHES["minmax_prog_bwd_bf16" if _bf16(hg) else "minmax_prog_bwd"] += 1
    return dhg, dc


# --------------------------------------------------------------- dispatch

def _segment_minmax(data, row_ptr, ops):
    """Kernel 4's operator's CPU implementation: the plain version for CPU
    tensors."""
    ops = _check_ops(ops)
    if _on_cpu(data, row_ptr):
        return segment_minmax_reference(data, row_ptr, ops)
    return _segment_minmax_kernel(data, row_ptr, ops)


_segment_minmax_op = library.define(
    "segment_minmax(Tensor data, Tensor row_ptr, str[] ops) -> Tensor",
    cpu=_segment_minmax,
    cuda=lambda data, row_ptr, ops: _segment_minmax_kernel(data, row_ptr, _check_ops(ops)),
    fake=lambda data, row_ptr, ops: data.new_empty(
        (row_ptr.shape[0] - 1, len(ops) * data.shape[1]), dtype=torch.float32),
)


def segment_minmax(data, row_ptr, ops):
    """Kernel 4 (``mma_tpu_torch::segment_minmax``), or its plain version
    for CPU tensors."""
    return _segment_minmax_op(data, row_ptr, list(_check_ops(ops)))


def segment_minmax_bwd(data, row_ptr, ops, out, ct):
    """Kernel 5, or its plain version for CPU tensors."""
    ops = _check_ops(ops)
    if _on_cpu(data, row_ptr, out, ct):
        return segment_minmax_bwd_reference(data, row_ptr, ops, out, ct)
    return _segment_minmax_bwd_kernel(data, row_ptr, ops, out, ct)


def _minmax_edge_program(c, hg, row_ptr, ops, seed=None, rate=0.5):
    """Kernel 6's operator's CPU implementation: the plain version for CPU
    tensors."""
    ops = _check_ops(ops)
    if _on_cpu(c, hg, row_ptr, seed):
        return minmax_edge_program_reference(c, hg, row_ptr, ops, seed, rate)
    return _minmax_prog_kernel(c, hg, row_ptr, ops, seed, rate)


_minmax_edge_program_op = library.define(
    "minmax_edge_program(Tensor c, Tensor hg, Tensor row_ptr, str[] ops, Tensor? seed=None, "
    "float rate=0.5) -> Tensor",
    cpu=_minmax_edge_program,
    cuda=lambda c, hg, row_ptr, ops, seed=None, rate=0.5: _minmax_prog_kernel(
        c, hg, row_ptr, _check_ops(ops), seed, rate),
    fake=lambda c, hg, row_ptr, ops, seed=None, rate=0.5: c.new_empty(
        (c.shape[0], len(ops) * c.shape[1]), dtype=torch.float32),
)


def minmax_edge_program(c, hg, row_ptr, ops, seed=None, rate=0.5):
    """Kernel 6 (``mma_tpu_torch::minmax_edge_program``), or its plain
    version for CPU tensors."""
    return _minmax_edge_program_op(c, hg, row_ptr, list(_check_ops(ops)), seed, float(rate))


def minmax_edge_program_bwd(c, hg, row_ptr, ops, seed, rate, out, ct):
    """Kernel 7, or its plain version for CPU tensors."""
    ops = _check_ops(ops)
    if _on_cpu(c, hg, row_ptr, seed, out, ct):
        return minmax_edge_program_bwd_reference(c, hg, row_ptr, ops, seed, rate, out, ct)
    return _minmax_prog_bwd_kernel(c, hg, row_ptr, ops, seed, rate, out, ct)


class _SegmentMinmax(torch.autograd.Function):
    @staticmethod
    def forward(ctx, data, row_ptr, ops):
        out = segment_minmax(data, row_ptr, ops)
        ctx.save_for_backward(data, row_ptr, out)
        ctx.ops = ops
        return out

    @staticmethod
    def backward(ctx, ct):
        data, row_ptr, out = ctx.saved_tensors
        return segment_minmax_bwd(data, row_ptr, ctx.ops, out, ct.contiguous()), None, None


class _MinmaxEdgeProgram(torch.autograd.Function):
    @staticmethod
    def forward(ctx, c, hg, row_ptr, seed, ops, rate):
        out = minmax_edge_program(c, hg, row_ptr, ops, seed, rate)
        ctx.save_for_backward(c, hg, row_ptr, seed, out)
        ctx.ops, ctx.rate = ops, rate
        return out

    @staticmethod
    def backward(ctx, ct):
        c, hg, row_ptr, seed, out = ctx.saved_tensors
        dhg, dc = minmax_edge_program_bwd(c, hg, row_ptr, ctx.ops, seed, ctx.rate, out,
                                          ct.contiguous())
        return dc, dhg, None, None, None, None


def fused_segment_minmax(data: torch.Tensor, graph: Graph,
                         ops: Sequence[str] = ("min", "max")) -> torch.Tensor:
    """Min and/or max of ``data`` (E, C; float32 or bf16) over each node's
    in-edges → (N, P·C) float32.

    ``ops`` ⊆ {"min", "max"} in aggregator order, sharing one pass over the
    edge data. Rows without real in-edges give 0; padding edges take no
    part. Differentiable in ``data``: the backward routes each (row,
    channel, op) cotangent to the first in-edge whose value equals the
    optimum (exact f32 ``==``), summed over ops, and gives padding edges 0;
    for bf16 ``data`` the cotangent is rounded to bf16 first and the
    gradient is bf16. Deterministic.
    """
    return _SegmentMinmax.apply(data.contiguous(), graph.real_row_ptr, _check_ops(ops))


def fused_minmax_edge_program(c: torch.Tensor, hg: torch.Tensor, graph: Graph,
                              ops: Sequence[str] = ("min", "max"), *,
                              seed: Optional[torch.Tensor] = None,
                              rate: float = 0.5) -> torch.Tensor:
    """Fused min/max edge program → (N, P·C).

    ``out[i, p·C:(p+1)·C] = op_p over the real in-edges e of i of
    m_e ⊙ (hg_e + c[i])``: ``c`` (N, C) is the dst-side node projection,
    ``hg`` (E, C) the per-edge rest of the message, ``m`` the N2 dropout
    mask (:func:`dropout_keep` of ``seed``, a (1,) int32 tensor on the
    device, at ``rate``; ``seed=None`` turns it off). The mask multiplies
    after the add, so dropped lanes take part in the min/max as 0. The
    (E, C) message is never stored. ``c`` and ``hg`` are float32 or both
    bf16; the add and the mask product are float32 either way.

    Differentiable in ``c`` and ``hg`` with first-hit routing as
    :func:`fused_segment_minmax`: ``dhg = routed ⊙ m`` (padding edges 0)
    and ``dc`` its sum over each row's in-edges, in the inputs' dtype.
    """
    return _MinmaxEdgeProgram.apply(c.contiguous(), hg.contiguous(), graph.real_row_ptr,
                                    seed, _check_ops(ops), rate)

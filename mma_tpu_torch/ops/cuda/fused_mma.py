"""Segment-sum and MMA edge-program kernels, with their plain versions.

Eight hand-written CUDA kernels (``mma_tpu_torch/csrc/fused_mma.cu``)
reduce over the dst-sorted CSR of a :class:`~mma_tpu_torch.graph.Graph` or
its CSC twin:

- :func:`segment_sum_csr` replaces the JAX package's ``_sum_kernel``:
  ``out[i] = Σ_{e ∈ [row_ptr[i], row_ptr[i+1])} data[e]``, or
  ``data[index[e]]`` with an index (the CSC, by-src and gather-VJP uses).
  Two kernels a call: fixed-size edge chunks, one warp each, then a fixup
  of the rows longer than a chunk, which are split across warps.
  ``LAUNCHES["segment_sum"]`` counts calls, ``"segment_sum_bf16"`` those on
  bf16 rows.
- :func:`edge_program_lean` replaces ``_program_fwd_lean_kernel``:
  ``S[i] = Σ_{dst_e=i} act(c[i] + h[src_e] @ W_bot) ⊙ tile(h[src_e], K)``.
  Three kernels a call: a node pass ``D = h @ W_bot``, then kernel 1's two
  passes summing the messages from ``D`` and ``h``.
  ``LAUNCHES["edge_program_lean"]`` counts calls (``"..._bf16"`` those with
  a bf16 ``h``; the same for kernel 3's ``"edge_program_lean_bwd"``).
- Its backward, :func:`edge_program_lean_bwd`, replaces
  ``_program_bwd_lean_kernel``: ``dc``, ``dW_bot`` and ``dh``. Eight
  kernels a call and no per-edge tensor: kernel 2's node pass ``D = h @
  W_bot``, a dst pass over the CSR (``dc``) and a src pass over the CSC
  (``[dD ‖ G]``), each kernel 1's two passes with its own message, and a
  node pass (``dh = fold_K(G) + dD @ W_botᵀ``, ``dW_bot = hᵀ · dD`` in
  slab partials added in order).
- :func:`segment_sum_sq_csr` replaces ``_sumsq_kernel``: ``[Σx ‖ Σx²]``
  per row, the var/std aggregators' input.
- The wide edge program :func:`edge_program` (``S[i] = Σ_{dst_e=i}
  act(c[i] + d[src_e]) ⊙ tile(h[src_e], K)`` from both projections)
  replaces ``_program_fwd_kernel`` (:func:`edge_program_fwd`: kernel 2's
  edge pass over the caller's ``d``, two launches),
  ``_program_bwd_kernel`` (:func:`edge_program_bwd`: ``dc`` and an
  optional per-edge ``[dlogits ‖ dh_e]`` payload; kernel 3's dst pass over
  the caller's ``d``, two launches, the payload written in the same pass)
  and ``_program_bwd_csc_kernel`` (:func:`edge_program_bwd_csc`: ``[dd ‖
  dh]`` in CSC order; kernel 3's src pass over the caller's ``d``, two
  launches, ``G``'s K blocks folded into ``dh`` as it stores).
- :func:`masked_segment_sum` replaces ``_masked_kernel``: ``S[i] =
  Σ_{dst_e=i} where(pat, σ(l_e), l_e) ⊙ tile(h_src_e, K)`` from
  pre-gathered per-edge logits and source rows, the forward of
  :func:`fused_masked_aggregate`.

Every kernel of this module also takes bf16 operands, the edge pipeline's
``compute_dtype="bfloat16"``: :func:`segment_sum_csr` and
:func:`segment_sum_sq_csr` bf16 ``data``,
:func:`edge_program_lean` and :func:`edge_program_lean_bwd` a bf16 ``h``
(``c``, ``w_bot``, ``pattern``, ``ct`` and every output stay float32), the
wide program's kernels bf16 ``d`` and ``h`` (and a bf16 ``c``, which they
read as float32), :func:`masked_segment_sum` bf16 ``logits`` and/or
``h_src``. The kernels read the bf16 values from device memory and sum in
float32. Where the JAX package's kernels run a contraction as one MXU
pass on bf16 inputs, the pass rounds its float32 operands to bf16
(``mma_tpu/ops/pallas/fused_mma.py:107-118``): the lean kernels' message
before the forward sums it and the cotangent ``ct`` and ``dlog`` in the
backward (one pass on a bf16 ``h``, ``:1498``), kernel 8's square ``x²``
(precision ``"fastest"`` on bf16 data), kernel 12's message on bf16 logits
(``:1574``). Kernels 2, 3, 8 and 12 and their plain versions round at the
same places, so the port computes the JAX package's bf16 function. The
wide program's kernels round nothing: the JAX wide program runs two passes
whatever the dtype (``:1380``), float32 to about 2⁻¹⁷, and rounds only its
gradients, once, to their inputs' dtypes (``:1449``). ``LAUNCHES`` counts
every bf16 call under its kernel's key with ``_bf16`` appended.

Each function takes the plain PyTorch version for CPU tensors and launches
its kernel for CUDA tensors; any other device, dtype, shape or layout
raises. :func:`segment_sum_csr` (without an index),
:func:`edge_program_lean`, :func:`segment_sum_sq_csr`,
:func:`edge_program` and :func:`fused_masked_aggregate` are
differentiable through ``torch.autograd.Function``s whose backward
dispatches the same way: the plain forward and a plain backward on the
CPU, the kernels on the card (the backward of :func:`segment_sum_sq_csr`
and of :func:`fused_masked_aggregate` is plain elementwise code on both,
as in the JAX package). ``LAUNCHES`` counts kernel launches, so a run can
show that its path went through the kernels.

The forwards of kernels 1, 2 and 8 run as the ``torch.library`` operators
``mma_tpu_torch::segment_sum_csr``, ``edge_program_lean`` and
``segment_sum_sq_csr`` (``mma_tpu_torch.ops.cuda.library``), so that
``torch.export`` can trace a forward through them: the operator's CPU
implementation is the plain version, its CUDA implementation the kernel.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from mma_tpu_torch.ops.cuda import build, library

# The bf16 variants count under their own "_bf16" keys.
LAUNCHES = {"segment_sum": 0, "edge_program_lean": 0, "edge_program_lean_bwd": 0,
            "segment_sum_sq": 0, "edge_program_fwd": 0, "edge_program_bwd": 0,
            "edge_program_bwd_csc": 0, "masked_segment_sum": 0, "segment_sum_bf16": 0,
            "edge_program_lean_bf16": 0, "edge_program_lean_bwd_bf16": 0,
            "segment_sum_sq_bf16": 0, "edge_program_fwd_bf16": 0, "edge_program_bwd_bf16": 0,
            "edge_program_bwd_csc_bf16": 0, "masked_segment_sum_bf16": 0}

# The wide program's src-keyed backward strategies, as the JAX package's
# EDGE_BWD_MODE (mma_tpu/ops/pallas/fused_mma.py:47-58): "payload_permute"
# emits a per-edge payload from the dst pass and reduces it by source
# (kernel 1 over the CSC); "csc_gather" recomputes the mask chain in CSC
# order (kernel 11).
EDGE_BWD_MODE = "payload_permute"
EDGE_BWD_MODES = ("payload_permute", "csc_gather")

# Widths the edge-program kernels take: the lean node passes keep W_bot's
# 128-lane tile (or a slice of it) in shared memory; the chunk passes give a
# lane at most two rounds of two 16-byte slots of a K·F row, and kernel 12 a
# thread 4 lanes of each of at most four 128-lane tiles.
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
        lib.mma_segment_sum_n_chunks.argtypes = [_I]
        lib.mma_segment_sum_n_chunks.restype = _I
        lib.mma_segment_sum_csr.argtypes = [_P] * 6 + [_I] * 5 + [_P]
        lib.mma_segment_sum_csr.restype = _I
        lib.mma_edge_program_lean_node.argtypes = [_P, _P, _P] + [_I] * 4 + [_P]
        lib.mma_edge_program_lean_node.restype = _I
        lib.mma_edge_program_lean_edges.argtypes = [_P] * 9 + [_I] * 7 + [_P]
        lib.mma_edge_program_lean_edges.restype = _I
        lib.mma_edge_program_lean_bwd_dst.argtypes = [_P] * 11 + [_I] * 7 + [_P]
        lib.mma_edge_program_lean_bwd_src.argtypes = [_P] * 10 + [_I] * 5 + [_P]
        lib.mma_edge_program_lean_bwd_n_slabs.argtypes = [_I] * 3
        lib.mma_edge_program_lean_bwd_node.argtypes = [_P] * 6 + [_I] * 4 + [_P]
        lib.mma_segment_sum_sq_csr.argtypes = [_P, _P, _P, _I, _I, _I, _P]
        lib.mma_edge_program_bwd_csc.argtypes = [_P] * 10 + [_I] * 5 + [_P]
        lib.mma_masked_segment_sum.argtypes = [_P] * 7 + [_I] * 7 + [_P]
        for fn in ("mma_edge_program_lean_bwd_dst", "mma_edge_program_lean_bwd_src",
                   "mma_edge_program_lean_bwd_n_slabs", "mma_edge_program_lean_bwd_node",
                   "mma_segment_sum_sq_csr", "mma_edge_program_bwd_csc",
                   "mma_masked_segment_sum"):
            getattr(lib, fn).restype = _I
        _configured = True
    return lib


def _check_launch(lib: ctypes.CDLL, err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(
            f"{name} kernel launch failed: {lib.mma_cuda_error_string(err).decode()}"
        )


def _check_cuda_inputs(name: str, **tensors: torch.Tensor) -> None:
    """Validate device/contiguity of a kernel's inputs."""
    devices = {t.device for t in tensors.values()}
    if len(devices) != 1:
        raise ValueError(f"{name}: inputs on several devices {sorted(map(str, devices))}")
    (dev,) = devices
    if dev.type != "cuda":
        raise ValueError(f"{name}: the kernel takes CUDA tensors, got {dev}")
    for arg, t in tensors.items():
        if not t.is_contiguous():
            raise ValueError(f"{name}: {arg} must be contiguous")


def _check_dtype(name: str, arg: str, t: torch.Tensor, *dtypes: torch.dtype) -> None:
    if t.dtype not in dtypes:
        raise ValueError(f"{name}: {arg} must be {' or '.join(map(str, dtypes))}, got {t.dtype}")


def _bf16(t: torch.Tensor) -> int:
    """The kernels' element-type flag: 1 for a bf16 operand, 0 for float32."""
    return int(t.dtype == torch.bfloat16)


def _round_bf16(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to bf16 (to nearest, ties to even) and back to float32:
    the JAX lean kernels' one-pass MXU operand on bf16 inputs."""
    return x.bfloat16().float()


def _on_cpu(*tensors: Optional[torch.Tensor]) -> bool:
    return all(t.device.type == "cpu" for t in tensors if t is not None)


def _row_ids(row_ptr: torch.Tensor) -> torch.Tensor:
    """Destination row of every edge the CSR covers (``dst`` of a sorted list)."""
    n = row_ptr.shape[0] - 1
    counts = (row_ptr[1:] - row_ptr[:-1]).long()
    return torch.repeat_interleave(
        torch.arange(n, device=row_ptr.device), counts
    )


def _stream() -> int:
    return torch.cuda.current_stream().cuda_stream


# ---------------------------------------------------------------- kernel 1

def segment_sum_reference(data: torch.Tensor, row_ptr: torch.Tensor,
                          index: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain version of :func:`segment_sum_csr`: ``(N, C)`` float32 (bf16
    rows are summed as the float32 values they are)."""
    n = row_ptr.shape[0] - 1
    lo, hi = int(row_ptr[0]), int(row_ptr[-1])
    rows = data[lo:hi] if index is None else data.index_select(0, index[lo:hi].long())
    out = torch.zeros((n, data.shape[1]), dtype=torch.float32, device=data.device)
    return out.index_add_(0, _row_ids(row_ptr), rows.float())


def _chunk_scratch(n_edges: int, width: int, device):
    """Kernel 1's pass-1 scratch for ``n_edges`` edge positions and rows of
    ``width`` floats: the head and tail partials and the tail rows."""
    n_chunks = _lib().mma_segment_sum_n_chunks(n_edges)
    return (torch.empty((n_chunks, 2, width), dtype=torch.float32, device=device),
            torch.empty((n_chunks,), dtype=torch.int32, device=device))


def _segment_sum_kernel(data: torch.Tensor, row_ptr: torch.Tensor,
                        index: Optional[torch.Tensor] = None) -> torch.Tensor:
    name = "segment_sum_csr"
    extra = {} if index is None else {"index": index}
    _check_cuda_inputs(name, data=data, row_ptr=row_ptr, **extra)
    _check_dtype(name, "data", data, torch.float32, torch.bfloat16)
    _check_dtype(name, "row_ptr", row_ptr, torch.int32)
    if index is not None:
        _check_dtype(name, "index", index, torch.int32)
    if data.ndim != 2 or row_ptr.ndim != 1 or (index is not None and index.ndim != 1):
        raise ValueError(f"{name}: data must be (R, C), row_ptr (N+1,) and index (E,)")
    n, ch = row_ptr.shape[0] - 1, data.shape[1]
    # The edge positions the CSR may cover, from shapes alone (no host sync):
    # they fix the kernel's partition into chunks and its scratch.
    n_edges = data.shape[0] if index is None else index.shape[0]
    dev = data.device
    lib = _lib()
    out = torch.empty((n, ch), dtype=torch.float32, device=dev)
    part, tail_row = _chunk_scratch(n_edges, ch, dev)
    # 4-lane slots: 16-byte float32 loads, 8-byte bf16 ones.
    vec4 = ch % 4 == 0 and data.data_ptr() % (4 * data.element_size()) == 0
    with torch.cuda.device(dev):
        err = lib.mma_segment_sum_csr(
            data.data_ptr(), row_ptr.data_ptr(),
            None if index is None else index.data_ptr(), out.data_ptr(), part.data_ptr(),
            tail_row.data_ptr(), n, ch, n_edges, int(vec4), _bf16(data), _stream(),
        )
    _check_launch(lib, err, name)
    LAUNCHES["segment_sum_bf16" if _bf16(data) else "segment_sum"] += 1
    return out


def _segment_sum(data, row_ptr, index=None):
    """The operator's CPU implementation: the plain version for CPU tensors."""
    if _on_cpu(data, row_ptr, index):
        return segment_sum_reference(data, row_ptr, index)
    return _segment_sum_kernel(data, row_ptr, index)


_segment_sum_op = library.define(
    "segment_sum_csr(Tensor data, Tensor row_ptr, Tensor? index=None) -> Tensor",
    cpu=_segment_sum,
    cuda=lambda data, row_ptr, index=None: _segment_sum_kernel(data, row_ptr, index),
    fake=lambda data, row_ptr, index=None: data.new_empty(
        (row_ptr.shape[0] - 1, data.shape[1]), dtype=torch.float32),
)


def _expand_rows(ct: torch.Tensor, row_ptr: torch.Tensor, n_edges: int) -> torch.Tensor:
    """The VJP of a segment sum: ``ct[row(e)]`` for every edge the CSR
    covers, 0 for the others (the JAX package's ``ct[dst]`` masked by
    ``edge_mask``). The rows come from the CSR itself, without a host sync."""
    e = torch.arange(n_edges, dtype=row_ptr.dtype, device=ct.device)
    ids = torch.searchsorted(row_ptr, e, right=True) - 1
    covered = (e >= row_ptr[0]) & (e < row_ptr[-1])
    rows = ct.index_select(0, ids.clamp_(0, ct.shape[0] - 1))
    return torch.where(covered[:, None], rows, 0.0)


class _SegmentSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, data, row_ptr):
        ctx.save_for_backward(row_ptr)
        ctx.n_edges, ctx.dtype = data.shape[0], data.dtype
        return _segment_sum_op(data, row_ptr)

    @staticmethod
    def backward(ctx, ct):
        # ct[dst] in the data's dtype, as the JAX package's VJP casts it.
        (row_ptr,) = ctx.saved_tensors
        return _expand_rows(ct, row_ptr, ctx.n_edges).to(ctx.dtype), None


def segment_sum_csr(data: torch.Tensor, row_ptr: torch.Tensor,
                    index: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Sum ``data`` (float32 or bf16) over each CSR row of ``row_ptr`` → (N,
    C) float32.

    Without ``index`` row ``i`` sums ``data[e]`` (``data`` is (E, C)) for
    ``e ∈ [row_ptr[i], row_ptr[i+1])``, and the result is differentiable
    in ``data``. With ``index`` (E,) int32 it sums ``data[index[e]]``, so a
    CSC reduction or a gather's VJP needs no permuted copy of ``data``; that
    form is backward machinery and not differentiable. ``row_ptr`` (N+1,)
    int32 must be non-decreasing with ``row_ptr[-1] <= E`` and every index
    in range (a graph builder's CSR; the kernel does not check the values).
    Deterministic; rows without edges give 0. bf16 rows are summed in
    float32 (each value exact); the gradient of bf16 ``data`` is bf16.
    """
    if index is None:
        return _SegmentSum.apply(data, row_ptr)
    if torch.is_grad_enabled() and data.requires_grad:
        raise ValueError("segment_sum_csr with an index is not differentiable")
    return _segment_sum_op(data, row_ptr, index)


# ------------------------------------------------------------ kernels 2-3

def _mask_chain(logits: torch.Tensor, pattern: torch.Tensor):
    """``(mask, dmask)``: σ and its derivative on the pattern's lanes, the
    identity and 1 elsewhere."""
    sig = torch.sigmoid(logits)
    on = pattern.bool()
    return torch.where(on, sig, logits), torch.where(on, sig * (1.0 - sig), 1.0)


def _check_program_inputs(name, c, w_bot, h, pattern, src, row_ptr, ct=None):
    extra = {} if ct is None else {"ct": ct}
    _check_cuda_inputs(name, c=c, w_bot=w_bot, h=h, pattern=pattern, src=src,
                       row_ptr=row_ptr, **extra)
    for arg, t in (("c", c), ("w_bot", w_bot), ("pattern", pattern), *extra.items()):
        _check_dtype(name, arg, t, torch.float32)
    _check_dtype(name, "h", h, torch.float32, torch.bfloat16)
    for arg, t in (("src", src), ("row_ptr", row_ptr)):
        _check_dtype(name, arg, t, torch.int32)
    n, f = h.shape
    kf = w_bot.shape[1]
    if (c.shape != (n, kf) or w_bot.shape != (f, kf) or pattern.shape != (kf,)
            or row_ptr.shape != (n + 1,) or src.ndim != 1
            or (ct is not None and ct.shape != (n, kf))):
        raise ValueError(
            f"{name}: shapes c{tuple(c.shape)} w_bot{tuple(w_bot.shape)} "
            f"h{tuple(h.shape)} pattern{tuple(pattern.shape)} src{tuple(src.shape)} "
            f"row_ptr{tuple(row_ptr.shape)} do not fit together"
        )
    if f % 4 or f > MAX_F or kf % f or kf > MAX_KF:
        raise ValueError(
            f"{name}: takes F % 4 == 0, F <= {MAX_F}, K·F <= {MAX_KF}; got F={f}, K·F={kf}"
        )
    if c.data_ptr() % 16 or (ct is not None and ct.data_ptr() % 16):
        raise ValueError(f"{name}: c and ct must be 16-byte aligned")
    return n, f, kf


def _node_product(h, w_bot):
    """``D = h @ W_bot`` (N, K·F) float32 for a bf16 ``h``, as the card's node
    pass sums it: the products ``h[:, k] W_bot[k]`` of bf16 values are exact
    in float32 and are added in k order, so the two agree bit for bit."""
    h = h.float()
    d = torch.zeros((h.shape[0], w_bot.shape[1]), dtype=torch.float32, device=h.device)
    for k in range(h.shape[1]):
        d = d + h[:, k:k + 1] * w_bot[k]
    return d


def _lean_edges(c, w_bot, h, pattern, src, row_ptr):
    """The per-edge values of kernels 2 and 3's plain versions, over the
    edges the CSR covers: ``(ids, h_src, mask, dmask)`` with each edge's row,
    its float32 source row and the activation and its derivative at ``c[ids]
    + h_src @ W_bot``. A bf16 ``h`` takes ``D`` per node
    (:func:`_node_product`)."""
    ids = _row_ids(row_ptr)
    lo, hi = int(row_ptr[0]), int(row_ptr[-1])
    s = src[lo:hi].long()
    if h.dtype == torch.bfloat16:
        d_src = _node_product(h, w_bot)[s]
        h_src = h[s].float()
    else:
        h_src = h[s]  # (E, F)
        d_src = h_src @ w_bot
    mask, dmask = _mask_chain(c[ids] + d_src, pattern)  # (E, K·F)
    return ids, h_src, mask, dmask


def edge_program_lean_reference(c, w_bot, h, pattern, src, row_ptr):
    """Plain version of :func:`edge_program_lean`: ``(N, K·F)`` float32. With
    a bf16 ``h`` each message is rounded to bf16 before the float32 sum."""
    f, kf = w_bot.shape
    ids, h_src, mask, _ = _lean_edges(c, w_bot, h, pattern, src, row_ptr)
    msg = mask * h_src.repeat(1, kf // f)
    if h.dtype == torch.bfloat16:
        msg = _round_bf16(msg)
    out = torch.zeros((c.shape[0], kf), dtype=torch.float32, device=c.device)
    return out.index_add_(0, ids, msg)


def _lean_node_pass(h, w_bot):
    """Kernel 2's node pass, one launch: ``D = h @ W_bot`` (N, K·F) float32
    from a float32 or bf16 ``h``."""
    n, f = h.shape
    kf = w_bot.shape[1]
    d = torch.empty((n, kf), dtype=torch.float32, device=h.device)
    lib = _lib()
    with torch.cuda.device(h.device):
        err = lib.mma_edge_program_lean_node(h.data_ptr(), w_bot.data_ptr(), d.data_ptr(), n, f,
                                             kf, _bf16(h), _stream())
    _check_launch(lib, err, "edge_program_lean_fwd node pass")
    return d


def _form(h: torch.Tensor, d: torch.Tensor) -> Tuple[int, int, int]:
    """The edge-program passes' form flags ``(h_bf16, d_bf16, round)``: a
    bf16 ``h`` beside a float32 ``d`` is kernels 2-3's bf16 form, whose
    messages (and ``ct``) are rounded to bf16 as the JAX lean kernel's one
    pass rounds them; bf16 ``d`` and ``h`` are kernels 9-11's, which round
    nothing (the JAX wide kernels run two passes whatever the dtype)."""
    h_bf16, d_bf16 = _bf16(h), _bf16(d)
    return h_bf16, d_bf16, int(h_bf16 and not d_bf16)


def _lean_edge_pass(c, pattern, d, h, src, row_ptr):
    """Kernel 2's edge pass, kernel 1's two launches with the lean message:
    ``S[i] = Σ_{e ∈ row i} act(c[i] + d[src_e]) ⊙ tile(h[src_e], K)`` over
    the CSR ``row_ptr`` (N+1,), with ``c`` (N, K·F) float32 and the node
    tables ``d`` (R, K·F) and ``h`` (R, F) in a form of :func:`_form` (both
    float32, a bf16 ``h`` with each message rounded to bf16, or both bf16),
    as :func:`_edge_program_lean_kernel` and :func:`_check_wide_inputs`
    check them (``c`` may be a slice of rows of a checked one). The
    partition, scratch and grid come from ``src.shape`` alone: no host
    sync."""
    n, kf, f = row_ptr.shape[0] - 1, c.shape[1], h.shape[1]
    n_edges = src.shape[0]
    lib = _lib()
    out = torch.empty((n, kf), dtype=torch.float32, device=c.device)
    part, tail_row = _chunk_scratch(n_edges, kf, c.device)
    with torch.cuda.device(c.device):
        err = lib.mma_edge_program_lean_edges(
            c.data_ptr(), pattern.data_ptr(), d.data_ptr(), h.data_ptr(), src.data_ptr(),
            row_ptr.data_ptr(), out.data_ptr(), part.data_ptr(), tail_row.data_ptr(), n, f, kf,
            n_edges, *_form(h, d), _stream(),
        )
    _check_launch(lib, err, "edge_program_lean_fwd edge pass")
    return out


def _edge_program_lean_kernel(c, w_bot, h, pattern, src, row_ptr):
    """Kernel 2 on the card: the node pass, then the edge pass."""
    name = "edge_program_lean_fwd"
    _check_program_inputs(name, c, w_bot, h, pattern, src, row_ptr)
    if h.data_ptr() % 16 or pattern.data_ptr() % 16:
        raise ValueError(f"{name}: h and pattern must be 16-byte aligned")
    out = _lean_edge_pass(c, pattern, _lean_node_pass(h, w_bot), h, src, row_ptr)
    LAUNCHES["edge_program_lean_bf16" if _bf16(h) else "edge_program_lean"] += 1
    return out


def edge_program_lean_payload_reference(c, w_bot, h, pattern, src, row_ptr, ct):
    """The JAX kernel's own contract, with explicit per-edge tensors:
    ``(dc, dW_bot, payload)``, the payload ``(E, F)`` being each edge's
    ``Σ_k (ct[i] ⊙ mask_e)_k + dlog_e @ W_botᵀ`` (0 on edges the CSR skips).
    With a bf16 ``h``, ``ct`` and each ``dlog_e`` are rounded to bf16."""
    f, kf = w_bot.shape
    bf16 = h.dtype == torch.bfloat16
    ids, h_src, mask, dmask = _lean_edges(c, w_bot, h, pattern, src, row_ptr)
    lo, hi = int(row_ptr[0]), int(row_ptr[-1])
    ge = (_round_bf16(ct) if bf16 else ct)[ids]
    dlog = ge * h_src.repeat(1, kf // f) * dmask
    if bf16:
        dlog = _round_bf16(dlog)
    dc = torch.zeros((c.shape[0], kf), dtype=torch.float32, device=c.device)
    dc.index_add_(0, ids, dlog)
    dw = h_src.t() @ dlog
    payload = torch.zeros((src.shape[0], f), dtype=torch.float32, device=c.device)
    payload[lo:hi] = (ge * mask).reshape(-1, kf // f, f).sum(dim=1) + dlog @ w_bot.t()
    return dc, dw, payload


def edge_program_lean_bwd_reference(c, w_bot, h, pattern, src, row_ptr, col_ptr, dst_csc, ct):
    """Plain version of :func:`edge_program_lean_bwd`: the per-edge form
    (:func:`edge_program_lean_payload_reference`), then its payload summed
    by source. ``col_ptr`` and ``dst_csc`` are the kernels' (the CSC covers
    the edges the CSR covers): ``(dc, dW_bot, dh)``."""
    dc, dw, payload = edge_program_lean_payload_reference(c, w_bot, h, pattern, src, row_ptr, ct)
    lo, hi = int(row_ptr[0]), int(row_ptr[-1])
    dh = torch.zeros(h.shape, dtype=torch.float32, device=h.device)
    return dc, dw, dh.index_add_(0, src[lo:hi].long(), payload[lo:hi])


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """``t``, or a copy of it on a 16-byte boundary."""
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _lean_bwd_dst_pass(c, ct, pattern, d, h, src, row_ptr, emit_payload=False):
    """The dst pass of kernels 3 and 10, kernel 1's two launches with the
    ``dc`` message: ``dc[i] = Σ_{e ∈ row i} dlog_e``, ``dlog_e = ct[i] ⊙
    tile(h[src_e], K) ⊙ dmask(c[i] + d[src_e])``, over the CSR ``row_ptr``
    (N+1,), with ``c``, ``ct`` (N, K·F) float32 and the node tables ``d``
    (R, K·F) and ``h`` (R, F) in a form of :func:`_form`, 16-byte aligned
    (the payload only where ``d`` and ``h`` share a dtype). With
    ``emit_payload`` the same pass
    also writes kernel 10's payload (E, K·F+F), ``[dlog_e ‖ Σ_k (ct[i] ⊙
    mask_e)_k]`` at each covered edge's position and 0 elsewhere: ``(dc,
    payload or None)``. No host sync."""
    n, kf, f = row_ptr.shape[0] - 1, c.shape[1], h.shape[1]
    n_edges = src.shape[0]
    lib = _lib()
    dc = torch.empty((n, kf), dtype=torch.float32, device=c.device)
    payload = (torch.empty((n_edges, kf + f), dtype=torch.float32, device=c.device)
               if emit_payload else None)
    part, tail_row = _chunk_scratch(n_edges, kf, c.device)
    with torch.cuda.device(c.device):
        err = lib.mma_edge_program_lean_bwd_dst(
            c.data_ptr(), ct.data_ptr(), pattern.data_ptr(), d.data_ptr(), h.data_ptr(),
            src.data_ptr(), row_ptr.data_ptr(), dc.data_ptr(),
            None if payload is None else payload.data_ptr(), part.data_ptr(),
            tail_row.data_ptr(), n, f, kf, n_edges, *_form(h, d), _stream(),
        )
    _check_launch(lib, err, "edge program dst pass")
    return dc, payload


def _lean_bwd_src_pass(c, ct, pattern, d, h, dst_csc, col_ptr, fold=False):
    """The src pass of kernels 3 and 11, kernel 1's two launches with the
    ``[dD ‖ G]`` message over the CSC ``col_ptr`` (N+1,), reading each
    edge's destination through ``dst_csc``: row ``s`` is ``[Σ dlog_e ‖ Σ
    ct[i] ⊙ mask_e]`` over the edges ``e = (s → i)`` it covers, (N,
    2·K·F). With ``fold`` kernel 11's row ``[dd ‖ dh]`` instead, ``G``'s K
    blocks added as it is stored, (N, K·F+F). ``c``, ``ct`` are float32 node
    tables (R, K·F), ``d`` (N, K·F), ``h`` (N, F): kernel 3's a float32
    ``d`` and a float32 or bf16 ``h``, kernel 11's ``d`` and ``h`` of one
    dtype. No host sync."""
    n, kf, f = col_ptr.shape[0] - 1, d.shape[1], h.shape[1]
    width = kf + f if fold else 2 * kf
    lib = _lib()
    out = torch.empty((n, width), dtype=torch.float32, device=d.device)
    part, tail_row = _chunk_scratch(dst_csc.shape[0], width, d.device)
    args = [c.data_ptr(), ct.data_ptr(), pattern.data_ptr(), d.data_ptr(), h.data_ptr(),
            dst_csc.data_ptr(), col_ptr.data_ptr(), out.data_ptr(), part.data_ptr(),
            tail_row.data_ptr(), n, f, kf, dst_csc.shape[0]]
    with torch.cuda.device(d.device):
        if fold:  # kernel 11: d and h float32 or both bf16
            err = lib.mma_edge_program_bwd_csc(*args, _bf16(h), _stream())
        else:
            err = lib.mma_edge_program_lean_bwd_src(*args, _bf16(h), _stream())
    _check_launch(lib, err, "edge program src pass")
    return out


def _lean_bwd_node_pass(ddg, h, w_bot):
    """Kernel 3's node pass, three launches: ``dh = fold_K(G) + dD @
    W_botᵀ`` (N, F) and ``dW_bot = hᵀ · dD`` (F, K·F) from ``ddg = [dD ‖
    G]`` (N, 2·K·F), ``dW_bot`` as slab partials over node rows added in
    order."""
    n, f = h.shape
    kf = w_bot.shape[1]
    lib = _lib()
    dh = torch.empty((n, f), dtype=torch.float32, device=h.device)
    dw = torch.empty((f, kf), dtype=torch.float32, device=h.device)
    dw_part = torch.empty((lib.mma_edge_program_lean_bwd_n_slabs(n, f, kf), f, kf),
                          dtype=torch.float32, device=h.device)
    with torch.cuda.device(h.device):
        err = lib.mma_edge_program_lean_bwd_node(
            ddg.data_ptr(), h.data_ptr(), w_bot.data_ptr(), dh.data_ptr(), dw.data_ptr(),
            dw_part.data_ptr(), n, f, kf, _bf16(h), _stream(),
        )
    _check_launch(lib, err, "edge_program_lean_bwd node pass")
    return dh, dw


def _edge_program_lean_bwd_kernel(c, w_bot, h, pattern, src, row_ptr, col_ptr, dst_csc, ct):
    """Kernel 3 on the card: ``D``, the dst pass, the src pass, the node pass."""
    name = "edge_program_lean_bwd"
    n, _, _ = _check_program_inputs(name, c, w_bot, h, pattern, src, row_ptr, ct)
    _check_cuda_inputs(name, c=c, col_ptr=col_ptr, dst_csc=dst_csc)
    for arg, t in (("col_ptr", col_ptr), ("dst_csc", dst_csc)):
        _check_dtype(name, arg, t, torch.int32)
    if col_ptr.shape != (n + 1,) or dst_csc.ndim != 1:
        raise ValueError(f"{name}: col_ptr{tuple(col_ptr.shape)} and "
                         f"dst_csc{tuple(dst_csc.shape)} do not fit N={n}")
    # The passes read h, the pattern and W_bot in 16-byte pieces.
    h, pattern, w_bot = _aligned(h), _aligned(pattern), _aligned(w_bot)
    d = _lean_node_pass(h, w_bot)
    dc, _ = _lean_bwd_dst_pass(c, ct, pattern, d, h, src, row_ptr)
    ddg = _lean_bwd_src_pass(c, ct, pattern, d, h, dst_csc, col_ptr)
    dh, dw = _lean_bwd_node_pass(ddg, h, w_bot)
    LAUNCHES["edge_program_lean_bwd_bf16" if _bf16(h) else "edge_program_lean_bwd"] += 1
    return dc, dw, dh


def edge_program_lean_bwd(c: torch.Tensor, w_bot: torch.Tensor, h: torch.Tensor,
                          pattern: torch.Tensor, src: torch.Tensor, row_ptr: torch.Tensor,
                          col_ptr: torch.Tensor, dst_csc: torch.Tensor, ct: torch.Tensor
                          ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Backward of :func:`edge_program_lean` for the cotangent ``ct`` (N, K·F).

    With ``logits_e = c[i] + h[s] @ W_bot`` on edge ``e = (s → i)``,
    ``mask`` and ``dmask`` the activation and its derivative, and
    ``dlog_e = ct[i] ⊙ tile(h[s], K) ⊙ dmask``, returns

    - ``dc`` (N, K·F): ``Σ_{e: dst=i} dlog_e`` over the CSR ``row_ptr``;
    - ``dW_bot`` (F, K·F): ``Σ_e h[s]ᵀ dlog_e``;
    - ``dh`` (N, F): ``Σ_{e: src=s} (Σ_k (ct[i] ⊙ mask_e)_k + dlog_e @
      W_botᵀ)``, the gradient of both uses of ``h``.

    All three are float32. ``h`` may be bf16, the rest is float32; then
    ``ct`` and each ``dlog_e`` are rounded to bf16 first, as the JAX
    package's one-pass kernel rounds them.

    ``col_ptr`` (N+1,) and ``dst_csc`` (E,) int32 are the CSC that covers
    the same edges as ``row_ptr`` (``Graph.real_col_ptr`` and
    ``Graph.dst_csc`` beside ``Graph.real_row_ptr``). On the card no
    per-edge tensor is stored: the src-keyed sums come from a pass over the
    CSC and the products from node-level passes. Deterministic: no
    atomics, every partition fixed by E and N.
    """
    tensors = (c, w_bot, h, pattern, src, row_ptr, col_ptr, dst_csc, ct)
    if _on_cpu(*tensors):
        return edge_program_lean_bwd_reference(*tensors)
    return _edge_program_lean_bwd_kernel(*tensors)


def _edge_program_lean(c, w_bot, h, pattern, src, row_ptr):
    """The operator's CPU implementation: the plain version for CPU tensors."""
    if _on_cpu(c, w_bot, h, pattern, src, row_ptr):
        return edge_program_lean_reference(c, w_bot, h, pattern, src, row_ptr)
    return _edge_program_lean_kernel(c, w_bot, h, pattern, src, row_ptr)


_edge_program_lean_op = library.define(
    "edge_program_lean(Tensor c, Tensor w_bot, Tensor h, Tensor pattern, Tensor src, "
    "Tensor row_ptr) -> Tensor",
    cpu=_edge_program_lean,
    cuda=lambda *args: _edge_program_lean_kernel(*args),
    fake=lambda c, w_bot, h, pattern, src, row_ptr: c.new_empty(
        (c.shape[0], w_bot.shape[1]), dtype=torch.float32),
)


class _EdgeProgramLean(torch.autograd.Function):
    @staticmethod
    def forward(ctx, c, w_bot, h, pattern, src, row_ptr, col_ptr, dst_csc):
        ctx.save_for_backward(c, w_bot, h, pattern, src, row_ptr, col_ptr, dst_csc)
        return _edge_program_lean_op(c, w_bot, h, pattern, src, row_ptr)

    @staticmethod
    def backward(ctx, ct):
        c, w_bot, h = ctx.saved_tensors[:3]
        dc, dw, dh = edge_program_lean_bwd(*ctx.saved_tensors, ct.contiguous())
        # Each gradient in its input's dtype, as the JAX VJP casts them.
        return (dc.to(c.dtype), dw.to(w_bot.dtype), dh.to(h.dtype),
                None, None, None, None, None)


def edge_program_lean(c: torch.Tensor, w_bot: torch.Tensor, h: torch.Tensor,
                      pattern: torch.Tensor, src: torch.Tensor, row_ptr: torch.Tensor,
                      col_ptr: torch.Tensor, dst_csc: torch.Tensor) -> torch.Tensor:
    """Lean MMA edge program over the dst-sorted CSR.

    ``S[i] = Σ_{e ∈ row i} act(c[i] + h[src_e] @ W_bot) ⊙ tile(h[src_e], K)``
    where ``act`` is σ on lanes with ``pattern == 1`` and the identity
    elsewhere. ``c``: (N, K·F); ``w_bot``: (F, K·F); ``h``: (N, F);
    ``pattern``: (K·F,) float 0/1; ``src``: (E,) int32; ``row_ptr``:
    (N+1,) int32, non-decreasing, with every ``src`` it covers in ``[0, N)``
    (a graph builder's CSR; the kernel does not check the values).
    Aggregator ``k`` owns lanes ``[k·F, (k+1)·F)``. ``h`` may be bf16 (the
    rest is float32): the kernels then read it as bf16, round each message
    to bf16 before the float32 sum, as the JAX package's one-pass kernel
    does, and the gradient of ``h`` is bf16. On the card a node pass
    computes ``D = h @ W_bot`` once per node, and an edge-balanced pass sums
    the messages from ``D`` and ``h``; no (E, K·F) tensor is stored. On the
    card it takes F % 4 == 0, F <= 128, K·F <= 512 and a 16-byte aligned
    ``c``, as before, and now also a 16-byte aligned ``h`` and ``pattern``,
    which the edge pass reads in 16-byte slots; the backward takes ``h`` and
    ``pattern`` at any alignment.

    Differentiable in ``c``, ``w_bot`` and ``h`` (:func:`edge_program_lean_bwd`),
    whose src-keyed sums run over the CSC ``col_ptr`` (N+1,) int32 and
    ``dst_csc`` (E,) int32, the destination of each edge in CSC order: the
    CSC that covers the same edges as ``row_ptr`` (``Graph.real_col_ptr``
    and ``Graph.dst_csc`` beside ``Graph.real_row_ptr``).
    """
    return _EdgeProgramLean.apply(c, w_bot, h, pattern, src, row_ptr, col_ptr, dst_csc)


# ---------------------------------------------------------------- kernel 8

def segment_sum_sq_reference(data: torch.Tensor, row_ptr: torch.Tensor) -> torch.Tensor:
    """Plain version of :func:`segment_sum_sq_csr`: ``(N, 2C)`` float32.

    Each row is summed slot by slot in CSR order, with the square rounded
    before it is added (to float32, and then to bf16 for bf16 ``data``), as
    the kernel sums: the two agree bit for bit, so that ``var = E[x²] -
    E[x]²`` cancels the same way on both sides."""
    n, ch = row_ptr.shape[0] - 1, data.shape[1]
    s1 = torch.zeros((n, ch), dtype=torch.float32, device=data.device)
    s2 = torch.zeros_like(s1)
    starts = row_ptr[:-1].long()
    counts = row_ptr[1:].long() - starts
    for j in range(int(counts.max()) if n else 0):
        live = (counts > j)[:, None]
        x = data.index_select(0, torch.where(counts > j, starts + j, 0)).float()
        sq = _round_bf16(x * x) if data.dtype == torch.bfloat16 else x * x
        s1 = s1 + torch.where(live, x, 0.0)
        s2 = s2 + torch.where(live, sq, 0.0)
    return torch.cat([s1, s2], dim=1)


def _segment_sum_sq_kernel(data: torch.Tensor, row_ptr: torch.Tensor) -> torch.Tensor:
    name = "segment_sum_sq_csr"
    _check_cuda_inputs(name, data=data, row_ptr=row_ptr)
    _check_dtype(name, "data", data, torch.float32, torch.bfloat16)
    _check_dtype(name, "row_ptr", row_ptr, torch.int32)
    if data.ndim != 2 or row_ptr.ndim != 1:
        raise ValueError(f"{name}: data must be (E, C) and row_ptr (N+1,)")
    n, ch = row_ptr.shape[0] - 1, data.shape[1]
    out = torch.empty((n, 2 * ch), dtype=torch.float32, device=data.device)
    lib = _lib()
    with torch.cuda.device(data.device):
        err = lib.mma_segment_sum_sq_csr(data.data_ptr(), row_ptr.data_ptr(), out.data_ptr(),
                                         n, ch, _bf16(data), _stream())
    _check_launch(lib, err, name)
    LAUNCHES["segment_sum_sq_bf16" if _bf16(data) else "segment_sum_sq"] += 1
    return out


def _segment_sum_sq(data, row_ptr):
    """The operator's CPU implementation: the plain version for CPU tensors."""
    if _on_cpu(data, row_ptr):
        return segment_sum_sq_reference(data, row_ptr)
    return _segment_sum_sq_kernel(data, row_ptr)


_segment_sum_sq_op = library.define(
    "segment_sum_sq_csr(Tensor data, Tensor row_ptr) -> Tensor",
    cpu=_segment_sum_sq,
    cuda=lambda data, row_ptr: _segment_sum_sq_kernel(data, row_ptr),
    fake=lambda data, row_ptr: data.new_empty(
        (row_ptr.shape[0] - 1, 2 * data.shape[1]), dtype=torch.float32),
)


class _SegmentSumSq(torch.autograd.Function):
    @staticmethod
    def forward(ctx, data, row_ptr):
        ctx.save_for_backward(data, row_ptr)
        return _segment_sum_sq_op(data, row_ptr)

    @staticmethod
    def backward(ctx, ct):
        # In float32 and then cast to the data's dtype, as the JAX VJP
        # computes it (mma_tpu/ops/pallas/fused_mma.py:1210-1215).
        data, row_ptr = ctx.saved_tensors
        ch = data.shape[1]
        ct_e = _expand_rows(ct, row_ptr, data.shape[0])
        return (ct_e[:, :ch] + 2.0 * data.float() * ct_e[:, ch:]).to(data.dtype), None


def segment_sum_sq_csr(data: torch.Tensor, row_ptr: torch.Tensor) -> torch.Tensor:
    """``[Σ data ‖ Σ data²]`` over each CSR row of ``row_ptr`` → (N, 2C) float32.

    Row ``i`` sums ``data[e]`` and ``data[e]²`` (``data`` (E, C)) for
    ``e ∈ [row_ptr[i], row_ptr[i+1])`` in one pass: the var/std
    aggregators' input. Differentiable in ``data``: ``d/dx_e = ct[i, :C] +
    2·x_e·ct[i, C:]`` for the edges the CSR covers and 0 for the others, as
    plain gathers (no kernel). ``row_ptr`` as :func:`segment_sum_csr`'s.
    Deterministic; rows without edges give 0. ``data`` is float32 or bf16:
    bf16 values are summed in float32, each square rounded to bf16 first,
    and the gradient (taken in float32) is cast to bf16.
    """
    return _SegmentSumSq.apply(data, row_ptr)


# ------------------------------------------------------------ kernels 9-11

def _check_wide_inputs(name, c, d, h, pattern, index, ptr, ct=None):
    """Kernels 9-11's inputs: ``d`` and ``h`` float32 or both bf16, ``c``
    float32 or bf16 (the wrappers cast it to float32, as the JAX wrapper
    does), ``pattern`` and ``ct`` float32."""
    extra = {} if ct is None else {"ct": ct}
    _check_cuda_inputs(name, c=c, d=d, h=h, pattern=pattern, index=index, ptr=ptr, **extra)
    for arg, t in (("pattern", pattern), *extra.items()):
        _check_dtype(name, arg, t, torch.float32)
    for arg, t in (("c", c), ("d", d), ("h", h)):
        _check_dtype(name, arg, t, torch.float32, torch.bfloat16)
    if d.dtype != h.dtype:
        raise ValueError(f"{name}: d and h must share a dtype, got {d.dtype} and {h.dtype}")
    for arg, t in (("index", index), ("ptr", ptr)):
        _check_dtype(name, arg, t, torch.int32)
    if h.ndim != 2 or c.ndim != 2:
        raise ValueError(f"{name}: c must be (N, K·F) and h (N, F)")
    n, f = h.shape
    kf = c.shape[1]
    if (c.shape != (n, kf) or d.shape != (n, kf) or pattern.shape != (kf,)
            or ptr.shape != (n + 1,) or index.ndim != 1
            or (ct is not None and ct.shape != (n, kf))):
        raise ValueError(
            f"{name}: shapes c{tuple(c.shape)} d{tuple(d.shape)} h{tuple(h.shape)} "
            f"pattern{tuple(pattern.shape)} index{tuple(index.shape)} "
            f"ptr{tuple(ptr.shape)} do not fit together"
        )
    if f % 4 or f > MAX_F or kf % f or kf > MAX_KF:
        raise ValueError(
            f"{name}: takes F % 4 == 0, F <= {MAX_F}, K·F <= {MAX_KF}; got F={f}, K·F={kf}"
        )
    if any(t.data_ptr() % 16 for t in (c, d, h, *extra.values())):
        raise ValueError(f"{name}: c, d, h and ct must be 16-byte aligned")
    return n, f, kf


def _wide_edges(c, d, h, pattern, ids, s):
    """Kernels 9-11's per-edge values in float32 from the values of ``c``,
    ``d`` and ``h`` (bf16 ones exact): each edge's ``(h_src, mask, dmask)``
    at the logits ``c[ids] + d[s]``. Nothing is rounded to bf16."""
    mask, dmask = _mask_chain(c.float()[ids] + d.float()[s], pattern)  # (E, K·F)
    return h.float()[s], mask, dmask


def edge_program_fwd_reference(c, d, h, pattern, src, row_ptr):
    """Plain version of :func:`edge_program_fwd`: ``(N, K·F)`` float32, from
    float32 or bf16 inputs computed in float32."""
    kf, f = c.shape[1], h.shape[1]
    ids = _row_ids(row_ptr)
    lo, hi = int(row_ptr[0]), int(row_ptr[-1])
    h_src, mask, _ = _wide_edges(c, d, h, pattern, ids, src[lo:hi].long())
    out = torch.zeros((c.shape[0], kf), dtype=torch.float32, device=c.device)
    return out.index_add_(0, ids, mask * h_src.repeat(1, kf // f))


def _edge_program_fwd_kernel(c, d, h, pattern, src, row_ptr):
    """Kernel 9 on the card: kernel 2's edge pass (two launches) over the
    caller's ``d``; ``c`` as float32."""
    _check_wide_inputs("edge_program_fwd", c, d, h, pattern, src, row_ptr)
    out = _lean_edge_pass(c.float(), _aligned(pattern), d, h, src, row_ptr)
    LAUNCHES["edge_program_fwd_bf16" if _bf16(h) else "edge_program_fwd"] += 1
    return out


def edge_program_fwd(c: torch.Tensor, d: torch.Tensor, h: torch.Tensor,
                     pattern: torch.Tensor, src: torch.Tensor,
                     row_ptr: torch.Tensor) -> torch.Tensor:
    """``S[i] = Σ_{e ∈ row i} act(c[i] + d[src_e]) ⊙ tile(h[src_e], K)`` →
    (N, K·F) float32; arguments and dtypes as :func:`edge_program`'s. Not
    differentiable (:func:`edge_program` is)."""
    if _on_cpu(c, d, h, pattern, src, row_ptr):
        return edge_program_fwd_reference(c, d, h, pattern, src, row_ptr)
    return _edge_program_fwd_kernel(c, d, h, pattern, src, row_ptr)


def edge_program_bwd_reference(c, d, h, pattern, src, row_ptr, ct, emit_payload=True):
    """Plain version of :func:`edge_program_bwd`, with explicit per-edge
    tensors: ``(dc, payload or None)``, float32 from float32 or bf16 inputs
    computed in float32."""
    kf, f = c.shape[1], h.shape[1]
    ids = _row_ids(row_ptr)
    lo, hi = int(row_ptr[0]), int(row_ptr[-1])
    h_src, mask, dmask = _wide_edges(c, d, h, pattern, ids, src[lo:hi].long())
    ge = ct[ids]
    dlog = ge * h_src.repeat(1, kf // f) * dmask
    dc = torch.zeros((c.shape[0], kf), dtype=torch.float32, device=c.device)
    dc.index_add_(0, ids, dlog)
    if not emit_payload:
        return dc, None
    payload = torch.zeros((src.shape[0], kf + f), dtype=torch.float32, device=c.device)
    payload[lo:hi] = torch.cat([dlog, (ge * mask).reshape(-1, kf // f, f).sum(dim=1)], dim=1)
    return dc, payload


def _edge_program_bwd_kernel(c, d, h, pattern, src, row_ptr, ct, emit_payload=True):
    """Kernel 10 on the card: kernel 3's dst pass (two launches) over the
    caller's ``d``, writing the payload in the same pass; ``c`` as
    float32."""
    _check_wide_inputs("edge_program_bwd", c, d, h, pattern, src, row_ptr, ct)
    out = _lean_bwd_dst_pass(c.float(), ct, _aligned(pattern), d, h, src, row_ptr, emit_payload)
    LAUNCHES["edge_program_bwd_bf16" if _bf16(h) else "edge_program_bwd"] += 1
    return out


def edge_program_bwd(c: torch.Tensor, d: torch.Tensor, h: torch.Tensor,
                     pattern: torch.Tensor, src: torch.Tensor, row_ptr: torch.Tensor,
                     ct: torch.Tensor, emit_payload: bool = True
                     ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Dst half of :func:`edge_program`'s backward for the cotangent ``ct``
    (N, K·F).

    With ``logits_e = c[i] + d[src_e]`` on edge ``e`` of row ``i``,
    ``mask``/``dmask`` the activation and its derivative, and ``dlog_e =
    ct[i] ⊙ tile(h[src_e], K) ⊙ dmask``, returns ``dc`` (N, K·F) = ``Σ_{e ∈
    row i} dlog_e`` and, with ``emit_payload``, the per-edge payload (E,
    K·F+F) = ``[dlog_e ‖ Σ_k (ct[i] ⊙ mask_e)_k]`` for the edges the CSR
    covers, 0 for the others (else None). ``[dd ‖ dh]`` is the payload
    summed by source. ``ct``, ``dc`` and the payload are float32; ``c``,
    ``d`` and ``h`` as :func:`edge_program` takes them, every term float32.
    On the card it also takes a ``pattern`` off a 16-byte boundary (it is
    copied to one); ``c``, ``d``, ``h`` and ``ct`` must be 16-byte aligned.
    Deterministic: no atomics, chunks fixed by E.
    """
    tensors = (c, d, h, pattern, src, row_ptr, ct)
    if _on_cpu(*tensors):
        return edge_program_bwd_reference(*tensors, emit_payload)
    return _edge_program_bwd_kernel(*tensors, emit_payload)


def edge_program_bwd_csc_reference(c, d, h, pattern, dst_csc, col_ptr, ct):
    """Plain version of :func:`edge_program_bwd_csc`, with explicit
    per-edge tensors in CSC order: ``(N, K·F+F)`` float32, from float32 or
    bf16 inputs computed in float32."""
    kf, f = c.shape[1], h.shape[1]
    js = _row_ids(col_ptr)
    lo, hi = int(col_ptr[0]), int(col_ptr[-1])
    i = dst_csc[lo:hi].long()
    h_src, mask, dmask = _wide_edges(c, d, h, pattern, i, js)
    ge = ct[i]
    dlog = ge * h_src.repeat(1, kf // f) * dmask
    dh_e = (ge * mask).reshape(-1, kf // f, f).sum(dim=1)
    out = torch.zeros((c.shape[0], kf + f), dtype=torch.float32, device=c.device)
    return out.index_add_(0, js, torch.cat([dlog, dh_e], dim=1))


def _edge_program_bwd_csc_kernel(c, d, h, pattern, dst_csc, col_ptr, ct):
    """Kernel 11 on the card: kernel 3's src pass (two launches) over the
    caller's ``d``, folding ``G``'s K blocks into ``dh`` as it stores; ``c``
    as float32."""
    _check_wide_inputs("edge_program_bwd_csc", c, d, h, pattern, dst_csc, col_ptr, ct)
    out = _lean_bwd_src_pass(c.float(), ct, _aligned(pattern), d, h, dst_csc, col_ptr, fold=True)
    LAUNCHES["edge_program_bwd_csc_bf16" if _bf16(h) else "edge_program_bwd_csc"] += 1
    return out


def edge_program_bwd_csc(c: torch.Tensor, d: torch.Tensor, h: torch.Tensor,
                         pattern: torch.Tensor, dst_csc: torch.Tensor,
                         col_ptr: torch.Tensor, ct: torch.Tensor) -> torch.Tensor:
    """Src half of :func:`edge_program`'s backward in CSC order: ``[dd ‖
    dh]`` (N, K·F+F) with ``dd[s] = Σ_{e: src=s} dlog_e`` and ``dh[s] =
    Σ_{e: src=s} Σ_k (ct[i] ⊙ mask_e)_k``, ``i = dst_csc[e]``, over the
    CSC ``col_ptr``. The kernel gathers ``c[i]`` and ``ct[i]`` itself and
    recomputes the mask chain; no per-edge table is stored. ``ct`` and the
    result are float32; ``c``, ``d`` and ``h`` as :func:`edge_program` takes
    them, every term float32. On the card it also takes a ``pattern`` off a
    16-byte boundary (it is copied to one); ``c``, ``d``, ``h`` and ``ct``
    must be 16-byte aligned. Deterministic: no atomics, chunks fixed by E.
    """
    tensors = (c, d, h, pattern, dst_csc, col_ptr, ct)
    if _on_cpu(*tensors):
        return edge_program_bwd_csc_reference(*tensors)
    return _edge_program_bwd_csc_kernel(*tensors)


class _EdgeProgram(torch.autograd.Function):
    @staticmethod
    def forward(ctx, c, d, h, pattern, src, row_ptr, col_ptr, src_perm, dst_csc, bwd_mode):
        # The kernels take c as float32, as the JAX wrapper casts it
        # (mma_tpu/ops/pallas/fused_mma.py:1389); d and h go as they are.
        ctx.c_dtype = c.dtype
        c = c.float()
        ctx.save_for_backward(c, d, h, pattern, src, row_ptr, col_ptr, src_perm, dst_csc)
        ctx.bwd_mode = bwd_mode
        return edge_program_fwd(c, d, h, pattern, src, row_ptr)

    @staticmethod
    def backward(ctx, ct):
        c, d, h, pattern, src, row_ptr, col_ptr, src_perm, dst_csc = ctx.saved_tensors
        ct = ct.contiguous()
        src_side = ctx.needs_input_grad[1] or ctx.needs_input_grad[2]
        csc = ctx.bwd_mode == "csc_gather"
        dc, payload = edge_program_bwd(c, d, h, pattern, src, row_ptr, ct,
                                       emit_payload=src_side and not csc)
        dd = dh = None
        if src_side:
            both = (edge_program_bwd_csc(c, d, h, pattern, dst_csc, col_ptr, ct) if csc
                    else segment_sum_csr(payload, col_ptr, index=src_perm))
            # Rounded once to the inputs' dtypes, as the JAX VJP casts them (:1449).
            dd, dh = both[:, :c.shape[1]].to(d.dtype), both[:, c.shape[1]:].to(h.dtype)
        return dc.to(ctx.c_dtype), dd, dh, None, None, None, None, None, None, None


def edge_program(c: torch.Tensor, d: torch.Tensor, h: torch.Tensor, pattern: torch.Tensor,
                 src: torch.Tensor, row_ptr: torch.Tensor, col_ptr: torch.Tensor,
                 src_perm: torch.Tensor, dst_csc: torch.Tensor,
                 bwd_mode: Optional[str] = None) -> torch.Tensor:
    """Wide MMA edge program over the dst-sorted CSR.

    ``S[i] = Σ_{e ∈ row i} act(c[i] + d[src_e]) ⊙ tile(h[src_e], K)`` with
    the per-node mask projections ``c``, ``d`` (N, K·F), ``h`` (N, F),
    ``pattern`` (K·F,) float 0/1 (σ where 1, the identity elsewhere),
    ``src`` (E,) int32 and ``row_ptr`` (N+1,) int32 (a graph builder's
    CSR; the kernels do not check the values). The kernel gathers
    ``d[src]`` and ``h[src]`` itself; no (E, K·F+F) table is stored.
    ``d`` and ``h`` are float32 or both bf16 and ``c`` is float32 or bf16,
    as the JAX package's ``fused_mma_edge_program`` takes them: the kernels
    read bf16 ``d`` and ``h`` as they are and ``c`` as float32, compute and
    sum every term in float32 with no bf16 rounding (the JAX kernels run two
    passes whatever the dtype) and give a float32 ``S``; each gradient is
    rounded once to its input's dtype.

    Differentiable in ``c``, ``d`` and ``h``: :func:`edge_program_bwd`
    gives ``dc``; ``bwd_mode`` (None: :data:`EDGE_BWD_MODE`) chooses how
    ``[dd ‖ dh]`` is formed over the CSC ``col_ptr`` that covers the same
    edges as ``row_ptr``: ``"payload_permute"`` sums the dst pass's
    per-edge payload by source (:func:`segment_sum_csr` with
    ``index=src_perm``), ``"csc_gather"`` recomputes the mask chain in CSC
    order (:func:`edge_program_bwd_csc`, reading ``dst_csc``).
    """
    if bwd_mode is None:
        bwd_mode = EDGE_BWD_MODE
    if bwd_mode not in EDGE_BWD_MODES:
        raise ValueError(f"bwd_mode must be one of {EDGE_BWD_MODES}, got {bwd_mode!r}")
    return _EdgeProgram.apply(c, d, h, pattern, src, row_ptr, col_ptr, src_perm, dst_csc,
                              bwd_mode)


# --------------------------------------------------------------- kernel 12

def _check_masked_inputs(name, logits, h_src, pattern, row_ptr):
    """Dtypes, shapes and widths of :func:`masked_segment_sum`'s inputs, on
    any device: ``(n_rows, F, K·F)``. ``logits`` and ``h_src`` are each
    float32 or bf16."""
    for arg, t in (("logits", logits), ("h_src", h_src)):
        _check_dtype(name, arg, t, torch.float32, torch.bfloat16)
    _check_dtype(name, "pattern", pattern, torch.float32)
    _check_dtype(name, "row_ptr", row_ptr, torch.int32)
    if logits.ndim != 2 or h_src.ndim != 2 or row_ptr.ndim != 1:
        raise ValueError(f"{name}: logits must be (E, K·F), h_src (E, F) and row_ptr (N+1,)")
    (e, kf), f = logits.shape, h_src.shape[1]
    if h_src.shape[0] != e or pattern.shape != (kf,) or f == 0 or kf % f:
        raise ValueError(
            f"{name}: shapes logits{tuple(logits.shape)} h_src{tuple(h_src.shape)} "
            f"pattern{tuple(pattern.shape)} do not fit together"
        )
    if f > MAX_F or kf > MAX_KF:
        raise ValueError(f"{name}: takes F <= {MAX_F}, K·F <= {MAX_KF}; got F={f}, K·F={kf}")
    return row_ptr.shape[0] - 1, f, kf


def masked_segment_sum_reference(logits: torch.Tensor, h_src: torch.Tensor,
                                 pattern: torch.Tensor, row_ptr: torch.Tensor) -> torch.Tensor:
    """Plain version of :func:`masked_segment_sum`: ``(N, K·F)`` float32. The
    mask and the message are float32 from the inputs' values; with bf16
    ``logits`` each message is rounded to bf16 before the float32 sum."""
    mask, _ = _mask_chain(logits.float(), pattern)
    msg = mask * h_src.float().repeat(1, logits.shape[1] // h_src.shape[1])
    if logits.dtype == torch.bfloat16:
        msg = _round_bf16(msg)
    return segment_sum_reference(msg, row_ptr)


def _masked_segment_sum_kernel(logits, h_src, pattern, row_ptr):
    name = "masked_segment_sum"
    _check_cuda_inputs(name, logits=logits, h_src=h_src, pattern=pattern, row_ptr=row_ptr)
    n, f, kf = _check_masked_inputs(name, logits, h_src, pattern, row_ptr)
    # The edge positions the CSR may cover, from shapes alone (no host
    # sync): they fix kernel 1's chunks, which this kernel runs on.
    n_edges = logits.shape[0]
    dev = logits.device
    out = torch.empty((n, kf), dtype=torch.float32, device=dev)
    part, tail_row = _chunk_scratch(n_edges, kf, dev)
    # 4-lane slots: 16-byte float32 loads, 8-byte bf16 ones.
    vec4 = f % 4 == 0 and pattern.data_ptr() % 16 == 0 and all(
        t.data_ptr() % (4 * t.element_size()) == 0 for t in (logits, h_src))
    lib = _lib()
    with torch.cuda.device(dev):
        err = lib.mma_masked_segment_sum(
            logits.data_ptr(), h_src.data_ptr(), pattern.data_ptr(), row_ptr.data_ptr(),
            out.data_ptr(), part.data_ptr(), tail_row.data_ptr(), n, f, kf, n_edges, int(vec4),
            _bf16(logits), _bf16(h_src), _stream(),
        )
    _check_launch(lib, err, name)
    LAUNCHES["masked_segment_sum_bf16" if _bf16(logits) or _bf16(h_src)
             else "masked_segment_sum"] += 1
    return out


def masked_segment_sum(logits: torch.Tensor, h_src: torch.Tensor, pattern: torch.Tensor,
                       row_ptr: torch.Tensor) -> torch.Tensor:
    """``S[i] = Σ_{e ∈ row i} where(pattern, σ(logits_e), logits_e) ⊙
    tile(h_src_e, K)`` → (N, K·F) float32 over the CSR ``row_ptr`` (N+1,)
    int32, from per-edge ``logits`` (E, K·F) and ``h_src`` (E, F), each
    float32 or bf16, and ``pattern`` (K·F,) float32 0/1. Lane ``k·F + j``
    multiplies ``h_src[e, j]``; rows without edges give 0. The mask and the
    message are float32; with bf16 ``logits`` each message is rounded to
    bf16 before the float32 sum, whatever ``h_src``'s dtype, as the JAX
    wrapper keys its one-pass contraction on the logits' dtype. Takes F <=
    128 and K·F <= 512. Deterministic. Not differentiable
    (:func:`fused_masked_aggregate` is). Other dtypes raise on every
    device."""
    if _on_cpu(logits, h_src, pattern, row_ptr):
        _check_masked_inputs("masked_segment_sum", logits, h_src, pattern, row_ptr)
        return masked_segment_sum_reference(logits, h_src, pattern, row_ptr)
    return _masked_segment_sum_kernel(logits, h_src, pattern, row_ptr)


class _MaskedAggregate(torch.autograd.Function):
    @staticmethod
    def forward(ctx, logits, h_src, pattern, row_ptr):
        ctx.save_for_backward(logits, h_src, pattern, row_ptr)
        return masked_segment_sum(logits, h_src, pattern, row_ptr)

    @staticmethod
    def backward(ctx, ct):
        # The JAX package's VJP (mma_tpu/ops/pallas/fused_mma.py:1593-1607),
        # elementwise and in its dtypes: sigmoid, mask, dmask and ct[dst] in
        # the logits' dtype, dlogits in the promotion of the logits' and
        # h_src's, dh_src in the logits' (bf16 blocks added in k order, each
        # sum rounded). Autograd then casts each to its input's dtype.
        logits, h_src, pattern, row_ptr = ctx.saved_tensors
        (e, kf), f = logits.shape, h_src.shape[1]
        # ct[dst_e], 0 on edges the CSR skips.
        ge = _expand_rows(ct, row_ptr, e).to(logits.dtype)
        mask, dmask = _mask_chain(logits, pattern)
        dlogits = ge * h_src.repeat(1, kf // f) * dmask
        gm = ge * mask
        dh_src = gm[:, :f]
        for k in range(1, kf // f):
            dh_src = dh_src + gm[:, k * f:(k + 1) * f]
        return dlogits, dh_src, None, None


def fused_masked_aggregate(logits: torch.Tensor, h_src: torch.Tensor,
                           sig_pattern: torch.Tensor, graph, n_agg: int) -> torch.Tensor:
    """``S[i] = Σ_{e: dst=i} act(logits_e) ⊙ tile(h_src_e, K)`` fused → (N,
    K·F) float32, with the JAX package's name and argument order.

    ``logits``: (E, K·F) flat mask logits, pre-gathered per edge (``E =
    graph.n_edge``); ``h_src``: (E, F) gathered source features;
    ``sig_pattern``: (K·F,) bool or 0/1, the lanes that apply σ (the N1
    table); ``n_agg`` = K. The sum runs over ``graph.real_row_ptr``:
    padding edges add nothing and get zero gradient, and padding rows are 0
    (the JAX kernel sums the padding edges into them). Differentiable in
    ``logits`` and ``h_src``; the backward recomputes the activation
    elementwise, as the JAX package's custom VJP does.

    ``logits`` and ``h_src`` are each float32 or bf16. With bf16 logits
    each message is rounded to bf16 before the float32 sum, as the JAX
    wrapper's one pass on bf16 logits rounds it, and the backward runs in
    the JAX VJP's dtypes (:class:`_MaskedAggregate`). The result is float32.
    The port computes in float32 natively, so the JAX wrapper's TPU knobs
    (``block_r``, ``block_b``, ``precision``) have no counterpart. Takes F
    <= 128 and K·F <= 512 on any device.
    """
    if logits.ndim != 2 or logits.shape[0] != graph.n_edge or logits.shape[1] % n_agg:
        raise ValueError(f"fused_masked_aggregate: logits {tuple(logits.shape)} must be "
                         f"(graph.n_edge={graph.n_edge}, K·F) with K={n_agg}")
    if tuple(h_src.shape) != (logits.shape[0], logits.shape[1] // n_agg):
        raise ValueError(f"fused_masked_aggregate: h_src {tuple(h_src.shape)} must be "
                         f"{(logits.shape[0], logits.shape[1] // n_agg)}")
    pattern = sig_pattern.to(torch.float32).reshape(-1).contiguous()
    row_ptr = graph.real_row_ptr
    _check_masked_inputs("fused_masked_aggregate", logits, h_src, pattern, row_ptr)
    return _MaskedAggregate.apply(logits, h_src, pattern, row_ptr)

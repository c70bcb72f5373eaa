"""ELL (dense-neighbour) edge format: segment reductions without a scatter
on graphs of small bounded in-degree.

The port of the JAX package's ``mma_tpu/ops/ell.py``. Edges are dst-sorted
with one contiguous run per node, so neighbour slot ``(i, d)`` of node
``i`` reads edge ``row_ptr[i] + d``. Real edges and valid slots are in
bijection, and both directions of the data movement are gathers:

- expand:   ``x_slot[i, d] = x_edge[row_ptr[i] + d]``      (valid slots)
- collapse: ``x_edge[e]   = x_slot[dst_e, e − row_ptr[dst_e]]``

Every segment reduction becomes a masked reduce over the slot axis, in
plain PyTorch element-wise ops. Slot arrays are 2-D ``(rows, W·C)``: slot
``d`` owns lanes ``[d·C, (d+1)·C)``, as in the JAX package, so that the
``(rows·W, C) ↔ (rows, W·C)`` reshape is free.

An :class:`EllSpec` holds degree *buckets*: contiguous row ranges with one
width each. Each range's width must be at least the largest in-degree of
its rows (:func:`validate_spec` checks it on the host): edges past the
budget would be dropped.

Degree-exact layouts (``Graph.ell_exact``, the degree-exact collate of
``mma_tpu_torch.data.batching``) give every bucket row exactly its width
in edges, so the flat slot index equals the edge index:
:func:`ell_expand_exact` is a reshape and no slot needs a mask.

Every sum accumulates in float32.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from mma_tpu_torch.graph.container import Graph
from mma_tpu_torch.ops.cuda.fused_mma import segment_sum_csr

_NEUTRAL = {"min": float("inf"), "max": float("-inf")}


@dataclasses.dataclass(frozen=True)
class EllSpec:
    """Static degree-bucket layout: rows ``[start_b, bounds[b])`` have
    ``widths[b]`` neighbour slots each; rows ``>= bounds[-1]`` have none
    (known leaves and padding rows)."""

    bounds: Tuple[int, ...]
    widths: Tuple[int, ...]

    def __post_init__(self):
        if not len(self.bounds) == len(self.widths) >= 1:
            raise ValueError(f"bounds {self.bounds} and widths {self.widths} must pair up")
        if any(b <= a for a, b in zip((0,) + self.bounds[:-1], self.bounds)):
            raise ValueError(f"bounds {self.bounds} must increase from above 0")

    @property
    def starts(self) -> Tuple[int, ...]:
        return (0,) + self.bounds[:-1]

    @property
    def rows(self) -> Tuple[int, ...]:
        return tuple(e - s for s, e in zip(self.starts, self.bounds))

    @classmethod
    def from_hint(cls, ell_hint) -> "EllSpec":
        """The spec of a graph's ``ell_hint``, ``((bound, width), ...)``."""
        return cls(bounds=tuple(b for b, _ in ell_hint), widths=tuple(w for _, w in ell_hint))


def single_width_spec(n_rows: int, width: int) -> EllSpec:
    return EllSpec(bounds=(int(n_rows),), widths=(int(width),))


def validate_spec(graph: Graph, spec: EllSpec) -> None:
    """Host-side check that every real row's run of edges fits its bucket's
    width and that rows past the last bound have no real in-edges."""
    rp = graph.row_ptr.cpu().numpy()
    run = np.diff(rp) * graph.node_mask.cpu().numpy()
    for s, e, w in zip(spec.starts, spec.bounds, spec.widths):
        worst = run[s:e].max(initial=0)
        if worst > w:
            raise ValueError(f"ELL bucket rows [{s}, {e}) width {w} < max in-degree {int(worst)}")
    tail = run[spec.bounds[-1]:].max(initial=0)
    if tail > 0:
        raise ValueError(f"rows ≥ {spec.bounds[-1]} have in-edges (max run {int(tail)}) "
                         "but no ELL slots")


def max_indegree(graph: Graph) -> int:
    """Host-side largest real in-degree (to size a single-width spec)."""
    return int(graph.deg.max().item()) if graph.deg.numel() else 0


def _bucket_ids(graph: Graph, spec: EllSpec) -> List[Tuple[torch.Tensor, torch.Tensor]]:
    """Per bucket: the clipped edge ids ``(R_b, W_b)`` of its slots and
    their validity ``(R_b, W_b)``.

    Validity comes from the CSR run length (``row_ptr``), not from ``deg``:
    a sampled subgraph's ``deg`` holds full-graph degrees while its runs
    hold only the sampled edges. Real rows' runs hold only real edges
    (padding edges sit in padding rows, which ``node_mask`` excludes)."""
    rp = graph.row_ptr.long()
    out = []
    for s, b, w in zip(spec.starts, spec.bounds, spec.widths):
        base = rp[s:b]
        d = torch.arange(w, device=rp.device)[None, :]
        ids = torch.clamp(base[:, None] + d, max=graph.n_edge - 1)
        valid = (d < (rp[s + 1:b + 1] - base)[:, None]) & graph.node_mask[s:b, None]
        out.append((ids, valid))
    return out


def ell_valid(graph: Graph, spec: EllSpec) -> Tuple[torch.Tensor, ...]:
    """Per-bucket ``(R_b, W_b)`` bool slot-validity masks."""
    return tuple(v for _, v in _bucket_ids(graph, spec))


def _slot_of_edge(graph: Graph, spec: EllSpec) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(slot, ok)``, both ``(E,)``: each edge's row in the flat
    concatenated ``(Σ R_b·W_b, C)`` slot array, the inverse of the slot →
    edge map. Edges whose dst row has no slot for them (padding edges, and
    edges past a bucket's width, which break the spec's contract) get
    ``ok = False``."""
    dst = graph.dst.long()
    rank = torch.arange(graph.n_edge, device=dst.device) - graph.row_ptr.long()[dst]
    slot = torch.zeros_like(dst)
    ok = torch.zeros_like(graph.edge_mask)
    off = 0
    for s, b, w in zip(spec.starts, spec.bounds, spec.widths):
        in_b = (dst >= s) & (dst < b) & (rank < w)
        slot = torch.where(in_b, off + (dst - s) * w + rank, slot)
        ok = ok | in_b
        off += (b - s) * w
    return slot, ok & graph.edge_mask


def _collapse(flat: torch.Tensor, graph: Graph, spec: EllSpec, out_dtype) -> torch.Tensor:
    """``(Σ R_b·W_b, C)`` flat slot values → ``(E, C)`` edge values, 0 for
    the edges without a slot: one gather, no scatter."""
    slot, ok = _slot_of_edge(graph, spec)
    flat = flat.to(out_dtype)
    return torch.where(ok[:, None], flat.index_select(0, slot.clamp(0, flat.shape[0] - 1)), 0.0)


def _flat(cts: Sequence[torch.Tensor], c: int) -> torch.Tensor:
    return torch.cat([ct.reshape(-1, c) for ct in cts], dim=0)


class _EllExpand(torch.autograd.Function):
    @staticmethod
    def forward(ctx, edge_data, graph, spec):
        ctx.graph, ctx.spec, ctx.c = graph, spec, edge_data.shape[1]
        return tuple(edge_data.index_select(0, ids.reshape(-1)).reshape(ids.shape[0], -1)
                     for ids, _ in _bucket_ids(graph, spec))

    @staticmethod
    def backward(ctx, *cts):
        return _collapse(_flat(cts, ctx.c), ctx.graph, ctx.spec, cts[0].dtype), None, None


def ell_expand(edge_data: torch.Tensor, graph: Graph, spec: EllSpec) -> Tuple[torch.Tensor, ...]:
    """Compact dst-sorted edge data ``(E, C)`` → per-bucket slot blocks
    ``(R_b, W_b·C)``.

    Invalid slots hold arbitrary (clip-gathered) rows: callers mask them
    (:func:`ell_valid`) before any reduction, so that their cotangents are
    0. Under that contract the backward is the exact adjoint, one gather
    back to edge order (padding edges get 0), never a scatter."""
    if edge_data.ndim != 2 or edge_data.shape[0] != graph.n_edge:
        raise ValueError(f"edge_data must be (E={graph.n_edge}, C), got {tuple(edge_data.shape)}")
    return _EllExpand.apply(edge_data, graph, spec)


def ell_collapse(slot_data: Sequence[torch.Tensor], graph: Graph, spec: EllSpec,
                 channels: int) -> torch.Tensor:
    """The inverse of :func:`ell_expand` on values: per-bucket
    ``(R_b, W_b·C)`` slot data → ``(E, C)`` edge data."""
    flat = _flat(slot_data, channels)
    return _collapse(flat, graph, spec, flat.dtype)


def _csc_order(graph: Graph) -> Tuple[torch.Tensor, torch.Tensor]:
    """The graph's CSC permutation (int64) and offsets; for a graph that
    carries no CSC view, the same derived on its device: a stable argsort
    of ``src`` (the list is dst-sorted, so that is the src-major, dst-minor
    order) and a searchsorted, as ``finish_graph_on_device`` derives them."""
    if graph.src_perm is not None and graph.col_ptr is not None:
        return graph.src_perm.long(), graph.col_ptr
    perm = torch.argsort(graph.src, stable=True)
    rows = torch.arange(graph.n_node + 1, dtype=graph.src.dtype, device=graph.src.device)
    return perm, torch.searchsorted(graph.src[perm], rows, out_int32=True)


class _EllGatherNodesBySrc(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, graph, spec):
        ctx.graph, ctx.spec, ctx.c, ctx.dtype = graph, spec, x.shape[1], x.dtype
        src = graph.src.long()
        return tuple(x.index_select(0, src[ids.reshape(-1)]).reshape(ids.shape[0], -1)
                     for ids, _ in _bucket_ids(graph, spec))

    @staticmethod
    def backward(ctx, *cts):
        g = ctx.graph
        # Collapse straight into CSC order (the slot → edge map composed
        # with the CSC permutation, one integer gather), so the wide rows
        # are gathered once, then reduce each source's contiguous run with
        # kernel 1.
        # The rows keep the table's dtype (a bf16 table's go to kernel 1's
        # bf16 form); the sums are float32, cast back as the JAX VJP does.
        slot, ok = _slot_of_edge(g, ctx.spec)
        perm, col_ptr = _csc_order(g)
        flat = _flat(cts, ctx.c).to(ctx.dtype)
        rows = flat.index_select(0, slot[perm].clamp(0, flat.shape[0] - 1))
        ct_csc = torch.where(ok[perm][:, None], rows, 0.0)
        return segment_sum_csr(ct_csc, col_ptr).to(ctx.dtype), None, None


def ell_gather_nodes_by_src(x: torch.Tensor, graph: Graph, spec: EllSpec
                            ) -> Tuple[torch.Tensor, ...]:
    """Per-slot source-node rows: bucket arrays ``(R_b, W_b·C)`` whose slot
    ``d`` lanes hold ``x[src[row_ptr[i] + d]]``.

    The forward is one gather of a gather (slot → edge → source row). The
    backward is a src-keyed segment sum of the slot cotangents: collapsed
    into CSC edge order and reduced by kernel 1 over ``Graph.col_ptr``,
    never a scatter. A graph without the CSC fields gets that order derived
    in the backward (where the JAX package falls back to an XLA scatter).
    Invalid slots hold arbitrary rows, as in :func:`ell_expand`: callers
    mask them."""
    if x.ndim != 2 or x.shape[0] != graph.n_node:
        raise ValueError(f"x must be (N={graph.n_node}, C), got {tuple(x.shape)}")
    return _EllGatherNodesBySrc.apply(x, graph, spec)


def ell_expand_exact(edge_data: torch.Tensor, spec: EllSpec) -> Tuple[torch.Tensor, ...]:
    """Degree-exact slot expand: per-bucket ``(R_b, W_b·C)`` views of the
    edge stream by reshape alone, valid only for ``Graph.ell_exact``
    layouts (the flat slot index is the edge index). No gather forward or
    backward."""
    c = edge_data.shape[1]
    out, off = [], 0
    for r, w in zip(spec.rows, spec.widths):
        out.append(edge_data[off:off + r * w].reshape(r, w * c))
        off += r * w
    return tuple(out)


def slot_slices(x2: torch.Tensor, w: int) -> List[torch.Tensor]:
    """The ``w`` per-slot ``(rows, C)`` lane slices of a ``(rows, W·C)`` block."""
    c = x2.shape[1] // w
    return [x2[:, d * c:(d + 1) * c] for d in range(w)]


def masked_slot_sum(x2: torch.Tensor, valid: Optional[torch.Tensor], w: int) -> torch.Tensor:
    """Masked float32 sum over the slot axis, ``(R, W·C) → (R, C)``, slot by
    slot in order; autograd's own backward is exact. ``valid=None`` means
    every slot is valid (degree-exact layouts)."""
    acc = None
    for d, xd in enumerate(slot_slices(x2, w)):
        xd = xd.float()
        term = xd if valid is None else torch.where(valid[:, d:d + 1], xd, 0.0)
        acc = term if acc is None else acc + term
    return acc


def _minmax(x2, valid, ops, w):
    c = x2.shape[1] // w
    outs = []
    for op in ops:
        red = torch.minimum if op == "min" else torch.maximum
        acc = torch.full((x2.shape[0], c), _NEUTRAL[op], dtype=x2.dtype, device=x2.device)
        for d, xd in enumerate(slot_slices(x2, w)):
            acc = red(acc, xd) if valid is None else torch.where(valid[:, d:d + 1],
                                                                 red(acc, xd), acc)
        outs.append(acc)
    return tuple(outs)


class _MaskedMinmaxFirstHit(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x2, valid, ops, w):
        outs = _minmax(x2, valid, ops, w)
        ctx.save_for_backward(x2, valid, *outs)
        ctx.w = w
        return outs

    @staticmethod
    def backward(ctx, *cts):
        x2, valid, *outs = ctx.saved_tensors
        taken = [torch.zeros_like(out, dtype=torch.bool) for out in outs]
        parts = []
        for d, xd in enumerate(slot_slices(x2, ctx.w)):
            dxd = torch.zeros_like(xd)
            for pi, (out, ct) in enumerate(zip(outs, cts)):
                hit = xd == out
                if valid is not None:
                    hit = hit & valid[:, d:d + 1]
                dxd = dxd + torch.where(hit & ~taken[pi], ct, 0.0)
                taken[pi] = taken[pi] | hit
            parts.append(dxd)
        return torch.cat(parts, dim=1), None, None, None


def masked_minmax_firsthit(x2: torch.Tensor, valid: Optional[torch.Tensor],
                           ops: Sequence[str], w: int) -> Tuple[torch.Tensor, ...]:
    """Per-op masked reduce over the slot axis of ``x2`` ``(R, W·C)``: one
    ``(R, C)`` tensor per op, the op's neutral (±inf) on rows without a
    valid slot (for the caller's degree select).

    Each (row, channel, op) cotangent goes to the FIRST valid slot, in slot
    order, whose value equals the optimum: slots are in CSR order (src
    ascending), so this is ``torch_scatter``'s argmin/argmax and kernel 5's
    first-hit rule. ``valid=None`` means every slot is valid."""
    ops = tuple(ops)
    if not ops or any(o not in _NEUTRAL for o in ops):
        raise ValueError(f"ops must be a non-empty sequence of 'min'/'max', got {ops}")
    return _MaskedMinmaxFirstHit.apply(x2, valid, ops, w)


def pad_rows(x: torch.Tensor, n_rows: int) -> torch.Tensor:
    """Zero-pad an ``(R, C)`` per-bucket concatenation to ``(n_rows, C)``."""
    return torch.nn.functional.pad(x, (0, 0, 0, n_rows - x.shape[0]))

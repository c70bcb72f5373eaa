"""Node-sharded execution with an overlapped halo exchange: the large-graph regime.

The port of ``mma_tpu/parallel/node_sharded.py``. ``edge_parallel``
replicates the node rows and shards the edges, which stops where ``(N, F)``
no longer fits one card. Here the *nodes* are sharded:

- the nodes are cut into contiguous, edge-balanced row ranges
  (``native.balanced_row_cuts``), one per rank; a rank owns its rows'
  values and every in-edge of those rows (the CSR rows partition the
  dst-sorted edge list);
- a message may need a source row that another rank owns, the *halo*. The
  host plan (:func:`build_node_sharded`) lists, for every pair of ranks
  (q → p), the rows q must send p, and at run time one all-to-all
  (:func:`~mma_tpu_torch.parallel.collectives.all_to_all`) moves exactly
  those rows;
- the exchange overlaps compute: the local edges are split on the host into
  *interior* edges (source owned here) and *boundary* edges (source in the
  halo, a compact side list ``bnd_*``). The interior reduce reads local
  rows only, so :func:`halo_spmm` starts the exchange, runs the interior
  reduce, and waits for the halo only before the boundary gather, where
  the JAX package leaves that order to XLA's scheduler;
- each reduce is kernel 1 (``segment_sum_csr``) over the rank's own CSR
  (``row_ptr`` over the interior list, ``bnd_row_ptr`` over the boundary
  list), its plain version on the CPU. No kernel is new.

The host plan is numpy arrays stacked along a leading shard axis ``S``,
field for field and bit for bit the JAX package's plan. Each rank holds
only its own row of it (:func:`place_on_mesh`), as tensors on its device;
the JAX package keeps the stack and lets ``shard_map`` hand each device
its row.

Gradients follow the rule of :mod:`mma_tpu_torch.parallel.collectives`
(its docstring reads it for this regime): every rank holds the global loss
``psum(lsum) / psum(lcnt)`` and backpropagates ``loss / S``; ``psum``'s
backward all-reduces, the all-to-all's backward routes the halo cotangents
home, and :func:`~mma_tpu_torch.parallel.collectives.psum_grads` sums the
parameter gradients before the optimizer step. Dropout draws from one
generator per rank, seeded ``seed · S + rank`` (the JAX package folds the
axis index into its key).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple, Union

import numpy as np
import torch
from torch.distributed.device_mesh import DeviceMesh

from mma_tpu_torch.graph import native
from mma_tpu_torch.graph.build import graph_from_edges
from mma_tpu_torch.graph.container import Graph
from mma_tpu_torch.nn.layers import dropout as feature_dropout
from mma_tpu_torch.ops.cuda.fused_mma import segment_sum_csr
from mma_tpu_torch.ops.gather import gather_by_csr
from mma_tpu_torch.ops.scalers import apply_scalers
from mma_tpu_torch.parallel.collectives import (
    AxisName,
    PendingAllToAll,
    all_to_all_start,
    axis_size,
    psum,
    psum_grads,
    psum_no_grad,
)


Array = Union[np.ndarray, torch.Tensor]


@dataclasses.dataclass
class NodeShardedGraph:
    """Per-shard graph structure: the host plan stacks it along a leading
    shard axis ``S`` (numpy); a rank's piece (:func:`place_on_mesh`) is its
    row, as tensors, without that axis.

    Shapes: ``S`` shards, ``N_m`` rows per shard (the most any shard owns,
    plus one padding row), ``E_m`` local edges, ``H_m`` halo rows per
    (sender, receiver) pair, ``B_m`` boundary edges. Edge sources index the
    extended value table ``[N_m local ‖ S·H_m halo]`` (halo slot ``j`` of
    sender ``q`` ↦ ``N_m + q·H_m + j``). Boundary edges (source remote)
    also appear in the compact ``bnd_*`` side list, whose ``bnd_halo``
    indexes the flat halo buffer directly (``q·H_m + j``), so that the
    interior reduce, which never reads the halo, and the exchange overlap.
    """

    ext_src: Array  # (S, E_m) int32: src as extended-table index
    dst_local: Array  # (S, E_m) int32: dst as local row, sorted
    edge_mask: Array  # (S, E_m) bool
    deg: Array  # (S, N_m) float32: true in-degree of local rows
    node_mask: Array  # (S, N_m) bool
    global_ids: Array  # (S, N_m) int32: local row → global id (pad -1)
    send_idx: Array  # (S, S, H_m) int32: local rows shard p sends to q
    send_mask: Array  # (S, S, H_m) bool
    bnd_halo: Array  # (S, B_m) int32: boundary edge → halo-flat row
    bnd_dst: Array  # (S, B_m) int32: boundary edge dst (local, sorted)
    bnd_mask: Array  # (S, B_m) bool
    # Local CSR row pointers over dst_local / bnd_dst (padding edges
    # counted in the last row, which is always a padding row): kernel 1's
    # structure on each shard.
    row_ptr: Array  # (S, N_m+1) int32
    bnd_row_ptr: Array  # (S, N_m+1) int32


def _host(t) -> np.ndarray:
    return t.cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def _real_edges(graph: Graph):
    """``(src, dst, num_nodes)``: the graph's real edges, in order, on the host."""
    e_mask = _host(graph.edge_mask)
    return (_host(graph.src)[e_mask], _host(graph.dst)[e_mask],
            int(_host(graph.node_mask).sum()))


def partition_order(graph: Graph, num_shards: int, method: str = "ldg") -> np.ndarray:
    """Locality-aware node order for the node-sharded regime: the original
    node ids arranged so that each shard's nodes are one contiguous block,
    from the native LDG streaming partitioner (``graph/native.partition_ldg``:
    each node goes to the part holding most of its placed neighbours, edge
    load balanced). ``method="contiguous"``, or a missing native library,
    gives the identity order."""
    src, dst, num_nodes = _real_edges(graph)
    if method == "ldg":
        row_ptr = np.zeros(num_nodes + 1, np.int64)
        np.cumsum(np.bincount(dst, minlength=num_nodes), out=row_ptr[1:])
        part = native.partition_ldg(row_ptr, src, num_shards)
        if part is not None:
            return np.argsort(part, kind="stable").astype(np.int64)
    return np.arange(num_nodes, dtype=np.int64)


def build_node_sharded_ordered(graph: Graph, num_shards: int, method: str = "ldg"
                               ) -> Tuple[NodeShardedGraph, np.ndarray, np.ndarray]:
    """Partition and halo plan under a locality-aware node order:
    ``(sg, cuts, order)``, the stacked host plan, the cut points in the
    reordered node sequence, and ``order`` (original ids; shard ``p`` owns
    ``order[cuts[p]:cuts[p+1]]``). Pass ``order`` to
    :func:`shard_node_values` so that features and labels follow;
    ``sg.global_ids`` holds original ids."""
    order = partition_order(graph, num_shards, method)
    src, dst, num_nodes = _real_edges(graph)
    if np.array_equal(order, np.arange(num_nodes)):
        sg, cuts = build_node_sharded(graph, num_shards)
        return sg, cuts, order
    inv = np.empty(num_nodes, np.int64)
    inv[order] = np.arange(num_nodes)
    g2 = graph_from_edges(inv[src].astype(np.int32), inv[dst].astype(np.int32), num_nodes,
                          n_node_pad=graph.n_node, n_edge_pad=graph.n_edge, device="cpu")
    sg, cuts = build_node_sharded(g2, num_shards)
    gids = sg.global_ids.copy()
    valid = gids >= 0
    gids[valid] = order[gids[valid]]
    return dataclasses.replace(sg, global_ids=gids), cuts, order


def _round_edges(m: int) -> int:
    """The JAX plan's edge pads: a multiple of 128, and of 1,024 above it
    (its Pallas kernel's block)."""
    m = max(((m + 127) // 128) * 128, 128)
    if m > 1024:
        m = ((m + 1023) // 1024) * 1024
    return m


def build_node_sharded(graph: Graph, num_shards: int) -> Tuple[NodeShardedGraph, np.ndarray]:
    """Host-side partition and halo plan: the stacked structure (numpy) and
    the row cut points (``(num_shards + 1,)`` int32 global node ids)."""
    src, dst, num_nodes = _real_edges(graph)
    deg_global = _host(graph.deg)

    row_ptr = np.zeros(num_nodes + 1, np.int64)
    np.cumsum(np.bincount(dst, minlength=num_nodes), out=row_ptr[1:])
    cuts = native.balanced_row_cuts(row_ptr.astype(np.int32), num_shards)
    owner = np.repeat(np.arange(num_shards, dtype=np.int32), np.diff(cuts))

    # Per shard p: its edges (dst in its range) and, per sender q, the
    # sorted unique sources q owns (the rows q sends p).
    per_shard, halo = [], [[None] * num_shards for _ in range(num_shards)]
    for p in range(num_shards):
        lo, hi = int(cuts[p]), int(cuts[p + 1])
        e_sel = (dst >= lo) & (dst < hi)
        s_p, d_p = src[e_sel], dst[e_sel]
        own = owner[s_p]
        for q in range(num_shards):
            if q != p:
                halo[q][p] = np.unique(s_p[own == q])
        per_shard.append((lo, hi, s_p, d_p, own))

    n_m = int(np.diff(cuts).max()) + 1
    e_m = _round_edges(max(len(ps[2]) for ps in per_shard))
    h_m = max((len(halo[q][p]) for q in range(num_shards) for p in range(num_shards) if q != p),
              default=0)
    h_m = max(((h_m + 7) // 8) * 8, 8)
    b_m = _round_edges(max(int((ps[4] != p).sum()) for p, ps in enumerate(per_shard)))

    ext_src = np.zeros((num_shards, e_m), np.int32)
    dst_local = np.full((num_shards, e_m), n_m - 1, np.int32)
    edge_mask = np.zeros((num_shards, e_m), bool)
    deg = np.zeros((num_shards, n_m), np.float32)
    node_mask = np.zeros((num_shards, n_m), bool)
    global_ids = np.full((num_shards, n_m), -1, np.int32)
    send_idx = np.zeros((num_shards, num_shards, h_m), np.int32)
    send_mask = np.zeros((num_shards, num_shards, h_m), bool)
    bnd_halo = np.zeros((num_shards, b_m), np.int32)
    bnd_dst = np.full((num_shards, b_m), n_m - 1, np.int32)
    bnd_mask = np.zeros((num_shards, b_m), bool)
    row_ptr_l = np.zeros((num_shards, n_m + 1), np.int32)
    bnd_row_ptr = np.zeros((num_shards, n_m + 1), np.int32)

    for p, (lo, hi, s_p, d_p, own) in enumerate(per_shard):
        n_loc, k = hi - lo, len(s_p)
        node_mask[p, :n_loc] = True
        global_ids[p, :n_loc] = np.arange(lo, hi)
        deg[p, :n_loc] = deg_global[lo:hi]
        dst_local[p, :k] = d_p - lo  # dst-sorted: a contiguous slice of the list
        edge_mask[p, :k] = True
        ext = (s_p - lo).astype(np.int32)
        for q in range(num_shards):
            if q == p:
                continue
            rows = halo[q][p]
            send_idx[q, p, :len(rows)] = rows - int(cuts[q])  # q-local rows
            send_mask[q, p, :len(rows)] = True
            sel = own == q
            # The halo lists are sorted, so a search gives each source's slot.
            ext[sel] = n_m + q * h_m + np.searchsorted(rows, s_p[sel])
        ext_src[p, :k] = ext
        # The boundary side list, dst-sorted (taken in edge order).
        remote = own != p
        nb = int(remote.sum())
        bnd_halo[p, :nb] = ext[remote] - n_m
        bnd_dst[p, :nb] = d_p[remote] - lo
        bnd_mask[p, :nb] = True
        # Local CSRs over all E_m / B_m slots (padding edges in the last row).
        np.cumsum(np.bincount(dst_local[p], minlength=n_m), out=row_ptr_l[p, 1:])
        np.cumsum(np.bincount(bnd_dst[p], minlength=n_m), out=bnd_row_ptr[p, 1:])

    return (NodeShardedGraph(ext_src=ext_src, dst_local=dst_local, edge_mask=edge_mask, deg=deg,
                             node_mask=node_mask, global_ids=global_ids, send_idx=send_idx,
                             send_mask=send_mask, bnd_halo=bnd_halo, bnd_dst=bnd_dst,
                             bnd_mask=bnd_mask, row_ptr=row_ptr_l, bnd_row_ptr=bnd_row_ptr),
            np.asarray(cuts))


def shard_spec(axis: str) -> NodeShardedGraph:
    """Every field is sharded along ``axis`` (the JAX package's spec tree of
    ``PartitionSpec``s, as documentation: here each rank holds its row)."""
    return NodeShardedGraph(*([axis] * len(dataclasses.fields(NodeShardedGraph))))


def place_on_mesh(sharded, mesh: DeviceMesh, axis: str = "node", device=None):
    """This rank's row of a stacked host plan, as tensors on ``device``
    (default: the mesh's): a :class:`NodeShardedGraph` field by field, or a
    stacked array such as :func:`shard_node_values` gives (this rank's
    block; the JAX function maps over any tree of stacked arrays)."""
    rank = mesh.get_local_rank(axis)
    dev = torch.device(mesh.device_type if device is None else device)

    def row(a):
        return torch.from_numpy(np.ascontiguousarray(_host(a)[rank])).to(dev)

    if isinstance(sharded, NodeShardedGraph):
        return NodeShardedGraph(*(row(getattr(sharded, f.name))
                                  for f in dataclasses.fields(NodeShardedGraph)))
    return row(sharded)


def shard_node_values(values, cuts: np.ndarray, n_m: int, order: Optional[np.ndarray] = None
                      ) -> np.ndarray:
    """The stacked per-shard blocks ``(S, N_m, ...)`` of global node values
    ``(N, ...)``, zero past each shard's rows; ``order`` is the node order
    of :func:`build_node_sharded_ordered` (None: the identity). A rank
    takes its block with :func:`place_on_mesh`."""
    values = _host(values)
    if order is not None:
        values = values[order]
    s = len(cuts) - 1
    out = np.zeros((s, n_m) + values.shape[1:], values.dtype)
    for p in range(s):
        lo, hi = int(cuts[p]), int(cuts[p + 1])
        out[p, :hi - lo] = values[lo:hi]
    return out


def _start_halo_exchange(values_local: torch.Tensor, sg: NodeShardedGraph,
                         axis_name: AxisName) -> PendingAllToAll:
    """Gather the rows this shard sends each receiver, zero the unused slots
    and start the all-to-all (its result: the flat halo buffer, once
    reshaped)."""
    s, h_m = sg.send_idx.shape
    buf = values_local.index_select(0, sg.send_idx.reshape(-1)).reshape(s, h_m, -1)
    buf = torch.where(sg.send_mask[..., None], buf, 0.0)
    return all_to_all_start(buf.reshape(s * h_m, -1), axis_name)


def halo_exchange(values_local: torch.Tensor, sg: NodeShardedGraph, axis_name: AxisName
                  ) -> torch.Tensor:
    """The flat halo buffer ``(S·H_m, F)`` this shard receives: one
    all-to-all that moves exactly the planned boundary rows.
    ``values_local`` is this shard's ``(N_m, F)`` rows; ``axis_name`` the
    node axis's process group. Its backward is the reverse exchange."""
    return _start_halo_exchange(values_local, sg, axis_name).wait().reshape(
        -1, values_local.shape[-1])


def _seg_sum(data: torch.Tensor, row_ptr: torch.Tensor) -> torch.Tensor:
    """Shard-local dst-keyed segment sum: kernel 1 over the shard's CSR on
    the card, its plain version on the CPU. Callers zero padding data rows;
    padding edges sit in the last (padding) row."""
    return segment_sum_csr(data, row_ptr)


def _interior_gather(values_local: torch.Tensor, sg: NodeShardedGraph):
    """Per-edge source rows for the interior edges, 0 for boundary and
    padding edges (routed to an appended zero row): no halo needed."""
    n_m = values_local.shape[0]
    vz = torch.cat([values_local, values_local.new_zeros((1, values_local.shape[1]))])
    is_int = (sg.ext_src < n_m) & sg.edge_mask
    idx = torch.where(is_int, sg.ext_src, n_m)
    return vz.index_select(0, idx), is_int


def halo_spmm(values_local: torch.Tensor, sg: NodeShardedGraph, axis_name: AxisName,
              use_pallas: bool = False) -> torch.Tensor:
    """``A @ values`` restricted to this shard's rows: the exchange starts,
    the interior edges reduce local rows meanwhile, and the boundary edges
    reduce the halo rows once it has arrived. ``use_pallas`` is ignored:
    the route follows the device (kernel 1 on the card)."""
    del use_pallas
    pending = _start_halo_exchange(values_local, sg, axis_name)
    vals_int, _ = _interior_gather(values_local, sg)
    out = _seg_sum(vals_int, sg.row_ptr)
    halo = pending.wait().reshape(-1, values_local.shape[-1])
    bvals = torch.where(sg.bnd_mask[:, None], halo.index_select(0, sg.bnd_halo), 0.0)
    return out + _seg_sum(bvals, sg.bnd_row_ptr)


def _mma_local_forward(model, x_local: torch.Tensor, sg: NodeShardedGraph,
                       axis_name: AxisName, generator: Optional[torch.Generator] = None,
                       training: bool = False) -> torch.Tensor:
    """One shard's :class:`~mma_tpu_torch.models.NodeClassifier` forward
    (log-probabilities ``(N_m, C)``), in float32 as the JAX package's.

    ``generator`` (this rank's) turns on the between-layer feature dropout
    (with ``training``) and the mask dropout (N2), drawn in the JAX order:
    the features, then the interior edges' masks, then the boundary's."""
    # ops.masked_aggregate imports this package (its collectives).
    from mma_tpu_torch.ops.masked_aggregate import (
        _EPS,
        mma_mask_projections,
        sigmoid_lane_pattern,
    )

    mma = model.mma
    specs = mma.specs
    k = len(specs)
    n_m = x_local.shape[0]
    f_hid = model.gc1.out_features

    # --- gc1: support halo + SpMM + bias + relu (+ dropout)
    h = torch.relu(halo_spmm(x_local @ model.gc1.w, sg, axis_name) + model.gc1.b)
    h = feature_dropout(h, model.dropout_rate, generator if training else None)

    # --- the masked aggregation, interior ‖ boundary, the exchange overlapped
    c, d = mma_mask_projections(h, mma.masks)  # (N_m, K·F)
    dh = torch.cat([d, h], dim=1)
    pending = _start_halo_exchange(dh, sg, axis_name)
    pat = sigmoid_lane_pattern(specs, mma.activation, mma.parity, f_hid, h.device).bool()
    need_m2 = any(sp.combine == "std" for sp in specs)
    need_m3 = any(sp.combine == "moment_3" for sp in specs)
    rate = mma.mask_dropout
    mask_gen = generator if rate > 0.0 else None

    def edge_msgs(dh_rows, dst_idx, row_ptr, valid):
        logits = gather_by_csr(c, dst_idx, row_ptr) + dh_rows[:, :k * f_hid]
        mask = torch.where(pat, torch.sigmoid(logits), logits)
        if mask_gen is not None:
            keep = torch.rand(mask.shape, generator=mask_gen, device=mask.device) >= rate
            mask = torch.where(keep, mask / (1.0 - rate), 0.0)
        msgs = mask * dh_rows[:, k * f_hid:].repeat(1, k)
        return torch.where(valid[:, None], msgs, 0.0)

    dh_int, is_int = _interior_gather(dh, sg)
    m_int = edge_msgs(dh_int, sg.dst_local, sg.row_ptr, is_int)
    halo_dh = pending.wait().reshape(-1, dh.shape[1])
    m_bnd = edge_msgs(halo_dh.index_select(0, sg.bnd_halo), sg.bnd_dst, sg.bnd_row_ptr, sg.bnd_mask)

    def both_sums(fi, fb):
        return (_seg_sum(fi, sg.row_ptr) + _seg_sum(fb, sg.bnd_row_ptr)).reshape(n_m, k, f_hid)

    s = both_sums(m_int, m_bnd)
    s2 = both_sums(m_int * m_int, m_bnd * m_bnd) if need_m2 else None
    s3 = None
    if need_m3:
        # The two-pass central moment: cube the centered messages (the
        # raw-moment form cancels for low-degree rows).
        mean_flat = (s / torch.clamp(sg.deg, min=1.0)[:, None, None]).reshape(n_m, k * f_hid)
        c_int = torch.where(is_int[:, None],
                            (m_int - gather_by_csr(mean_flat, sg.dst_local, sg.row_ptr)) ** 3,
                            0.0)
        c_bnd = torch.where(sg.bnd_mask[:, None],
                            (m_bnd - gather_by_csr(mean_flat, sg.bnd_dst, sg.bnd_row_ptr)) ** 3,
                            0.0)
        s3 = both_sums(c_int, c_bnd)

    deg = torch.clamp(sg.deg, min=1.0)[:, None]
    msum = 0.0
    for idx, sp in enumerate(specs):
        sk = s[:, idx, :]
        if sp.combine == "sum":
            out = h + sk
        elif sp.combine == "mean":
            out = (h + sk) / deg
        elif sp.combine == "max":
            out = torch.maximum(h, sk)
        elif sp.combine == "min":
            out = torch.minimum(h, sk)
        elif sp.combine == "passthrough":
            out = sk
        elif sp.combine == "std":
            mean, mean_sq = sk / deg, s2[:, idx, :] / deg
            out = torch.sqrt(torch.relu(mean_sq - mean * mean) + _EPS)
        elif sp.combine == "normalized_mean":
            out = sk * torch.rsqrt(deg)
        elif sp.combine == "moment_3":
            m3 = s3[:, idx, :] / deg
            out = m3 * (m3 * m3 + _EPS) ** (-1.0 / 3.0)  # the continuous signed cube root
        else:
            raise ValueError(f"unknown combine {sp.combine!r}")
        msum = msum + out
    # Fixed-mode scalers normalize by the GLOBAL mean log-degree: the local
    # sums summed over the ranks (parity mode never reads it).
    avg_log_deg = None
    if not mma.parity:
        lsum = psum_no_grad(torch.where(sg.node_mask, torch.log(sg.deg + 1.0), 0.0).sum(),
                            axis_name)
        lcnt = psum_no_grad(sg.node_mask.to(torch.float32).sum(), axis_name)
        avg_log_deg = lsum / torch.clamp(lcnt, min=1.0)
    scaled = apply_scalers(msum, sg.deg, sg.node_mask, mma.scalers, parity=mma.parity,
                           avg_log_deg=avg_log_deg)

    # --- the final SpMM
    out = halo_spmm(scaled @ mma.w, sg, axis_name) + mma.b
    return torch.log_softmax(out, dim=-1)


def make_node_sharded_forward(model, mesh: DeviceMesh, axis: str = "node",
                              use_pallas: bool = False):
    """Edge-balanced node-sharded forward of a
    :class:`~mma_tpu_torch.models.NodeClassifier`: ``forward(x_local,
    sg_local) -> logp_local`` (``(N_m, C)``), ``x_local`` and ``sg_local``
    this rank's pieces (:func:`place_on_mesh`). Deterministic (dropout
    off) and differentiable; :func:`make_node_sharded_train_step` trains.
    ``use_pallas`` is ignored: the route follows the device."""
    del use_pallas
    group = mesh.get_group(axis)

    def forward(x_local: torch.Tensor, sg_local: NodeShardedGraph) -> torch.Tensor:
        return _mma_local_forward(model, x_local, sg_local, group)

    return forward


def make_node_sharded_train_step(model, opt, mesh: DeviceMesh, axis: str = "node",
                                 dropout: bool = True, use_pallas: bool = False):
    """The full training step of the node-sharded regime: ``step(x_local,
    sg_local, labels_local, train_mask_local, seed=None) -> loss``, the
    global NLL over the training nodes (detached); ``model`` and ``opt``
    are updated in place, as the port's other steps do.

    With ``dropout`` the step needs ``seed`` (an int, the same on every
    rank): the feature and mask dropout draw from a generator seeded
    ``seed · S + rank``, so the ranks draw apart (dropout patterns differ
    from the unsharded run's, as any two partitions of the draws do). With
    ``dropout=False`` the step is the unsharded step's. ``use_pallas`` is
    ignored: the route follows the device."""
    del use_pallas
    group = mesh.get_group(axis)
    size = axis_size(group)
    rank = mesh.get_local_rank(axis)

    def step(x_local: torch.Tensor, sg_local: NodeShardedGraph, labels_local: torch.Tensor,
             train_mask_local: torch.Tensor, seed: Optional[int] = None) -> torch.Tensor:
        generator = None
        if dropout:
            if seed is None:
                raise ValueError("a node-sharded step with dropout needs a seed")
            generator = torch.Generator(device=x_local.device)
            generator.manual_seed(int(seed) * size + rank)
        opt.zero_grad(set_to_none=True)
        logp = _mma_local_forward(model, x_local, sg_local, group, generator, training=True)
        pick = logp.gather(1, labels_local.long()[:, None])[:, 0]
        lsum = psum(torch.where(train_mask_local, pick, 0.0).sum(), group)
        lcnt = psum_no_grad(train_mask_local.to(torch.float32).sum(), group)
        loss = -lsum / torch.clamp(lcnt, min=1.0)
        (loss / size).backward()
        psum_grads(model.parameters())
        opt.step()
        return loss.detach()

    return step

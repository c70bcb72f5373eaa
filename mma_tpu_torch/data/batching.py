"""Disjoint-union batching of small graphs with static padding.

The port of the JAX package's plain collate (``mma_tpu/data/batching.py``,
the replacement for PyG's ``DataLoader`` collate of
``graph_regression/mma.py:52-54``): node arrays are concatenated with
per-graph index offsets, edge lists stay dst-sorted (each graph is sorted
and node offsets increase), and everything is padded to a fixed
``(n_graph, n_node, n_edge)``. Every field equals the JAX package's.

``batch_graphs(ell_degree_budgets=...)`` is the degree-exact ELL collate
(``_batch_graphs_degree_exact``) and :func:`degree_budgets` sizes its
buckets; both equal the JAX package's field for field.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np
import torch

from mma_tpu_torch.device import DeviceLike, resolve_device
from mma_tpu_torch.graph.build import build_row_ptr, sort_edges
from mma_tpu_torch.graph.container import BatchedGraphs, Graph


def _tensor(a: np.ndarray, dev: torch.device) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a)).to(dev)


def batch_graphs(
    num_nodes: Sequence[int],
    srcs: Sequence[np.ndarray],
    dsts: Sequence[np.ndarray],
    *,
    n_graph: int,
    n_node: int,
    n_edge: int,
    node_feats: Optional[Sequence[np.ndarray]] = None,
    edge_feats: Optional[Sequence[np.ndarray]] = None,
    targets: Optional[Sequence[np.ndarray]] = None,
    ell_degree_budgets: Optional[Sequence[int]] = None,
    device: DeviceLike = None,
) -> BatchedGraphs:
    """Collate ``len(num_nodes)`` graphs into one padded disjoint union on
    ``device`` (the GPU unless told otherwise).

    Padding edges point at the last node (``n_node - 1``), padding nodes map
    to graph ``n_graph - 1`` and padding graphs are masked out of
    ``graph_mask``. ``BatchedGraphs.graph_ptr`` holds each graph's node
    range (padding nodes in the last graph's), for pooled readouts.

    ``ell_degree_budgets`` opts into the degree-exact ELL layout:
    ``budgets[d-1]`` is the static row budget for nodes of in-degree ``d``
    (d = 1..W). Nodes are grouped by exact in-degree and each bucket is
    padded to its budget with synthetic rows that carry exactly ``d``
    masked self-loops, so the flat ELL slot index is the dst-sorted edge
    index (``Graph.ell_exact``). The budgets must stay the same across the
    batches of a stream; :func:`degree_budgets` sizes them.
    """
    dev = resolve_device(device)
    if ell_degree_budgets is not None:
        return _batch_graphs_degree_exact(
            num_nodes, srcs, dsts, n_graph=n_graph, n_node=n_node, n_edge=n_edge,
            budgets=tuple(int(b) for b in ell_degree_budgets), node_feats=node_feats,
            edge_feats=edge_feats, targets=targets, dev=dev)
    g = len(num_nodes)
    if g > n_graph:
        raise ValueError(f"{g} graphs > n_graph={n_graph}")
    tot_nodes = int(sum(num_nodes))
    tot_edges = int(sum(len(s) for s in srcs))
    if tot_nodes >= n_node:
        raise ValueError(f"{tot_nodes} nodes ≥ n_node={n_node} (need ≥1 padding node)")
    if tot_edges > n_edge:
        raise ValueError(f"{tot_edges} edges > n_edge={n_edge}")

    src = np.full(n_edge, n_node - 1, np.int32)
    dst = np.full(n_edge, n_node - 1, np.int32)
    node_to_graph = np.full(n_node, n_graph - 1, np.int32)
    orders = []
    offs_n = 0
    offs_e = 0
    for gi, nn in enumerate(num_nodes):
        s, d = np.asarray(srcs[gi], np.int32), np.asarray(dsts[gi], np.int32)
        order = np.lexsort((s, d))
        orders.append(order)
        src[offs_e : offs_e + len(s)] = s[order] + offs_n
        dst[offs_e : offs_e + len(s)] = d[order] + offs_n
        node_to_graph[offs_n : offs_n + nn] = gi
        offs_n += nn
        offs_e += len(s)

    edge_mask = np.zeros(n_edge, bool)
    edge_mask[:tot_edges] = True
    node_mask = np.zeros(n_node, bool)
    node_mask[:tot_nodes] = True
    graph_mask = np.zeros(n_graph, bool)
    graph_mask[:g] = True

    deg = np.bincount(dst[:tot_edges], minlength=n_node).astype(np.float32)
    row_ptr = build_row_ptr(dst, n_node)
    _, src_sorted, src_perm = sort_edges(dst, src)
    col_ptr = build_row_ptr(src_sorted, n_node)

    def t(a):
        return _tensor(a, dev)

    graph = Graph(
        src=t(src), dst=t(dst), edge_mask=t(edge_mask), node_mask=t(node_mask),
        deg=t(deg), row_ptr=t(row_ptr), src_perm=t(src_perm), col_ptr=t(col_ptr),
        src_csc=t(src_sorted), dst_csc=t(dst[src_perm]),
    )

    def pack(parts: Sequence[np.ndarray], total: int, pad_to: int):
        cat = np.concatenate([np.asarray(p) for p in parts], axis=0)
        out = np.zeros((pad_to,) + cat.shape[1:], cat.dtype)
        out[:total] = cat
        return t(out)

    node_feat = pack(node_feats, tot_nodes, n_node) if node_feats is not None else None
    # Edge features are packed in the same dst-sorted order as src/dst.
    edge_feat = None
    if edge_feats is not None:
        sorted_feats: List[np.ndarray] = [np.asarray(edge_feats[gi])[orders[gi]]
                                          for gi in range(g)]
        edge_feat = pack(sorted_feats, tot_edges, n_edge)
    target = pack(targets, g, n_graph) if targets is not None else None

    return BatchedGraphs(
        graph=graph,
        node_to_graph=t(node_to_graph),
        graph_mask=t(graph_mask),
        node_feat=node_feat,
        edge_feat=edge_feat,
        target=target,
        graph_ptr=t(build_row_ptr(node_to_graph, n_graph)),
    )


def degree_budgets(
    num_nodes: Sequence[int],
    srcs: Sequence[np.ndarray],
    dsts: Sequence[np.ndarray],
    batch_size: int,
    *,
    margin: float = 0.08,
    round_to: int = 8,
    worst_case: bool = False,
    include_zero: bool = False,
):
    """Static per-degree row budgets for the degree-exact collate (index
    ``d-1`` holds degree ``d``).

    By default ("observed"): the largest per-batch count of degree-``d``
    nodes over a sequential pass, raised by ``margin`` (shuffled epochs
    draw other batches) and rounded up to ``round_to`` rows.

    ``worst_case=True``: a guaranteed bound, the sum of the ``batch_size``
    largest per-graph degree-``d`` counts (any batch of at most
    ``batch_size`` graphs fits, under any shuffle; no margin).

    ``include_zero=True`` returns ``(budgets, zero_degree_worst)``, the
    matching bound on degree-0 rows, for sizing ``n_node``
    (``sum(budgets) + zero_worst + 1`` rows are needed).
    """
    per_graph = []
    w = 1
    for nn, d in zip(num_nodes, dsts):
        deg = np.bincount(np.asarray(d, np.int64), minlength=int(nn))
        w = max(w, int(deg.max(initial=0)))
        per_graph.append(np.bincount(deg.astype(np.int64)))
    counts = np.zeros((len(per_graph), w + 1), np.int64)
    for i, c in enumerate(per_graph):
        counts[i, :len(c)] = c
    if worst_case:
        worst_all = (-np.sort(-counts, axis=0)[:batch_size]).sum(axis=0)
        worst, zero_worst = worst_all[1:], int(worst_all[0])
        margin = 0.0
    else:
        worst = np.zeros(w, np.int64)
        zero_worst = 0
        for lo in range(0, len(per_graph), batch_size):
            tot = counts[lo:lo + batch_size].sum(axis=0)
            worst = np.maximum(worst, tot[1:])
            zero_worst = max(zero_worst, int(tot[0]))
    pad = np.ceil(worst * (1.0 + margin) / round_to).astype(np.int64) * round_to
    budgets = tuple(int(max(b, round_to)) for b in pad)
    if include_zero:
        return budgets, zero_worst
    return budgets


def _batch_graphs_degree_exact(num_nodes, srcs, dsts, *, n_graph, n_node, n_edge, budgets,
                               node_feats, edge_feats, targets, dev) -> BatchedGraphs:
    """The degree-exact ELL collate (see :func:`batch_graphs`).

    Bucket ``d`` (d = 1..W) owns rows ``[off_d, off_d + budgets[d-1])``:
    the real degree-``d`` nodes first, then synthetic bucket-padding rows
    that each carry exactly ``d`` masked self-loops. The real degree-0
    nodes follow the buckets, then the global padding rows. Every bucket
    row has exactly ``d`` edges, so edge ``k`` is flat slot ``k``.
    ``nodes_grouped`` is False: ``BatchedGraphs.node_order`` lists the
    nodes by graph for the pooled readout.
    """
    g = len(num_nodes)
    if g > n_graph:
        raise ValueError(f"{g} graphs > n_graph={n_graph}")
    tot_nodes = int(sum(num_nodes))
    tot_edges = int(sum(len(s) for s in srcs))
    w_max = len(budgets)

    offs = np.concatenate([[0], np.cumsum(num_nodes)]).astype(np.int64)
    src_r = (np.concatenate([np.asarray(s, np.int64) + offs[i] for i, s in enumerate(srcs)])
             if tot_edges else np.zeros(0, np.int64))
    dst_r = (np.concatenate([np.asarray(d, np.int64) + offs[i] for i, d in enumerate(dsts)])
             if tot_edges else np.zeros(0, np.int64))
    graph_of_node = np.repeat(np.arange(g, dtype=np.int32), num_nodes)

    deg = np.bincount(dst_r, minlength=tot_nodes)
    counts = np.bincount(deg, minlength=w_max + 1)
    if deg.max(initial=0) > w_max:
        raise ValueError(f"in-degree {int(deg.max())} > len(ell_degree_budgets)={w_max}")
    for d in range(1, w_max + 1):
        if counts[d] > budgets[d - 1]:
            raise ValueError(f"{int(counts[d])} degree-{d} nodes > budget {budgets[d - 1]}")
    slot_total = sum(budgets[d - 1] * d for d in range(1, w_max + 1))
    n_zero = int(counts[0])
    rows_used = sum(budgets) + n_zero
    if rows_used >= n_node:
        raise ValueError(f"degree buckets + zero-degree rows = {rows_used} ≥ n_node={n_node} "
                         "(need ≥1 global padding row)")
    if slot_total > n_edge:
        raise ValueError(f"slot total {slot_total} > n_edge={n_edge}")

    # New node index per old node: bucket rows, then degree-0 rows.
    bucket_off = np.concatenate([[0], np.cumsum(budgets)]).astype(np.int64)
    new_of_old = np.empty(tot_nodes, np.int64)
    for d in range(1, w_max + 1):
        nodes_d = np.flatnonzero(deg == d)
        new_of_old[nodes_d] = bucket_off[d - 1] + np.arange(len(nodes_d))
    new_of_old[np.flatnonzero(deg == 0)] = bucket_off[w_max] + np.arange(n_zero)

    node_mask = np.zeros(n_node, bool)
    node_mask[new_of_old] = True
    node_to_graph = np.full(n_node, n_graph - 1, np.int32)
    node_to_graph[new_of_old] = graph_of_node
    deg_new = np.zeros(n_node, np.float32)
    deg_new[new_of_old] = deg

    # Synthetic self-loops: d per bucket-padding row, then the global tail
    # pointing at the last padding row.
    syn = [np.repeat(np.arange(bucket_off[d - 1] + counts[d], bucket_off[d], dtype=np.int64), d)
           for d in range(1, w_max + 1)]
    tail = np.full(n_edge - slot_total, n_node - 1, np.int64)
    all_src = np.concatenate([new_of_old[src_r]] + syn + [tail])
    all_dst = np.concatenate([new_of_old[dst_r]] + syn + [tail])
    emask = np.zeros(n_edge, bool)
    emask[:tot_edges] = True

    order = np.lexsort((all_src, all_dst))
    src = all_src[order].astype(np.int32)
    dst = all_dst[order].astype(np.int32)

    row_ptr = build_row_ptr(dst, n_node)
    _, src_sorted, src_perm = sort_edges(dst, src)
    col_ptr = build_row_ptr(src_sorted, n_node)
    ell_hint = tuple((int(bucket_off[d]), d) for d in range(1, w_max + 1) if budgets[d - 1] > 0)
    # Symmetric input (in-degree = out-degree at every real node): the CSC
    # order is degree-exact under the same buckets (the self-loops keep the
    # padding rows symmetric too), so src-keyed sums need no kernel.
    csc_exact = bool(np.array_equal(np.bincount(src_r, minlength=tot_nodes), deg))

    def t(a):
        return _tensor(a, dev)

    graph = Graph(
        src=t(src), dst=t(dst), edge_mask=t(emask[order]), node_mask=t(node_mask),
        deg=t(deg_new), row_ptr=t(row_ptr), src_perm=t(src_perm), col_ptr=t(col_ptr),
        src_csc=t(src_sorted), dst_csc=t(dst[src_perm]), ell_hint=ell_hint, ell_exact=True,
        csc_ell_exact=csc_exact,
    )

    def placed(parts, rows, pad_to):
        cat = np.concatenate([np.asarray(p) for p in parts], axis=0)
        out = np.zeros((pad_to,) + cat.shape[1:], cat.dtype)
        out[rows] = cat
        return out

    node_feat = t(placed(node_feats, new_of_old, n_node)) if node_feats is not None else None
    edge_feat = (t(placed(edge_feats, slice(0, tot_edges), n_edge)[order])
                 if edge_feats is not None else None)
    target = t(placed(targets, slice(0, g), n_graph)) if targets is not None else None
    graph_mask = np.zeros(n_graph, bool)
    graph_mask[:g] = True
    return BatchedGraphs(
        graph=graph,
        node_to_graph=t(node_to_graph),
        graph_mask=t(graph_mask),
        node_feat=node_feat,
        edge_feat=edge_feat,
        target=target,
        graph_ptr=t(build_row_ptr(node_to_graph, n_graph)),
        nodes_grouped=False,
        node_order=t(np.argsort(node_to_graph, kind="stable").astype(np.int32)),
    )

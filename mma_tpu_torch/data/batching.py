"""Disjoint-union batching of small graphs with static padding.

The port of the JAX package's plain collate (``mma_tpu/data/batching.py``,
the replacement for PyG's ``DataLoader`` collate of
``graph_regression/mma.py:52-54``): node arrays are concatenated with
per-graph index offsets, edge lists stay dst-sorted (each graph is sorted
and node offsets increase), and everything is padded to a fixed
``(n_graph, n_node, n_edge)``. Every field equals the JAX package's.

The degree-exact ELL collate (``ell_degree_budgets``) and its budget
helper belong to the ELL slice of the port and raise here.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np
import torch

from mma_tpu_torch.device import DeviceLike, resolve_device
from mma_tpu_torch.graph.build import build_row_ptr, sort_edges
from mma_tpu_torch.graph.container import BatchedGraphs, Graph

_ELL_SLICE = ("the degree-exact ELL collate is not ported yet (it comes with the ELL "
              "and degree-exact conv paths); use the plain collate")


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
    """
    if ell_degree_budgets is not None:
        raise NotImplementedError(_ELL_SLICE)
    dev = resolve_device(device)
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
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

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


def degree_budgets(*args, **kwargs):
    """Per-degree row budgets of the degree-exact collate: not ported yet."""
    raise NotImplementedError(_ELL_SLICE)

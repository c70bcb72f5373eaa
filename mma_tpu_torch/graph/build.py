"""Host-side graph construction: COO → sorted, padded edge lists.

The port of the JAX package's ``graph_from_edges``, which, as there, sorts
and counts with the native graph library
(:mod:`mma_tpu_torch.graph.native`: a stable two-pass counting sort,
O(E + N)) and takes its NumPy fallbacks without it. The NumPy helpers
below (``sort_edges``, ``build_row_ptr``, ``symmetrize``) serve the other
builders: every sort is a stable ``np.lexsort``, which gives the counting
sort's order, duplicate edges included.

Padding policy: node/edge counts round up to ``NODE_PAD_MULTIPLE`` /
``EDGE_PAD_MULTIPLE`` and at least one padding node is always added to
serve as the target of padding edges.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from mma_tpu_torch.constants import EDGE_PAD_MULTIPLE, NODE_PAD_MULTIPLE
from mma_tpu_torch.device import DeviceLike, resolve_device
from mma_tpu_torch.graph import native
from mma_tpu_torch.graph.container import Graph


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def sort_edges(src: np.ndarray, dst: np.ndarray
               ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Stable (dst-major, src-minor) sort; returns ``(src, dst, perm)``."""
    perm = np.lexsort((src, dst)).astype(np.int32)
    return src[perm], dst[perm], perm


def build_row_ptr(dst_sorted: np.ndarray, num_nodes: int) -> np.ndarray:
    counts = np.bincount(dst_sorted, minlength=num_nodes)
    row_ptr = np.zeros(num_nodes + 1, np.int32)
    np.cumsum(counts, out=row_ptr[1:])
    return row_ptr


def symmetrize(src: np.ndarray, dst: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Undirected-graph semantics: both directions, no duplicates or
    self-loops; returned in (dst, src) order."""
    src = np.asarray(src, np.int32)
    dst = np.asarray(dst, np.int32)
    keep = src != dst
    pairs = np.concatenate(
        [np.stack([dst[keep], src[keep]], 1), np.stack([src[keep], dst[keep]], 1)]
    )
    pairs = np.unique(pairs, axis=0)
    return pairs[:, 1].copy(), pairs[:, 0].copy()


def graph_from_edges(
    src: np.ndarray,
    dst: np.ndarray,
    num_nodes: int,
    n_node_pad: Optional[int] = None,
    n_edge_pad: Optional[int] = None,
    sort: bool = True,
    *,
    device: DeviceLike = None,
) -> Graph:
    """Build a padded, dst-sorted :class:`Graph` from COO endpoints.

    Within each destination segment, edges keep ascending source order.
    ``device=None`` places the graph on the GPU (and raises without one).
    """
    dev = resolve_device(device)
    src = np.asarray(src, dtype=np.int32)
    dst = np.asarray(dst, dtype=np.int32)
    if src.shape != dst.shape or src.ndim != 1:
        raise ValueError(f"src/dst must be 1-D and equal length, got {src.shape} vs {dst.shape}")
    num_edges = src.shape[0]

    n_node = n_node_pad or _round_up(num_nodes + 1, NODE_PAD_MULTIPLE)
    n_edge = n_edge_pad or max(_round_up(num_edges, EDGE_PAD_MULTIPLE), EDGE_PAD_MULTIPLE)
    if n_node <= num_nodes:
        raise ValueError(f"n_node_pad={n_node} must exceed num_nodes={num_nodes} (padding node needed)")
    if n_edge < num_edges:
        raise ValueError(f"n_edge_pad={n_edge} < num_edges={num_edges}")

    if sort and num_edges > 0:
        src, dst, _ = native.sort_edges(src, dst, n_node)

    pad_e = n_edge - num_edges
    pad_node = n_node - 1
    src_p = np.concatenate([src, np.full(pad_e, pad_node, np.int32)])
    dst_p = np.concatenate([dst, np.full(pad_e, pad_node, np.int32)])
    edge_mask = np.zeros(n_edge, bool)
    edge_mask[:num_edges] = True
    node_mask = np.zeros(n_node, bool)
    node_mask[:num_nodes] = True

    deg = native.degrees(dst, n_node)
    # CSR offsets over the padded edge list: padding edges land on the
    # padding node's row, which is masked out.
    row_ptr = native.build_row_ptr(dst_p, n_node)
    # Transpose (CSC) order over the padded list.
    _, src_sorted, src_perm = native.sort_edges(dst_p, src_p, n_node)
    col_ptr = native.build_row_ptr(src_sorted, n_node)

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    return Graph(
        src=t(src_p),
        dst=t(dst_p),
        edge_mask=t(edge_mask),
        node_mask=t(node_mask),
        deg=t(deg),
        row_ptr=t(row_ptr),
        src_perm=t(src_perm),
        col_ptr=t(col_ptr),
        src_csc=t(src_sorted),
        dst_csc=t(dst_p[src_perm]),
    )


def graph_from_neighbor_lists(
    add_all: Sequence[np.ndarray],
    n_node_pad: Optional[int] = None,
    n_edge_pad: Optional[int] = None,
    *,
    device: DeviceLike = None,
) -> Graph:
    """Build from the reference's per-node neighbor-list format.

    ``add_all[i]`` lists the neighbors of center node ``i``
    (``node_classification/utils.py:98-100``); each pair becomes an edge
    ``j → i`` so that aggregation at ``i`` sums over its neighbors.
    ``device=None`` places the graph on the GPU.
    """
    num_nodes = len(add_all)
    dst = np.concatenate(
        [np.full(len(nbrs), i, np.int32) for i, nbrs in enumerate(add_all)]
        or [np.zeros(0, np.int32)]
    )
    src = np.concatenate(
        [np.asarray(nbrs, np.int32) for nbrs in add_all] or [np.zeros(0, np.int32)]
    )
    return graph_from_edges(src, dst, num_nodes, n_node_pad, n_edge_pad, device=device)


def graph_from_dense(adj: np.ndarray, **kw) -> Graph:
    """Build from a dense 0/1 adjacency; ``adj[i, j] != 0`` ⇒ edge ``j → i``.
    ``kw`` goes to :func:`graph_from_edges` (padding, ``device``)."""
    adj = np.asarray(adj)
    dst, src = np.nonzero(adj)
    return graph_from_edges(src.astype(np.int32), dst.astype(np.int32), adj.shape[0], **kw)


def pad_graph(g: Graph, n_node: int, n_edge: int, *, device: DeviceLike = None) -> Graph:
    """Re-pad an existing graph to larger static shapes (host-side), as the
    JAX package's ``pad_graph`` (``mma_tpu/graph/build.py:141``): its real
    edges, in their order, rebuilt by :func:`graph_from_edges` without a
    sort, so every derived field (CSR, CSC, degrees, masks) is made anew and
    the new padding edges sit at the tail. ``device=None`` keeps ``g``'s."""
    mask = g.edge_mask.cpu().numpy()
    return graph_from_edges(
        g.src.cpu().numpy()[mask], g.dst.cpu().numpy()[mask], int(g.node_mask.sum()),
        n_node_pad=n_node, n_edge_pad=n_edge, sort=False,
        device=g.src.device if device is None else device)

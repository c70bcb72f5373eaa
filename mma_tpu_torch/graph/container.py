"""Padded, dst-sorted graph container.

The same layout as the JAX package's ``Graph``: a padded edge list sorted
by destination node, with source ascending within each destination.

- ``src[e]`` / ``dst[e]``: endpoints of edge ``e`` (messages flow
  ``src → dst``).
- Padding edges sit at the tail with ``src = dst = n_node - 1`` (a padding
  node) and ``edge_mask = False``.
- ``row_ptr`` is the CSR row-offset view of the same edge list; the
  kernels reduce each row's contiguous edge range ``[row_ptr[i],
  row_ptr[i+1])``.
- The CSC fields (``src_perm``, ``col_ptr``, ``src_csc``, ``dst_csc``)
  are the transpose order, used by src-keyed reductions.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch


@dataclasses.dataclass
class Graph:
    """A single graph (or disjoint union of graphs) in padded edge-list form."""

    src: torch.Tensor  # (E,) int32 — neighbor / message source
    dst: torch.Tensor  # (E,) int32 — center / message destination, sorted
    edge_mask: torch.Tensor  # (E,) bool — True for real edges
    node_mask: torch.Tensor  # (N,) bool — True for real nodes
    deg: torch.Tensor  # (N,) float32 — in-degree over real edges
    row_ptr: torch.Tensor  # (N+1,) int32 — CSR offsets into the edge list
    src_perm: Optional[torch.Tensor] = None  # (E,) int32 — (src, dst) sort order
    col_ptr: Optional[torch.Tensor] = None  # (N+1,) int32 — CSC offsets
    src_csc: Optional[torch.Tensor] = None  # (E,) int32 — src, CSC order
    dst_csc: Optional[torch.Tensor] = None  # (E,) int32 — dst, CSC order
    # Static metadata under the JAX package's names. ``chunk_hint`` (the
    # TPU kernels' grid bound) stays None in the port. The degree-exact
    # collate sets the ELL fields: ``ell_hint`` ``((bound, width), ...)``
    # the degree buckets (``mma_tpu_torch.ops.ell.EllSpec``);
    # ``ell_exact`` every bucket row has exactly its width in edges, so
    # the flat slot index is the edge index; ``csc_ell_exact`` the CSC
    # order is degree-exact under the same buckets (symmetric graphs).
    chunk_hint: Optional[tuple] = None
    ell_hint: Optional[tuple] = None
    ell_exact: bool = False
    csc_ell_exact: bool = False

    @property
    def n_node(self) -> int:
        return self.node_mask.shape[0]

    @property
    def n_edge(self) -> int:
        return self.src.shape[0]

    @property
    def num_nodes(self) -> torch.Tensor:
        """Number of real (unpadded) nodes, as a 0-d tensor."""
        return self.node_mask.sum(dtype=torch.int32)

    @property
    def num_edges(self) -> torch.Tensor:
        return self.edge_mask.sum(dtype=torch.int32)

    @property
    def real_row_ptr(self) -> torch.Tensor:
        """``row_ptr`` with the last (padding) node's row emptied.

        Every padding edge points at the last node, and no real edge does,
        so a reduction over this CSR skips exactly the padding edges. The
        degree-exact layout breaks that rule: its bucket-padding rows hold
        masked self-loops (``ell_exact``), and the callers that reduce over
        such a graph zero those rows' results (``MultiMaskConv``). On a
        small graph the padding edges are the longest row (Cora: 708 of
        11,264), which would otherwise hold one warp for the whole launch.
        """
        return torch.cat([self.row_ptr[:-1], self.row_ptr[-2:-1]])

    @property
    def real_col_ptr(self) -> torch.Tensor:
        """``col_ptr`` with the last (padding) node's column emptied.

        The twin of :attr:`real_row_ptr` for src-keyed reductions in CSC
        order: every padding edge has the padding node as its source, and
        no real edge does, so this CSC covers exactly the real edges.
        """
        return torch.cat([self.col_ptr[:-1], self.col_ptr[-2:-1]])

    def to(self, device) -> "Graph":
        """A copy with every tensor field on ``device``."""
        return _to(self, device)


def _to(obj, device):
    fields = {f.name: getattr(obj, f.name) for f in dataclasses.fields(obj)}
    return dataclasses.replace(obj, **{
        name: v.to(device) for name, v in fields.items()
        if isinstance(v, (torch.Tensor, Graph))
    })


@dataclasses.dataclass
class BatchedGraphs:
    """A batch of graphs packed as one disjoint union plus readout indices.

    The JAX package's ``BatchedGraphs`` (the PyG ``DataLoader`` collate of
    ``graph_regression/mma.py:52-54``): node and edge arrays of all graphs
    concatenated, node indices offset per graph, ``node_to_graph`` mapping
    each node to its graph (the reference's ``batch`` vector).
    """

    graph: Graph
    node_to_graph: torch.Tensor  # (N,) int32 — graph id per node (pad → G-1)
    graph_mask: torch.Tensor  # (G,) bool — True for real graphs
    node_feat: Optional[torch.Tensor] = None  # (N, ...) node features/ids
    edge_feat: Optional[torch.Tensor] = None  # (E, ...) edge features/ids
    target: Optional[torch.Tensor] = None  # (G, ...) per-graph targets
    # (G+1,) int32 — CSR offsets of each graph's nodes, padding nodes in
    # the last graph's range. The port's own field: pooled readouts sum
    # over it with the segment-sum kernel.
    graph_ptr: Optional[torch.Tensor] = None
    # True when each graph's nodes are contiguous (node_to_graph ascending).
    nodes_grouped: bool = True
    # (N,) int32 — the node ids stably sorted by graph, which ``graph_ptr``
    # then covers; set when ``nodes_grouped`` is False (the degree-exact
    # collate), so that the pooled readout is the segment-sum kernel's
    # index form, with no float atomics. The port's own field.
    node_order: Optional[torch.Tensor] = None

    @property
    def n_graph(self) -> int:
        return self.graph_mask.shape[0]

    @property
    def num_graphs(self) -> torch.Tensor:
        return self.graph_mask.sum(dtype=torch.int32)

    def to(self, device) -> "BatchedGraphs":
        """A copy with every tensor field (and the graph) on ``device``."""
        return _to(self, device)

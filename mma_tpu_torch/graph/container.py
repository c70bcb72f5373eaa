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
import json
from typing import Optional

import torch
import torch.utils._pytree as pytree


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


# ------------------------------------------------------------------ pytrees
#
# ``torch.export`` takes a Graph or a BatchedGraphs as an argument, so both
# are pytree nodes: the tensor fields (and a batch's graph) are children,
# and the static fields, with the names of the optional fields that are
# set, are the context. The context is serialized as JSON, so that an
# artifact's calling convention stays readable and executes no pickled
# code (the JAX package's ``mma_tpu/serve/__init__.py:41-72`` codec). The
# static fields are not int leaves: ``torch.export`` would specialize the
# artifact on their values, where they are the graph's layout, which fixes
# the traced code.

_STATIC = {Graph: ("chunk_hint", "ell_hint", "ell_exact", "csc_ell_exact"),
           BatchedGraphs: ("nodes_grouped",)}


def _tuples(x):
    """JSON lists back to the tuples the static fields hold."""
    return tuple(_tuples(v) for v in x) if isinstance(x, list) else x


def _register(cls, serialized_name: str) -> None:
    static = _STATIC[cls]
    children = tuple(f.name for f in dataclasses.fields(cls) if f.name not in static)

    def flatten_with_keys(obj):
        names = tuple(n for n in children if getattr(obj, n) is not None)
        context = (names, tuple(getattr(obj, n) for n in static))
        return [(pytree.GetAttrKey(n), getattr(obj, n)) for n in names], context

    def flatten(obj):
        keyed, context = flatten_with_keys(obj)
        return [v for _, v in keyed], context

    def unflatten(values, context):
        names, statics = context
        return cls(**dict(zip(names, values)), **dict(zip(static, statics)))

    def to_dumpable(context) -> str:
        return json.dumps(context, default=int)  # numpy ints in a hint

    def from_dumpable(text: str):
        names, statics = json.loads(text)
        return tuple(names), tuple(_tuples(v) for v in statics)

    pytree.register_pytree_node(
        cls, flatten, unflatten, serialized_type_name=serialized_name,
        to_dumpable_context=to_dumpable, from_dumpable_context=from_dumpable,
        flatten_with_keys_fn=flatten_with_keys)


_register(Graph, "mma_tpu_torch.Graph")
_register(BatchedGraphs, "mma_tpu_torch.BatchedGraphs")

"""Device-side completion of a sampled subgraph's structure.

The port of the JAX package's ``mma_tpu/graph/device_build.py``. The
sampled pipeline makes a fresh subgraph per batch. Everything in a
:class:`Graph` but the sorted edge endpoints can be derived, so the host
ships only ``(src, dst, node_ids)``, the edge count and the CSC
permutation, and the device builds the rest with a few cheap ops
(searchsorted over a sorted array, two gathers, one gather into a
device-resident degree table).

The result equals, field for field, the graph that
:meth:`~mma_tpu_torch.data.sampling.NeighborSampler.sample` builds on the
host for the same draw:

- ``src``/``dst`` arrive dst-sorted (src ascending within dst, the native
  counting sort's order) with padding edges at the tail pointing at the
  padding node;
- ``row_ptr[i]`` is the first edge with ``dst ≥ i`` over the padded list;
- the CSC view is two gathers through the host-emitted ``src_perm``, or a
  stable ``torch.argsort`` of ``src`` when that is absent (the list is
  already dst-sorted, so a stable single-key sort gives the src-major,
  dst-minor order);
- ``deg`` holds the full-graph in-degrees gathered from a device-resident
  table by global node id (the sampler's unbiased-mean convention); holes
  and padding rows get 0;
- the masks come from the real counts.

The JAX package's ``shape_canonical_chunk_hint`` has no counterpart: it
bounds the TPU kernels' grid so that every batch of one pad shape shares
one compiled program, and the port's kernels derive their partition from
the shapes alone (``Graph.chunk_hint`` stays None in the port).
"""

from __future__ import annotations

from typing import Optional, Union

import torch

from mma_tpu_torch.graph.container import Graph


def finish_graph_on_device(
    src: torch.Tensor,
    dst: torch.Tensor,
    node_ids: torch.Tensor,
    n_real_edges: Union[int, torch.Tensor],
    deg_table: torch.Tensor,
    src_perm: Optional[torch.Tensor] = None,
    *,
    ell_hint: Optional[tuple] = None,
) -> Graph:
    """Build a full :class:`Graph` from the minimal arrays, on their device.

    ``src``/``dst``: (E_pad,) int32 dst-sorted padded endpoints;
    ``node_ids``: (N_pad,) int32 global id per local row (−1 for padding
    and holes, which also defines ``node_mask``); ``n_real_edges``: an int
    or a 0-d tensor; ``deg_table``: (N_global,) float32 true in-degrees on
    the same device; ``src_perm``: optional (E_pad,) int32 CSC permutation
    (``sample_arrays(emit_csc=True)``). No host sync.
    """
    e_pad = src.shape[0]
    n_node = node_ids.shape[0]
    dev = src.device

    edge_mask = torch.arange(e_pad, dtype=torch.int32, device=dev) < n_real_edges
    node_mask = node_ids >= 0
    deg = torch.where(node_mask, deg_table[node_ids.clamp(min=0).long()], 0.0).float()

    rows = torch.arange(n_node + 1, dtype=torch.int32, device=dev)
    row_ptr = torch.searchsorted(dst, rows, side="left", out_int32=True)

    if src_perm is None:
        src_perm = torch.argsort(src, stable=True).to(torch.int32)
    perm = src_perm.long()
    src_csc = src[perm]
    dst_csc = dst[perm]
    col_ptr = torch.searchsorted(src_csc, rows, side="left", out_int32=True)

    return Graph(
        src=src, dst=dst, edge_mask=edge_mask, node_mask=node_mask, deg=deg,
        row_ptr=row_ptr, src_perm=src_perm, col_ptr=col_ptr, src_csc=src_csc,
        dst_csc=dst_csc, ell_hint=ell_hint,
    )

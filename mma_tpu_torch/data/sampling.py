"""Neighbour sampling for graphs that exceed one card (the JAX package's
``mma_tpu/data/sampling.py``; ``BASELINE.json`` config[4],
"ogbn-products-scale … with neighbor sampling").

GraphSAGE-style layered sampling on the host (NumPy over the CSR arrays, or
the native sampler of :mod:`mma_tpu_torch.graph.native`), producing
statically padded :class:`Graph` mini-batches:

- seeds are the loss nodes, always the first ``len(seeds)`` rows of the
  subgraph, so callers index outputs and labels with ``[:num_seeds]``;
- hop ``k`` samples up to ``fanouts[k]`` in-neighbours (uniform, without
  replacement) of every node the previous hop reached, adding the sampled
  ``neighbour → node`` edges;
- the union subgraph is padded to fixed ``(n_node, n_edge)`` budgets.

The sampler draws from its own ``np.random.RandomState(seed)`` in the JAX
package's order, so with the same seed and backend both packages draw the
same subgraphs bit for bit. Graphs come out on the device the caller names
(the card unless told otherwise), built by
:func:`mma_tpu_torch.graph.build.graph_from_edges`.

Degree semantics: the subgraph carries each node's **true** in-degree, not
the sampled count, so mean-family combines divide by the full-graph degree.
At full fanout the seeds' L-layer outputs are the full-graph outputs; at
partial fanout this is the standard unbiased-mean estimator.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Iterator, Optional, Sequence, Tuple

import numpy as np
import torch

from mma_tpu_torch.device import DeviceLike, resolve_device
from mma_tpu_torch.graph import native
from mma_tpu_torch.graph.build import graph_from_edges
from mma_tpu_torch.graph.container import Graph


@dataclasses.dataclass
class SampledBatch:
    graph: Graph
    node_ids: np.ndarray  # (n_node,) int64 original ids (pad and holes → -1)
    num_seeds: int
    num_nodes: int


@dataclasses.dataclass
class SampledArrays:
    """The minimal host output of one sample (:meth:`NeighborSampler.sample_arrays`):
    the dst-sorted padded endpoints and the id map. Masks, degrees and the
    CSR/CSC views are derived on the device by
    :func:`mma_tpu_torch.graph.device_build.finish_graph_on_device`."""

    src: np.ndarray  # (E_pad,) int32, dst-sorted, padding at the tail
    dst: np.ndarray  # (E_pad,) int32
    node_ids: np.ndarray  # (N_pad,) int32 global ids (pad and holes → -1)
    num_edges: int
    num_seeds: int
    num_nodes: int
    ell_hint: Optional[tuple] = None
    # The CSC permutation of the padded edge list (stable src-major,
    # dst-minor: the native counting sort), so that the device never sorts;
    # None when emit_csc=False.
    src_perm: Optional[np.ndarray] = None


class NeighborSampler:
    """Samples layered neighbourhoods from a host copy of a graph.

    ``device``: where :meth:`sample` puts its graphs (None: the card, which
    must exist); ``sample(..., device=...)`` overrides it per call."""

    def __init__(self, graph: Graph, fanouts: Sequence[int], seed: int = 0,
                 use_native: bool = True, n_threads: Optional[int] = None, *,
                 device: DeviceLike = None):
        self._common(fanouts, seed, use_native, n_threads, device)
        # Host copies of the CSR structure (real edges only).
        e_mask = graph.edge_mask.cpu().numpy()
        self.src = graph.src.cpu().numpy()[e_mask]
        self.dst = graph.dst.cpu().numpy()[e_mask]
        self.num_nodes = int(graph.node_mask.cpu().numpy().sum())
        counts = np.bincount(self.dst, minlength=self.num_nodes)
        self.row_ptr = np.zeros(self.num_nodes + 1, np.int64)
        np.cumsum(counts, out=self.row_ptr[1:])
        order = np.argsort(self.dst, kind="stable")
        self.src_sorted = self.src[order]
        self.true_deg = counts.astype(np.float32)

    def _common(self, fanouts, seed, use_native, n_threads, device):
        self.fanouts = tuple(fanouts)
        self.rs = np.random.RandomState(seed)
        self.use_native = use_native
        self.n_threads = n_threads or (os.cpu_count() or 1)
        self.device = resolve_device(device)

    @classmethod
    def from_host_arrays(cls, src: np.ndarray, dst: np.ndarray, num_nodes: int,
                         fanouts: Sequence[int], seed: int = 0, use_native: bool = True,
                         n_threads: Optional[int] = None, *,
                         device: DeviceLike = None) -> "NeighborSampler":
        """Build directly from host edge arrays (unsorted is fine), with no
        :class:`Graph` round trip; the native counting sort keeps this
        O(E + N)."""
        self = cls.__new__(cls)
        self._common(fanouts, seed, use_native, n_threads, device)
        src_s, dst_s, _ = native.sort_edges(src, dst, num_nodes)
        self.src = src_s
        self.dst = dst_s
        self.num_nodes = int(num_nodes)
        self.row_ptr = native.build_row_ptr(dst_s, num_nodes).astype(np.int64)
        self.src_sorted = src_s
        self.true_deg = np.diff(self.row_ptr).astype(np.float32)
        return self

    @staticmethod
    def _concat_ranges(starts: np.ndarray, lengths: np.ndarray) -> np.ndarray:
        """Vectorised ``concat([arange(s, s+l) for s, l in zip(...)])``."""
        total = int(lengths.sum())
        if total == 0:
            return np.zeros(0, np.int64)
        step = np.ones(total, np.int64)
        step[0] = starts[0]
        offs = np.cumsum(lengths)[:-1]
        step[offs] = starts[1:] - (starts[:-1] + lengths[:-1]) + 1
        return np.cumsum(step)

    def _sample_neighbors(self, nodes: np.ndarray, fanout: int
                          ) -> Tuple[np.ndarray, np.ndarray]:
        """Up to ``fanout`` uniform in-neighbours per node, no replacement.

        Nodes with deg ≤ fanout take every edge (a concatenation of CSR
        ranges); larger nodes draw a random key per edge and keep each
        node's ``fanout`` smallest keys (a per-segment random top-k by one
        argsort)."""
        nodes = np.asarray(nodes, np.int64)
        lo = self.row_ptr[nodes]
        deg = self.row_ptr[nodes + 1] - lo
        small = deg <= fanout

        idx_parts, dst_parts = [], []
        ns, ds_, ls = nodes[small], lo[small], deg[small]
        nz = ls > 0
        if nz.any():
            idx_parts.append(self._concat_ranges(ds_[nz], ls[nz]))
            dst_parts.append(np.repeat(ns[nz], ls[nz]))

        nb, lb, db = nodes[~small], lo[~small], deg[~small]
        if len(nb):
            edge_pos = self._concat_ranges(lb, db)  # all edges of big nodes
            owner = np.repeat(np.arange(len(nb)), db)
            # A random order within each owner's contiguous block.
            key = owner.astype(np.float64) + self.rs.rand(len(edge_pos)) * 0.5
            order = np.argsort(key, kind="stable")
            starts = np.concatenate([[0], np.cumsum(db)[:-1]])
            sel = np.repeat(starts, fanout) + np.tile(
                np.arange(fanout, dtype=np.int64), len(nb)
            )
            idx_parts.append(edge_pos[order][sel])
            dst_parts.append(np.repeat(nb, fanout))

        if not idx_parts:
            return np.zeros(0, np.int64), np.zeros(0, np.int64)
        idx = np.concatenate(idx_parts)
        return self.src_sorted[idx].astype(np.int64), np.concatenate(dst_parts)

    def _structure_numpy(self, seeds):
        """(hop node counts, global node ids in discovery order, local src,
        local dst): the NumPy backend."""
        node_ids = seeds
        frontier = seeds
        hop_counts = [len(seeds)]
        all_src, all_dst = [], []
        for fanout in self.fanouts:
            if len(frontier) == 0:
                hop_counts.append(0)
                continue
            s, d = self._sample_neighbors(frontier, fanout)
            all_src.append(s)
            all_dst.append(d)
            cand = np.unique(s)
            new = cand[~np.isin(cand, node_ids, assume_unique=False)]
            node_ids = np.concatenate([node_ids, new])
            hop_counts.append(len(new))
            frontier = new

        src = np.concatenate(all_src) if all_src else np.zeros(0, np.int64)
        dst = np.concatenate(all_dst) if all_dst else np.zeros(0, np.int64)
        # Deduplicate edges sampled at several hops.
        if len(src):
            key = dst * (self.num_nodes + 1) + src
            _, uniq = np.unique(key, return_index=True)
            src, dst = src[uniq], dst[uniq]
        order = np.argsort(node_ids, kind="stable")
        src_l = order[np.searchsorted(node_ids[order], src)].astype(np.int32)
        dst_l = order[np.searchsorted(node_ids[order], dst)].astype(np.int32)
        return hop_counts, node_ids, src_l, dst_l

    def _structure(self, seeds, node_cap, edge_cap):
        """The native multithreaded sampler when it runs (deterministic per
        seed at any thread count), else the NumPy backend. Both return the
        same representation; only the random stream differs."""
        if self.use_native:
            res = native.sample_layered(
                self.row_ptr, self.src_sorted, seeds, self.fanouts,
                rng_seed=int(self.rs.randint(0, 2**62)),
                n_threads=self.n_threads,
                node_cap=node_cap, edge_cap=edge_cap,
            )
            if res is not None:
                nodes, hop_counts, src_l, dst_l = res
                return [int(c) for c in hop_counts], nodes.astype(np.int64), src_l, dst_l
        return self._structure_numpy(seeds)

    def sample(self, seeds: np.ndarray, *, n_node_pad: Optional[int] = None,
               n_edge_pad: Optional[int] = None,
               hop_node_pads: Optional[Sequence[int]] = None,
               device: DeviceLike = None) -> SampledBatch:
        """Sample one layered subgraph, its graph on ``device`` (None: the
        sampler's device).

        ``hop_node_pads``: optional per-hop node budgets ``(seeds, new₁, …,
        new_L)`` (``len(fanouts) + 1`` of them). Each hop's nodes then
        occupy a FIXED row range padded to its budget, and the graph
        carries the ELL degree-bucket layout ``ell_hint = ((range_end_h,
        fanouts[h]), …)``: hop ``h``'s nodes have at most ``fanouts[h]``
        sampled in-edges (each node joins exactly one frontier). Rows
        between a hop's node count and its budget are masked holes.
        """
        dev = self.device if device is None else resolve_device(device)
        seeds = np.asarray(seeds, np.int64)
        node_cap = (sum(hop_node_pads) if hop_node_pads is not None
                    else (n_node_pad or self._structural_node_bound(len(seeds))))
        edge_cap = n_edge_pad or self._structural_edge_bound(len(seeds))
        hop_counts, node_ids, src_l, dst_l = self._structure(seeds, node_cap, edge_cap)

        if hop_node_pads is not None:
            return self._layout_hopped(seeds, hop_counts, node_ids, src_l, dst_l,
                                       tuple(hop_node_pads), n_node_pad, n_edge_pad, dev)

        g = graph_from_edges(src_l, dst_l, len(node_ids), n_node_pad=n_node_pad,
                             n_edge_pad=n_edge_pad, device=dev)
        # Full-graph degrees in place of the sampled ones (module docstring).
        deg = np.zeros(g.n_node, np.float32)
        deg[: len(node_ids)] = self.true_deg[node_ids]
        g = dataclasses.replace(g, deg=torch.from_numpy(deg).to(dev))

        ids_pad = np.full(g.n_node, -1, np.int64)
        ids_pad[: len(node_ids)] = node_ids
        return SampledBatch(graph=g, node_ids=ids_pad, num_seeds=len(seeds),
                            num_nodes=len(node_ids))

    def sample_arrays(self, seeds: np.ndarray, *, n_node_pad: int, n_edge_pad: int,
                      hop_node_pads: Optional[Sequence[int]] = None,
                      emit_csc: bool = True) -> SampledArrays:
        """Sample one subgraph and return only the minimal host arrays
        (:class:`SampledArrays`), for
        :func:`~mma_tpu_torch.graph.device_build.finish_graph_on_device`
        and a device-resident ``true_deg`` table. The layout is
        :meth:`sample`'s. ``emit_csc``: also emit the CSC permutation (one
        more host counting sort, O(E + N)), so that the device derives the
        CSC view with two gathers instead of a sort."""
        seeds = np.asarray(seeds, np.int64)
        hop_counts, node_ids, src_l, dst_l = self._structure(
            seeds, (sum(hop_node_pads) if hop_node_pads is not None else n_node_pad),
            n_edge_pad,
        )
        ell_hint = None
        if hop_node_pads is not None:
            pads = tuple(hop_node_pads)
            self._check_hop_pads(hop_counts, pads)
            offs, loc = self._hop_rows(hop_counts, pads)
            src_l = loc[src_l].astype(np.int32)
            dst_l = loc[dst_l].astype(np.int32)
            total = int(offs[-1])
            ell_hint = self._ell_hint(offs)
            if n_node_pad <= total:
                raise ValueError(f"n_node_pad={n_node_pad} <= {total}")
            ids_pad = np.full(n_node_pad, -1, np.int32)
            ids_pad[loc] = node_ids
        else:
            if n_node_pad <= len(node_ids):
                raise ValueError(f"n_node_pad={n_node_pad} <= {len(node_ids)} nodes")
            ids_pad = np.full(n_node_pad, -1, np.int32)
            ids_pad[: len(node_ids)] = node_ids
        if n_edge_pad < len(src_l):
            raise ValueError(f"n_edge_pad={n_edge_pad} < {len(src_l)} edges")

        src_s, dst_s, _ = native.sort_edges(src_l.astype(np.int32), dst_l.astype(np.int32),
                                            n_node_pad)
        pad_e = n_edge_pad - len(src_s)
        pad_node = n_node_pad - 1
        src_p = np.concatenate([src_s, np.full(pad_e, pad_node, np.int32)])
        dst_p = np.concatenate([dst_s, np.full(pad_e, pad_node, np.int32)])
        src_perm = None
        if emit_csc:
            # Stable counting sort by src over the PADDED list (padding
            # edges point at the last node and sort to the tail).
            _, _, src_perm = native.sort_edges(dst_p, src_p, n_node_pad)
        return SampledArrays(src=src_p, dst=dst_p, node_ids=ids_pad, num_edges=len(src_s),
                             num_seeds=len(seeds), num_nodes=len(node_ids),
                             ell_hint=ell_hint, src_perm=src_perm)

    def _structural_node_bound(self, n_seeds: int) -> int:
        b, f = n_seeds, n_seeds
        for fo in self.fanouts:
            f *= fo
            b += f
        return b + 1

    def _structural_edge_bound(self, n_seeds: int) -> int:
        b, f = 0, n_seeds
        for fo in self.fanouts:
            f *= fo
            b += f
        return max(b, 1)

    def _check_hop_pads(self, hop_counts, pads) -> None:
        if len(pads) != len(self.fanouts) + 1:
            raise ValueError(
                f"hop_node_pads needs {len(self.fanouts) + 1} entries "
                f"(seeds + one per fanout), got {len(pads)}"
            )
        for h, c in enumerate(hop_counts):
            if c > pads[h]:
                raise ValueError(f"hop {h}: {c} nodes > budget {pads[h]} — "
                                 "recalibrate hop_node_pads")

    @staticmethod
    def _hop_rows(hop_counts, pads):
        """Per-hop row offsets and each discovered node's padded row."""
        offs = np.concatenate([[0], np.cumsum(pads)]).astype(np.int64)
        loc = np.concatenate([offs[h] + np.arange(c, dtype=np.int64)
                              for h, c in enumerate(hop_counts)])
        return offs, loc

    def _ell_hint(self, offs) -> tuple:
        # Hops 0..L-1 are ELL buckets of their fanout's width; the last
        # hop's nodes are leaves with no in-edges, so they get no bucket.
        return tuple((int(offs[h + 1]), int(self.fanouts[h])) for h in range(len(self.fanouts)))

    def _layout_hopped(self, seeds, hop_counts, node_ids, src_l, dst_l,
                       pads, n_node_pad, n_edge_pad, dev) -> SampledBatch:
        """The per-hop padded row layout and its ELL bucket hint (:meth:`sample`)."""
        self._check_hop_pads(hop_counts, pads)
        offs, loc = self._hop_rows(hop_counts, pads)
        total = int(offs[-1])
        src_p = loc[src_l].astype(np.int32)
        dst_p = loc[dst_l].astype(np.int32)

        g = graph_from_edges(src_p, dst_p, total, n_node_pad=n_node_pad,
                             n_edge_pad=n_edge_pad, device=dev)
        node_mask = np.zeros(g.n_node, bool)
        node_mask[loc] = True
        deg = np.zeros(g.n_node, np.float32)
        deg[loc] = self.true_deg[node_ids]
        g = dataclasses.replace(g, node_mask=torch.from_numpy(node_mask).to(dev),
                                deg=torch.from_numpy(deg).to(dev),
                                ell_hint=self._ell_hint(offs))
        ids_pad = np.full(g.n_node, -1, np.int64)
        ids_pad[loc] = node_ids
        return SampledBatch(graph=g, node_ids=ids_pad, num_seeds=len(seeds),
                            num_nodes=len(node_ids))

    def batches(self, seed_nodes: np.ndarray, batch_size: int, *, n_node_pad: int,
                n_edge_pad: int, shuffle: bool = True) -> Iterator[SampledBatch]:
        order = np.asarray(seed_nodes).copy()
        if shuffle:
            self.rs.shuffle(order)
        for lo in range(0, len(order), batch_size):
            yield self.sample(order[lo: lo + batch_size], n_node_pad=n_node_pad,
                              n_edge_pad=n_edge_pad)

"""Neighbour sampling on the device that trains: :class:`DeviceSampler`.

The same draw as :meth:`NeighborSampler.sample_arrays
<mma_tpu_torch.data.sampling.NeighborSampler.sample_arrays>` without hop
pads (native backend), bit for bit, made where the graph's CSR is held:
the card, or the CPU for tests. It takes its random seed from the host
sampler's own stream, one draw a batch as the host path takes it, so a
:class:`DeviceSampler` and the :class:`NeighborSampler` it wraps give the
same subgraphs in the same order.

A hop is one kernel and a few tensor ops, with no read back to the host:

- the picks: for each frontier slot, the node's sorted distinct sampled
  in-neighbours (``ops/cuda/sampling.py::sample_picks``; on the CPU the
  native library's host version);
- the relabel, which the host sampler does in one sequential pass: a
  source not yet placed takes a new row in emission order (slot, then
  pick). Each such source keeps its least emission position (a
  ``scatter_reduce`` min into a node-indexed table), the positions that
  hold it are its first occurrences, and a running count over them numbers
  the new rows;
- each destination's edges, sources sorted, go to their place in the
  dst-sorted edge list: the running count of the slots' pick counts.

Every shape is fixed by the seed count and the fan-outs (the frontiers and
pick buffers at their structural bounds, slots past the real frontier
empty), and the counts stay on the device as 0-d tensors, so a batch
launches without waiting for the one before. On the card the draw of one
shape is a CUDA graph, captured at its first batch over a static input
buffer (the random seed and the seeds), and a batch is a copy in, a replay
and copies of its outputs: about 70 launches become a handful, and the
host's thread, which shares the interpreter with the step's, stays free. The pads must hold the
structural bounds (``NeighborSampler._structural_node_bound`` and
``_structural_edge_bound``), which no sample can pass.

Two node-indexed int32 tables (the row of each placed node, and each
unplaced source's least position) hold the state of a batch; each batch
leaves them as it found them. They have one spare entry past the graph's
nodes, where the masked scatters land. Batches of one sampler must run in
stream order: one stream, one at a time.
"""

from __future__ import annotations

import numpy as np
import torch

from mma_tpu_torch.data.sampling import NeighborSampler, SampledArrays
from mma_tpu_torch.device import DeviceLike, resolve_device
from mma_tpu_torch.graph import native
from mma_tpu_torch.ops.cuda import sampling as cuda_sampling

_UNSEEN = torch.iinfo(torch.int32).max


def sample_picks(row_ptr: torch.Tensor, src_sorted: torch.Tensor, frontier: torch.Tensor,
                 n_frontier: torch.Tensor, fanout: int, hop: int, rng_seed: torch.Tensor):
    """One hop's picks, ``(picks, count)``, on the frontier's device: the
    card's kernel, or on the CPU the native library's host version (which
    reads ``n_frontier`` and ``rng_seed``, a one-element int64 tensor)."""
    if frontier.device.type == "cuda":
        return cuda_sampling.sample_picks(row_ptr, src_sorted, frontier, n_frontier, fanout, hop,
                                          rng_seed)
    res = native.sample_picks(row_ptr.numpy(), src_sorted.numpy(), frontier.numpy(),
                              int(n_frontier), fanout, hop, int(rng_seed))
    if res is None:
        raise RuntimeError("sample_picks on the CPU needs the native graph library")
    return torch.from_numpy(res[0]), torch.from_numpy(res[1])


class DeviceSampler:
    """:class:`NeighborSampler`'s draws made on ``device`` (None: the host
    sampler's device), over a copy of its CSR there (module docstring)."""

    def __init__(self, sampler: NeighborSampler, device: DeviceLike = None):
        fanouts = tuple(int(f) for f in sampler.fanouts)
        if not fanouts or not all(1 <= f <= native.MAX_FANOUT for f in fanouts):
            raise ValueError(f"fanouts must lie in [1, {native.MAX_FANOUT}], got {fanouts}")
        self.sampler = sampler
        self.fanouts = fanouts
        self.num_nodes = sampler.num_nodes
        self.device = sampler.device if device is None else resolve_device(device)
        self.row_ptr = torch.from_numpy(np.ascontiguousarray(sampler.row_ptr, np.int64)).to(
            self.device)
        self.src_sorted = torch.from_numpy(
            np.ascontiguousarray(sampler.src_sorted, np.int32)).to(self.device)
        n = self.num_nodes
        self._row_of = torch.full((n + 1,), -1, dtype=torch.int32, device=self.device)
        self._first = torch.full((n + 1,), _UNSEEN, dtype=torch.int32, device=self.device)
        self._graphs = {}  # (seeds, node pad, edge pad) -> (inputs, CUDA graph, outputs)

    def sample_arrays(self, seeds: np.ndarray, *, n_node_pad: int,
                      n_edge_pad: int) -> SampledArrays:
        """One subgraph, as :meth:`NeighborSampler.sample_arrays` gives it
        without hop pads and without the CSC permutation, its arrays on the
        device and ``num_edges`` and ``num_nodes`` 0-d int64 tensors there,
        each a tensor of its own. Enqueued on the current stream, inputs
        through pinned memory; on the card as one CUDA graph a shape,
        captured at its first batch (module docstring)."""
        seeds = np.asarray(seeds, np.int64)
        n_seeds = len(seeds)
        need = (self.sampler._structural_node_bound(n_seeds),
                self.sampler._structural_edge_bound(n_seeds))
        if n_node_pad < need[0] or n_edge_pad < need[1]:
            raise ValueError(f"pads ({n_node_pad}, {n_edge_pad}) under the structural bounds "
                             f"{need} of {n_seeds} seeds: the device sampler cannot check them")
        native._check_ids("DeviceSampler", self.num_nodes, seeds)
        if n_edge_pad * max(self.fanouts) >= _UNSEEN:
            raise ValueError(f"n_edge_pad={n_edge_pad} too large to number its picks in int32")
        # The random seed (the host path's draw), then the seeds.
        host = torch.from_numpy(np.concatenate([[self.sampler.rs.randint(0, 2**62)], seeds]))
        if self.device.type != "cuda":
            out = self._draw(host.to(self.device), n_node_pad, n_edge_pad)
        else:
            key = (n_seeds, n_node_pad, n_edge_pad)
            if key not in self._graphs:
                self._graphs[key] = self._capture(host, n_node_pad, n_edge_pad)
            inputs, graph, static = self._graphs[key]
            inputs.copy_(host.pin_memory(), non_blocking=True)
            graph.replay()
            out = [t.clone() for t in static]
        src, dst, nodes, n_edges, n_local = out
        return SampledArrays(src=src, dst=dst, node_ids=nodes, num_edges=n_edges,
                             num_seeds=n_seeds, num_nodes=n_local)

    def _capture(self, host: torch.Tensor, n_node_pad: int, n_edge_pad: int):
        """``(inputs, graph, outputs)``: :meth:`_draw` captured over a
        static input buffer, after one eager draw on a side stream (which
        leaves the tables as they were) has made its workspaces."""
        inputs = torch.empty(host.shape, dtype=torch.int64, device=self.device)
        inputs.copy_(host.pin_memory(), non_blocking=True)
        current = torch.cuda.current_stream(self.device)
        side = torch.cuda.Stream(self.device)
        side.wait_stream(current)
        with torch.cuda.stream(side):
            self._draw(inputs, n_node_pad, n_edge_pad)
        current.wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        # thread_local: the step's thread may launch while this one captures.
        with torch.cuda.graph(graph, capture_error_mode="thread_local"):
            static = self._draw(inputs, n_node_pad, n_edge_pad)
        return inputs, graph, static

    def _draw(self, inputs: torch.Tensor, n_node_pad: int, n_edge_pad: int):
        """``(src, dst, nodes, n_edges, n_local)`` of the subgraph of
        ``inputs`` (int64: the random seed, then the seeds) on the device,
        with no read back."""
        dev, sink = self.device, self.num_nodes
        rng_seed, s = inputs[:1], inputs[1:].int()
        n_seeds = s.shape[0]

        # Padded outputs, each with one spare slot at the end for masked scatters.
        nodes = torch.full((n_node_pad + 1,), -1, dtype=torch.int32, device=dev)
        src = torch.full((n_edge_pad + 1,), n_node_pad - 1, dtype=torch.int32, device=dev)
        dst = torch.full_like(src, n_node_pad - 1)

        # The seeds take rows 0..S-1; their first occurrences are hop 0's frontier.
        nodes[:n_seeds] = s
        s64 = s.long()
        order = torch.arange(n_seeds, dtype=torch.int32, device=dev)
        self._first.scatter_reduce_(0, s64, order, reduce="amin")
        lead = self._first[s64] == order
        self._first.index_fill_(0, s64, _UNSEEN)
        self._row_of.scatter_(0, torch.where(lead, s64, sink), order)
        frontier = torch.zeros(n_seeds + 1, dtype=torch.int32, device=dev)
        frontier.scatter_(0, torch.where(lead, torch.cumsum(lead, 0) - 1, n_seeds), s)
        frontier = frontier[:n_seeds]
        n_front = lead.sum()

        n_local = torch.full((), n_seeds, dtype=torch.int64, device=dev)
        n_edges = torch.zeros((), dtype=torch.int64, device=dev)
        for hop, fanout in enumerate(self.fanouts):
            slots = frontier.shape[0]
            picks, count = sample_picks(self.row_ptr, self.src_sorted, frontier, n_front, fanout,
                                        hop, rng_seed)
            real = picks >= 0  # packed left: pick j of slot i is real iff j < count[i]
            g = torch.where(real, picks, sink).long()
            pos = torch.arange(slots * fanout, dtype=torch.int32, device=dev).view(slots, fanout)
            unseen = real & (self._row_of[g] < 0)
            self._first.scatter_reduce_(0, torch.where(unseen, g, sink).view(-1), pos.view(-1),
                                        reduce="amin")
            new = (unseen & (self._first[g] == pos)).view(-1)
            rows = n_local + torch.cumsum(new, 0) - 1
            placed = torch.where(new, g.view(-1), sink)
            self._first.index_fill_(0, placed, _UNSEEN)
            self._row_of.scatter_(0, placed, rows.int())
            nodes.scatter_(0, torch.where(new, rows, n_node_pad), g.view(-1).int())
            n_new = new.sum()

            # This hop's edges: each destination's sources sorted, in place.
            loc = torch.where(real, self._row_of[g], _UNSEEN).sort(dim=1).values
            at = (n_edges + torch.cumsum(count, 0) - count).unsqueeze(1) + torch.arange(
                fanout, device=dev)
            at = torch.where(real, at, n_edge_pad).view(-1)
            dst_row = self._row_of[torch.where(frontier >= 0, frontier, sink).long()]
            src.scatter_(0, at, loc.view(-1))
            dst.scatter_(0, at, dst_row.unsqueeze(1).expand(slots, fanout).reshape(-1))
            n_edges = n_edges + count.sum()
            if hop + 1 < len(self.fanouts):  # the next frontier: this hop's new rows
                at_rows = (n_local + torch.arange(slots * fanout, device=dev)).clamp(
                    max=n_node_pad)
                frontier = nodes[at_rows]
                n_front = n_new
            n_local = n_local + n_new

        # Leave the tables as they came.
        self._row_of.index_fill_(0, torch.where(nodes >= 0, nodes, sink).long(), -1)
        self._row_of[sink:].fill_(-1)
        self._first[sink:].fill_(_UNSEEN)
        return src[:n_edge_pad], dst[:n_edge_pad], nodes[:n_node_pad], n_edges, n_local

"""Mini-batch node-classification training by neighbour sampling.

The port of the JAX package's ``mma_tpu/train/sampled.py``: the
large-graph regime (``BASELINE.json`` config[4], "ogbn-products-scale …
MMA with neighbor sampling"), where full-graph training stops fitting, so
seeds are mini-batched, layered neighbourhoods are sampled on the host
(:mod:`mma_tpu_torch.data.sampling`) and each step trains on a fixed-pad
subgraph.

- :func:`train_sampled`: one device, epochs over the training nodes.
- :func:`sampled_batch_producer`: the production pipeline. A producer
  thread samples on the host and copies to the card while the step runs;
  feature and label rows are gathered on the card from device-resident
  tables (:class:`DeviceTableAssembler`). It takes ``(n_dev, batch)`` seed
  batches, and rank ``r`` of a data-parallel world consumes row ``r``.
- :func:`make_sampled_dp_step`: the data-parallel step, one sampled
  subgraph per rank of the data axis (``mma_tpu/train/sampled.py:327-389``);
  :func:`stack_graphs` and :func:`stack_sampled_batches` give the per-rank
  pieces, where the JAX package stacks them along a leading device axis.
  Each subgraph is whole and keeps its structure, so the lean, half-fused
  and ELL routes run unsharded on every rank.

Randomness: the weights come from a CPU generator seeded with
``cfg.seed`` and dropout from one generator on the run's device; the
sampler draws from its own ``np.random.RandomState``, as in the JAX
package, so both packages sample the same subgraphs.
"""

from __future__ import annotations

import dataclasses
import queue
import threading
import time
from typing import Iterable, List, Optional, Sequence

import numpy as np
import torch

from mma_tpu_torch.convert import node_classifier_to_numpy
from mma_tpu_torch.data.sampling import NeighborSampler
from mma_tpu_torch.device import DeviceLike, resolve_device
from mma_tpu_torch.graph.container import Graph
from mma_tpu_torch.graph.device_build import finish_graph_on_device
from mma_tpu_torch.models import NodeClassifier
from mma_tpu_torch.parallel.collectives import psum_grads, psum_no_grad
from mma_tpu_torch.train.logger import JsonlLogger
from mma_tpu_torch.train.metrics import accuracy
from mma_tpu_torch.train.optim import make_optimizer


@dataclasses.dataclass(frozen=True)
class SampledTrainConfig:
    aggregators: tuple = ("mean", "mean2")
    hidden: int = 64
    lr: float = 0.003
    weight_decay: float = 0.0
    dropout: float = 0.5
    epochs: int = 3
    batch_size: int = 512
    fanouts: tuple = (10, 10, 5)  # 3 hops: gc1 + the MMA layer's two (aggregate + spmm)
    n_node_pad: int = 32768
    n_edge_pad: int = 131072
    seed: int = 0
    parity: bool = True
    log_path: Optional[str] = None


def seed_nll(logp: torch.Tensor, y: torch.Tensor, seed_mask: torch.Tensor) -> torch.Tensor:
    """Mean negative log-likelihood over the seed rows (``seed_mask``)."""
    nll = -logp[torch.arange(y.shape[0], device=y.device), y]
    return (nll * seed_mask).sum() / torch.clamp(seed_mask.sum(), min=1.0)


def sampled_train_step(model: NodeClassifier, optimizer: torch.optim.Optimizer,
                       x: torch.Tensor, graph: Graph, y: torch.Tensor,
                       seed_mask: torch.Tensor, generator: Optional[torch.Generator]):
    """One step on one sampled subgraph: the train-mode forward, the seed
    NLL, the backward and one optimizer update. Returns ``(loss, logp)``,
    detached; ``y`` is int64."""
    optimizer.zero_grad(set_to_none=True)
    logp = model(x, graph, training=True, generator=generator)
    loss = seed_nll(logp, y, seed_mask)
    loss.backward()
    optimizer.step()
    return loss.detach(), logp.detach()


def prepare_sampled_arrays(batch, features: np.ndarray, labels: np.ndarray):
    """Host-side ``(x, y, seed_mask)`` numpy arrays for one :class:`SampledBatch`."""
    x = np.zeros((batch.graph.n_node, features.shape[1]), np.float32)
    valid = batch.node_ids >= 0
    x[valid] = features[batch.node_ids[valid]]
    y = np.zeros(batch.graph.n_node, np.int32)
    y[valid] = labels[batch.node_ids[valid]]
    seed_mask = np.zeros(batch.graph.n_node, np.float32)
    seed_mask[: batch.num_seeds] = 1.0
    return x, y, seed_mask


def train_sampled(cfg: SampledTrainConfig, graph: Graph, features: np.ndarray,
                  labels: np.ndarray, train_nodes: np.ndarray, *,
                  device: DeviceLike = None):
    """Single-device sampled training on ``graph`` (any device; the sampler
    keeps a host copy). ``device=None`` runs on the GPU and raises without
    one. Returns ``{"params", "history", "model"}``: ``params`` as the JAX
    package's numpy tree, ``history`` one record per epoch with the JAX
    package's keys."""
    dev = resolve_device(device)
    log = JsonlLogger(cfg.log_path)
    features = np.asarray(features, np.float32)
    labels = np.asarray(labels)
    model = NodeClassifier(
        features.shape[1], cfg.hidden, int(labels.max()) + 1, cfg.aggregators,
        dropout_rate=cfg.dropout, parity=cfg.parity, device=dev,
        generator=torch.Generator().manual_seed(cfg.seed),
    )
    opt = make_optimizer(model.parameters(), cfg.lr, cfg.weight_decay)
    gen = torch.Generator(device=dev).manual_seed(cfg.seed)
    sampler = NeighborSampler(graph, cfg.fanouts, seed=cfg.seed, device=dev)

    history = []
    for epoch in range(cfg.epochs):
        t0 = time.time()
        tot_loss, tot_acc, nb = 0.0, 0.0, 0
        for batch in sampler.batches(train_nodes, cfg.batch_size,
                                     n_node_pad=cfg.n_node_pad, n_edge_pad=cfg.n_edge_pad):
            x, y, sm = (torch.from_numpy(a).to(dev)
                        for a in prepare_sampled_arrays(batch, features, labels))
            y = y.long()
            loss, logp = sampled_train_step(model, opt, x, batch.graph, y, sm, gen)
            tot_loss += float(loss)
            tot_acc += float(accuracy(logp[: batch.num_seeds], y[: batch.num_seeds]))
            nb += 1
        rec = dict(epoch=epoch, loss=tot_loss / max(nb, 1), acc_train=tot_acc / max(nb, 1),
                   batches=nb, time=time.time() - t0)
        history.append(rec)
        log.log(**rec)
    log.close()
    return {"params": node_classifier_to_numpy(model), "history": history, "model": model}


class DeviceTableAssembler:
    """Feature and label tables resident on the device, gathered by node id.

    Per batch only the ``(N_pad,)`` int32 id map crosses to the device. Rows
    whose id is -1 (padding, holes) get zeros. Ids index the tables modulo
    their row count (``max(id, 0) % rows``), as in the JAX package: a
    feature table smaller than the graph (the CLI's hashed ``min(n, 65536)``
    rows) is read that way."""

    def __init__(self, features: np.ndarray, labels: np.ndarray, *,
                 device: DeviceLike = None):
        dev = resolve_device(device)
        self.feat_tab = torch.from_numpy(np.ascontiguousarray(features, np.float32)).to(dev)
        self.lab_tab = torch.from_numpy(np.asarray(labels).astype(np.int64)).to(dev)

    def assemble(self, ids: torch.Tensor, num_seeds: int):
        """``(x, y, seed_mask)`` on the tables' device from ``ids`` (N_pad,)
        int32 on that device; the first ``num_seeds`` rows are the seeds."""
        valid = ids >= 0
        safe = ids.clamp(min=0).long() % self.feat_tab.shape[0]
        x = torch.where(valid[:, None], self.feat_tab[safe], 0.0)
        y = torch.where(valid, self.lab_tab[safe], 0)
        sm = (torch.arange(ids.shape[0], device=ids.device) < num_seeds).float()
        return x, y, sm

    def __call__(self, batch):
        """``(x, y, seed_mask)`` of a :class:`SampledBatch` or :class:`SampledArrays`."""
        ids = torch.from_numpy(np.asarray(batch.node_ids, np.int32)).to(self.feat_tab.device)
        return self.assemble(ids, batch.num_seeds)


def _rank_seeds(seeds_nd, rank: int) -> np.ndarray:
    """Row ``rank`` of an ``(n_dev, batch)`` seed batch."""
    seeds_nd = np.asarray(seeds_nd)
    if seeds_nd.ndim != 2 or not 0 <= rank < seeds_nd.shape[0]:
        raise ValueError(f"seed batches of shape {seeds_nd.shape} have no row for rank "
                         f"{rank}; pass (n_dev, batch) arrays")
    return seeds_nd[rank]


class _Shipper:
    """Moves a batch's host tensors to the device. On the card: through
    pinned memory, with the copies on a stream of their own and an event the
    consumer's stream waits on, so that they overlap the running step."""

    def __init__(self, dev: torch.device):
        self.dev = dev
        self.stream = torch.cuda.Stream(dev) if dev.type == "cuda" else None

    def ship(self, tensors: dict):
        if self.stream is None:
            return {k: v.to(self.dev) for k, v in tensors.items()}, None
        with torch.cuda.stream(self.stream):
            moved = {k: v.pin_memory().to(self.dev, non_blocking=True)
                     for k, v in tensors.items()}
            done = torch.cuda.Event()
            done.record(self.stream)
        return moved, done

    def receive(self, moved: dict, done) -> dict:
        if done is not None:
            cur = torch.cuda.current_stream(self.dev)
            cur.wait_event(done)
            for t in moved.values():
                t.record_stream(cur)  # their memory was allocated on the copy stream
        return moved


def sampled_batch_producer(sampler: NeighborSampler, seed_batches: Iterable,
                           assembler: DeviceTableAssembler, *, n_node_pad: int,
                           n_edge_pad: int, hop_node_pads: Optional[Sequence[int]] = None,
                           queue_depth: int = 2, device_finish: bool = False,
                           deg_table: Optional[torch.Tensor] = None, rank: int = 0):
    """Generator of ``(x, graph, y, seed_mask)`` step inputs on the
    assembler's device, with the host work in a producer thread, up to
    ``queue_depth`` batches ahead of the step.

    ``seed_batches``: an iterable of ``(n_dev, batch)`` seed-id arrays (the
    JAX package's per-device stacks); this producer samples row ``rank``,
    the data-axis rank of its process (0 on one device).

    The producer thread does host work only (sampling, which the native
    sampler runs with the interpreter lock released, sorting, filling
    pinned buffers) and starts the copies to the card on a copy stream;
    the consumer's stream waits for them on an event. The graph finishing
    and the feature gathers run on the consumer's stream.

    ``device_finish=True`` is the minimal-transfer pipeline: the host ships
    ``(src, dst, ids)`` and the CSC permutation, and the CSR/CSC views,
    masks and true degrees are derived on the device
    (:func:`finish_graph_on_device`), which needs ``deg_table``: the
    ``(N_global,)`` float32 true in-degrees on the device. Otherwise the
    host builds the whole graph and ships every field. The JAX package's
    ``use_pallas`` has no counterpart: the device chooses the kernels, and
    every subgraph keeps its structure.

    An exception in the producer is raised again here, after the batches
    before it; closing the generator early stops the producer.
    """
    dev = assembler.feat_tab.device
    if device_finish and deg_table is None:
        raise ValueError("device_finish needs deg_table")
    shipper = _Shipper(dev)
    pads = dict(n_node_pad=n_node_pad, n_edge_pad=n_edge_pad, hop_node_pads=hop_node_pads)

    def make_inputs(seeds_nd):
        seeds = _rank_seeds(seeds_nd, rank)
        if device_finish:
            ar = sampler.sample_arrays(seeds, **pads)
            host = {"src": ar.src, "dst": ar.dst, "node_ids": ar.node_ids,
                    "src_perm": ar.src_perm}
            moved, done = shipper.ship({k: torch.from_numpy(v) for k, v in host.items()})
            return moved, done, (ar.num_edges, ar.num_seeds, ar.ell_hint)
        bt = sampler.sample(seeds, device="cpu", **pads)
        host = {f.name: getattr(bt.graph, f.name) for f in dataclasses.fields(bt.graph)
                if isinstance(getattr(bt.graph, f.name), torch.Tensor)}
        host["node_ids"] = torch.from_numpy(bt.node_ids.astype(np.int32))
        moved, done = shipper.ship(host)
        return moved, done, (bt.graph, bt.num_seeds)

    q: queue.Queue = queue.Queue(maxsize=queue_depth)
    stop = threading.Event()
    err = []

    def put(item) -> bool:
        while not stop.is_set():
            try:
                q.put(item, timeout=0.05)
                return True
            except queue.Full:
                continue
        return False

    def producer():
        try:
            for seeds_nd in seed_batches:
                if not put(make_inputs(seeds_nd)):
                    return
        except Exception as e:  # raised again by the consumer
            err.append(e)
        finally:
            put(None)

    th = threading.Thread(target=producer, name="sampled-batch-producer", daemon=True)
    th.start()
    try:
        while True:
            item = q.get()
            if item is None:
                break
            moved, done, meta = item
            t = shipper.receive(moved, done)
            if device_finish:
                num_edges, num_seeds, ell_hint = meta
                graph = finish_graph_on_device(t["src"], t["dst"], t["node_ids"], num_edges,
                                               deg_table, t["src_perm"], ell_hint=ell_hint)
            else:
                host_graph, num_seeds = meta
                graph = dataclasses.replace(
                    host_graph, **{k: v for k, v in t.items() if k != "node_ids"})
            x, y, sm = assembler.assemble(t["node_ids"], num_seeds)
            yield x, graph, y, sm
    finally:
        stop.set()
        while th.is_alive():
            try:
                q.get(timeout=0.05)
            except queue.Empty:
                pass
        th.join()
    if err:
        raise err[0]


# ------------------------------------------------------------ data parallel

def stack_graphs(graphs: Sequence[Graph], keep_structure: bool = True) -> List[Graph]:
    """The per-rank subgraphs, in rank order (the JAX package stacks them
    along a leading device axis; rank ``r`` takes ``graphs[r]``). They must
    share their padding. ``keep_structure=False`` drops the CSC view and the
    ELL layout, as the JAX package's stripped stack does, so that each
    subgraph takes the half-fused route."""
    shapes = {(g.n_node, g.n_edge) for g in graphs}
    if len(shapes) != 1:
        raise ValueError(f"subgraphs of different padding: {sorted(shapes)}")
    if keep_structure:
        return list(graphs)
    return [dataclasses.replace(g, chunk_hint=None, ell_hint=None, src_perm=None,
                                col_ptr=None, src_csc=None, dst_csc=None) for g in graphs]


def stack_sampled_batches(batches, features: np.ndarray, labels: np.ndarray,
                          keep_structure: bool = True) -> List[tuple]:
    """Per-rank step inputs ``(x, graph, y, seed_mask)``, in rank order, on
    the CPU (``y`` int64): the JAX package's stacks, one piece per rank, for
    :func:`make_sampled_dp_step`. The subgraphs must share their padding."""
    graphs = stack_graphs([b.graph for b in batches], keep_structure)
    out = []
    for b, g in zip(batches, graphs):
        x, y, sm = prepare_sampled_arrays(b, features, labels)
        out.append((torch.from_numpy(x), g, torch.from_numpy(y).long(), torch.from_numpy(sm)))
    return out


def make_sampled_dp_step(model: NodeClassifier, optimizer: torch.optim.Optimizer, mesh,
                         axis: str = "data"):
    """Data-parallel sampled step: ``step(x, graph, y, seed_mask,
    generator=None) -> loss`` on this rank's subgraph. The loss is the
    seed-weighted NLL summed across ranks over the global seed count; each
    rank backpropagates its NLL sum over that count and the parameter
    gradients are summed over the mesh (``mma_tpu_torch.parallel.collectives``),
    so the step equals one step on the union of the subgraphs' seeds.
    Dropout draws from ``generator``, one per rank (the JAX package's
    per-device ``rng``). Returns the global loss, detached."""
    group = mesh.get_group(axis)

    def step(x, graph: Graph, y, seed_mask, generator: Optional[torch.Generator] = None):
        optimizer.zero_grad(set_to_none=True)
        logp = model(x, graph, training=True, generator=generator)
        lsum = (-logp[torch.arange(y.shape[0], device=y.device), y] * seed_mask).sum()
        cnt = torch.clamp(psum_no_grad(seed_mask.sum(), group), min=1.0)
        (lsum / cnt).backward()
        psum_grads(model.parameters())
        optimizer.step()
        return psum_no_grad(lsum, group) / cnt

    return step

"""``mma-sampled-products``, the program side: the port's neighbour-sampled
node classifier at ogbn-products' size, driven as
``mma_tpu_torch/cli/train_sampled.py::_run`` drives it.

The benchmark makes the graph's edges (``inputs/powerlaw.py``, fixed by
the configuration's ``graph_seed``) and sorts them into the sampler's CSR
with the port's native counting sort, as ``NeighborSampler.from_host_arrays``
does, once a checkout: drawing and sorting 122M edges takes about 50 s, so
the CSR is cached (:func:`csr`). From the run's seed it makes the feature
and label tables, the training nodes, the walk of seed batches and the
weights. The program builds its sampler from the CSR
(``NeighborSampler.from_csr``) and a copy of it on the card
(``DeviceSampler``), which draws the host sampler's subgraphs bit for bit;
a producer thread enqueues each batch's draw on a side stream
(``sampled_batch_producer`` with ``device_finish=True``), and the
subgraph's structure is finished and its feature and label rows gathered
on the card from the whole tables (``DeviceTableAssembler``) before the
step (``sampled_train_step``). Each step takes a fresh 1,024-seed
subgraph. A program without ``DeviceSampler`` stops in set-up.

The checked steps' subgraphs (the program's padded arrays, as sampled)
are kept and handed to ``reference/mma-sampled-products.py`` with the
tables and the full graph's in-degrees, counted here from the edges; the
reference reads the program's dropout keeps from the draws recorded in
those steps (``h100_bench/draws.py``) by subgraph edge position.

:data:`FAULTS` and :func:`plant` break the timed call underneath, for the
control runs (``control.py``) and the tests.
"""

from __future__ import annotations

import collections
import contextlib
import functools
import hashlib
import os
import time
from typing import Dict

import numpy as np
import torch

from mma_tpu_torch.cli.train_sampled import calibrate_pads
from mma_tpu_torch.data.sampling import NeighborSampler
from mma_tpu_torch.graph import native
from mma_tpu_torch.models import NodeClassifier
from mma_tpu_torch.train import loops, sampled
from mma_tpu_torch.train.optim import make_optimizer

from h100_bench import core
from h100_bench.core import CACHE_DIR, ROOT, sub_seeds
from h100_bench.inputs.powerlaw import powerlaw_edges

# The weights from the seed, the first gradient as Adam took it, and the
# counting rules of a step are those of the full-batch node configuration.
NODE = core.load_module("configs", "mma-node-large")

# Subgraphs kept for the check: the first steps' (at least the cell's
# ``check_steps``).
KEPT_BATCHES = 4
PAD = 4096


# The sources the cached CSR is made by: the generator and the sort.
CSR_SOURCES = ("h100_bench/inputs/powerlaw.py", "mma_tpu_torch/graph/native.py",
               "mma_tpu_torch/csrc/graphops.cpp")


@functools.lru_cache(maxsize=1)
def csr(n: int, avg_deg: int, seed: int):
    """The graph as the sampler holds it, ``(row_ptr, src_sorted)`` (int64,
    int32), and each node's in-degree counted from the drawn edges (not from
    the sort); cached at a fixed path in the checkout, keyed by the sources
    that make it, and kept for the process (``control.py`` runs many)."""
    h = hashlib.sha256()
    for rel in CSR_SOURCES:
        with open(os.path.join(ROOT, rel), "rb") as f:
            h.update(f.read())
    path = os.path.join(CACHE_DIR, f"powerlaw_csr_{n}_{avg_deg}_{seed}_{h.hexdigest()[:16]}.npz")
    if os.path.exists(path):
        z = np.load(path)
        return z["row_ptr"], z["src_sorted"], z["deg"]
    src, dst = powerlaw_edges(n, avg_deg, seed)
    deg = np.bincount(dst, minlength=n).astype(np.float32)
    src_sorted, dst_sorted, _ = native.sort_edges(src, dst, n)
    del src, dst
    row_ptr = native.build_row_ptr(dst_sorted, n).astype(np.int64)
    os.makedirs(CACHE_DIR, exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp.npz"
    np.savez(tmp, row_ptr=row_ptr, src_sorted=src_sorted, deg=deg)
    os.replace(tmp, path)
    return row_ptr, src_sorted, deg


def _round_up(v: int, to: int = PAD) -> int:
    return -(-int(v) // to) * to


def pads(sampler: NeighborSampler, batch_size: int):
    """``(n_node_pad, n_edge_pad)``: the structural bounds of ``batch_size``
    seeds at the sampler's fan-outs (every hop adds at most ``fanout`` edges
    and new nodes a frontier node), rounded up; no batch can exceed them."""
    return (_round_up(sampler._structural_node_bound(batch_size)),
            _round_up(sampler._structural_edge_bound(batch_size)))


def seed_walk(train_nodes: np.ndarray, batch_size: int, rs: np.random.RandomState):
    """``(1, batch_size)`` seed batches without end: each epoch a fresh
    shuffle of the training nodes, cut into whole batches."""
    while True:
        order = rs.permutation(train_nodes)
        for lo in range(0, len(order) - batch_size + 1, batch_size):
            yield order[None, lo:lo + batch_size]


class Train(NODE.Train):
    """One training object: the sampler and its producer, the tables on the
    card, the model and Adam. :meth:`step` is the timed call: the next batch
    from the producer, then ``sampled_train_step``."""

    def __init__(self, cfg: Dict, seed: int, device):
        s_inputs, s_weights, s_dropout, s_sampler, s_walk = sub_seeds(seed, 5)
        n, f, c = cfg["num_nodes"], cfg["num_features"], cfg["num_classes"]
        batch = cfg["batch_size"]
        self.cfg, self.device = cfg, torch.device(device)
        from_csr = NeighborSampler.from_csr  # a port without it stops here, before the graph
        from mma_tpu_torch.data.device_sampling import DeviceSampler  # likewise
        t0 = time.perf_counter()
        row_ptr, src_sorted, self.full_deg = csr(n, cfg["avg_deg"], cfg["graph_seed"])
        t_edges = time.perf_counter()
        self.sampler = from_csr(
            row_ptr, src_sorted, tuple(cfg["fanouts"]), seed=s_sampler,
            n_threads=cfg["sampler_threads"], device=self.device)
        t_csr = time.perf_counter()
        rs = np.random.RandomState(s_inputs)
        calibrated = calibrate_pads(self.sampler, rs, n, batch)
        self.n_node_pad, self.n_edge_pad = pads(self.sampler, batch)
        train_nodes = rs.permutation(n)[: cfg["num_train"]]
        gen = torch.Generator(device=self.device).manual_seed(s_inputs)
        self.features = torch.randn((n, f), generator=gen, device=self.device)
        self.labels = torch.randint(0, c, (n,), generator=gen, device=self.device)
        self.model = NodeClassifier(
            f, cfg["hidden"], c, cfg["aggregators"], scalers=cfg["scalers"],
            dropout_rate=cfg["dropout"], activation=cfg["activation"],
            sigmoid_k=cfg["sigmoid_k"], parity=cfg["parity"],
            compute_dtype=cfg["compute_dtype"], device=self.device)
        with torch.no_grad():
            for name, value in NODE.make_params(cfg, self.model, s_weights, self.device).items():
                self.model.get_parameter(name).copy_(value)
        b1, b2 = cfg["adam_betas"]
        self.optimizer = make_optimizer(self.model.parameters(), cfg["lr"], cfg["weight_decay"],
                                        b1=b1, b2=b2, eps=cfg["adam_eps"])
        self.generator = torch.Generator(device=self.device).manual_seed(s_dropout)
        # What the producer sampled, in order: a step takes the oldest.
        self._sampled = collections.deque()
        self.device_sampler = DeviceSampler(self.sampler, self.device)
        sample_arrays = self.device_sampler.sample_arrays

        def sample_and_note(seeds, **kw):
            ar = sample_arrays(seeds, **kw)
            self._sampled.append(ar)
            return ar

        self.device_sampler.sample_arrays = sample_and_note
        self.kept = []
        self.steps = 0
        # Counted on the card, so that a step waits for nothing.
        self.edges = torch.zeros((), dtype=torch.int64, device=self.device)
        self.nodes = torch.zeros((), dtype=torch.int64, device=self.device)
        self.assembler = sampled.DeviceTableAssembler(self.features, self.labels,
                                                      device=self.device)
        self.batches = sampled.sampled_batch_producer(
            self.device_sampler, seed_walk(train_nodes, batch, np.random.RandomState(s_walk)),
            self.assembler, n_node_pad=self.n_node_pad, n_edge_pad=self.n_edge_pad,
            queue_depth=cfg["queue_depth"], device_finish=True,
            deg_table=torch.from_numpy(self.sampler.true_deg).to(self.device))
        self.layers = {"mma_layer.fwd": self.model.mma, "gcn.fwd": self.model.gc1}
        print(f"train set-up: the CSR {t_edges - t0:.3f} s ({src_sorted.shape[0]} directed "
              f"edges), sampler {t_csr - t_edges:.3f} s, pads, tables, model and Adam "
              f"{time.perf_counter() - t_csr:.3f} s; pads: nodes {self.n_node_pad}, edges "
              f"{self.n_edge_pad} (calibrate_pads: hops {list(calibrated[0])}, nodes "
              f"{calibrated[1]}, edges {calibrated[2]})", flush=True)

    def step(self) -> torch.Tensor:
        x, g, y, sm = next(self.batches)
        ar = self._sampled.popleft()
        self.steps += 1
        self.edges += ar.num_edges  # 0-d tensors on the card
        self.nodes += ar.num_nodes
        if len(self.kept) < KEPT_BATCHES:
            self.kept.append(ar)
        loss, _ = sampled.sampled_train_step(self.model, self.optimizer, x, g, y, sm,
                                             self.generator)
        return loss

    @property
    def edge_visits_per_step(self) -> float:
        """The mean real sampled edges of the steps taken, times the
        message-passing layers (as ``mma-node-large`` counts them)."""
        return float(self.edges) / max(self.steps, 1) * self.cfg["message_passing_layers"]

    def reference_inputs(self) -> Dict:
        """The kept subgraphs as the program sampled them (padded ``src``,
        ``dst`` and ``node_ids``, ``num_seeds``, the real-edge mask), the
        feature and label tables they read, and the full graph's in-degrees."""
        batches = [{"src": ar.src.cpu().numpy(), "dst": ar.dst.cpu().numpy(),
                    "node_ids": ar.node_ids.cpu().numpy(), "num_seeds": ar.num_seeds,
                    "real": np.arange(ar.src.shape[0]) < int(ar.num_edges)}
                   for ar in self.kept]
        return {"batches": batches, "features": self.features, "labels": self.labels,
                "deg": self.full_deg}

    def free(self) -> None:
        if self.batches is not None:
            self.batches.close()  # stops and joins the producer thread
        for name in ("batches", "sampler", "device_sampler", "assembler", "features", "labels",
                     "model", "optimizer", "generator", "layers"):
            setattr(self, name, None)

    def work(self) -> Dict[str, Dict[str, float]]:
        steps = max(self.steps, 1)
        mean = dict(self.cfg, num_nodes=float(self.nodes) / steps)
        return NODE.step_work(mean, float(self.edges) / steps, self.cfg["batch_size"])


def precision(cfg: Dict):
    """The configuration's float32 matmul precision, as the program's loops
    set it (``"highest"``: no TF32)."""
    return loops.matmul_precision(cfg["matmul_precision"])


FAULTS = ("stale_batch", "half_seeds")


@contextlib.contextmanager
def plant(fault: str):
    """Break the timed call, ``sampled.sampled_train_step``, for the block:
    ``stale_batch`` trains each step on the previous step's subgraph (the
    first on its own), ``half_seeds`` takes the loss over the first half of
    the seeds."""
    if fault not in FAULTS:
        raise ValueError(f"unknown fault {fault!r}")
    real = sampled.sampled_train_step
    last = []

    def broken(model, optimizer, x, graph, y, seed_mask, generator):
        if fault == "stale_batch":
            inputs = last[0] if last else (x, graph, y, seed_mask)
            last[:] = [(x, graph, y, seed_mask)]
            return real(model, optimizer, *inputs, generator)
        rows = torch.arange(seed_mask.shape[0], device=seed_mask.device)
        return real(model, optimizer, x, graph, y, seed_mask * (rows < seed_mask.sum() / 2),
                    generator)

    sampled.sampled_train_step = broken
    try:
        yield
    finally:
        sampled.sampled_train_step = real

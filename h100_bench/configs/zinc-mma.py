"""``zinc-mma``, the program side: the port's ``ZincNet`` at the README's
ZINC preset, served from a ``torch.export`` artifact, with its weights
from the seed, its request pool, and its work.

The benchmark makes the molecules (``inputs/zinc_standin.py``), the
weights and the BatchNorm statistics, and hands the same to the program
and to ``reference/zinc-mma.py``. The program collates each request into
its padded disjoint-union layout (``batch_graphs``) and computes the
scalers' degree statistics (``compute_avg_deg``); the reference works
both out again.

:data:`FAULTS` and :func:`plant` break the timed call underneath, for the
control runs (``control.py``) and the tests.
"""

from __future__ import annotations

import contextlib
import dataclasses
import hashlib
import json
import math
import os
import time
from typing import Dict, List

import numpy as np
import torch

from mma_tpu_torch import serve
from mma_tpu_torch.data.batching import batch_graphs
from mma_tpu_torch.models import ZincNet
from mma_tpu_torch.nn.mma_conv import compute_avg_deg
from mma_tpu_torch.train import loops

from h100_bench import work as W
from h100_bench.core import CACHE_DIR, source_digest, sub_seeds
from h100_bench.inputs.zinc_standin import Molecules, synthesize


def molecules(cfg: Dict) -> Molecules:
    """The stand-in's train split, cached at a fixed path in the checkout
    (keyed by the generator's source) since drawing it takes seconds."""
    digest = source_digest(os.path.join("h100_bench", "inputs"))
    path = os.path.join(CACHE_DIR, f"zinc_standin_{cfg['dataset_size']}_{digest}.npz")
    if os.path.exists(path):
        z = np.load(path)
        n_off = np.concatenate([[0], np.cumsum(z["num_nodes"])])
        e_off = np.concatenate([[0], np.cumsum(z["num_edges"])])

        def cut(a, off):
            return [a[off[i]:off[i + 1]] for i in range(len(off) - 1)]

        return Molecules(z["num_nodes"], cut(z["node_types"], n_off), cut(z["edge_src"], e_off),
                         cut(z["edge_dst"], e_off), cut(z["edge_types"], e_off), z["y"])
    m = synthesize("train", cfg["dataset_size"])
    os.makedirs(CACHE_DIR, exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp.npz"
    np.savez(tmp, num_nodes=m.num_nodes, num_edges=m.num_edges(),
             node_types=np.concatenate(m.node_types), edge_src=np.concatenate(m.edge_src),
             edge_dst=np.concatenate(m.edge_dst), edge_types=np.concatenate(m.edge_types), y=m.y)
    os.replace(tmp, path)
    return m


def make_model(cfg: Dict, hist: np.ndarray, device) -> ZincNet:
    return ZincNet(cfg["aggregators"], cfg["scalers"], compute_avg_deg(hist, parity=cfg["parity"]),
                   num_layers=cfg["num_layers"], hidden=cfg["hidden"],
                   edge_hidden=cfg["edge_hidden"], num_node_types=cfg["num_node_types"],
                   num_edge_types=cfg["num_edge_types"], towers=cfg["towers"],
                   pre_layers=cfg["pre_layers"], post_layers=cfg["post_layers"],
                   mlp_sizes=tuple(cfg["mlp_sizes"]), parity=cfg["parity"],
                   compute_dtype=cfg["compute_dtype"], device=device)


def make_weights(model: torch.nn.Module, seed: int, device) -> Dict[str, torch.Tensor]:
    """Every entry of the model's ``state_dict``, from ``seed``, in two draws
    on the device: dense weights and biases ``U(+-1/sqrt(fan_in))``,
    BatchNorm scales ``U(0.5, 1.5)``, biases ``U(-0.5, 0.5)`` and running
    variances ``U(0.5, 2)``; embedding tables ``N(0, 1)`` and running
    means ``N(0, 0.5)``."""
    shapes = {k: v.shape for k, v in model.state_dict().items()}
    gen = torch.Generator(device=device).manual_seed(seed)
    normal = [k for k in shapes if k.endswith(".table") or k.endswith(".mean")]
    uniform = [k for k in shapes if k not in normal]
    u = torch.rand(sum(math.prod(shapes[k]) for k in uniform), generator=gen, device=device)
    z = torch.randn(sum(math.prod(shapes[k]) for k in normal), generator=gen, device=device)
    out, off = {}, 0
    for k in uniform:
        x = u[off:off + math.prod(shapes[k])].reshape(shapes[k])
        off += math.prod(shapes[k])
        head, leaf = k.rsplit(".", 1)
        if k.startswith("bn"):
            lo, hi = {"scale": (0.5, 1.5), "bias": (-0.5, 0.5), "var": (0.5, 2.0)}[leaf]
        else:
            bound = 1.0 / math.sqrt(shapes[f"{head}.w"][0])
            lo, hi = -bound, bound
        out[k] = lo + (hi - lo) * x
    off = 0
    for k in normal:
        x = z[off:off + math.prod(shapes[k])].reshape(shapes[k])
        off += math.prod(shapes[k])
        out[k] = x * (0.5 if k.endswith(".mean") else 1.0)
    return out


@dataclasses.dataclass
class Request:
    ids: np.ndarray  # the molecules, in the stand-in's numbering
    batch: object  # the program's host-side BatchedGraphs
    nodes: int
    edges: int

    @property
    def graphs(self) -> int:
        return len(self.ids)


def budget(m: Molecules, n_graph: int):
    """``(n_node, n_edge)`` that the ``n_graph`` largest molecules fit, plus a
    padding node, rounded up to 256 (nodes and edges bounded apart)."""
    n = 1 + int(np.sort(m.num_nodes)[::-1][:n_graph].sum())
    e = int(np.sort(m.num_edges())[::-1][:n_graph].sum())
    return -(-n // 256) * 256, -(-e // 256) * 256


def pinned(obj):
    """``obj`` (a ``BatchedGraphs`` or ``Graph``) with every tensor field in
    page-locked host memory, where a serving client stages its requests,
    so that each field goes to the card in one direct copy."""
    fields = {f.name: getattr(obj, f.name) for f in dataclasses.fields(obj)}
    return dataclasses.replace(obj, **{
        k: v.pin_memory() if isinstance(v, torch.Tensor) else pinned(v)
        for k, v in fields.items() if isinstance(v, torch.Tensor) or dataclasses.is_dataclass(v)})


def request_sizes(lo: int, hi: int, count: int) -> List[int]:
    """The same sizes for every seed: ``count`` evenly spaced in [lo, hi]."""
    return [int(round(v)) for v in np.linspace(lo, hi, count)]


class Serve:
    """The served callable with its weights and the request pool.

    Each request is ``sizes[i]`` molecules drawn by the seed without
    replacement from the stand-in, collated on the host by the program
    into one padded shape and kept in page-locked memory. The artifact
    takes the weights as arguments, so one export serves every seed; it
    is cached in the checkout, keyed by the program's and the benchmark's
    sources, the PyTorch version and the shape."""

    def __init__(self, cfg: Dict, params: Dict, seed: int, device):
        s_pool, s_weights = sub_seeds(seed, 2)
        self.cfg, self.device = cfg, torch.device(device)
        t0 = time.perf_counter()
        self.data = molecules(cfg)
        t_data = time.perf_counter()
        hist = self.data.degree_histogram()
        self.model = make_model(cfg, hist, self.device)
        weights = make_weights(self.model, s_weights, self.device)
        buffers = {k for k, _ in self.model.named_buffers()}
        self.params = {k: v for k, v in weights.items() if k not in buffers}
        self.state = {k: v for k, v in weights.items() if k in buffers}
        self.weights = weights
        self.n_params = sum(int(v.numel()) for v in weights.values())
        self.n_graph = int(params["max_molecules"])
        self.n_node, self.n_edge = budget(self.data, self.n_graph)
        rng = np.random.default_rng(s_pool)
        sizes = request_sizes(int(params["min_molecules"]), self.n_graph, int(params["pool"]))
        rng.shuffle(sizes)
        t_model = time.perf_counter()
        self.pool = [self._request(rng.choice(len(self.data), size, replace=False))
                     for size in sizes]
        t_pool = time.perf_counter()
        self.served = serve.load_forward(self._artifact())
        print(f"serve set-up: molecules {t_data - t0:.3f} s, model and weights "
              f"{t_model - t_data:.3f} s, {len(sizes)} requests collated "
              f"{t_pool - t_model:.3f} s, artifact {time.perf_counter() - t_pool:.3f} s "
              f"(n_graph {self.n_graph}, n_node {self.n_node}, n_edge {self.n_edge})", flush=True)

    def _request(self, ids: np.ndarray) -> Request:
        m = self.data
        b = batch_graphs([int(m.num_nodes[i]) for i in ids], [m.edge_src[i] for i in ids],
                         [m.edge_dst[i] for i in ids], n_graph=self.n_graph, n_node=self.n_node,
                         n_edge=self.n_edge, node_feats=[m.node_types[i] for i in ids],
                         edge_feats=[m.edge_types[i] for i in ids], device="cpu")
        if self.device.type == "cuda":
            b = pinned(b)
        return Request(ids, b, int(m.num_nodes[ids].sum()), int(sum(len(m.edge_src[i])
                                                                    for i in ids)))

    def _artifact(self) -> bytes:
        shape = json.dumps([self.cfg, self.n_graph, self.n_node, self.n_edge], sort_keys=True)
        key = "_".join([source_digest("mma_tpu_torch", "h100_bench"), torch.__version__,
                        self.device.type, hashlib.sha256(shape.encode()).hexdigest()[:12]])
        key = key.replace("+", "-").replace("/", "-")
        path = os.path.join(CACHE_DIR, f"zinc_served_{key}.pt2")
        if os.path.exists(path):
            with open(path, "rb") as f:
                return f.read()
        t0 = time.perf_counter()
        blob = serve.export_zinc_predictor(self.model, self.params, self.state,
                                           self.pool[0].batch.to(self.device))
        print(f"export {time.perf_counter() - t0:.3f} s, {len(blob)} bytes", flush=True)
        tmp = f"{path}.{os.getpid()}.tmp"
        with open(tmp, "wb") as f:
            f.write(blob)
        os.replace(tmp, path)
        return blob

    # The three parts of a request, as the window times them.
    def send(self, req: Request):
        return req.batch.to(self.device)

    def call(self, batch) -> torch.Tensor:
        return self.served(self.params, self.state, batch)

    def receive(self, out: torch.Tensor, req: Request) -> np.ndarray:
        return out[: req.graphs].cpu().numpy()

    def reference_inputs(self) -> Dict:
        return {"molecules": self.data, "weights": self.weights}

    def free(self) -> None:
        for name in ("model", "params", "state", "served"):
            setattr(self, name, None)

    def work(self, req: Request) -> Dict[str, float]:
        return forward_work(self.cfg, req.nodes, req.edges, req.graphs, self.n_params)


def forward_work(cfg: Dict, n: int, m: int, g: int, n_params: int) -> Dict[str, float]:
    """FLOPs and least bytes of one eval forward over ``n`` real atoms,
    ``m`` real (directed) bonds and ``g`` molecules (``work.py``'s rules).

    Per layer: the edge encoder (``m x 50 @ 50 x 75``), the dst and src
    projections of the first pre-NN layer for all towers (``n x 75 @ 75 x
    375`` each) and its edge block (``m x 75 @ 75 x 375``), the message sum
    (3 adds an edge lane), min and max (a compare each), the compounded
    amplification and linear scalers (a multiply a lane and aggregator
    each), the towers' post-NN (``n x 525 @ 525 x 15`` each) and ``lin``,
    BatchNorm (4) and ReLU (1) a lane. Then the pooled sum and the MLP.
    Bytes: the atoms' types, the bonds' endpoints and types, the weights,
    the predictions."""
    h, fe, t = cfg["hidden"], cfg["edge_hidden"], cfg["towers"]
    k, s = len(cfg["aggregators"]), len(cfg["scalers"])
    th = t * h
    layer = (W.matmul(m, fe, h) + m * h + 2 * W.matmul(n, h, th) + W.matmul(m, h, th)
             + 3 * m * th + k * m * th + (s - 1) * k * n * th
             + W.matmul(n, (k * s + 1) * h, h) + n * h + W.matmul(n, h, h) + n * h + 5 * n * h)
    sizes = cfg["mlp_sizes"]
    mlp = sum(W.matmul(g, a, b) + g * b for a, b in zip(sizes[:-1], sizes[1:]))
    flops = cfg["num_layers"] * layer + n * h + mlp
    nbytes = n * W.I32 + m * 3 * W.I32 + (g + 1) * W.I32 + n_params * W.F32 + g * W.F32
    return {"flops": flops, "bytes": nbytes}


def precision(cfg: Dict):
    return loops.matmul_precision(cfg["matmul_precision"])


def edge_visits(cfg: Dict, req: Request) -> int:
    return req.edges * cfg["message_passing_layers"]


FAULTS = ("altered_answer",)


@contextlib.contextmanager
def plant(fault: str):
    """Break the timed call for the block: ``altered_answer`` changes each
    request's first prediction where the served callable makes it."""
    if fault not in FAULTS:
        raise ValueError(f"unknown fault {fault!r}")
    real = serve.load_forward

    def load(blob):
        fn = real(blob)

        def served(*args):
            out = fn(*args).clone()
            out[0] = out[0] + 1.0
            return out

        return served

    serve.load_forward = load
    try:
        yield
    finally:
        serve.load_forward = real

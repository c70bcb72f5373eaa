"""``mma-node-large``, the program side: the port's ``NodeClassifier`` on the
power-law graph, its inputs and weights from the seed, and its work.

The benchmark makes the graph's edges (``inputs/powerlaw.py``), the
features, labels, training nodes and weights, and hands the same to the
program and to ``reference/mma-node-large.py``. The program builds its
own layout from the edges (``graph_from_edges``: padding, CSR, CSC),
which the reference works out again, and draws its dropout from a device
generator seeded by the benchmark; the checked steps record those draws
(``h100_bench/draws.py``) and the reference reads its keeps from them.

:data:`FAULTS` and :func:`plant` break the timed call underneath, for the
control runs (``control.py``) and the tests.
"""

from __future__ import annotations

import contextlib
import math
import time
from typing import Dict

import torch

from mma_tpu_torch.graph.build import graph_from_edges
from mma_tpu_torch.models import NodeClassifier
from mma_tpu_torch.train import loops
from mma_tpu_torch.train.optim import make_optimizer

from h100_bench import work as W
from h100_bench.core import sub_seeds
from h100_bench.inputs.powerlaw import powerlaw_edges


def init_bounds(cfg: Dict, model: torch.nn.Module) -> Dict[str, float]:
    """Each parameter's uniform bound, as the reference initialises it: the
    GCN weight ``1/sqrt(fan_out)``, every other ``1/sqrt(fan_in)``."""
    h = cfg["hidden"]
    return {name: 1.0 / math.sqrt(h) for name, _ in model.named_parameters()}


def make_params(cfg: Dict, model: torch.nn.Module, seed: int, device) -> Dict[str, torch.Tensor]:
    """The weights, from ``seed``: one uniform draw on the device, cut into
    the parameters and scaled to their bounds."""
    named = list(model.named_parameters())
    bounds = init_bounds(cfg, model)
    gen = torch.Generator(device=device).manual_seed(seed)
    flat = torch.rand(sum(p.numel() for _, p in named), generator=gen, device=device)
    out, off = {}, 0
    for name, p in named:
        u = flat[off:off + p.numel()].reshape(p.shape)
        out[name] = (2.0 * u - 1.0) * bounds[name]
        off += p.numel()
    return out


def edges(cfg: Dict):
    return powerlaw_edges(cfg["num_nodes"], cfg["avg_deg"], cfg["graph_seed"])


class Train:
    """One training object: the model, Adam, the graph and the inputs.
    :meth:`step` is the timed call, ``node_train_step`` itself."""

    def __init__(self, cfg: Dict, seed: int, device):
        s_inputs, s_weights, s_dropout = sub_seeds(seed, 3)
        n, f, c = cfg["num_nodes"], cfg["num_features"], cfg["num_classes"]
        self.cfg, self.device = cfg, torch.device(device)
        t0 = time.perf_counter()
        src, dst = edges(cfg)
        self.src, self.dst = src, dst
        t_edges = time.perf_counter()
        self.graph = graph_from_edges(src, dst, n, device=self.device)
        t_graph = time.perf_counter()
        n_pad = self.graph.n_node
        gen = torch.Generator(device=self.device).manual_seed(s_inputs)
        words = (torch.rand((n_pad, f), generator=gen, device=self.device)
                 < cfg["feature_density"]).float() * self.graph.node_mask[:, None]
        self.x = words / words.sum(dim=1, keepdim=True).clamp(min=1.0)
        del words
        self.labels = torch.randint(0, c, (n_pad,), generator=gen, device=self.device)
        n_train = int(n * cfg["train_fraction"])
        self.idx_train = torch.randperm(n, generator=gen, device=self.device)[:n_train]
        self.model = NodeClassifier(
            f, cfg["hidden"], c, cfg["aggregators"], scalers=cfg["scalers"],
            dropout_rate=cfg["dropout"], activation=cfg["activation"],
            sigmoid_k=cfg["sigmoid_k"], parity=cfg["parity"],
            compute_dtype=cfg["compute_dtype"], device=self.device)
        with torch.no_grad():
            for name, value in make_params(cfg, self.model, s_weights, self.device).items():
                self.model.get_parameter(name).copy_(value)
        b1, b2 = cfg["adam_betas"]
        self.optimizer = make_optimizer(self.model.parameters(), cfg["lr"], cfg["weight_decay"],
                                        b1=b1, b2=b2, eps=cfg["adam_eps"])
        self.generator = torch.Generator(device=self.device).manual_seed(s_dropout)
        self.num_edges = int(src.shape[0])
        self.edge_visits_per_step = self.num_edges * cfg["message_passing_layers"]
        self.layers = {"mma_layer.fwd": self.model.mma, "gcn.fwd": self.model.gc1}
        print(f"train set-up: edges {t_edges - t0:.3f} s, graph {t_graph - t_edges:.3f} s, "
              f"inputs, model and Adam {time.perf_counter() - t_graph:.3f} s", flush=True)

    def step(self) -> torch.Tensor:
        loss, _ = loops.node_train_step(self.model, self.optimizer, self.x, self.graph,
                                        self.labels, self.idx_train, self.generator)
        return loss

    def params(self) -> Dict[str, torch.Tensor]:
        return {k: v.detach().clone() for k, v in self.model.named_parameters()}

    def first_gradient(self) -> Dict[str, torch.Tensor]:
        """The gradient Adam took at step 1 (weight decay included), from its
        state after that step: ``exp_avg / (1 - beta1)`` (zero for a
        parameter that Adam holds no state of: it took no step)."""
        b1 = self.cfg["adam_betas"][0]
        state = self.optimizer.state
        return {k: (state[p]["exp_avg"].detach() / (1.0 - b1) if "exp_avg" in state.get(p, {})
                    else torch.zeros_like(p))
                for k, p in self.model.named_parameters()}

    def reference_inputs(self) -> Dict:
        """The benchmark's inputs, and the labels of the program's edge rows,
        which name the rows of its recorded mask draws."""
        g = self.graph
        return {"src": self.src, "dst": self.dst, "x": self.x[: self.cfg["num_nodes"]],
                "labels": self.labels[: self.cfg["num_nodes"]], "idx_train": self.idx_train,
                "draw_rows": {"src": g.src.cpu().numpy(), "dst": g.dst.cpu().numpy(),
                              "real": g.edge_mask.cpu().numpy()}}

    def free(self) -> None:
        for name in ("graph", "x", "labels", "idx_train", "model", "optimizer", "generator",
                     "layers"):
            setattr(self, name, None)

    def work(self) -> Dict[str, Dict[str, float]]:
        return step_work(self.cfg, self.num_edges, int(self.cfg["num_nodes"]
                                                       * self.cfg["train_fraction"]))


def step_work(cfg: Dict, e: int, n_train: int) -> Dict[str, Dict[str, float]]:
    """FLOPs and least bytes of one training step and of its MMA layer
    (forward and backward), from the shapes (``work.py``'s rules).

    The MMA layer: per-node mask projections ``c, d`` (``h @ W_top``,
    ``h @ W_bot``, K·H wide), per edge and lane the logit ``c[dst] +
    d[src]``, the sigmoid, the dropout scale, the product with
    ``h[src]`` and the sum; the mean combine, the sum over aggregators,
    the parity scale, ``@ W`` and its propagation. Backward: the
    transposes of each, with the weights' gradients; the GCN's input
    needs no gradient. Adam: 12 FLOPs a parameter.
    """
    n, f, h, c = cfg["num_nodes"], cfg["num_features"], cfg["hidden"], cfg["num_classes"]
    k = len(cfg["aggregators"])
    kh = k * h
    n_params = f * h + h + 2 * k * h * h + h * c + c
    mma_fwd = (2 * W.matmul(n, h, kh) + e * kh * (1 + 3 + 1 + 1 + 1)
               + n * kh * 2 + n * (k - 1) * h + n * h + W.matmul(n, h, c) + e * c + n * c)
    mma_bwd = (e * c + 2 * W.matmul(n, h, c) + n * h + n * kh * 2
               + e * kh * (1 + 1 + 1 + 1 + 3 + 1 + 1) + 4 * W.matmul(n, h, kh))
    gcn_fwd = W.matmul(n, f, h) + e * h + n * h * 3
    gcn_bwd = n * h * 2 + e * h + W.matmul(n, f, h)
    head = 5 * n * c + 3 * n * c + 2 * n_train
    step_flops = mma_fwd + mma_bwd + gcn_fwd + gcn_bwd + head + 12 * n_params
    graph_bytes = 2 * e * W.I32 + (n + 1) * W.I32
    mma_bytes = (graph_bytes + n * h * W.F32 + n * c * W.F32  # h in, out
                 + n * c * W.F32 + n * h * W.F32  # ct in, dh out
                 + 2 * (2 * k * h * h + h * c + c) * W.F32)  # weights in, gradients out
    step_bytes = (graph_bytes + n * f * W.F32 + n * W.I64 + n_train * W.I64
                  + n_params * W.F32 * 6)  # params, grads, two moments: read and written
    return {"step": {"flops": step_flops, "bytes": step_bytes},
            "mma_layer": {"flops": mma_fwd + mma_bwd, "bytes": mma_bytes}}


def precision(cfg: Dict):
    """The configuration's float32 matmul precision, as the program's loops
    set it (``"highest"``: no TF32)."""
    return loops.matmul_precision(cfg["matmul_precision"])


FAULTS = ("half_batch", "unchanged")


@contextlib.contextmanager
def plant(fault: str):
    """Break the timed call, ``loops.node_train_step``, for the block:
    ``half_batch`` takes the loss over half the training nodes,
    ``unchanged`` returns the loss and leaves the state as it was."""
    if fault not in FAULTS:
        raise ValueError(f"unknown fault {fault!r}")
    real = loops.node_train_step

    def broken(model, optimizer, x, graph, labels, idx_train, generator):
        if fault == "half_batch":
            return real(model, optimizer, x, graph, labels,
                        idx_train[: idx_train.shape[0] // 2], generator)
        logp = model(x, graph, training=True, generator=generator)
        return loops.nll(logp, labels, idx_train).detach(), logp.detach()

    loops.node_train_step = broken
    try:
        yield
    finally:
        loops.node_train_step = real

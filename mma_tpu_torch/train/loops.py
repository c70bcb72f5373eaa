"""The node-classification training loop.

Full-batch transductive training (reference ``node_classification/
train.py:72-116``), the counterpart of the JAX package's
``train_node_classification`` (``mma_tpu/train/loops.py:35-162``): the
same loss, the same per-epoch record, the same ``fastmode`` rule and a
final test evaluation. PyTorch runs eagerly, so the step is a plain
function (:func:`node_train_step`) where the JAX package jits one.

Randomness: the weights are drawn from a CPU generator seeded with
``cfg.seed`` (so one seed gives the same weights on any device), and the
dropout draws from one generator on the run's device, seeded with
``cfg.seed``. Its stream differs from JAX's.
"""

from __future__ import annotations

import contextlib
import time
import warnings
from typing import Optional

import torch

from mma_tpu_torch.convert import node_classifier_to_numpy
from mma_tpu_torch.data import load_planetoid
from mma_tpu_torch.device import DeviceLike, resolve_device
from mma_tpu_torch.graph.container import Graph
from mma_tpu_torch.models import NodeClassifier
from mma_tpu_torch.train.config import NodeClassificationConfig
from mma_tpu_torch.train.logger import JsonlLogger
from mma_tpu_torch.train.metrics import accuracy
from mma_tpu_torch.train.optim import make_optimizer

# The JAX package's matmul precisions → torch's float32 matmul precision.
_MATMUL_PRECISION = {"highest": "highest", "high": "high", "default": "medium"}


@contextlib.contextmanager
def matmul_precision(precision: Optional[str]):
    """Run the block at ``precision`` ("highest" keeps float32 products in
    full float32, with no TF32), then restore the process's setting."""
    if precision is None:
        yield
        return
    if precision not in _MATMUL_PRECISION:
        raise ValueError(f"unknown matmul_precision {precision!r}; valid: {sorted(_MATMUL_PRECISION)}")
    before = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision(_MATMUL_PRECISION[precision])
    try:
        yield
    finally:
        torch.set_float32_matmul_precision(before)


def nll(logp: torch.Tensor, labels: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Mean negative log-likelihood of ``labels`` over the nodes ``idx``."""
    return -logp[idx, labels[idx]].mean()


def node_train_step(model: NodeClassifier, optimizer: torch.optim.Optimizer,
                    x: torch.Tensor, graph: Graph, labels: torch.Tensor,
                    idx_train: torch.Tensor, generator: Optional[torch.Generator]):
    """One training step: the train-mode forward, the NLL over ``idx_train``,
    the backward and one optimizer update. Returns ``(loss, logp)``,
    detached; ``labels`` and ``idx_train`` are int64."""
    optimizer.zero_grad(set_to_none=True)
    logp = model(x, graph, training=True, generator=generator)
    loss = nll(logp, labels, idx_train)
    loss.backward()
    optimizer.step()
    return loss.detach(), logp.detach()


def train_node_classification(cfg: NodeClassificationConfig, data=None, *,
                              device: DeviceLike = None):
    """Train the node classifier of ``cfg`` on its Planetoid dataset (or on
    ``data``, a :class:`~mma_tpu_torch.data.PlanetoidData`).

    ``device=None`` runs on the GPU and raises without one. Returns
    ``{"loss_test", "acc_test", "history", "params", "synthetic_features",
    "model"}``: ``history`` holds one record per epoch with the JAX
    package's keys, ``params`` the trained parameters as the JAX package's
    numpy tree, ``model`` the trained module.
    """
    if cfg.checkpoint_dir or cfg.resume:
        raise NotImplementedError("checkpoint/resume is not ported yet")
    dev = resolve_device(device)
    with matmul_precision(cfg.matmul_precision):
        return _train(cfg, data, dev)


def _train(cfg: NodeClassificationConfig, data, dev: torch.device):
    log = JsonlLogger(cfg.log_path)
    synthetic_features = False
    if data is None:
        synthetic_features = cfg.dataset == "pubmed"
        if synthetic_features:
            # ind.pubmed.allx is absent upstream; refuse to let a
            # synthetic-feature accuracy pass silently as a quality number.
            warnings.warn(
                "pubmed features are SYNTHETIC (ind.pubmed.allx missing): "
                "accuracies are structural-benchmarks only, NOT quality "
                "numbers. Results are tagged synthetic_features=True.",
                stacklevel=3,
            )
            log.log(synthetic_features=True)
        data = load_planetoid(cfg.dataset, synthetic_features=synthetic_features, device=dev)
    graph = data.graph.to(dev)
    x = data.features.to(dev)
    labels = data.labels.to(dev).long()
    idx_train, idx_val, idx_test = (i.to(dev).long()
                                    for i in (data.idx_train, data.idx_val, data.idx_test))

    model = NodeClassifier(
        data.num_features, cfg.hidden, data.num_classes, cfg.aggregators,
        scalers=cfg.scalers, dropout_rate=cfg.dropout, activation=cfg.activation,
        sigmoid_k=cfg.sigmoid_k, parity=cfg.parity, device=dev,
        generator=torch.Generator().manual_seed(cfg.seed),
    )
    opt = make_optimizer(model.parameters(), cfg.lr, cfg.weight_decay)
    gen = torch.Generator(device=dev).manual_seed(cfg.seed)

    def eval_forward():
        with torch.no_grad():
            return model(x, graph, training=False,
                         generator=gen if cfg.parity_eval_dropout else None,
                         parity_eval_dropout=cfg.parity_eval_dropout)

    history = []
    for epoch in range(cfg.epochs):
        t = time.time()
        with torch.profiler.record_function("train_step"):
            loss_train, logp_train = node_train_step(model, opt, x, graph, labels,
                                                     idx_train, gen)
        acc_train = accuracy(logp_train[idx_train], labels[idx_train])
        # train.py:82-86: fastmode reuses the train-mode forward.
        logp = logp_train if cfg.fastmode else eval_forward()
        loss_val = nll(logp, labels, idx_val)
        acc_val = accuracy(logp[idx_val], labels[idx_val])
        rec = dict(
            epoch=epoch + 1,
            loss_train=float(loss_train),
            acc_train=float(acc_train),
            loss_val=float(loss_val),
            acc_val=float(acc_val),
            time=time.time() - t,
        )
        history.append(rec)
        log.log(**rec)

    logp = eval_forward()
    results = {
        "loss_test": float(nll(logp, labels, idx_test)),
        "acc_test": float(accuracy(logp[idx_test], labels[idx_test])),
        "history": history,
        "params": node_classifier_to_numpy(model),
        "synthetic_features": synthetic_features,
        "model": model,
    }
    log.log(loss_test=results["loss_test"], acc_test=results["acc_test"])
    log.close()
    return results

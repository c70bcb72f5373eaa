"""The training loops: node classification and ZINC graph regression.

- :func:`train_node_classification`: full-batch transductive training
  (reference ``node_classification/train.py:72-116``), the counterpart of
  the JAX package's loop (``mma_tpu/train/loops.py:35-162``): the same
  loss, the same per-epoch record, the same ``fastmode`` rule and a final
  test evaluation.
- :func:`train_zinc`: batched L1 regression (reference
  ``graph_regression/mma.py:139-200``; ``mma_tpu/train/loops.py:165-354``):
  the same padding budgets, loss, plateau schedule and per-epoch record.

PyTorch runs eagerly, so each step is a plain function
(:func:`node_train_step`, :func:`zinc_train_step`) where the JAX package
jits one.

Randomness: the weights are drawn from a CPU generator seeded with
``cfg.seed`` (so one seed gives the same weights on any device), and the
dropout draws from one generator on the run's device, seeded with
``cfg.seed``. Its stream differs from JAX's.
"""

from __future__ import annotations

import contextlib
import time
import warnings
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from mma_tpu_torch.convert import node_classifier_to_numpy, zinc_net_to_numpy
from mma_tpu_torch.data import load_planetoid, load_zinc
from mma_tpu_torch.device import DeviceLike, resolve_device
from mma_tpu_torch.graph.container import BatchedGraphs, Graph
from mma_tpu_torch.models import NodeClassifier, ZincNet
from mma_tpu_torch.nn.mma_conv import compute_avg_deg
from mma_tpu_torch.train.config import NodeClassificationConfig, ZincConfig
from mma_tpu_torch.train.logger import JsonlLogger
from mma_tpu_torch.train.metrics import accuracy
from mma_tpu_torch.train.optim import ReduceLROnPlateau, make_optimizer

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


# --------------------------------------------------------------------- ZINC

def l1_loss(pred: torch.Tensor, batch: BatchedGraphs) -> torch.Tensor:
    """Mean absolute error over the batch's real graphs (``mma.py:156``)."""
    gm = batch.graph_mask.to(pred.dtype)
    return (torch.abs(pred - batch.target) * gm).sum() / torch.clamp(gm.sum(), min=1.0)


def zinc_train_step(model: ZincNet, optimizer: torch.optim.Optimizer,
                    batch: BatchedGraphs, generator: Optional[torch.Generator]
                    ) -> torch.Tensor:
    """One training step (train-mode forward with message dropout drawn
    from ``generator``, L1 loss, backward, optimizer update); returns the
    loss, detached.

    Every parameter takes an update, as every leaf of the JAX package's
    tree does: those the loss does not reach (the detached pre-NNs of
    parity mode, N7) get a zero gradient, so that weight decay still moves
    them. ``torch.optim.Adam`` would skip a parameter without a gradient.
    """
    optimizer.zero_grad(set_to_none=True)
    loss = l1_loss(model(batch, training=True, generator=generator), batch)
    loss.backward()
    for p in model.parameters():
        if p.grad is None:
            p.grad = torch.zeros_like(p)
    optimizer.step()
    return loss.detach()


def set_learning_rate(optimizer: torch.optim.Optimizer, lr: float) -> None:
    for group in optimizer.param_groups:
        group["lr"] = lr


def zinc_padding(cfg: ZincConfig, splits: Sequence) -> tuple:
    """``(n_node, n_edge)`` of every batch: the sum of the ``batch_size``
    largest molecules over all splits (nodes and edges bounded apart), plus
    one padding node, rounded up to 256 and capped by the per-graph-slot
    budgets (``mma_tpu/train/loops.py:224-242``)."""
    def budget(values):
        return int(np.sort(np.asarray(values))[::-1][: cfg.batch_size].sum())

    n_node = 1 + max(budget(d.num_nodes) for d in splits)
    n_edge = max(budget([len(s) for s in d.edge_src]) for d in splits)
    n_node = min(-(-n_node // 256) * 256, cfg.batch_size * cfg.n_node_per_graph)
    n_edge = min(-(-n_edge // 256) * 256, cfg.batch_size * cfg.n_edge_per_graph)
    return n_node, n_edge


def train_zinc(cfg: ZincConfig, datasets: Optional[Dict] = None, *,
               device: DeviceLike = None):
    """Train ``ZincNet`` on ZINC (``datasets``: ``{"train", "val", "test"}``
    of :class:`~mma_tpu_torch.data.ZincDataset`, else :func:`load_zinc`).

    ``device=None`` runs on the GPU and raises without one. Returns
    ``{"history", "params", "state", "val_mae", "test_mae", "model"}``:
    ``history`` holds one record per epoch with the JAX package's keys,
    ``params``/``state`` the trained model as the JAX package's numpy trees.
    """
    if cfg.checkpoint_dir or cfg.resume:
        raise NotImplementedError("checkpoint/resume is not ported yet")
    if cfg.batch_layout not in ("auto", "plain"):
        raise NotImplementedError(
            f"batch_layout={cfg.batch_layout!r} is not ported yet (the ELL / degree-exact "
            "slice of the port); 'auto' and 'plain' take the plain collate")
    dev = resolve_device(device)
    with matmul_precision(cfg.matmul_precision):
        return _train_zinc(cfg, datasets, dev)


def _train_zinc(cfg: ZincConfig, datasets, dev: torch.device):
    log = JsonlLogger(cfg.log_path)
    if datasets is None:
        datasets = {split: load_zinc(split, subset_size=cfg.subset_size)
                    for split in ("train", "val", "test")}
    train_ds, val_ds, test_ds = datasets["train"], datasets["val"], datasets["test"]
    model = ZincNet(
        cfg.aggregators, cfg.scalers,
        compute_avg_deg(train_ds.degree_histogram(), parity=cfg.parity),
        num_layers=cfg.num_layers, hidden=cfg.hidden, edge_hidden=cfg.edge_hidden,
        towers=cfg.towers, pre_layers=cfg.pre_layers, post_layers=cfg.post_layers,
        mlp_sizes=cfg.mlp_sizes, parity=cfg.parity, remat=cfg.remat,
        compute_dtype=cfg.compute_dtype,
        edge_format=cfg.edge_format, device=dev,
        generator=torch.Generator().manual_seed(cfg.seed),
    )
    opt = make_optimizer(model.parameters(), cfg.lr, cfg.weight_decay)
    sched = ReduceLROnPlateau(lr=cfg.lr, factor=cfg.lr_factor, patience=cfg.lr_patience,
                              min_lr=cfg.min_lr)
    n_node, n_edge = zinc_padding(cfg, (train_ds, val_ds, test_ds))
    gen = torch.Generator(device=dev).manual_seed(cfg.seed)

    def batches(ds, **kw):
        return ds.batches(cfg.batch_size, n_node=n_node, n_edge=n_edge, device=dev, **kw)

    # The eval splits are not shuffled: collate them once.
    eval_sets = {"val": list(batches(val_ds)), "test": list(batches(test_ds))}

    def evaluate(split):
        tot = torch.zeros((), device=dev)
        cnt = torch.zeros((), device=dev)
        with torch.no_grad():
            for batch in eval_sets[split]:
                pred = model(batch, training=False)
                gm = batch.graph_mask.to(pred.dtype)
                tot += (torch.abs(pred - batch.target) * gm).sum()
                cnt += gm.sum()
        return float(tot) / max(float(cnt), 1.0)

    history = []
    for epoch in range(cfg.epochs):
        t = time.time()
        total_loss = torch.zeros((), device=dev)
        total_graphs = torch.zeros((), device=dev)
        for batch in batches(train_ds, shuffle=True, seed=cfg.seed + epoch):
            with torch.profiler.record_function("train_step"):
                loss = zinc_train_step(model, opt, batch, gen)
            ng = batch.graph_mask.sum()
            total_loss += loss * ng
            total_graphs += ng
        val_mae = evaluate("val")
        test_mae = evaluate("test")
        new_lr = sched.step(val_mae)
        set_learning_rate(opt, new_lr)
        rec = dict(epoch=epoch, loss=float(total_loss) / max(float(total_graphs), 1.0),
                   val_mae=val_mae, test_mae=test_mae, lr=new_lr, time=time.time() - t)
        history.append(rec)
        log.log(**rec)
    log.close()
    params, state = zinc_net_to_numpy(model)
    return {
        "history": history,
        "params": params,
        "state": state,
        "val_mae": history[-1]["val_mae"] if history else None,
        "test_mae": history[-1]["test_mae"] if history else None,
        "model": model,
    }

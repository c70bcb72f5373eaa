"""Carry parameters between the JAX package's models and the port's modules.

The JAX parameter tree is nested dicts of numpy arrays (the caller
converts with ``np.asarray``), so this module needs no JAX.
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch

from mma_tpu_torch.models.node_classifier import NodeClassifier
from mma_tpu_torch.models.zinc_net import ZincNet
from mma_tpu_torch.nn.mma_conv import MultiMaskConv


def _load_into(module: torch.nn.Module, params: Mapping[str, np.ndarray], prefix: str) -> None:
    own = dict(module.named_parameters(recurse=False))
    if set(own) != set(params):
        raise ValueError(f"{prefix}: parameters {sorted(params)} != {sorted(own)}")
    with torch.no_grad():
        for name, value in params.items():
            target = own[name]
            value = torch.tensor(np.asarray(value, np.float32))
            if tuple(value.shape) != tuple(target.shape):
                raise ValueError(
                    f"{prefix}.{name}: shape {tuple(value.shape)} != {tuple(target.shape)}"
                )
            target.copy_(value)


def node_classifier_to_numpy(model: NodeClassifier) -> Dict[str, Dict[str, np.ndarray]]:
    """The inverse of :func:`node_classifier_from_jax`: the model's
    parameters as ``{"gc1": {"w", "b"}, "mma": {"w", "masks", "b"}}`` numpy
    arrays, in the JAX package's layouts."""
    return {
        name: {p: t.detach().cpu().numpy().copy()
               for p, t in getattr(model, name).named_parameters(recurse=False)}
        for name in ("gc1", "mma")
    }


def node_classifier_from_jax(params_np: Mapping[str, Mapping[str, np.ndarray]],
                             model: NodeClassifier) -> NodeClassifier:
    """Copy ``{"gc1": {"w", "b"}, "mma": {"w", "masks", "b"}}`` into ``model``
    in place (same layouts: weights ``(in, out)``, masks ``(K, 2F, F)``)."""
    if set(params_np) != {"gc1", "mma"}:
        raise ValueError(f"expected keys gc1, mma; got {sorted(params_np)}")
    _load_into(model.gc1, params_np["gc1"], "gc1")
    _load_into(model.mma, params_np["mma"], "mma")
    return model


def _dense_tree(d) -> Dict[str, np.ndarray]:
    return {p: t.detach().cpu().numpy().copy() for p, t in d.named_parameters(recurse=False)}


def multi_mask_conv_to_numpy(conv: MultiMaskConv) -> Dict:
    """One conv's parameters as the JAX package's ``MultiMaskConv`` tree."""
    tree = {
        "pre_nns": [[[_dense_tree(d) for d in tower] for tower in agg] for agg in conv.pre_nns],
        "post_nns": [[_dense_tree(d) for d in tower] for tower in conv.post_nns],
        "lin": _dense_tree(conv.lin),
    }
    if conv.edge_dim is not None:
        tree["edge_encoder"] = _dense_tree(conv.edge_encoder)
    return tree


def zinc_net_to_numpy(model: ZincNet):
    """``(params, state)`` of ``model`` as the JAX package's ZincNet trees
    of numpy arrays: ``node_emb.table``, ``edge_emb.table``,
    ``mlp.layer{i}``, ``conv{i}`` (``edge_encoder``, ``pre_nns[k][t][l]``,
    ``post_nns[t][l]``, ``lin``) and ``bn{i}.{scale, bias}``; the state
    ``bn{i}.{mean, var}``."""
    params = {
        "node_emb": {"table": model.node_emb.table.detach().cpu().numpy().copy()},
        "edge_emb": {"table": model.edge_emb.table.detach().cpu().numpy().copy()},
        "mlp": {f"layer{i}": _dense_tree(getattr(model.mlp, f"layer{i}"))
                for i in range(model.mlp.n_layers)},
    }
    state = {}
    for i in range(model.num_layers):
        bn = getattr(model, f"bn{i}")
        params[f"conv{i}"] = multi_mask_conv_to_numpy(getattr(model, f"conv{i}"))
        params[f"bn{i}"] = _dense_tree(bn)
        state[f"bn{i}"] = {"mean": bn.mean.cpu().numpy().copy(),
                           "var": bn.var.cpu().numpy().copy()}
    return params, state


def multi_mask_conv_from_jax(tree: Mapping, conv: MultiMaskConv,
                             prefix: str = "conv") -> MultiMaskConv:
    """Copy one JAX ``MultiMaskConv`` tree (``edge_encoder``,
    ``pre_nns[k][t][l]``, ``post_nns[t][l]``, ``lin``) into ``conv`` in place."""
    if conv.edge_dim is not None:
        _load_into(conv.edge_encoder, tree["edge_encoder"], f"{prefix}.edge_encoder")
    for k, agg in enumerate(tree["pre_nns"]):
        for t, tower in enumerate(agg):
            for li, layer in enumerate(tower):
                _load_into(conv.pre_nns[k][t][li], layer, f"{prefix}.pre_nns[{k}][{t}][{li}]")
    for t, tower in enumerate(tree["post_nns"]):
        for li, layer in enumerate(tower):
            _load_into(conv.post_nns[t][li], layer, f"{prefix}.post_nns[{t}][{li}]")
    _load_into(conv.lin, tree["lin"], f"{prefix}.lin")
    return conv


def zinc_net_from_jax(params_np: Mapping, state_np: Mapping, model: ZincNet) -> ZincNet:
    """Copy the JAX package's ZincNet ``params`` and ``state`` trees (numpy
    arrays, the layout :func:`zinc_net_to_numpy` returns) into ``model`` in
    place; shapes and names must match."""
    want = {"node_emb", "edge_emb", "mlp"} | {f"{p}{i}" for i in range(model.num_layers)
                                              for p in ("conv", "bn")}
    if set(params_np) != want:
        raise ValueError(f"expected keys {sorted(want)}; got {sorted(params_np)}")
    _load_into(model.node_emb, params_np["node_emb"], "node_emb")
    _load_into(model.edge_emb, params_np["edge_emb"], "edge_emb")
    for name, tree in params_np["mlp"].items():
        _load_into(getattr(model.mlp, name), tree, f"mlp.{name}")
    for i in range(model.num_layers):
        multi_mask_conv_from_jax(params_np[f"conv{i}"], getattr(model, f"conv{i}"), f"conv{i}")
        bn = getattr(model, f"bn{i}")
        _load_into(bn, params_np[f"bn{i}"], f"bn{i}")
        with torch.no_grad():
            for buf in ("mean", "var"):
                getattr(bn, buf).copy_(torch.tensor(np.asarray(state_np[f"bn{i}"][buf],
                                                               np.float32)))
    return model

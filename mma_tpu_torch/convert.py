"""Load parameters of the JAX package's models into the port's modules.

The JAX parameter tree arrives as nested dicts of numpy arrays (the caller
converts with ``np.asarray``), so this module needs no JAX.
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

from mma_tpu_torch.models.node_classifier import NodeClassifier


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


def node_classifier_from_jax(params_np: Mapping[str, Mapping[str, np.ndarray]],
                             model: NodeClassifier) -> NodeClassifier:
    """Copy ``{"gc1": {"w", "b"}, "mma": {"w", "masks", "b"}}`` into ``model``
    in place (same layouts: weights ``(in, out)``, masks ``(K, 2F, F)``)."""
    if set(params_np) != {"gc1", "mma"}:
        raise ValueError(f"expected keys gc1, mma; got {sorted(params_np)}")
    _load_into(model.gc1, params_np["gc1"], "gc1")
    _load_into(model.mma, params_np["mma"], "mma")
    return model

"""Planetoid (Cora/Citeseer/Pubmed) loader.

The same semantics as the JAX package's loader, which reproduces the
reference's ``load_data`` (``node_classification/utils.py:33-119``):

- the non-standard large train splits (train = first ``len(y)+1068``
  nodes for cora, ``+1707`` citeseer, ``+18157`` pubmed);
- the citeseer isolated-node feature/label extension;
- test-row feature/label reordering;
- citeseer all-zero label rows mapped to class 0;
- a binary, symmetric adjacency with no self-loops and no normalization.

Data files are the pickled Planetoid blobs under ``datasets/``
(``ind.{name}.{x,y,tx,ty,allx,ally,graph,test.index}``).
``ind.pubmed.allx`` is absent; ``synthetic_features=True`` substitutes
random features of the right shape.
"""

from __future__ import annotations

import dataclasses
import os
import pickle
from typing import Optional

import numpy as np
import scipy.sparse as sp
import torch

from mma_tpu_torch.device import DeviceLike, resolve_device
from mma_tpu_torch.graph.build import graph_from_edges, symmetrize
from mma_tpu_torch.graph.container import Graph

_DEFAULT_ROOT = os.path.join(os.path.dirname(__file__), "..", "..", "datasets")

# Train-split extents beyond len(y) (utils.py:80-94).
_TRAIN_EXTRA = {"cora": 1068, "citeseer": 1707, "pubmed": 18157}


@dataclasses.dataclass
class PlanetoidData:
    graph: Graph
    features: torch.Tensor  # (N_pad, F) float32, padding rows zero
    labels: torch.Tensor  # (N_pad,) int32, padding rows 0
    idx_train: torch.Tensor  # int32 node ids
    idx_val: torch.Tensor
    idx_test: torch.Tensor
    num_nodes: int
    num_classes: int

    @property
    def num_features(self) -> int:
        return self.features.shape[1]


def _load_pickle(path: str):
    with open(path, "rb") as f:
        return pickle.load(f, encoding="latin1")


def _parse_index_file(path: str):
    with open(path) as f:
        return np.array([int(line.strip()) for line in f], dtype=np.int64)


def load_planetoid(
    name: str,
    root: str = _DEFAULT_ROOT,
    *,
    n_node_pad: Optional[int] = None,
    n_edge_pad: Optional[int] = None,
    synthetic_features: bool = False,
    seed: int = 0,
    device: DeviceLike = None,
) -> PlanetoidData:
    """Load a Planetoid dataset; ``device=None`` puts it on the GPU."""
    dev = resolve_device(device)
    if name not in _TRAIN_EXTRA:
        raise ValueError(f"unknown dataset {name!r}; valid: {sorted(_TRAIN_EXTRA)}")

    def path(part):
        return os.path.join(root, f"ind.{name}.{part}")

    objs = {}
    for part in ("x", "y", "tx", "ty", "allx", "ally", "graph"):
        p = path(part)
        if not os.path.exists(p):
            if part == "allx" and synthetic_features:
                objs["allx"] = None
                continue
            raise FileNotFoundError(
                f"{p} missing"
                + (
                    " — pass synthetic_features=True to substitute random features"
                    if part == "allx"
                    else ""
                )
            )
        objs[part] = _load_pickle(p)
    x, y, tx, ty, allx, ally, graph_dict = (
        objs["x"], objs["y"], objs["tx"], objs["ty"], objs["allx"], objs["ally"], objs["graph"],
    )

    test_idx_reorder = _parse_index_file(path("test.index"))
    test_idx_range = np.sort(test_idx_reorder)

    if name == "citeseer":
        # Isolated test nodes: extend tx/ty with zero rows (utils.py:54-64).
        full = range(test_idx_reorder.min(), test_idx_reorder.max() + 1)
        tx_ext = sp.lil_matrix((len(full), x.shape[1]))
        tx_ext[test_idx_range - test_idx_reorder.min(), :] = tx
        tx = tx_ext
        ty_ext = np.zeros((len(full), y.shape[1]))
        ty_ext[test_idx_range - test_idx_reorder.min(), :] = ty
        ty = ty_ext

    if allx is None:  # synthetic pubmed features
        num_all = len(graph_dict) - tx.shape[0]
        rs = np.random.RandomState(seed)
        allx = sp.csr_matrix(
            (rs.rand(num_all, tx.shape[1]) < 0.02).astype(np.float32)
        )
        ally = np.zeros((num_all, ty.shape[1]))
        ally[np.arange(num_all), rs.randint(ty.shape[1], size=num_all)] = 1
        y = ally[: y.shape[0]]

    features = sp.vstack((allx, tx)).tolil()
    features[test_idx_reorder, :] = features[test_idx_range, :]
    features = np.asarray(features.todense(), dtype=np.float32)

    labels_oh = np.vstack((ally, ty))
    labels_oh[test_idx_reorder, :] = labels_oh[test_idx_range, :]
    if name == "citeseer":
        # All-zero label rows → class 0 (utils.py:104-109).
        labels = np.array(
            [row.argmax() if row.any() else 0 for row in labels_oh], dtype=np.int32
        )
    else:
        labels = np.asarray(np.where(labels_oh)[1], dtype=np.int32)

    num_nodes = len(graph_dict)
    srcs, dsts = [], []
    for i, nbrs in graph_dict.items():
        for j in nbrs:
            srcs.append(i)
            dsts.append(j)
    sym_src, sym_dst = symmetrize(np.asarray(srcs, np.int32), np.asarray(dsts, np.int32))
    graph = graph_from_edges(
        sym_src, sym_dst, num_nodes, n_node_pad=n_node_pad, n_edge_pad=n_edge_pad,
        device=dev,
    )

    n_pad = graph.n_node
    feat_pad = np.zeros((n_pad, features.shape[1]), np.float32)
    feat_pad[:num_nodes] = features
    lab_pad = np.zeros((n_pad,), np.int32)
    lab_pad[:num_nodes] = labels

    extra = _TRAIN_EXTRA[name]
    idx_train = np.arange(len(y) + extra, dtype=np.int32)
    idx_val = np.arange(len(y) + extra, len(y) + extra + 500, dtype=np.int32)
    idx_test = test_idx_range.astype(np.int32)

    def t(a):
        return torch.from_numpy(a).to(dev)

    return PlanetoidData(
        graph=graph,
        features=t(feat_pad),
        labels=t(lab_pad),
        idx_train=t(idx_train),
        idx_val=t(idx_val),
        idx_test=t(idx_test),
        num_nodes=num_nodes,
        num_classes=int(labels.max()) + 1,
    )

"""ZINC-subset molecular graph regression data.

A copy of the JAX package's loader (``mma_tpu/data/zinc.py``): 10k train /
1k val / 1k test molecules, node types 0..20 (atoms), edge types 1..3
(bond orders), one scalar target per graph (constrained solubility).

- If a converted copy exists at ``<root>/zinc_<split>.npz`` it is used
  (``scripts/convert_zinc.py`` produces it from a PyG checkout).
- Otherwise a deterministic synthetic stand-in with the same schema and
  statistics (9-37 atoms, in-degree ≤ 4) is generated. It is NumPy
  ``RandomState`` drawn in the same order as the JAX package's, so the two
  packages produce the same arrays. Its target is a graph functional plus
  noise: optimisation progress means something, quality numbers do not.

npz schema: ``num_nodes (G,)``, ``num_edges (G,)``, ``node_types (ΣN,)``,
``edge_src/edge_dst/edge_types (ΣE,)`` (directed, both directions
present), ``y (G,)``.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Iterator, List, Optional

import numpy as np

from mma_tpu_torch.data.batching import batch_graphs
from mma_tpu_torch.device import DeviceLike
from mma_tpu_torch.graph.container import BatchedGraphs

_SPLIT_SIZES = {"train": 10000, "val": 1000, "test": 1000}
NUM_NODE_TYPES = 21
NUM_EDGE_TYPES = 4


@dataclasses.dataclass
class ZincDataset:
    num_nodes: np.ndarray  # (G,)
    node_types: List[np.ndarray]
    edge_src: List[np.ndarray]
    edge_dst: List[np.ndarray]
    edge_types: List[np.ndarray]
    y: np.ndarray  # (G,)
    synthetic: bool

    def __len__(self):
        return len(self.num_nodes)

    def degree_histogram(self, num_bins: int = 5) -> np.ndarray:
        """In-degree histogram over the dataset (reference ``mma.py:57-60``;
        its fixed 5 bins work because ZINC's max in-degree is 4)."""
        hist = np.zeros(num_bins, np.int64)
        for nn, dst in zip(self.num_nodes, self.edge_dst):
            deg = np.bincount(dst, minlength=nn)
            hist += np.bincount(deg, minlength=num_bins)[:num_bins]
        return hist

    def max_nodes_edges(self):
        return (
            int(self.num_nodes.max()),
            int(max(len(s) for s in self.edge_src)),
        )

    def batches(
        self,
        batch_size: int,
        *,
        n_node: int,
        n_edge: int,
        shuffle: bool = False,
        seed: int = 0,
        drop_remainder: bool = False,
        ell_degree_budgets=None,
        device: DeviceLike = None,
    ) -> Iterator[BatchedGraphs]:
        """Yield padded :class:`BatchedGraphs` of one static shape, on
        ``device`` (the GPU unless told otherwise). ``shuffle`` draws the
        order from ``RandomState(seed)`` as the JAX package does."""
        order = np.arange(len(self))
        if shuffle:
            np.random.RandomState(seed).shuffle(order)
        for lo in range(0, len(order), batch_size):
            idx = order[lo : lo + batch_size]
            if drop_remainder and len(idx) < batch_size:
                return
            yield batch_graphs(
                [int(self.num_nodes[i]) for i in idx],
                [self.edge_src[i] for i in idx],
                [self.edge_dst[i] for i in idx],
                n_graph=batch_size,
                n_node=n_node,
                n_edge=n_edge,
                node_feats=[self.node_types[i] for i in idx],
                edge_feats=[self.edge_types[i] for i in idx],
                targets=[np.array([self.y[i]], np.float32).reshape(1) for i in idx],
                ell_degree_budgets=ell_degree_budgets,
                device=device,
            )


def _synthesize_split(split: str, size: int, seed_base: int = 1234) -> ZincDataset:
    rs = np.random.RandomState(seed_base + {"train": 0, "val": 1, "test": 2}[split])
    num_nodes, node_types, srcs, dsts, etypes, ys = [], [], [], [], [], []
    for _ in range(size):
        n = int(rs.randint(9, 38))
        types = rs.choice(NUM_NODE_TYPES, size=n, p=_atom_dist())
        # Molecule-like sparse graph: a random spanning tree (branching kept
        # low) plus a few ring-closing extra edges, degree ≤ 4.
        deg = np.zeros(n, np.int64)
        edges = []
        perm = rs.permutation(n)
        for i in range(1, n):
            # attach perm[i] to a previous node with spare valence
            for _ in range(10):
                j = perm[rs.randint(i)]
                if deg[j] < 4:
                    break
            edges.append((perm[i], j))
            deg[perm[i]] += 1
            deg[j] += 1
        n_extra = rs.randint(0, max(n // 6, 1) + 1)
        for _ in range(n_extra):
            a, b = rs.randint(n), rs.randint(n)
            if a != b and deg[a] < 4 and deg[b] < 4:
                edges.append((a, b))
                deg[a] += 1
                deg[b] += 1
        e = np.array(edges, np.int32)
        et = rs.choice([1, 2, 3], size=len(e), p=[0.7, 0.25, 0.05]).astype(np.int32)
        src = np.concatenate([e[:, 0], e[:, 1]])
        dst = np.concatenate([e[:, 1], e[:, 0]])
        et2 = np.concatenate([et, et])
        # Synthetic target: a smooth graph functional of types + structure.
        y = (
            0.1 * n
            - 0.3 * float(np.mean(types))
            + 0.5 * float(np.mean(deg))
            + 0.2 * float(np.mean(et2))
            + rs.normal(0, 0.1)
        )
        num_nodes.append(n)
        node_types.append(types.astype(np.int32))
        srcs.append(src)
        dsts.append(dst)
        etypes.append(et2)
        ys.append(y)
    return ZincDataset(
        num_nodes=np.array(num_nodes, np.int64),
        node_types=node_types,
        edge_src=srcs,
        edge_dst=dsts,
        edge_types=etypes,
        y=np.array(ys, np.float32),
        synthetic=True,
    )


def _atom_dist():
    p = np.ones(NUM_NODE_TYPES)
    p[0] = 30.0  # carbon-dominated, like ZINC
    p[1] = 6.0
    p[2] = 6.0
    return p / p.sum()


def load_zinc(
    split: str,
    root: Optional[str] = None,
    *,
    subset_size: Optional[int] = None,
) -> ZincDataset:
    """One split (``train``/``val``/``test``), from ``<root>/zinc_<split>.npz``
    when present (``root`` defaults to the repository's ``datasets/``), else
    the synthetic stand-in; ``subset_size`` keeps the first molecules."""
    if split not in _SPLIT_SIZES:
        raise ValueError(f"unknown split {split!r}")
    root = root or os.path.join(os.path.dirname(__file__), "..", "..", "datasets")
    npz_path = os.path.join(root, f"zinc_{split}.npz")
    if os.path.exists(npz_path):
        z = np.load(npz_path)
        num_nodes = z["num_nodes"]
        num_edges = z["num_edges"]
        n_off = np.concatenate([[0], np.cumsum(num_nodes)])
        e_off = np.concatenate([[0], np.cumsum(num_edges)])
        ds = ZincDataset(
            num_nodes=num_nodes,
            node_types=[z["node_types"][n_off[i] : n_off[i + 1]] for i in range(len(num_nodes))],
            edge_src=[z["edge_src"][e_off[i] : e_off[i + 1]] for i in range(len(num_nodes))],
            edge_dst=[z["edge_dst"][e_off[i] : e_off[i + 1]] for i in range(len(num_nodes))],
            edge_types=[z["edge_types"][e_off[i] : e_off[i + 1]] for i in range(len(num_nodes))],
            y=z["y"].astype(np.float32),
            synthetic=False,
        )
    else:
        ds = _synthesize_split(split, _SPLIT_SIZES[split])
    if subset_size is not None:
        ds = ZincDataset(
            num_nodes=ds.num_nodes[:subset_size],
            node_types=ds.node_types[:subset_size],
            edge_src=ds.edge_src[:subset_size],
            edge_dst=ds.edge_dst[:subset_size],
            edge_types=ds.edge_types[:subset_size],
            y=ds.y[:subset_size],
            synthetic=ds.synthetic,
        )
    return ds

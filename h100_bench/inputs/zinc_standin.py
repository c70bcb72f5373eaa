"""The 10,000-molecule ZINC stand-in, frozen inside the benchmark.

A copy of ``mma_tpu_torch/data/zinc.py::_synthesize_split`` and
``_atom_dist`` (the same ``RandomState`` call sequence, so the same
molecules): 9-37 atoms of 21 types, a random spanning tree plus a few
ring-closing bonds, in-degree at most 4, bond types 1-3, both directions
of every bond. The repository holds no ``zinc_*.npz``, so the program's
loader serves this stand-in too. NumPy only.
"""

from __future__ import annotations

import dataclasses
from typing import List

import numpy as np

NUM_NODE_TYPES = 21
NUM_EDGE_TYPES = 4
_SPLIT_SEED = {"train": 0, "val": 1, "test": 2}


@dataclasses.dataclass
class Molecules:
    num_nodes: np.ndarray  # (G,) int64
    node_types: List[np.ndarray]  # int32 each
    edge_src: List[np.ndarray]  # int32, local ids
    edge_dst: List[np.ndarray]
    edge_types: List[np.ndarray]  # int32, 1..3
    y: np.ndarray  # (G,) float32

    def __len__(self) -> int:
        return len(self.num_nodes)

    def num_edges(self) -> np.ndarray:
        return np.array([len(s) for s in self.edge_src], np.int64)

    def degree_histogram(self, num_bins: int = 5) -> np.ndarray:
        """In-degree histogram over all molecules (5 bins: in-degree <= 4)."""
        hist = np.zeros(num_bins, np.int64)
        for nn, dst in zip(self.num_nodes, self.edge_dst):
            deg = np.bincount(dst, minlength=nn)
            hist += np.bincount(deg, minlength=num_bins)[:num_bins]
        return hist


def _atom_dist() -> np.ndarray:
    p = np.ones(NUM_NODE_TYPES)
    p[0] = 30.0  # carbon-dominated, like ZINC
    p[1] = 6.0
    p[2] = 6.0
    return p / p.sum()


def synthesize(split: str = "train", size: int = 10000, seed_base: int = 1234) -> Molecules:
    rs = np.random.RandomState(seed_base + _SPLIT_SEED[split])
    num_nodes, node_types, srcs, dsts, etypes, ys = [], [], [], [], [], []
    p_atom = _atom_dist()
    for _ in range(size):
        n = int(rs.randint(9, 38))
        types = rs.choice(NUM_NODE_TYPES, size=n, p=p_atom)
        deg = np.zeros(n, np.int64)
        edges = []
        perm = rs.permutation(n)
        for i in range(1, n):
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
        y = (0.1 * n - 0.3 * float(np.mean(types)) + 0.5 * float(np.mean(deg))
             + 0.2 * float(np.mean(et2)) + rs.normal(0, 0.1))
        num_nodes.append(n)
        node_types.append(types.astype(np.int32))
        srcs.append(src)
        dsts.append(dst)
        etypes.append(et2)
        ys.append(y)
    return Molecules(np.array(num_nodes, np.int64), node_types, srcs, dsts, etypes,
                     np.array(ys, np.float32))

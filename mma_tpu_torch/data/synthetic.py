"""The synthetic-large power-law graph.

The same generator as the JAX package's benchmark graph
(``bench.py::powerlaw_graph``), with the same ``np.random.RandomState``
call sequence, so that one seed gives the same COO in both packages. The
headline workload uses n=131072, avg_deg=16, seed=1: 2,097,138 edges.
"""

from __future__ import annotations

import numpy as np

from mma_tpu_torch.device import DeviceLike
from mma_tpu_torch.graph.build import graph_from_edges
from mma_tpu_torch.graph.container import Graph


def powerlaw_edges(n: int, avg_deg: int, seed: int = 0):
    """Symmetric power-law-ish COO ``(src, dst)`` via preferential targets."""
    rs = np.random.RandomState(seed)
    m = n * avg_deg // 2
    # Zipf-weighted endpoint sampling → heavy-tailed degree distribution.
    w = 1.0 / np.arange(1, n + 1) ** 0.5
    w /= w.sum()
    a = rs.choice(n, size=m, p=w).astype(np.int32)
    b = rs.randint(0, n, size=m).astype(np.int32)
    keep = a != b
    a, b = a[keep], b[keep]
    return np.concatenate([a, b]), np.concatenate([b, a])


def synthetic_powerlaw(n: int = 131072, avg_deg: int = 16, seed: int = 1,
                       *, device: DeviceLike = None) -> Graph:
    """The power-law graph as a padded :class:`Graph` (GPU by default)."""
    src, dst = powerlaw_edges(n, avg_deg, seed)
    return graph_from_edges(src, dst, n, device=device)

"""The power-law graph of the node configurations, frozen inside the benchmark.

A copy of ``bench.py::powerlaw_graph``'s edge draw (the JAX package's
headline graph: ``n=131072, avg_deg=16, seed=1`` gives 2,097,138 directed
edges), kept here so that the yardstick does not move when the program's
own generator (``mma_tpu_torch/data/synthetic.py``) changes. NumPy only.
"""

from __future__ import annotations

import numpy as np


def powerlaw_edges(n: int, avg_deg: int, seed: int):
    """Symmetric power-law-ish COO ``(src, dst)`` (int32): ``n * avg_deg // 2``
    endpoint pairs, the first drawn with Zipf weights ``1/sqrt(rank)``, the
    second uniformly; self-loops dropped, both directions kept."""
    rs = np.random.RandomState(seed)
    m = n * avg_deg // 2
    w = 1.0 / np.arange(1, n + 1) ** 0.5
    w /= w.sum()
    a = rs.choice(n, size=m, p=w).astype(np.int32)
    b = rs.randint(0, n, size=m).astype(np.int32)
    keep = a != b
    a, b = a[keep], b[keep]
    return np.concatenate([a, b]), np.concatenate([b, a])

#!/usr/bin/env python3
"""Time the edge-program kernel on graphs of chosen shape, on one GPU.

    python3 scripts/torch_edge_program_shapes.py

Separates the kernel's per-edge cost from its skew cost: one heavy row
alone, uniform degrees, and the power-law synthetic-large graph, at F=64,
K=2 with random inputs. Reduces over ``Graph.real_row_ptr`` as the model
does, and prints the median device time of one launch (``chip_smoke``'s
CUDA-event timer).
"""

from __future__ import annotations

import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main() -> int:
    if not torch.cuda.is_available():
        print("torch.cuda.is_available() is False", file=sys.stderr)
        return 1
    from chip_smoke import device_ms, nvidia_smi_line
    from mma_tpu_torch import graph_from_edges, synthetic_powerlaw
    from mma_tpu_torch.ops.cuda import fused_mma

    torch.backends.cuda.matmul.allow_tf32 = False
    print(nvidia_smi_line())
    rs = np.random.RandomState(0)
    gen = torch.Generator().manual_seed(0)

    def run(name, graph, f=64, k=2):
        kf = f * k
        h = torch.randn((graph.n_node, f), generator=gen).cuda()
        c = torch.randn((graph.n_node, kf), generator=gen).cuda()
        w = (torch.randn((f, kf), generator=gen) / f ** 0.5).cuda()
        pat = torch.ones(kf, device="cuda")
        row_ptr = graph.real_row_ptr
        ms = device_ms(lambda: fused_mma.edge_program_lean(c, w, h, pat, graph.src, row_ptr))
        print(f"{name}: E={int(graph.num_edges)} max in-degree {int(graph.deg.max())} "
              f"N={graph.n_node}: {ms:.4f} ms")

    def edges(src, dst, n):
        return graph_from_edges(np.asarray(src, np.int32), np.asarray(dst, np.int32), n)

    n = 2716
    run("one row of 168 edges, N=2716", edges(rs.randint(0, n, 168), np.zeros(168), n))
    run("one row of 1448 edges, N=2716", edges(rs.randint(0, n, 1448), np.zeros(1448), n))
    run("every row 4 edges, N=2716", edges(rs.randint(0, n, 4 * n), np.repeat(np.arange(n), 4), n))
    n = 131072
    run("every row 16 edges, N=131072",
        edges(rs.randint(0, n, 16 * n), np.repeat(np.arange(n), 16), n))
    run("synthetic-large power law", synthetic_powerlaw(131072, avg_deg=16, seed=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())

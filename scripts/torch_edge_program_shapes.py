#!/usr/bin/env python3
"""Time the lean edge program on graphs of chosen shape, on one GPU.

    python3 scripts/torch_edge_program_shapes.py [--backward]

Separates the kernel's per-edge cost from its skew cost: one heavy row
alone, uniform degrees, the power-law synthetic-large graph and Cora's graph
(the eval forward's shape), at F=64, K=2 with random inputs. Uses
only ``edge_program_lean``'s public signature (its last argument, the CSC
index, is ``dst_csc`` or, in older checkouts, ``src_perm``), so a copy
placed in the ``scripts/`` of another checkout of this repository times
that checkout's kernels on the same graphs. Reduces over
``Graph.real_row_ptr`` as the model does, and prints the median device
time of one call (``chip_smoke``'s CUDA-event timer): the forward (kernel
2), or with ``--backward`` the forward and the backward through autograd
to ``c``, ``W_bot`` and ``h`` (kernels 2 and 3, and whatever else the
checkout's backward launches).
"""

from __future__ import annotations

import argparse
import inspect
import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--backward", action="store_true",
                    help="time the forward and the backward through autograd")
    backward = ap.parse_args().backward
    if not torch.cuda.is_available():
        print("torch.cuda.is_available() is False", file=sys.stderr)
        return 1
    from chip_smoke import device_ms, nvidia_smi_line
    from mma_tpu_torch import graph_from_edges, load_planetoid, synthetic_powerlaw
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
        csc_index = getattr(graph, list(inspect.signature(
            fused_mma.edge_program_lean).parameters)[-1])
        args = (c, w, h, pat, graph.src, graph.real_row_ptr, graph.real_col_ptr, csc_index)
        if backward:
            ct = torch.randn((graph.n_node, kf), generator=gen).cuda()
            leaves = [t.clone().requires_grad_() for t in (c, w, h)]

            def step():
                fused_mma.edge_program_lean(*leaves, *args[3:]).backward(ct)
        else:
            def step():
                fused_mma.edge_program_lean(*args)
        ms = device_ms(step)
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
    run("Cora", load_planetoid("cora").graph)
    return 0


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python3
"""Time the lean or the wide edge program on graphs of chosen shape, on one GPU.

    python3 scripts/torch_edge_program_shapes.py [--backward | --wide]

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
checkout's backward launches). ``--wide`` times the wide program's kernels
instead, through ``edge_program_fwd`` and ``edge_program_bwd``'s public
signatures with random ``d``: kernel 9, and kernel 10 without and with its
per-edge payload, on the same graphs and on the synthetic-large graph's
heaviest row alone (a CSR of all its rows that covers that row's edges
only).
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
    mode = ap.add_mutually_exclusive_group()
    mode.add_argument("--backward", action="store_true",
                      help="time the forward and the backward through autograd")
    mode.add_argument("--wide", action="store_true",
                      help="time kernels 9 and 10 (with and without the payload) instead")
    opts = ap.parse_args()
    backward, wide = opts.backward, opts.wide
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

    def run_wide(name, graph, f=64, k=2, row_ptr=None):
        kf = f * k
        rp = graph.real_row_ptr if row_ptr is None else row_ptr
        c, d, ct = (torch.randn((graph.n_node, kf), generator=gen).cuda() for _ in range(3))
        h = torch.randn((graph.n_node, f), generator=gen).cuda()
        pat = torch.ones(kf, device="cuda")
        fwd = (c, d, h, pat, graph.src, rp)
        times = [device_ms(lambda: fused_mma.edge_program_fwd(*fwd))]
        for emit in (False, True):
            times.append(device_ms(
                lambda: fused_mma.edge_program_bwd(*fwd, ct, emit_payload=emit), iters=15))
        # A yardstick for the payload's stores: zeros written over a tensor
        # of its shape, (E, K·F+F), by one PyTorch call.
        payload = torch.empty((graph.src.shape[0], kf + f), device="cuda")
        times.append(device_ms(payload.zero_, iters=15))
        print(f"{name}: E={int(rp[-1] - rp[0])} max in-degree {int((rp[1:] - rp[:-1]).max())} "
              f"N={graph.n_node}: kernel 9 {times[0]:.4f} ms, kernel 10 without the payload "
              f"{times[1]:.4f} ms, with it {times[2]:.4f} ms; zero_ of the payload's shape "
              f"{times[3]:.4f} ms")

    def run(name, graph, f=64, k=2):
        if wide:
            return run_wide(name, graph, f, k)
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
    big = synthetic_powerlaw(131072, avg_deg=16, seed=1)
    run("synthetic-large power law", big)
    if wide:
        rp = big.real_row_ptr
        top = int(torch.argmax(rp[1:] - rp[:-1]))
        run_wide("synthetic-large, its heaviest row alone", big,
                 row_ptr=rp.clamp(int(rp[top]), int(rp[top + 1])))
    run("Cora", load_planetoid("cora").graph)
    return 0


if __name__ == "__main__":
    sys.exit(main())

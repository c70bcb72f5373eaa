#!/usr/bin/env python3
"""Time kernel 3 (``edge_program_lean_bwd``) and its parts at synthetic-large, on one GPU.

    python3 scripts/torch_lean_bwd_parts.py [--iters 25]

On the synthetic-large graph (131,072 nodes, avg_deg 16, seed 1) at the
large-train model's widths (F=64, ``mean,mean2``: K·F=128), with ``c``,
``h``, ``W_bot`` and the cotangent random from a seed, prints the median
device time of one whole call and of each part alone (``D = h @ W_bot``,
the dst pass, the src pass, the node pass with ``sum_slabs``), the
kernels' ``-Xptxas -v`` lines, and the card's name and power limit.
Reads ``Graph.real_row_ptr``/``real_col_ptr`` as the model does. The
timer is ``chip_smoke.device_ms``.
"""

from __future__ import annotations

import argparse
import os
import re
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--iters", type=int, default=25)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch.cuda.is_available() is False", file=sys.stderr)
        return 1
    from chip_smoke import device_ms, nvidia_smi_line
    from mma_tpu_torch import synthetic_powerlaw
    from mma_tpu_torch.ops import get_agg_spec
    from mma_tpu_torch.ops.cuda import build, fused_mma
    from mma_tpu_torch.ops.masked_aggregate import sigmoid_lane_pattern

    print(nvidia_smi_line())
    for log in build.build_all():
        for line in log.splitlines():
            if re.search(r"Compiling entry|registers|spill", line):
                print("  ptxas:", line.strip())
    dev = torch.device("cuda")
    g = synthetic_powerlaw(131072, avg_deg=16, seed=1, device=dev)
    f, k = 64, 2
    gen = torch.Generator().manual_seed(0)

    def draw(*shape, scale=1.0):
        return (torch.randn(shape, generator=gen) * scale).to(dev)

    h, c, ct = draw(g.n_node, f), draw(g.n_node, k * f), draw(g.n_node, k * f)
    w_bot = draw(f, k * f, scale=f ** -0.5)
    pat = sigmoid_lane_pattern([get_agg_spec(a) for a in ("mean", "mean2")], "new_sigmoid",
                               True, f, dev)
    rp, cp = g.real_row_ptr, g.real_col_ptr
    call = (c, w_bot, h, pat, g.src, rp, cp, g.dst_csc, ct)
    d = fused_mma._lean_node_pass(h, w_bot)
    ddg = fused_mma._lean_bwd_src_pass(c, ct, pat, d, h, g.dst_csc, cp)
    times = {
        "whole call": lambda: fused_mma.edge_program_lean_bwd(*call),
        "D": lambda: fused_mma._lean_node_pass(h, w_bot),
        "dst pass": lambda: fused_mma._lean_bwd_dst_pass(c, ct, pat, d, h, g.src, rp),
        "src pass": lambda: fused_mma._lean_bwd_src_pass(c, ct, pat, d, h, g.dst_csc, cp),
        "node pass": lambda: fused_mma._lean_bwd_node_pass(ddg, h, w_bot),
    }
    print(f"E={int(rp[-1])} N={g.n_node} F={f} K·F={k * f}")
    for name, fn in times.items():
        print(f"{name}: {device_ms(fn, iters=args.iters):.4f} ms")
    return 0


if __name__ == "__main__":
    sys.exit(main())

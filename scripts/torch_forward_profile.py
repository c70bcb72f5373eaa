#!/usr/bin/env python3
"""Device-time breakdown of the port's node-classifier eval forward on one GPU.

    python3 scripts/torch_forward_profile.py [--graph synthetic-large|cora] [--iters 5]

Builds the kernels, runs the forward once to warm up, then traces
``--iters`` forwards with ``torch.profiler`` and prints the device time per
kernel (sum over the traced forwards, divided by ``--iters``), the device
busy share of the traced window, and the host-clock latency per forward.
Weights and features are random from a seed, as in ``chip_smoke.py``.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys
import time

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--graph", choices=("synthetic-large", "cora"), default="synthetic-large")
    ap.add_argument("--iters", type=int, default=5)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch.cuda.is_available() is False", file=sys.stderr)
        return 1
    from mma_tpu_torch import NodeClassifier, load_planetoid, synthetic_powerlaw
    from mma_tpu_torch.ops.cuda import build

    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    print(smi.splitlines()[0])
    build.build_all()
    gen = torch.Generator().manual_seed(0)
    if args.graph == "cora":
        data = load_planetoid("cora")
        graph, x = data.graph, data.features
        model = NodeClassifier(data.num_features, 64, data.num_classes, ("mean", "mean2"),
                               generator=gen)
    else:
        graph = synthetic_powerlaw(131072, avg_deg=16, seed=1)
        x = torch.randn((graph.n_node, 64), generator=gen).cuda() * graph.node_mask[:, None]
        model = NodeClassifier(64, 64, 16, ("mean", "mean2"), generator=gen)

    with torch.no_grad():
        model(x, graph)
        torch.cuda.synchronize()
        lat = []
        for _ in range(args.iters):
            t0 = time.perf_counter()
            model(x, graph)
            torch.cuda.synchronize()
            lat.append((time.perf_counter() - t0) * 1e3)
        acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
        with torch.profiler.profile(activities=acts) as prof:
            t0 = time.perf_counter()
            for _ in range(args.iters):
                model(x, graph)
            torch.cuda.synchronize()
            window_ms = (time.perf_counter() - t0) * 1e3

    rows = []
    for ev in prof.key_averages():
        if ev.device_type != torch.autograd.DeviceType.CUDA:
            continue  # operator rows repeat their kernels' device time
        dev_us = getattr(ev, "self_device_time_total", None)
        if dev_us is None:
            dev_us = getattr(ev, "self_cuda_time_total", 0)
        if dev_us > 0:
            rows.append((dev_us / args.iters / 1e3, ev.count // args.iters, ev.key))
    rows.sort(reverse=True)
    busy = sum(r[0] for r in rows)
    print(f"graph {args.graph}: host-clock latency per forward (ms): "
          f"{' '.join(f'{v:.3f}' for v in lat)}")
    print(f"traced window {window_ms / args.iters:.3f} ms per forward (host clock), "
          f"device busy {busy:.3f} ms per forward, busy share {busy / (window_ms / args.iters):.3f}")
    print("device ms per forward | launches per forward | kernel")
    for ms, count, key in rows[:15]:
        print(f"{ms:10.4f} | {count:3d} | {key[:110]}")
    if not rows:
        print("profiler recorded no device time")
    return 0


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python3
"""Device-time breakdown of the port's models on one GPU: an eval forward
or a train step.

    python3 scripts/torch_forward_profile.py
        [--graph synthetic-large|cora|zinc|zinc-default|zinc-pna]
        [--mode forward|train|wide|masked] [--bwd-mode payload_permute|csc_gather]
        [--iters 5] [--batch 1024] [--layout plain|exact] [--served]

Builds the kernels, runs the work once to warm up, then traces ``--iters``
runs with ``torch.profiler`` and prints the device time per kernel (sum
over the traced runs, divided by ``--iters``), the device busy share of
the traced window, and the host-clock time per run. ``--mode train`` runs
``node_train_step`` (forward, backward, Adam) as ``chip_smoke.py`` does:
Cora at the README preset (mask dropout 0.75, the half-fused route) and
synthetic-large with dropout 0 (the fused route, kernel 3). ``zinc`` is
ZincNet at the README preset (``min,max``: the fused min/max edge
program, kernels 6-7) and ``zinc-default`` at the command line's default
``mean,max,min`` (the general route, kernels 1, 4, 5), ``zinc-pna`` at
the PNA set ``mean,min,max,std`` (kernels 1, 4, 5 and 8), on the first
``--batch`` synthetic train molecules padded to the next 1,024 nodes and
edges (``chip_smoke.py``'s flagship batch at 1,024); ``--layout exact``
collates them degree-exact instead, budgeted and padded as
``chip_smoke.py``'s zinc-exact paths (the ELL route: plain PyTorch slot
reductions, kernel 1 for the pool); ``--mode train`` runs
``zinc_train_step`` with message dropout on. ``--mode wide`` runs
``chip_smoke.py``'s large-wide work on synthetic-large: the forward and
backward of ``masked_multi_aggregate`` (F=64, ``mean,mean2``) with
``pallas_bwd_mode=--bwd-mode`` (kernels 9, 10 and 1 or 11). ``--mode
masked`` runs ``chip_smoke.py``'s large-masked work: the forward and
backward of ``fused_masked_aggregate`` on the pre-gathered logits ``c[dst]
+ d[src]`` and rows ``h[src]`` (kernel 12, and kernel 1 for the gathers'
VJPs). ``--served`` runs the eval forward through an artifact of
``mma_tpu_torch.serve`` (exported on the card, loaded from its bytes), as
``chip_smoke.py``'s -serve-export paths serve it. Weights, features and
labels are random from a seed, as in ``chip_smoke.py``.
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
    ap.add_argument("--graph", choices=("synthetic-large", "cora", "zinc", "zinc-default",
                                        "zinc-pna"), default="synthetic-large")
    ap.add_argument("--mode", choices=("forward", "train", "wide", "masked"), default="forward")
    ap.add_argument("--bwd-mode", choices=("payload_permute", "csc_gather"),
                    default="payload_permute")
    ap.add_argument("--iters", type=int, default=5)
    ap.add_argument("--batch", type=int, default=1024, help="ZINC molecules per batch")
    ap.add_argument("--layout", choices=("plain", "exact"), default="plain",
                    help="ZINC collate: plain or degree-exact")
    ap.add_argument("--served", action="store_true",
                    help="the eval forward through an exported artifact (mma_tpu_torch.serve)")
    args = ap.parse_args()
    if args.mode in ("wide", "masked") and args.graph != "synthetic-large":
        ap.error(f"--mode {args.mode} runs on --graph synthetic-large")
    if args.served and args.mode != "forward":
        ap.error("--served profiles the eval forward (--mode forward)")
    if not torch.cuda.is_available():
        print("torch.cuda.is_available() is False", file=sys.stderr)
        return 1
    from mma_tpu_torch import NodeClassifier, load_planetoid, synthetic_powerlaw
    from mma_tpu_torch.ops.cuda import build
    from mma_tpu_torch.train import make_optimizer
    from mma_tpu_torch.train.loops import node_train_step, zinc_train_step

    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    print(smi.splitlines()[0])
    build.build_all()
    gen = torch.Generator().manual_seed(0)
    if args.graph.startswith("zinc"):
        from mma_tpu_torch.data import load_zinc
        from mma_tpu_torch.models import ZincNet
        from mma_tpu_torch.nn.mma_conv import compute_avg_deg

        ds = load_zinc("train", subset_size=args.batch)
        n_need = int(ds.num_nodes.sum()) + 1
        e_need = int(sum(len(s) for s in ds.edge_src))
        n_node, n_edge, budgets = -(-n_need // 1024) * 1024, -(-e_need // 1024) * 1024, None
        if args.layout == "exact":
            from mma_tpu_torch.data.batching import degree_budgets

            budgets, zero_worst = degree_budgets([int(n) for n in ds.num_nodes], ds.edge_src,
                                                 ds.edge_dst, args.batch, margin=0.0,
                                                 include_zero=True)
            rows = sum(budgets) + zero_worst + 1
            slots = sum(b * (i + 1) for i, b in enumerate(budgets))
            n_node = max(n_node, -(-rows // 1024) * 1024)
            n_edge = max(n_edge, -(-slots // 1024) * 1024)
        batch = next(ds.batches(args.batch, n_node=n_node, n_edge=n_edge,
                                ell_degree_budgets=budgets))
        aggs, scalers = {
            "zinc": (("min", "max"), ("identity", "amplification", "linear")),
            "zinc-default": (("mean", "max", "min"), ("identity", "amplification", "attenuation")),
            "zinc-pna": (("mean", "min", "max", "std"),
                         ("identity", "amplification", "attenuation")),
        }[args.graph]
        model = ZincNet(aggs, scalers, compute_avg_deg(ds.degree_histogram()), generator=gen)
    elif args.graph == "cora":
        data = load_planetoid("cora")
        graph, x = data.graph, data.features
        labels, idx = data.labels.long(), data.idx_train.long()
        model = NodeClassifier(data.num_features, 64, data.num_classes, ("mean", "mean2"),
                               dropout_rate=0.75, generator=gen)
    else:
        graph = synthetic_powerlaw(131072, avg_deg=16, seed=1)
        x = torch.randn((graph.n_node, 64), generator=gen).cuda() * graph.node_mask[:, None]
        labels = torch.randint(0, 16, (graph.n_node,), generator=gen).cuda()
        idx = torch.randperm(131072, generator=gen)[:65536].cuda()
        model = NodeClassifier(64, 64, 16, ("mean", "mean2"),
                               dropout_rate=0.0 if args.mode == "train" else 0.5,
                               generator=gen)

    if args.mode in ("wide", "masked"):
        from mma_tpu_torch.ops import fused_masked_aggregate, get_agg_spec
        from mma_tpu_torch.ops.gather import gather_by_dst, gather_by_src
        from mma_tpu_torch.ops.masked_aggregate import (masked_multi_aggregate,
                                                        mma_mask_projections,
                                                        sigmoid_lane_pattern)

        specs = [get_agg_spec(a) for a in ("mean", "mean2")]
        pat = sigmoid_lane_pattern(specs, "new_sigmoid", True, 64, "cuda")
        mw0 = (torch.randn((2, 128, 64), generator=gen) / 8.0).cuda()
        ct = torch.randn((graph.n_node, 2, 64), generator=gen).cuda()

        def run():
            h = x.clone().requires_grad_()
            mw = mw0.clone().requires_grad_()
            if args.mode == "wide":
                out = masked_multi_aggregate(h, graph, mw, specs, pallas_bwd_mode=args.bwd_mode)
            else:
                c, d = mma_mask_projections(h, mw)
                logits = gather_by_dst(c, graph) + gather_by_src(d, graph)
                out = fused_masked_aggregate(logits, gather_by_src(h, graph), pat, graph, 2)
            (out.reshape(ct.shape) * ct).sum().backward()
    elif args.mode == "train":
        opt = make_optimizer(model.parameters(), 1e-3, 3e-4)
        step_gen = torch.Generator(device="cuda").manual_seed(0)

        def run():
            if args.graph.startswith("zinc"):
                zinc_train_step(model, opt, batch, step_gen)
            else:
                node_train_step(model, opt, x, graph, labels, idx, step_gen)
    else:
        zinc = args.graph.startswith("zinc")
        params = model.state_dict()
        inputs, forward = ((params, batch), lambda p, b: model(b)) if zinc else (
            (params, x, graph), lambda p, x_, g: model(x_, g))
        if args.served:
            from mma_tpu_torch.serve import (export_node_classifier, export_zinc_predictor,
                                             load_forward)

            if zinc:
                buffers = {k for k, _ in model.named_buffers()}
                state = {k: v for k, v in params.items() if k in buffers}
                params = {k: v for k, v in params.items() if k not in buffers}
                forward = load_forward(export_zinc_predictor(model, params, state, batch))
                inputs = (params, state, batch)
            else:
                forward = load_forward(export_node_classifier(model, params, x, graph))

        def run():
            with torch.no_grad():
                forward(*inputs)

    run()
    torch.cuda.synchronize()
    lat = []
    for _ in range(args.iters):
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        lat.append((time.perf_counter() - t0) * 1e3)
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for _ in range(args.iters):
            run()
        torch.cuda.synchronize()
        window_ms = (time.perf_counter() - t0) * 1e3

    rows = []
    for ev in prof.key_averages():
        if ev.device_type != torch.autograd.DeviceType.CUDA or getattr(
                ev, "is_user_annotation", False):
            continue  # operator and annotation rows repeat their kernels' device time
        dev_us = getattr(ev, "self_device_time_total", None)
        if dev_us is None:
            dev_us = getattr(ev, "self_cuda_time_total", 0)
        if dev_us > 0:
            rows.append((dev_us / args.iters / 1e3, ev.count // args.iters, ev.key))
    rows.sort(reverse=True)
    busy = sum(r[0] for r in rows)
    mode = f"wide {args.bwd_mode}" if args.mode == "wide" else args.mode
    mode += " (served)" if args.served else ""
    layout = f" ({args.layout} layout)" if args.graph.startswith("zinc") else ""
    print(f"graph {args.graph}{layout}, {mode}: host-clock time per run (ms): "
          f"{' '.join(f'{v:.3f}' for v in lat)}")
    print(f"traced window {window_ms / args.iters:.3f} ms per run (host clock), "
          f"device busy {busy:.3f} ms per run, busy share {busy / (window_ms / args.iters):.3f}, "
          f"{sum(r[1] for r in rows)} device launches and copies per run")
    print("device ms per run | launches per run | kernel")
    for ms, count, key in rows[:20]:
        print(f"{ms:10.4f} | {count:3d} | {key[:110]}")
    if not rows:
        print("profiler recorded no device time")
    return 0


if __name__ == "__main__":
    sys.exit(main())

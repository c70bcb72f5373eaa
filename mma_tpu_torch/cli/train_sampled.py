"""Large-graph node classification by neighbour sampling, on one GPU.

The port of the JAX package's ``mma_tpu.cli.train_sampled``, with its
flags, synthetic power-law graph, per-hop budget calibration and loop: the
native multithreaded sampler feeds subgraphs from a producer thread,
features and labels live in device-resident tables gathered by node id,
and one step trains per batch. ``--device cpu`` runs the plain PyTorch
versions on the CPU; the default is the card, and a host without one
raises.

    python -m mma_tpu_torch.cli.train_sampled --nodes 200000 --avg-deg 25 \\
        --batch-size 512 --fanouts 10,10,5 --steps 50

The JAX package's multi-device mode (``mma_tpu/cli/train_sampled.py:113-129``:
one sampled subgraph per device, the seed-weighted NLL over all of them)
runs one process per rank over ``torch.distributed``
(``mma_tpu_torch.train.sampled.make_sampled_dp_step``):

    torchrun --nproc-per-node N -m mma_tpu_torch.cli.train_sampled ...

or, without ``torchrun``, ``--data-parallel`` as a world of one. Every rank
builds the same graph, pads and model from ``--seed`` and draws the same
``(N, batch)`` seed batches; rank ``r`` samples row ``r`` (rank 0 with the
sampler's stream of one device, rank ``r > 0`` with a stream seeded by
``(seed, r)`` after the calibration) and its dropout from ``seed + 1 +
r``. Rank 0 prints and returns; a world of one computes exactly the
one-device run.

With ``--features/--labels/--edges`` (npy/npz arrays) it trains on host
data instead of the synthetic stand-in.

``--compute-dtype`` defaults to ``auto``, as the JAX package's does, and
``auto`` resolves to float32 off a TPU (``mma_tpu_torch.autotune``);
``--compute-dtype bfloat16`` runs the edge pipeline on bf16 operands
(kernels 1-3 read them, sums stay float32) on every route.

Every step ends in a device sync so that it can be timed: ``main`` returns
the per-step host-clock times, CUDA-event times (on the card), pipeline
times (step end to step end, the wait for the producer included) and
sampled edge counts, and prints their medians after the warm-up steps. It
also returns the trained model, the sampler, the device tables and the
calibrated pads, so that a caller can sample more batches of the same run.
"""

from __future__ import annotations

import argparse
import os
import statistics
import time

import numpy as np
import torch
import torch.distributed as dist

from mma_tpu_torch.data.sampling import NeighborSampler
from mma_tpu_torch.autotune import resolve_compute_dtype
from mma_tpu_torch.device import resolve_device
from mma_tpu_torch.models import NodeClassifier
from mma_tpu_torch.parallel.mesh import initialize_distributed, make_mesh
from mma_tpu_torch.train.logger import JsonlLogger
from mma_tpu_torch.train.optim import make_optimizer
from mma_tpu_torch.train.sampled import (
    DeviceTableAssembler,
    make_sampled_dp_step,
    sampled_batch_producer,
    sampled_train_step,
)

# Steps left out of the medians: the first calls pay library loads and the
# allocator's first growth.
WARMUP_STEPS = 2


def build_parser():
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--nodes", type=int, default=200_000)
    p.add_argument("--avg-deg", type=int, default=25)
    p.add_argument("--edges", type=str, default=None,
                   help="npz with src/dst int32 arrays (else synthetic)")
    p.add_argument("--features", type=str, default=None,
                   help="npy (N, F) float32 feature table")
    p.add_argument("--labels", type=str, default=None, help="npy (N,) int labels")
    p.add_argument("--n-feat", type=int, default=100)
    p.add_argument("--n-class", type=int, default=47)
    p.add_argument("--hidden", type=int, default=64)
    p.add_argument("--aggregators", type=str, default="mean,mean2")
    p.add_argument("--batch-size", type=int, default=512)
    p.add_argument("--fanouts", type=str, default="10,10,5")
    p.add_argument("--steps", type=int, default=50)
    p.add_argument("--lr", type=float, default=3e-3)
    p.add_argument("--dropout", type=float, default=0.5)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--compute-dtype", type=str, default="auto",
                   help="edge-pipeline dtype: float32, bfloat16 or auto (float32 off a TPU)")
    p.add_argument("--use-ell", action="store_true",
                   help="per-hop ELL bucket layout (the scatter-free ELL route)")
    p.add_argument("--host-built", action="store_true",
                   help="ship whole host-built graphs instead of the default "
                        "minimal-transfer pipeline (src/dst/ids + CSC perm, "
                        "structure derived on the device)")
    p.add_argument("--device", type=str, default="cuda",
                   help="cuda (default; raises without a GPU) or cpu")
    p.add_argument("--data-parallel", action="store_true",
                   help="data-parallel mode (implied under torchrun): one sampled "
                        "subgraph per rank")
    p.add_argument("--log", type=str, default=None)
    return p


def calibrate_pads(sampler: NeighborSampler, rs: np.random.RandomState, n: int,
                   batch_size: int):
    """Per-hop node budgets, node pad and edge pad from three real samples
    with 1.5× headroom, as the JAX package's CLI calibrates them."""
    n_hops = len(sampler.fanouts)
    hop_max = np.zeros(n_hops + 1, np.int64)
    max_edges = 0
    for _ in range(3):
        hc, _, s_c, _ = sampler._structure(
            rs.randint(0, n, batch_size),
            sampler._structural_node_bound(batch_size),
            sampler._structural_edge_bound(batch_size),
        )
        hop_max = np.maximum(hop_max, hc)
        max_edges = max(max_edges, len(s_c))
    hop_pads = tuple(int(-(-int(c * 1.5) // 256) * 256) if i else batch_size
                     for i, c in enumerate(hop_max))
    n_node_pad = -(-(sum(hop_pads) + 1) // 4096) * 4096
    n_edge_pad = -(-int(max_edges * 1.5) // 4096) * 4096
    return hop_pads, n_node_pad, n_edge_pad


def _median_after_warmup(values):
    kept = values[WARMUP_STEPS:] or values
    return statistics.median(kept) if kept else None


def main(argv=None):
    args = build_parser().parse_args(argv)
    resolve_compute_dtype(args.compute_dtype)  # an unknown name raises before the set-up
    data_parallel = args.data_parallel or "WORLD_SIZE" in os.environ
    if not data_parallel:
        return _run(args, resolve_device(args.device), 0, 1, None)
    joined = not dist.is_initialized()  # a caller's process group is used as it is
    if joined:
        dev = initialize_distributed(args.device)
    else:
        dev = resolve_device(args.device)
        if dev.type == "cuda" and dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    try:
        return _run(args, dev, dist.get_rank(), dist.get_world_size(), make_mesh(("data",)))
    finally:
        if joined:
            dist.destroy_process_group()


def _run(args, dev, rank: int, n_dev: int, mesh):
    def say(text):
        if rank == 0:
            print(text, flush=True)

    rs = np.random.RandomState(args.seed)
    fanouts = tuple(int(f) for f in args.fanouts.split(","))
    if args.edges:
        z = np.load(args.edges)
        src, dst = z["src"], z["dst"]
        n = int(max(src.max(), dst.max())) + 1
    else:
        n = args.nodes
        m = n * args.avg_deg // 2
        a = (rs.rand(m) ** 2 * n).astype(np.int64)
        b = rs.randint(0, n, size=m)
        keep = a != b
        src = np.concatenate([a[keep], b[keep]]).astype(np.int32)
        dst = np.concatenate([b[keep], a[keep]]).astype(np.int32)
    sampler = NeighborSampler.from_host_arrays(src, dst, n, fanouts, seed=args.seed,
                                               device=dev)

    features = (np.load(args.features) if args.features
                else rs.randn(min(n, 65536), args.n_feat).astype(np.float32))
    labels = (np.load(args.labels) if args.labels
              else rs.randint(0, args.n_class, features.shape[0]))
    n_class = int(labels.max()) + 1

    hop_pads, n_node_pad, n_edge_pad = calibrate_pads(sampler, rs, n, args.batch_size)
    pads = {"hop_node_pads": list(hop_pads), "n_node_pad": n_node_pad, "n_edge_pad": n_edge_pad}
    say(f"calibrated pads: hops {list(hop_pads)}, nodes {n_node_pad}, edges {n_edge_pad}")
    if rank:
        sampler.rs = np.random.RandomState((args.seed, rank))

    model = NodeClassifier(
        features.shape[1], args.hidden, n_class, tuple(args.aggregators.split(",")),
        dropout_rate=args.dropout, compute_dtype=args.compute_dtype, device=dev,
        generator=torch.Generator().manual_seed(args.seed),
    )
    opt = make_optimizer(model.parameters(), args.lr)
    assembler = DeviceTableAssembler(features, labels, device=dev)
    gen = torch.Generator(device=dev).manual_seed(args.seed + 1 + rank)
    log = JsonlLogger(args.log if rank == 0 else None, echo=rank == 0)
    if mesh is None:
        def train_step(x, g, y, sm):
            return sampled_train_step(model, opt, x, g, y, sm, gen)[0]
    else:
        dp_step = make_sampled_dp_step(model, opt, mesh, "data")

        def train_step(x, g, y, sm):
            return dp_step(x, g, y, sm, gen)
    on_card = dev.type == "cuda"

    def sync():
        if on_card:
            torch.cuda.synchronize(dev)

    seed_batches = (rs.randint(0, n, size=(n_dev, args.batch_size)) for _ in range(args.steps))
    losses, records = [], []
    t0 = t_prev = time.perf_counter()
    for i, (x, g, y, sm) in enumerate(sampled_batch_producer(
        sampler, seed_batches, assembler, n_node_pad=n_node_pad, n_edge_pad=n_edge_pad,
        hop_node_pads=hop_pads if args.use_ell else None,
        device_finish=not args.host_built,
        deg_table=torch.from_numpy(sampler.true_deg).to(dev), rank=rank,
    )):
        t_step = time.perf_counter()
        if on_card:
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
        loss = train_step(x, g, y, sm)
        if on_card:
            end.record()
        sync()
        t_end = time.perf_counter()
        losses.append(float(loss))
        records.append({
            "step_ms": (t_end - t_step) * 1e3,
            "device_ms": start.elapsed_time(end) if on_card else None,
            "pipeline_ms": (t_end - t_prev) * 1e3,
            "edges": int(g.num_edges),
        })
        t_prev = t_end
        if i % 10 == 0 or i == args.steps - 1:
            log.log(step=i, loss=losses[-1], t=round(t_end - t0, 2))
            say(f"step {i}: loss {losses[-1]:.4f} ({t_end - t0:.1f}s)")
    log.close()

    summary = {key: _median_after_warmup([r[key] for r in records])
               for key in ("step_ms", "pipeline_ms", "edges")}
    summary["device_ms"] = (_median_after_warmup([r["device_ms"] for r in records])
                            if on_card else None)
    if records:
        e = summary["edges"]
        summary["edges_per_s_step"] = e / (summary["step_ms"] * 1e-3)
        summary["edges_per_s_pipeline"] = e / (summary["pipeline_ms"] * 1e-3)
        summary["pipeline_over_step"] = summary["pipeline_ms"] / summary["step_ms"]
        say("sampled steps (medians after warm-up, host clock): "
            + ", ".join(f"{k} {v:.6g}" for k, v in summary.items() if v is not None))
    return {"model": model, "losses": losses, "records": records, "pads": pads,
            "summary": summary, "sampler": sampler, "assembler": assembler}


if __name__ == "__main__":
    main()

"""Entry points: the flagship forward and a one-step dry run of every
multi-device regime.

The port's counterparts of ``__graft_entry__.py``: :func:`entry` (``:26-38``)
and :func:`dryrun_multichip` (``:41-261``). ``python -m
mma_tpu_torch.graft_entry`` runs the entry forward on the card and then
the dry run over every card of this host (``:264-269``).
"""

from __future__ import annotations

import os
from typing import Callable, Tuple

import numpy as np
import torch
import torch.distributed as dist

from mma_tpu_torch.device import DeviceLike, resolve_device


def _zinc_model_and_batch(dev: torch.device, batch_size: int = 8, towers: int = 5,
                          num_layers: int = 4, seed: int = 0):
    """The flagship ZincNet (README.md:79: ``min,max``, scalers
    ``identity,amplification,linear``), weights random from ``seed``, and
    one val batch of ``batch_size`` molecules padded to 40 nodes and 100
    edges a molecule."""
    from mma_tpu_torch.data import load_zinc
    from mma_tpu_torch.models import ZincNet
    from mma_tpu_torch.nn.mma_conv import compute_avg_deg

    ds = load_zinc("val", subset_size=batch_size * 2)
    avg = compute_avg_deg(ds.degree_histogram(), parity=True)
    model = ZincNet(("min", "max"), ("identity", "amplification", "linear"), avg,
                    towers=towers, num_layers=num_layers, device=dev,
                    generator=torch.Generator().manual_seed(seed))
    batch = next(ds.batches(batch_size, n_node=batch_size * 40, n_edge=batch_size * 100,
                            device=dev))
    return model, batch


def entry(device: DeviceLike = None) -> Tuple[Callable, tuple]:
    """``(fn, example_args)``: ``fn(*example_args)`` is the eval forward of
    the flagship ZincNet (4 convs, towers 5) on an 8-molecule val batch,
    per-graph predictions ``(8,)``. ``example_args`` is ``(params,
    buffers, batch)``: the model's parameters and BatchNorm buffers by
    name, as ``torch.func.functional_call`` takes them, and the batch. On
    the card unless ``device="cpu"``."""
    model, batch = _zinc_model_and_batch(resolve_device(device))

    def forward(params, buffers, batch_):
        return torch.func.functional_call(model, {**params, **buffers}, (batch_,),
                                          {"training": False})

    return forward, (dict(model.named_parameters()), dict(model.named_buffers()), batch)


def _finite(loss: torch.Tensor, regime: str) -> None:
    value = float(loss)
    if not np.isfinite(value):
        raise AssertionError(f"dryrun_multichip {regime}: loss {value}")
    print(f"dryrun_multichip {regime}: rank {dist.get_rank()} of {dist.get_world_size()}, "
          f"loss {value}")


def _dryrun_in_world(dev: torch.device) -> None:
    """One real training step of each regime (a)-(g) on the current world,
    every rank on ``dev``; each loss must be finite."""
    from mma_tpu_torch.data import load_zinc
    from mma_tpu_torch.data.sampling import NeighborSampler
    from mma_tpu_torch.graph.build import graph_from_edges
    from mma_tpu_torch.models import NodeClassifier
    from mma_tpu_torch.parallel import (
        build_node_sharded,
        build_node_sharded_ordered,
        make_dp_edge_train_step,
        make_dp_train_step,
        make_edge_sharded_train_step,
        make_mesh,
        make_node_sharded_train_step,
        place_on_mesh,
        shard_batches_dp_edge,
        shard_graph,
        shard_node_values,
        shard_stacked_batch,
        stack_batches,
    )
    from mma_tpu_torch.train import make_optimizer
    from mma_tpu_torch.train.sampled import (
        make_sampled_dp_step,
        stack_sampled_batches,
    )

    n_devices = dist.get_world_size()
    rank = dist.get_rank()
    mesh_type = "cuda" if dev.type == "cuda" else "cpu"

    def gen(seed: int) -> torch.Generator:
        return torch.Generator(device=dev).manual_seed(seed)

    # --- (a) data-parallel ZINC training step
    mesh = make_mesh(("data",), device_type=mesh_type)
    model, _ = _zinc_model_and_batch(dev, batch_size=2, towers=5, num_layers=2)
    ds = load_zinc("val", subset_size=2 * n_devices)
    micro = list(ds.batches(2, n_node=2 * 40, n_edge=2 * 100, device="cpu"))[:n_devices]
    opt = make_optimizer(model.parameters(), 1e-3, 3e-4)
    step = make_dp_train_step(model, opt, mesh, "data")
    _finite(step(shard_stacked_batch(stack_batches(micro), mesh, "data", device=dev),
                 gen(1 + rank)), "(a) data-parallel ZINC")

    # --- (b) edge-partitioned node classification step
    mesh_e = make_mesh(("edge",), device_type=mesh_type)
    rs = np.random.RandomState(0)
    n = 64
    a = (rs.rand(n, n) < 0.1).astype(np.float32)
    a = np.triu(a, 1)
    a = a + a.T
    dst, src = np.nonzero(a)
    graph = graph_from_edges(src.astype(np.int32), dst.astype(np.int32), n, device=dev)
    x = torch.from_numpy(rs.randn(graph.n_node, 10).astype(np.float32)).to(dev)
    labels = torch.from_numpy(rs.randint(0, 3, graph.n_node)).to(dev)
    idx = torch.arange(32, device=dev)

    def nc_model(seed: int) -> NodeClassifier:
        return NodeClassifier(10, 16, 3, ("mean", "min2", "max"), device=dev,
                              generator=torch.Generator().manual_seed(seed))

    nc = nc_model(2)
    estep = make_edge_sharded_train_step(nc, make_optimizer(nc.parameters(), 0.01, 5e-4),
                                         mesh_e, labels, idx, "edge")
    _finite(estep(x, shard_graph(graph, mesh_e, "edge"), gen(3)), "(b) edge-sharded")

    # --- (c) node-sharded (overlapped halo exchange) training step, and
    # (g) the same on the LDG order (the native locality partition).
    mesh_n = make_mesh(("node",), device_type=mesh_type)
    x_np, labels_np, tmask_np = x.cpu().numpy()[:n], labels.cpu().numpy()[:n], np.arange(n) < 32
    for regime, seed, built in (
            ("(c) node-sharded", 6, lambda: build_node_sharded(graph, n_devices) + (None,)),
            ("(g) LDG-ordered node-sharded", 12,
             lambda: build_node_sharded_ordered(graph, n_devices, "ldg"))):
        sg, cuts, order = built()
        n_m = sg.node_mask.shape[1]

        def local(values):
            return place_on_mesh(shard_node_values(values, cuts, n_m, order=order), mesh_n,
                                 "node", device=dev)

        ns = nc_model(seed)
        ns_step = make_node_sharded_train_step(
            ns, make_optimizer(ns.parameters(), 0.01, 5e-4), mesh_n, "node", dropout=True)
        _finite(ns_step(local(x_np), place_on_mesh(sg, mesh_n, "node", device=dev),
                        local(labels_np[:, None])[:, 0], local(tmask_np[:, None])[:, 0],
                        seed=seed + 1), regime)

    # --- (e) edge-sharded step on the per-shard kernel structure (each
    # shard's own CSR and CSC)
    nck = nc_model(8)
    estep_k = make_edge_sharded_train_step(nck, make_optimizer(nck.parameters(), 0.01, 5e-4),
                                           mesh_e, labels, idx, "edge")
    _finite(estep_k(x, shard_graph(graph, mesh_e, "edge", kernel_structure=True), gen(9)),
            "(e) edge-sharded, kernel structure")

    # --- (f) sampled-minibatch data-parallel step (the per-hop ELL layout)
    rs2 = np.random.RandomState(5)
    ns_nodes, ms = 256, 1024
    a2 = rs2.randint(0, ns_nodes, ms).astype(np.int32)
    b2 = rs2.randint(0, ns_nodes, ms).astype(np.int32)
    keep = a2 != b2
    sampler = NeighborSampler.from_host_arrays(
        np.concatenate([a2[keep], b2[keep]]), np.concatenate([b2[keep], a2[keep]]),
        ns_nodes, (3, 3), seed=6, device="cpu")
    seeds = [rs2.randint(0, ns_nodes, 8) for _ in range(n_devices)]
    sbs = [sampler.sample(s_, n_node_pad=256, n_edge_pad=256, hop_node_pads=(8, 32, 96))
           for s_ in seeds]
    feats = rs2.randn(ns_nodes, 12).astype(np.float32)
    labs = rs2.randint(0, 4, ns_nodes)
    xs, gs, ys, sms = stack_sampled_batches(sbs, feats, labs)[rank]
    s_model = NodeClassifier(12, 8, 4, ("mean", "mean2"), device=dev,
                             generator=torch.Generator().manual_seed(10))
    sstep = make_sampled_dp_step(s_model, make_optimizer(s_model.parameters(), 1e-3),
                                 make_mesh(("data",), device_type=mesh_type), "data")
    _finite(sstep(xs.to(dev), gs.to(dev), ys.to(dev), sms.to(dev), gen(11 + rank)),
            "(f) sampled data-parallel")

    # --- (d) 2-D data × edge ZINC training step
    if n_devices % 2 == 0:
        mesh_2d = make_mesh(("data", "edge"), shape=(2, n_devices // 2), device_type=mesh_type)
        micro2 = list(ds.batches(2, n_node=2 * 40, n_edge=2 * 100, device="cpu"))[:2]
        piece = shard_batches_dp_edge(micro2, mesh_2d, device=dev)
        model2, _ = _zinc_model_and_batch(dev, batch_size=2, towers=5, num_layers=2, seed=4)
        step2 = make_dp_edge_train_step(model2, make_optimizer(model2.parameters(), 1e-3, 3e-4),
                                        mesh_2d)
        _finite(step2(piece, seed=5 + mesh_2d.get_local_rank("data")), "(d) 2-D data × edge")


def _dryrun_rank(n_devices: str, device: str) -> None:
    """One rank of the world :func:`dryrun_multichip` starts."""
    from mma_tpu_torch.parallel import initialize_distributed

    dev = initialize_distributed(device)
    if dist.get_world_size() != int(n_devices):
        raise RuntimeError(f"a world of {dist.get_world_size()}, not {n_devices}")
    _dryrun_in_world(dev)


def dryrun_multichip(n_devices: int, device: DeviceLike = None) -> None:
    """One real training step of each parallel regime on ``n_devices``
    ranks: (a) data-parallel ZINC, (b) edge-sharded node classification,
    (c) node-sharded with the halo exchange, (d) the 2-D data × edge ZINC
    step (when ``n_devices`` is even), (e) the edge-sharded step on the
    per-shard kernel structure, (f) the sampled data-parallel step on the
    per-hop ELL layout, (g) the node-sharded step on the LDG order. Raises
    unless every loss is finite; no regime is skipped.

    Inside an initialized process group of ``n_devices`` ranks it runs on
    that world, every rank on ``device`` (None: the card, this process's
    current one). Outside one it starts such a world on this host
    (:func:`~mma_tpu_torch.parallel.launch_local`): NCCL, one card a rank,
    on the card; gloo on the CPU."""
    dev = resolve_device(device)
    if dist.is_initialized():
        if dist.get_world_size() != n_devices:
            raise ValueError(f"n_devices={n_devices} in a world of {dist.get_world_size()}")
        if dev.type == "cuda" and dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        _dryrun_in_world(dev)
        return
    from mma_tpu_torch.parallel import launch_local

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    launch_local("mma_tpu_torch.graft_entry:_dryrun_rank", n_devices,
                 [n_devices, "cpu" if dev.type == "cpu" else "cuda"],
                 env={"PYTHONPATH": os.pathsep.join([root, os.environ.get("PYTHONPATH", "")])})


def main() -> None:
    fn, args = entry()
    with torch.no_grad():
        out = fn(*args)
    print("entry forward:", out.cpu().numpy()[:4])
    dryrun_multichip(torch.cuda.device_count())
    print("dryrun_multichip OK")


if __name__ == "__main__":
    main()

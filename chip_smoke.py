#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU: ``python3 chip_smoke.py``.

1. Prints the card's name and power limit (``nvidia-smi``), then builds
   every CUDA kernel of the port from ``mma_tpu_torch/csrc`` (one ``nvcc``
   per source, all started together).
2. Nine main paths, each with the kernels' launch counters set to 0 just
   before it and read just after:

   - **serve**: the node classifier's eval forward answers 3 requests on
     Cora at the README preset (1433 features, hidden 64, 7 classes,
     ``mean,mean2``, parity mode), then runs 3 forwards of the
     synthetic-large model (131072-node / 2.1M-edge power-law graph, F=64,
     16 classes). Weights are random from a seed.
   - **cora-train**: ``train_node_classification`` at the README preset
     (``NODE_CLS_PRESETS["cora"]``: 200 epochs, mask dropout 0.75, so the
     half-fused route), seeds 0, 1, 2 and 42. The mean test accuracy must
     reach 0.834 (the JAX package's CPU band 0.849 ± 0.005, less 3 sd).
   - **large-train**: 3 Adam steps of ``NodeClassifier(64, 64, 16,
     mean,mean2, dropout 0)`` on the synthetic-large graph through
     ``node_train_step``, the loop's own step (the fused route: kernel 2
     forward, kernel 3 backward). Labels and the train split come from
     the seed.
   - **large-wide**: ``masked_multi_aggregate`` at synthetic-large (F=64,
     ``mean,mean2``, parity, no dropout), forward and backward through
     ``h`` and ``mask_weights``, 3 times with each ``pallas_bwd_mode``:
     the wide edge program, ``payload_permute`` (kernels 9, 10 and 1) and
     ``csc_gather`` (kernels 9, 10 and 11).
   - **large-masked**: the same work's aggregate ``S`` (no combine) through
     ``fused_masked_aggregate`` on the pre-gathered logits ``c[dst] +
     d[src]`` and rows ``h[src]``, forward and backward to ``h`` and
     ``mask_weights``, 3 times: kernel 12, and kernel 1 for the gathers'
     VJPs.
   - **zinc-serve**: the ZincNet eval forward at the README preset
     (``min,max``; ``identity,amplification,linear``; hidden 75, edge 50,
     towers 5, 4 layers; the fused min/max edge program, kernel 6) answers
     3 requests on the flagship batch: the first 1,024 synthetic ZINC train
     molecules, padded as the JAX package's benchmark pads them.
   - **zinc-train**: ``train_zinc`` at the README preset (lr 1e-4, wd 3e-4,
     batch 64) for 5 epochs on a 2,000-molecule subset, seeds 0, 1, 2 and
     42 (kernels 1, 6 and 7). The mean val MAE after epoch 5 must lie in
     the JAX package's CPU band, widened by 3 sd (``ZINC_VAL_MAE_BAND``).
   - **zinc-train-default**: 3 ``zinc_train_step``s of the command line's
     default ``mean,max,min`` at the flagship batch (the general CSR
     route: kernels 1, 4 and 5).
   - **zinc-train-pna**: 3 ``zinc_train_step``s of the PNA set
     ``mean,min,max,std`` (``identity,amplification,attenuation``, the
     command line's other defaults) at the flagship batch: kernels 1, 4, 5
     and 8.

   Each path's launch counts are derived from the code and checked.
3. Checks every output (finite log-probs of the expected shape whose rows
   sum to 1) and holds it against the same computation with every kernel,
   forward and backward, replaced by its plain PyTorch version on the
   card (under PyTorch's deterministic algorithms, so that the reference
   is the same every run): the serving outputs, every parameter gradient
   of one more Cora train step from a trained state (mask dropout on, the
   same draws on both sides), and every parameter gradient of the first
   synthetic-large train step. The first Cora request is also held against
   the plain forward on the CPU, which the CPU tests hold against the JAX
   package. The wide route's output and gradients, in both modes, against
   the lean route, the all-plain computation and each other; the masked
   route's ``S``, ``dlogits``, ``dh_src``, ``dh`` and ``dmask_weights``
   against the all-plain computation, and its ``S``, ``dh`` and
   ``dmask_weights`` against the wide and the lean route's. For ZINC: the
   first request against the all-plain forward on the card and on the
   CPU, one train step of each aggregator set at the flagship batch with
   dropout on (loss, every parameter gradient, the BatchNorm state), and
   the PNA model's first eval forward against the CPU.
4. Per kernel, at the shapes of the main paths (kernels 1-3 and 9-12 at
   synthetic-large, kernel 1 at the widths of both products, C=64 and
   C=16, and of the wide payload, C=192, and also its heaviest row alone at
   C=64 and Cora's spmm forward at C=64 and C=7; kernel 2 also as its node
   pass and edge pass alone, its heaviest row alone (as a whole call and
   through the edge pass alone) and at Cora's shape; kernel 3 also as its
   four parts alone (``D``, the dst pass, the src pass, the node pass),
   each edge pass on its heaviest row alone and at Cora's shape; kernels 9
   and 10, both payload modes, also on the heaviest row alone as a whole
   call; kernels 4-8 on the tensors the
   ZINC train steps gave them at the flagship batch, 4-7 for one and two
   ops, with dropout on and off): the
   error against the plain version (kernels 4 and 6, and the routed
   gradients of 5 and 7, must be equal to it), run-to-run equality, the
   kernel's median time, the plain version's time, the time of one
   PyTorch library call for the same function where there is one, and the
   least time the card could take (``bound_ms``).
5. Prints one ``kernels`` JSON line, the ``nvidia-smi`` line again, and as
   the last line ``{"ok": true, "device": {...}}``.

The per-epoch training logs go to ``artifacts/chip_smoke_train.log`` and
``artifacts/chip_smoke_zinc.log``.
Any failed check raises, so the script exits non-zero and prints no
result; so does a host without a GPU, or a directory without the port.
"""

from __future__ import annotations

import contextlib
import copy
import dataclasses
import json
import math
import os
import re
import statistics
import subprocess
import sys
import time
import warnings

# The plain references run under torch.use_deterministic_algorithms, which
# takes cuBLAS's deterministic workspace setting.
os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")

import torch  # noqa: E402

SEED = 0
CORA_SEEDS = (0, 1, 2, 42)
CORA_MIN_MEAN_ACC = 0.834
ZINC_SEEDS = (0, 1, 2, 42)
# Mean val MAE after 5 epochs: the JAX package on the CPU gave 0.2079,
# 0.2205, 0.2075, 0.2377 for these seeds (python -m mma_tpu.cli.train_zinc
# --aggregators min,max --scalers identity,amplification,linear --lr 0.0001
# --weight_decay 3e-4 --subset 2000 --epochs 5 --seed S), mean 0.2184, sd
# 0.0142: the band is the mean ± 3 sd, wide because the dropout streams
# of the two packages differ.
ZINC_VAL_MAE_BAND = (0.1758, 0.2610)
ZINC_PRESET_AGGS = (("min", "max"), ("identity", "amplification", "linear"))
ZINC_DEFAULT_AGGS = (("mean", "max", "min"), ("identity", "amplification", "attenuation"))
# PyG's examples/pna.py set, which the reference's ZINC script adapted.
ZINC_PNA_AGGS = (("mean", "min", "max", "std"), ("identity", "amplification", "attenuation"))
# Published peaks of one H100 SXM (NVIDIA data sheet): HBM3 bandwidth and
# dense float32 outside the tensor cores. The kernels run f32 on CUDA cores.
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_FLOP_PER_S = 67e12
# TPU kernels each port replaces (file:line of the Pallas kernel).
REPLACES = {
    "segment_sum_csr": "mma_tpu/ops/pallas/fused_mma.py:176",
    "edge_program_lean_fwd": "mma_tpu/ops/pallas/fused_mma.py:488",
    "edge_program_lean_bwd": "mma_tpu/ops/pallas/fused_mma.py:540",
    "segment_minmax": "mma_tpu/ops/pallas/segment_minmax.py:85",
    "segment_minmax_bwd": "mma_tpu/ops/pallas/segment_minmax.py:409",
    "minmax_prog": "mma_tpu/ops/pallas/segment_minmax.py:195",
    "minmax_prog_bwd": "mma_tpu/ops/pallas/segment_minmax.py:288",
    "segment_sum_sq": "mma_tpu/ops/pallas/fused_mma.py:207",
    "edge_program_fwd": "mma_tpu/ops/pallas/fused_mma.py:293",
    "edge_program_bwd": "mma_tpu/ops/pallas/fused_mma.py:339",
    "edge_program_bwd_csc": "mma_tpu/ops/pallas/fused_mma.py:425",
    "masked_segment_sum": "mma_tpu/ops/pallas/fused_mma.py:247",
}
SOURCE = "mma_tpu_torch/csrc/fused_mma.cu"
MINMAX_SOURCE = "mma_tpu_torch/csrc/segment_minmax.cu"
LOG_DIR = "artifacts"


def nvidia_smi_line() -> str:
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return res.stdout.strip().splitlines()[0]


def check_log_probs(out: torch.Tensor, n_pad: int, n_class: int, n_real: int, what: str):
    if tuple(out.shape) != (n_pad, n_class):
        raise AssertionError(f"{what}: shape {tuple(out.shape)} != {(n_pad, n_class)}")
    real = out[:n_real]
    if not torch.isfinite(real).all():
        raise AssertionError(f"{what}: non-finite log-probs")
    row_err = (real.exp().sum(dim=1) - 1.0).abs().max().item()
    if row_err > 1e-4:
        raise AssertionError(f"{what}: probabilities sum to 1 ± {row_err}")


def compare(got: torch.Tensor, want: torch.Tensor, rel: float, what: str,
            scale: float = None, verbose: bool = True) -> dict:
    """``|got - want| <= rel * (|want| + scale)``, ``scale`` the largest
    ``|want|`` unless given: a relative bound per element with a floor
    scaled to the tensor, since f32 sums taken in another order differ by a
    few ulps of their largest partial sums."""
    got, want = got.double(), want.double()
    if scale is None:
        scale = want.abs().max().item()
    diff = (got - want).abs()
    max_abs = diff.max().item()
    # An all-zero reference (the detached pre-NNs' gradients) must be met exactly.
    max_rel = 0.0 if max_abs == 0 else (diff / (want.abs() + scale)).max().item()
    if verbose:
        print(f"{what}: max_abs_err {max_abs:.3e} max_rel_err {max_rel:.3e} "
              f"(scale {scale:.3e}, tolerance {rel:g})")
    if not max_rel <= rel:
        raise AssertionError(f"{what}: max_rel_err {max_rel:.3e} > {rel:g}")
    return {"max_abs_err": max_abs, "max_rel_err": max_rel}


def device_ms(fn, iters: int = 25) -> float:
    """Median device time of one call, from CUDA events around each of
    ``iters`` back-to-back calls. A spin kernel first holds the stream so
    that the host enqueues every call before the first runs: the events
    then time the device and not the host's launch overhead."""
    fn()
    torch.cuda.synchronize()
    events = [torch.cuda.Event(enable_timing=True) for _ in range(iters + 1)]
    torch.cuda._sleep(200_000_000)
    events[0].record()
    for i in range(iters):
        fn()
        events[i + 1].record()
    torch.cuda.synchronize()
    return statistics.median(events[i].elapsed_time(events[i + 1]) for i in range(iters))


def bound(nbytes: float, flops: float) -> dict:
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_F32_FLOP_PER_S * 1e3
    return {"bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def kernel_modules():
    from mma_tpu_torch.ops.cuda import fused_mma, segment_minmax

    return fused_mma, segment_minmax


# Each kernel launcher of the port and its plain version.
PLAIN = {
    "fused_mma": {"_segment_sum_kernel": "segment_sum_reference",
                  "_edge_program_lean_kernel": "edge_program_lean_reference",
                  "_edge_program_lean_bwd_kernel": "edge_program_lean_bwd_reference",
                  "_segment_sum_sq_kernel": "segment_sum_sq_reference",
                  "_edge_program_fwd_kernel": "edge_program_fwd_reference",
                  "_edge_program_bwd_kernel": "edge_program_bwd_reference",
                  "_edge_program_bwd_csc_kernel": "edge_program_bwd_csc_reference",
                  "_masked_segment_sum_kernel": "masked_segment_sum_reference"},
    "segment_minmax": {"_segment_minmax_kernel": "segment_minmax_reference",
                       "_segment_minmax_bwd_kernel": "segment_minmax_bwd_reference",
                       "_minmax_prog_kernel": "minmax_edge_program_reference",
                       "_minmax_prog_bwd_kernel": "minmax_edge_program_bwd_reference"},
}


def launches() -> dict:
    """Every kernel's launch count, across the port's kernel modules."""
    out = {}
    for mod in kernel_modules():
        out.update(mod.LAUNCHES)
    return out


@contextlib.contextmanager
def plain_kernels():
    """Route every kernel launch, forward and backward, to its plain version,
    under PyTorch's deterministic algorithms: the plain versions sum with
    ``index_add_``, whose atomic order otherwise changes run to run, so the
    reference would not be the same from one run to the next."""
    saved = []
    for mod in kernel_modules():
        for launcher, plain in PLAIN[mod.__name__.rsplit(".", 1)[-1]].items():
            saved.append((mod, launcher, getattr(mod, launcher)))
            setattr(mod, launcher, getattr(mod, plain))
    deterministic = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(deterministic)
        for mod, launcher, fn in saved:
            setattr(mod, launcher, fn)


@contextlib.contextmanager
def counted(path: str, paths: dict):
    """Count the kernel launches of one main path into ``paths[path]``."""
    for mod in kernel_modules():
        for key in mod.LAUNCHES:
            mod.LAUNCHES[key] = 0
    yield
    torch.cuda.synchronize()
    paths[path] = launches()


def expect_launches(paths: dict, path: str, **nonzero: int) -> None:
    """Check that the path launched exactly ``nonzero`` and no other kernel."""
    expected = {key: nonzero.pop(key, 0) for key in launches()}
    if nonzero:
        raise KeyError(f"unknown kernels {sorted(nonzero)}")
    print(f"{path}: launches {paths[path]} (expected {expected})")
    if paths[path] != expected:
        raise AssertionError(f"{path}: launch counts {paths[path]} != {expected}")


def capture_call(module, name, run):
    """Run ``run()`` with ``module.<name>`` wrapped so that its arguments and
    the cotangent of its output are kept; returns ``(args, kwargs, ct)`` of
    the last call (``ct`` None when the output takes no gradient)."""
    real = getattr(module, name)
    kept = {}

    def wrapper(*args, **kwargs):
        out = real(*args, **kwargs)
        kept["args"], kept["kwargs"] = args, kwargs
        if out.requires_grad:
            out.register_hook(lambda g: kept.__setitem__("ct", g.detach().clone()))
        return out

    setattr(module, name, wrapper)
    try:
        run()
    finally:
        setattr(module, name, real)
    return kept["args"], kept["kwargs"], kept.get("ct")


def bn_fed_scale(name: str, grads: dict):
    """For a ZincNet conv's ``lin.b`` and its post-NNs' (last) biases, the
    largest gradient of the same conv's ``lin.w``; else None. Those biases
    only shift a training BatchNorm's input by a constant per channel, which
    the BatchNorm subtracts again: their gradient is 0 in exact arithmetic
    and rounding noise on both sides, so it is held on the scale of the
    layer's weight gradient instead of its own."""
    parts = name.split(".")
    if parts[0].startswith("conv") and parts[-1] == "b" and parts[1] in ("lin", "post_nns"):
        return grads[f"{parts[0]}.lin.w"].abs().max().item()
    return None


def run_zinc(dev, paths: dict) -> dict:
    """The four ZINC main paths, their checks and the per-kernel holds of
    kernels 4-8; returns the kernels' JSON entries (without ``launches``)."""
    from mma_tpu_torch.data import load_zinc
    from mma_tpu_torch.models import ZincNet
    from mma_tpu_torch.nn import mma_conv
    from mma_tpu_torch.ops.cuda import fused_mma
    from mma_tpu_torch.ops.cuda import segment_minmax as mm
    from mma_tpu_torch.train import ZincConfig, make_optimizer, train_zinc
    from mma_tpu_torch.train.loops import zinc_train_step

    # The flagship batch: the first 1,024 train molecules, padded to the
    # next 1,024 nodes and edges as bench.py:654-667 pads them.
    ds = load_zinc("train", subset_size=1024)
    n_need = int(ds.num_nodes.sum()) + 1
    e_need = int(sum(len(s_) for s_ in ds.edge_src))
    batch = next(ds.batches(1024, n_node=-(-n_need // 1024) * 1024,
                            n_edge=-(-e_need // 1024) * 1024, device=dev))
    g = batch.graph
    avg = mma_conv.compute_avg_deg(ds.degree_histogram(), parity=True)
    layers = 4
    print(f"zinc flagship batch: 1024 molecules, {int(g.num_nodes)} nodes (padded {g.n_node}), "
          f"{int(g.num_edges)} edges (padded {g.n_edge}), max in-degree {int(g.deg.max())}")

    def model_of(aggs_scalers, seed, device=dev):
        aggs, scalers = aggs_scalers
        return ZincNet(aggs, scalers, avg, num_layers=layers, device=device,
                       generator=torch.Generator().manual_seed(seed))

    # ------------------------------------------------- main path: zinc-serve
    model = model_of(ZINC_PRESET_AGGS, SEED)
    serve_ms, outs = [], []
    with counted("zinc-serve", paths), torch.no_grad():
        for _ in range(3):
            t0 = time.perf_counter()
            outs.append(model(batch))
            torch.cuda.synchronize()
            serve_ms.append((time.perf_counter() - t0) * 1e3)
    print(f"zinc-serve: 3 requests (host clock) {serve_ms} ms; median "
          f"{statistics.median(serve_ms):.4f} ms = "
          f"{layers * int(g.num_edges) / (statistics.median(serve_ms) * 1e-3):.4e} edge-visits/s")
    # Per forward: kernel 6 once per conv layer, kernel 1 once (pooling).
    expect_launches(paths, "zinc-serve", minmax_prog=3 * layers, segment_sum=3)
    with torch.no_grad():
        for i, out in enumerate(outs):
            if tuple(out.shape) != (1024,) or not torch.isfinite(out).all():
                raise AssertionError(f"zinc-serve request {i}: shape {tuple(out.shape)} or "
                                     "non-finite predictions")
            if not torch.equal(out, outs[0]):
                raise AssertionError(f"zinc-serve request {i} differs from request 0")
        before = launches()
        with plain_kernels():
            plain_out = model(batch)
        if launches() != before:
            raise AssertionError("the plain ZINC forward launched a kernel")
        compare(outs[0], plain_out, 1e-5, "zinc-serve request 0 vs plain on the card")
        cpu_model = model_of(ZINC_PRESET_AGGS, SEED, device="cpu")
        cpu_model.load_state_dict({k: v.cpu() for k, v in model.state_dict().items()})
        compare(outs[0].cpu(), cpu_model(batch.to("cpu")), 1e-5,
                "zinc-serve request 0 vs plain on the CPU")
    del model, cpu_model

    # ------------------------------------------------- main path: zinc-train
    aggs, scalers = ZINC_PRESET_AGGS
    cfg0 = ZincConfig(aggregators=aggs, scalers=scalers, lr=1e-4, weight_decay=3e-4,
                      batch_size=64, epochs=5, subset_size=2000)
    splits = {s: load_zinc(s, subset_size=cfg0.subset_size) for s in ("train", "val", "test")}
    results = {}
    with counted("zinc-train", paths), \
            open(os.path.join(LOG_DIR, "chip_smoke_zinc.log"), "w") as log, \
            contextlib.redirect_stdout(log):
        for seed in ZINC_SEEDS:
            results[seed] = train_zinc(dataclasses.replace(cfg0, seed=seed), datasets=splits,
                                       device=dev)
    val = [results[s]["val_mae"] for s in ZINC_SEEDS]
    epoch_s = [r["time"] for s in ZINC_SEEDS for r in results[s]["history"][1:]]
    mean_val = statistics.mean(val)
    print("zinc-train: val MAE per seed " + ", ".join(f"{s}: {v:.4f}" for s, v in zip(ZINC_SEEDS, val))
          + "; test MAE " + ", ".join(f"{results[s]['test_mae']:.4f}" for s in ZINC_SEEDS)
          + f"; mean val {mean_val:.4f} (band {ZINC_VAL_MAE_BAND}); median epoch "
          f"{statistics.median(epoch_s) * 1e3:.3f} ms (host clock, train steps + val/test "
          f"eval, epochs 2-{cfg0.epochs})")
    # Per train step: kernel 6 and kernel 7 once per layer, kernel 1 once per
    # layer (the gather_by_src VJP) and once for the pooling; per eval
    # forward kernel 6 once per layer and kernel 1 once.
    steps = -(-len(splits["train"]) // cfg0.batch_size)
    evals = sum(-(-len(splits[s]) // cfg0.batch_size) for s in ("val", "test"))
    runs = len(ZINC_SEEDS) * cfg0.epochs
    expect_launches(paths, "zinc-train", minmax_prog=runs * layers * (steps + evals),
                    minmax_prog_bwd=runs * layers * steps,
                    segment_sum=runs * (steps * (layers + 1) + evals))
    if not ZINC_VAL_MAE_BAND[0] <= mean_val <= ZINC_VAL_MAE_BAND[1]:
        raise AssertionError(f"zinc-train: mean val MAE {mean_val:.4f} outside {ZINC_VAL_MAE_BAND}")
    del results

    # ----------------------------------------- main path: zinc-train-default
    # The command line's defaults: mean,max,min with
    # identity,amplification,attenuation, lr 0.01, weight decay 5e-4.
    dmodel = model_of(ZINC_DEFAULT_AGGS, SEED + 5)
    opt = make_optimizer(dmodel.parameters(), 0.01, 5e-4)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    step_ms, losses = [], []
    with counted("zinc-train-default", paths):
        for _ in range(3):
            t0 = time.perf_counter()
            losses.append(float(zinc_train_step(dmodel, opt, batch, gen)))
            torch.cuda.synchronize()
            step_ms.append((time.perf_counter() - t0) * 1e3)
    print(f"zinc-train-default: losses {losses}; step times (host clock) {step_ms} ms; median "
          f"{statistics.median(step_ms):.4f} ms")
    # Per step and layer: forward kernel 4 once (max and min paired) and
    # kernel 1 once (mean); backward kernel 5 once and kernel 1 twice (the
    # gather VJPs by dst and by src); kernel 1 once more for the pooling.
    expect_launches(paths, "zinc-train-default", segment_minmax=3 * layers,
                    segment_minmax_bwd=3 * layers, segment_sum=3 * (3 * layers + 1))
    if not all(math.isfinite(v) for v in losses):
        raise AssertionError(f"zinc-train-default: non-finite loss {losses}")
    del dmodel

    # --------------------------------------------- main path: zinc-train-pna
    # The PNA set with the command line's other defaults (lr 0.01, weight
    # decay 5e-4, hidden 75, edge 50, towers 5, 4 layers).
    pmodel = model_of(ZINC_PNA_AGGS, SEED + 9)
    opt = make_optimizer(pmodel.parameters(), 0.01, 5e-4)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    step_ms, losses = [], []
    with counted("zinc-train-pna", paths):
        for _ in range(3):
            t0 = time.perf_counter()
            losses.append(float(zinc_train_step(pmodel, opt, batch, gen)))
            torch.cuda.synchronize()
            step_ms.append((time.perf_counter() - t0) * 1e3)
    print(f"zinc-train-pna: losses {losses}; step times (host clock) {step_ms} ms; median "
          f"{statistics.median(step_ms):.4f} ms")
    # Per step and layer: forward kernel 4 once (min and max paired),
    # kernel 1 once (mean) and kernel 8 once (std); backward kernel 5 once
    # and kernel 1 twice (the gather VJPs; the mean's and kernel 8's VJPs
    # are plain gathers); kernel 1 once more for the pooling.
    expect_launches(paths, "zinc-train-pna", segment_minmax=3 * layers,
                    segment_minmax_bwd=3 * layers, segment_sum=3 * (3 * layers + 1),
                    segment_sum_sq=3 * layers)
    if not all(math.isfinite(v) for v in losses):
        raise AssertionError(f"zinc-train-pna: non-finite loss {losses}")
    with torch.no_grad():
        ev = pmodel(batch)
        if tuple(ev.shape) != (1024,) or not torch.isfinite(ev).all():
            raise AssertionError("zinc-train-pna eval forward: bad shape or non-finite")
        cpu_model = model_of(ZINC_PNA_AGGS, SEED + 9, device="cpu")
        cpu_model.load_state_dict({k: v.cpu() for k, v in pmodel.state_dict().items()})
        compare(ev.cpu(), cpu_model(batch.to("cpu")), 1e-5,
                "zinc-train-pna eval forward vs plain on the CPU")
    del pmodel, cpu_model

    # ----------------------- one train step of each aggregator set vs plain
    captured = {}
    for aggs_scalers, site in ((ZINC_PRESET_AGGS, "fused_minmax_edge_program"),
                               (ZINC_DEFAULT_AGGS, "fused_segment_minmax"),
                               (ZINC_PNA_AGGS, "segment_sum_sq_csr")):
        steps_out = []
        for plain in (False, True):
            m = model_of(aggs_scalers, SEED + 7)
            opt = make_optimizer(m.parameters(), 1e-4, 3e-4)

            def step():
                with plain_kernels() if plain else contextlib.nullcontext():
                    loss = zinc_train_step(m, opt, batch,
                                           torch.Generator(device=dev).manual_seed(SEED))
                steps_out.append((float(loss),
                                  {n_: p.grad.clone() for n_, p in m.named_parameters()},
                                  {n_: b.clone() for n_, b in m.named_buffers()}))

            if plain:
                step()
            else:
                captured[site] = capture_call(mma_conv, site, step)
        (loss_k, grads_k, bufs_k), (loss_p, grads_p, bufs_p) = steps_out
        what = f"zinc {','.join(aggs_scalers[0])} step (dropout on)"
        compare(torch.tensor([loss_k]), torch.tensor([loss_p]), 1e-5, f"{what} loss vs plain")
        for kind, got, want in (("gradients", grads_k, grads_p), ("BatchNorm buffers", bufs_k,
                                                                   bufs_p)):
            errs = {name: compare(t, want[name], 1e-5, f"{what} {name} vs plain",
                                  scale=bn_fed_scale(name, want) if kind == "gradients" else None,
                                  verbose=False)
                    for name, t in got.items()}
            worst = max(errs, key=lambda k: errs[k]["max_rel_err"])
            print(f"{what}: {len(errs)} {kind} vs plain on the card, max_rel_err "
                  f"{errs[worst]['max_rel_err']:.3e} ({worst}; tolerance 1e-05), max_abs_err "
                  f"{max(e['max_abs_err'] for e in errs.values()):.3e}")

    # ------------------------------------- per-kernel, ZINC flagship shapes
    rp = g.real_row_ptr
    e_cov, n_rows = int(rp[-1]), g.n_node
    kernels = {}

    def record(name, got_err, ms, plain_ms, nbytes, flops, library_ms, shape,
               source=MINMAX_SOURCE):
        kernels[name] = {
            "name": name, "route": "cuda", "source": source,
            "replaces": REPLACES[name], "max_abs_err": got_err, "ms": ms,
            "plain_ms": plain_ms, **bound(nbytes, flops), "library_ms": library_ms,
            "shape": shape,
        }
        e = kernels[name]
        print(f"{name}: ms {ms:.4f} plain_ms {plain_ms:.4f} library_ms {library_ms} "
              f"bound_ms {e['bound_ms']:.4f} ({e['bound_by']})")

    def equal(got, want, what):
        if not torch.equal(got, want):
            raise AssertionError(f"{what}: max_abs_err {(got - want).abs().max().item():.3e}, "
                                 "must be equal")
        return 0.0

    with torch.no_grad():
        # Kernels 4-5 on the messages and cotangent of the mean,max,min step.
        (msgs, _, ops2), _, ct2 = captured["fused_segment_minmax"]
        msgs, ch = msgs.detach().contiguous(), msgs.shape[1]
        for ops in (ops2, ops2[:1]):
            ct = ct2[:, :len(ops) * ch].contiguous()
            out = mm.segment_minmax(msgs, rp, ops)
            grad = mm.segment_minmax_bwd(msgs, rp, ops, out, ct)
            equal(out, mm.segment_minmax_reference(msgs, rp, ops), f"segment_minmax {ops}")
            equal(grad, mm.segment_minmax_bwd_reference(msgs, rp, ops, out, ct),
                  f"segment_minmax_bwd {ops}")
            equal(out, mm.segment_minmax(msgs, rp, ops), f"segment_minmax {ops} run to run")
            equal(grad, mm.segment_minmax_bwd(msgs, rp, ops, out, ct),
                  f"segment_minmax_bwd {ops} run to run")
            print(f"segment_minmax / _bwd ops={ops}: equal to plain and run to run")
        ct = ct2.contiguous()
        out = mm.segment_minmax(msgs, rp, ops2)
        ids = mm._row_ids(rp)[:, None].expand(e_cov, ch)
        live = msgs[:e_cov]

        def library():
            return [torch.zeros(n_rows, ch, device=dev).scatter_reduce_(
                0, ids, live, "amax" if op == "max" else "amin", include_self=False)
                for op in ops2]

        shape = f"E={e_cov} N={n_rows} C={ch} ops={','.join(ops2)}"
        record("segment_minmax", 0.0, device_ms(lambda: mm.segment_minmax(msgs, rp, ops2)),
               device_ms(lambda: mm.segment_minmax_reference(msgs, rp, ops2), iters=10),
               4 * (e_cov * ch + (n_rows + 1) + n_rows * len(ops2) * ch),
               e_cov * ch * len(ops2), device_ms(library),
               shape + " (library: one scatter_reduce per op)")
        record("segment_minmax_bwd", 0.0,
               device_ms(lambda: mm.segment_minmax_bwd(msgs, rp, ops2, out, ct)),
               device_ms(lambda: mm.segment_minmax_bwd_reference(msgs, rp, ops2, out, ct),
                         iters=10),
               4 * (e_cov * ch + 2 * n_rows * len(ops2) * ch + (n_rows + 1) + g.n_edge * ch),
               e_cov * ch * 2 * len(ops2), None, shape)

        # Kernels 6-7 on the node projection, edge rest, seed and cotangent
        # of the min,max step (its last layer), with dropout on and off.
        (c, hg, _, ops_p), kw, ctp = captured["fused_minmax_edge_program"]
        c, hg, seed, rate = c.detach().contiguous(), hg.detach().contiguous(), kw["seed"], kw["rate"]
        errs = []
        for ops in (ops_p, ops_p[:1]):
            for sd in (seed, None):
                ct = ctp[:, :len(ops) * ch].contiguous()
                what = f"minmax_prog ops={ops} dropout={'on' if sd is not None else 'off'}"
                out = mm.minmax_edge_program(c, hg, rp, ops, sd, rate)
                dhg, dc = mm.minmax_edge_program_bwd(c, hg, rp, ops, sd, rate, out, ct)
                equal(out, mm.minmax_edge_program_reference(c, hg, rp, ops, sd, rate), what)
                want_dhg, want_dc = mm.minmax_edge_program_bwd_reference(c, hg, rp, ops, sd,
                                                                         rate, out, ct)
                equal(dhg, want_dhg, f"{what} dhg")
                errs.append(compare(dc, want_dc, 1e-5, f"{what} dc vs plain")["max_abs_err"])
                equal(out, mm.minmax_edge_program(c, hg, rp, ops, sd, rate), f"{what} run to run")
                again = mm.minmax_edge_program_bwd(c, hg, rp, ops, sd, rate, out, ct)
                equal(dhg, again[0], f"{what} dhg run to run")
                equal(dc, again[1], f"{what} dc run to run")
        ct = ctp.contiguous()
        p = len(ops_p)
        out = mm.minmax_edge_program(c, hg, rp, ops_p, seed, rate)
        shape = f"E={e_cov} N={n_rows} C={ch} ops={','.join(ops_p)} dropout on"
        # Operations per edge and lane: the add, the mask product and one
        # compare per op (the hash's integer operations not counted).
        record("minmax_prog", 0.0,
               device_ms(lambda: mm.minmax_edge_program(c, hg, rp, ops_p, seed, rate)),
               device_ms(lambda: mm.minmax_edge_program_reference(c, hg, rp, ops_p, seed, rate),
                         iters=10),
               4 * (e_cov * ch + n_rows * ch + (n_rows + 1) + 1 + n_rows * p * ch),
               e_cov * ch * (2 + p), None, shape)
        record("minmax_prog_bwd", max(errs),
               device_ms(lambda: mm.minmax_edge_program_bwd(c, hg, rp, ops_p, seed, rate, out,
                                                            ct)),
               device_ms(lambda: mm.minmax_edge_program_bwd_reference(c, hg, rp, ops_p, seed,
                                                                      rate, out, ct),
                         iters=10),
               4 * (e_cov * ch + n_rows * ch + 2 * n_rows * p * ch + (n_rows + 1) + 1
                    + g.n_edge * ch + n_rows * ch),
               e_cov * ch * (4 + 2 * p), None, shape)

        # Kernel 8 on the messages of the PNA step (its last layer).
        (msgs, rp8), _, _ = captured["segment_sum_sq_csr"]
        msgs = msgs.detach().contiguous()
        ch = msgs.shape[1]
        got = fused_mma.segment_sum_sq_csr(msgs, rp8)
        err = compare(got, fused_mma.segment_sum_sq_reference(msgs, rp8), 1e-5,
                      "segment_sum_sq vs plain")
        print(f"segment_sum_sq: equal to plain bit for bit: "
              f"{torch.equal(got, fused_mma.segment_sum_sq_reference(msgs, rp8))}")
        equal(got, fused_mma.segment_sum_sq_csr(msgs, rp8), "segment_sum_sq run to run")
        live = msgs[:e_cov]
        both = torch.cat([live, live * live], dim=1)
        ids = mm._row_ids(rp8)
        # Bytes: the covered edge rows and the CSR read once, [Σx ‖ Σx²]
        # written once; operations per element: the square and two adds.
        record("segment_sum_sq", err["max_abs_err"],
               device_ms(lambda: fused_mma.segment_sum_sq_csr(msgs, rp8)),
               device_ms(lambda: fused_mma.segment_sum_sq_reference(msgs, rp8), iters=10),
               4 * (e_cov * ch + (n_rows + 1) + n_rows * 2 * ch), 3 * e_cov * ch,
               device_ms(lambda: torch.zeros(n_rows, 2 * ch, device=dev).index_add_(0, ids, both)),
               f"E={e_cov} N={n_rows} C={ch} (library: index_add_ of a pre-built [x ‖ x²])",
               source=SOURCE)
    return kernels


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False", file=sys.stderr)
        return 1
    from mma_tpu_torch import NodeClassifier, load_planetoid, synthetic_powerlaw
    from mma_tpu_torch.ops import fused_masked_aggregate, get_agg_spec, masked_aggregate
    from mma_tpu_torch.ops.cuda import build, fused_mma
    from mma_tpu_torch.ops.gather import gather_by_dst, gather_by_src
    from mma_tpu_torch.train import NODE_CLS_PRESETS, make_optimizer, train_node_classification
    from mma_tpu_torch.train.loops import node_train_step

    # Parity with f32: TF32 would keep ~3 decimal digits in the dense
    # products (x @ W, h @ W_top, scaled @ W) that feed the kernels.
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    smi = nvidia_smi_line()
    print(smi)
    print("torch", torch.__version__, "cuda", torch.version.cuda, "device",
          torch.cuda.get_device_name(0))

    t0 = time.perf_counter()
    logs = build.build_all()
    print(f"build: {time.perf_counter() - t0:.2f} s for {len(build.SOURCES)} source(s)")
    for log in logs:
        for line in log.splitlines():
            if re.search(r"Compiling entry|registers|spill|smem", line):
                print("  ptxas:", line.strip())

    # ---------------------------------------------------------------- set-up
    gen = torch.Generator().manual_seed(SEED)
    cora = load_planetoid("cora", device=dev)
    cora_model = NodeClassifier(cora.num_features, 64, cora.num_classes, ("mean", "mean2"),
                                dropout_rate=0.75, device=dev, generator=gen)
    noise = torch.Generator().manual_seed(SEED + 1)
    requests = [cora.features] + [
        (cora.features + 0.1 * torch.randn(cora.features.shape, generator=noise).to(dev))
        * cora.graph.node_mask[:, None]
        for _ in range(2)
    ]
    t0 = time.perf_counter()
    big = synthetic_powerlaw(131072, avg_deg=16, seed=1, device=dev)
    n_big = 131072
    e_big = int(big.num_edges)
    print(f"synthetic-large graph: {big.n_node} nodes, {e_big} edges "
          f"(padded {big.n_edge}), max in-degree {int(big.deg.max())}, "
          f"built in {time.perf_counter() - t0:.2f} s")
    big_model = NodeClassifier(64, 64, 16, ("mean", "mean2"), device=dev, generator=gen)
    x_big = torch.randn((big.n_node, 64), generator=torch.Generator().manual_seed(SEED)).to(dev)
    x_big = x_big * big.node_mask[:, None]
    paths = {}

    # ------------------------------------------------------ main path: serve
    t0 = time.perf_counter()
    with counted("serve", paths), torch.no_grad():
        cora_out = [cora_model(x, cora.graph) for x in requests]
        torch.cuda.synchronize()
        t_cora = time.perf_counter() - t0
        t0 = time.perf_counter()
        big_out = [big_model(x_big, big) for _ in range(3)]
        torch.cuda.synchronize()
        t_big = time.perf_counter() - t0
    print(f"serve: 3 Cora requests in {t_cora * 1e3:.3f} ms (first includes "
          f"library load), 3 synthetic-large forwards in {t_big * 1e3:.3f} ms")
    # Per forward: kernel 1 for each binary_spmm (2), kernel 2 once.
    expect_launches(paths, "serve", segment_sum=2 * 6, edge_program_lean=6)

    cpu_model = NodeClassifier(cora.num_features, 64, cora.num_classes,
                               ("mean", "mean2"), device="cpu")
    cpu_model.load_state_dict({k: v.cpu() for k, v in cora_model.state_dict().items()})
    with torch.no_grad():
        for i, out in enumerate(cora_out):
            check_log_probs(out, cora.graph.n_node, cora.num_classes, cora.num_nodes,
                            f"cora request {i}")
        for i, out in enumerate(big_out):
            check_log_probs(out, big.n_node, 16, n_big, f"synthetic-large forward {i}")
        before = launches()
        with plain_kernels():
            cora_plain = [cora_model(x, cora.graph) for x in requests]
            big_plain = big_model(x_big, big)
        if launches() != before:
            raise AssertionError("the plain forward launched a kernel")
        n = cora.num_nodes
        for i, (got, want) in enumerate(zip(cora_out, cora_plain)):
            compare(got[:n], want[:n], 1e-5, f"cora request {i} vs plain on the card")
        compare(big_out[0][:n_big], big_plain[:n_big], 1e-5,
                "synthetic-large forward vs plain on the card")
        cpu_out = cpu_model(requests[0].cpu(), cora.graph.to("cpu"))
        compare(cora_out[0][:n].cpu(), cpu_out[:n], 1e-5, "cora request 0 vs plain on the CPU")
    del cora_plain, big_plain, big_out

    def latency_ms(fn, n: int) -> float:
        times = []
        for _ in range(n):
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        return statistics.median(times)

    with torch.no_grad():
        cora_ms = latency_ms(lambda: cora_model(requests[0], cora.graph), 10)
        big_ms = latency_ms(lambda: big_model(x_big, big), 5)
    print(f"serving latency (host clock, median): cora request {cora_ms:.4f} ms; "
          f"synthetic-large forward {big_ms:.4f} ms = {e_big / (big_ms * 1e-3):.4e} edges/s")

    # ------------------------------------------------- main path: cora-train
    os.makedirs(LOG_DIR, exist_ok=True)
    cfg0 = NODE_CLS_PRESETS["cora"]
    results = {}
    with counted("cora-train", paths), \
            open(os.path.join(LOG_DIR, "chip_smoke_train.log"), "w") as log, \
            contextlib.redirect_stdout(log):
        for seed in CORA_SEEDS:
            results[seed] = train_node_classification(dataclasses.replace(cfg0, seed=seed),
                                                      data=cora, device=dev)
    accs = [results[s]["acc_test"] for s in CORA_SEEDS]
    epoch_s = [r["time"] for s in CORA_SEEDS for r in results[s]["history"][1:]]
    mean_acc = statistics.mean(accs)
    print("cora-train: test accuracy per seed "
          + ", ".join(f"{s}: {a:.4f}" for s, a in zip(CORA_SEEDS, accs))
          + f"; mean {mean_acc:.4f} (must be >= {CORA_MIN_MEAN_ACC}); median epoch "
          f"{statistics.median(epoch_s) * 1e3:.3f} ms (host clock, train step + eval "
          f"forward + metrics, epochs 2-{cfg0.epochs})")
    # Per epoch: the train forward runs kernel 1 three times (2 binary_spmm,
    # the half-fused segment sum) and its backward five times (2
    # binary_spmm, the gathers of c by dst and of d and h by src); the eval
    # forward runs kernel 1 twice and kernel 2 once. Each run ends with one
    # more eval forward. Kernel 3 belongs to the fused route only.
    runs = len(CORA_SEEDS)
    epochs = cfg0.epochs
    print(f"cora-train: per epoch kernel 1 x10, kernel 2 x1, kernel 3 x0; "
          f"{runs} runs x {epochs} epochs + {runs} test forwards")
    expect_launches(paths, "cora-train", segment_sum=runs * (epochs * 10 + 2),
                    edge_program_lean=runs * (epochs + 1))
    if not mean_acc >= CORA_MIN_MEAN_ACC:
        raise AssertionError(f"cora-train: mean test accuracy {mean_acc:.4f} < {CORA_MIN_MEAN_ACC}")

    # One more cora-train step from seed 0's trained state, with the kernels
    # and then with every kernel plain: a fresh generator of one seed gives
    # both the same dropout draws, which do not depend on the kernels.
    steps = []
    for plain in (False, True):
        model = copy.deepcopy(results[CORA_SEEDS[0]]["model"])
        opt = make_optimizer(model.parameters(), cfg0.lr, cfg0.weight_decay)
        before = dict(fused_mma.LAUNCHES)
        with plain_kernels() if plain else contextlib.nullcontext():
            loss, _ = node_train_step(model, opt, cora.features, cora.graph,
                                      cora.labels.long(), cora.idx_train.long(),
                                      torch.Generator(device=dev).manual_seed(SEED))
        torch.cuda.synchronize()
        launched = fused_mma.LAUNCHES["segment_sum"] - before["segment_sum"]
        if launched != (0 if plain else 8):
            raise AssertionError(f"cora-train step (plain={plain}): {launched} kernel-1 launches")
        steps.append((float(loss), {n_: p.grad for n_, p in model.named_parameters()}))
    (loss_k, grads_k), (loss_p, grads_p) = steps
    compare(torch.tensor([loss_k]), torch.tensor([loss_p]), 1e-5,
            "cora-train step loss vs plain on the card")
    for name, g in grads_k.items():
        compare(g, grads_p[name], 1e-5, f"cora-train step grad {name} vs plain")
    del steps, grads_k, grads_p

    # ------------------------------------------------ main path: large-train
    lgen = torch.Generator().manual_seed(SEED + 2)
    labels = torch.randint(0, 16, (big.n_node,), generator=lgen).to(dev)
    idx_train = torch.randperm(n_big, generator=lgen)[: n_big // 2].to(dev)
    train_model = NodeClassifier(64, 64, 16, ("mean", "mean2"), dropout_rate=0.0,
                                 device=dev, generator=torch.Generator().manual_seed(SEED + 3))
    init_state = {k: v.clone() for k, v in train_model.state_dict().items()}
    # Adam at lr 1e-3, as the JAX package's training measurement (bench.py:587).
    opt = make_optimizer(train_model.parameters(), 1e-3)
    step_gen = torch.Generator(device=dev).manual_seed(SEED)
    step_ms, losses = [], []
    with counted("large-train", paths):
        for step in range(3):
            t0 = time.perf_counter()
            loss, logp = node_train_step(train_model, opt, x_big, big, labels, idx_train,
                                         step_gen)
            torch.cuda.synchronize()
            step_ms.append((time.perf_counter() - t0) * 1e3)
            losses.append(float(loss))
            if step == 0:
                grads1 = {n_: p.grad.clone() for n_, p in train_model.named_parameters()}
                check_log_probs(logp, big.n_node, 16, n_big, "large-train step 1")
    print(f"large-train: losses {losses}; step times (host clock) {step_ms}; median "
          f"{statistics.median(step_ms):.4f} ms = "
          f"{e_big / (statistics.median(step_ms) * 1e-3):.4e} edges/s")
    # Per step: forward kernel 1 x2 (binary_spmm) and kernel 2 x1; backward
    # kernel 1 x2 (binary_spmm) and kernel 3 x1, which gives dh itself.
    expect_launches(paths, "large-train", segment_sum=3 * 4, edge_program_lean=3,
                    edge_program_lean_bwd=3)
    if not all(math.isfinite(v) for v in losses):
        raise AssertionError(f"large-train: non-finite loss {losses}")

    # Step 1 again with every kernel, forward and backward, plain.
    plain_model = NodeClassifier(64, 64, 16, ("mean", "mean2"), dropout_rate=0.0,
                                 device=dev, generator=torch.Generator().manual_seed(SEED + 3))
    plain_model.load_state_dict(init_state)
    before = launches()
    with plain_kernels():
        plain_loss, _ = node_train_step(
            plain_model, make_optimizer(plain_model.parameters(), 1e-3), x_big, big,
            labels, idx_train, torch.Generator(device=dev).manual_seed(SEED))
    if launches() != before:
        raise AssertionError("the plain train step launched a kernel")
    compare(torch.tensor([losses[0]]), torch.tensor([float(plain_loss)]), 1e-5,
            "large-train step 1 loss vs plain on the card")
    for name, p in plain_model.named_parameters():
        compare(grads1[name], p.grad, 1e-5, f"large-train step 1 grad {name} vs plain")
    del plain_model, grads1

    # ------------------------------------------------- main path: large-wide
    wide_specs = [get_agg_spec(a) for a in ("mean", "mean2")]
    mw0 = (torch.randn((2, 128, 64), generator=torch.Generator().manual_seed(SEED + 5))
           / 8.0).to(dev)
    ct_wide = (torch.randn((big.n_node, 2, 64), generator=torch.Generator().manual_seed(SEED + 6))
               .to(dev) * big.node_mask[:, None, None])

    def wide_run(mode):
        """Forward and backward of the masked aggregate: (out, dh, dmask_weights)."""
        h = x_big.clone().requires_grad_()
        mw = mw0.clone().requires_grad_()
        with torch.enable_grad():
            out = masked_aggregate.masked_multi_aggregate(h, big, mw, wide_specs,
                                                          pallas_bwd_mode=mode)
            (out * ct_wide).sum().backward()
        return out.detach(), h.grad, mw.grad

    modes = fused_mma.EDGE_BWD_MODES
    wide, wide_ms = {}, {}
    with counted("large-wide", paths):
        for mode in modes:
            wide_ms[mode] = []
            for rep in range(3):
                t0 = time.perf_counter()
                res = wide_run(mode)
                torch.cuda.synchronize()
                wide_ms[mode].append((time.perf_counter() - t0) * 1e3)
                if rep == 0:
                    wide[mode] = res
    t_lean = []
    for _ in range(3):
        t0 = time.perf_counter()
        lean = wide_run(None)
        torch.cuda.synchronize()
        t_lean.append((time.perf_counter() - t0) * 1e3)
    print("large-wide: forward + backward (host clock, median of 3): "
          + ", ".join(f"{m} {statistics.median(wide_ms[m]):.4f} ms" for m in modes)
          + f"; the lean route {statistics.median(t_lean):.4f} ms (runs {wide_ms}, lean {t_lean})")
    # Per run: kernel 9 forward and kernel 10 backward, then payload_permute
    # sums the payload by source with kernel 1 and csc_gather runs kernel 11.
    expect_launches(paths, "large-wide", edge_program_fwd=6, edge_program_bwd=6,
                    segment_sum=3, edge_program_bwd_csc=3)
    before = launches()
    with plain_kernels():
        wide_plain = {mode: wide_run(mode) for mode in modes}
    if launches() != before:
        raise AssertionError("the plain wide route launched a kernel")
    names = ("output", "dh", "dmask_weights")
    for mode in modes:
        for name, got, want_lean, want_plain in zip(names, wide[mode], lean, wide_plain[mode]):
            compare(got, want_lean, 1e-5, f"large-wide {mode} {name} vs the lean route")
            compare(got, want_plain, 1e-5, f"large-wide {mode} {name} vs plain on the card")
    for name, a, b in zip(names, *(wide[m] for m in modes)):
        compare(a, b, 1e-5, f"large-wide {name}: {modes[0]} vs {modes[1]}")
    del wide, wide_plain, lean

    # ----------------------------------------------- main path: large-masked
    # The large-wide work's S = Σ_{e ∈ row i} act(c[i] + d[src_e]) ⊙
    # tile(h[src_e], K) (no combine) by three routes: fused_masked_aggregate
    # on the pre-gathered logits c[dst] + d[src] and rows h[src], built as
    # the half-fused route builds them (kernel 12; the input of the JAX
    # package's A/B profile, scripts/archive/profile_bwd.py:98-119), and the
    # wide and the lean edge program on c, d and h.
    f_big, k_big = 64, len(wide_specs)
    pat_big = masked_aggregate.sigmoid_lane_pattern(wide_specs, "new_sigmoid", True, f_big, dev)
    ct_s = ct_wide.reshape(big.n_node, k_big * f_big)
    rp_big, cp_big = big.real_row_ptr, big.real_col_ptr

    def s_run(route):
        """Forward and backward of S by ``route`` ("masked", "wide" or "lean")
        from h and mask_weights: S, dh and dmask_weights, and for "masked"
        the pre-gathered logits and h_src and their gradients."""
        h = x_big.clone().requires_grad_()
        mw = mw0.clone().requires_grad_()
        with torch.enable_grad():
            c, d = masked_aggregate.mma_mask_projections(h, mw)
            if route == "masked":
                logits = gather_by_dst(c, big) + gather_by_src(d, big)
                h_src = gather_by_src(h, big)
                logits.retain_grad()
                h_src.retain_grad()
                s = fused_masked_aggregate(logits, h_src, pat_big, big, k_big)
            elif route == "wide":
                s = fused_mma.edge_program(c, d, h, pat_big, big.src, rp_big, cp_big,
                                           big.src_perm, big.dst_csc, "payload_permute")
            else:
                w_bot = mw[:, f_big:, :].permute(1, 0, 2).reshape(f_big, -1).contiguous()
                s = fused_mma.edge_program_lean(c, w_bot, h, pat_big, big.src, rp_big, cp_big,
                                                big.dst_csc)
            (s * ct_s).sum().backward()
        res = {"S": s.detach(), "dh": h.grad, "dmask_weights": mw.grad}
        if route == "masked":
            res.update(dlogits=logits.grad, dh_src=h_src.grad, logits=logits.detach(),
                       h_src=h_src.detach())
        return res

    masked_ms = []
    with counted("large-masked", paths):
        for rep in range(3):
            t0 = time.perf_counter()
            res = s_run("masked")
            torch.cuda.synchronize()
            masked_ms.append((time.perf_counter() - t0) * 1e3)
            if rep == 0:
                masked = res
    print(f"large-masked: fused_masked_aggregate forward + backward from h and mask_weights "
          f"(host clock) {masked_ms} ms; median {statistics.median(masked_ms):.4f} ms")
    # Per run: kernel 12 forward. Backward: the Function's own VJP is
    # elementwise (no kernel), then the three gathers' VJPs run kernel 1
    # once each: c by dst over the CSR, d and h by src over the CSC.
    expect_launches(paths, "large-masked", masked_segment_sum=3, segment_sum=3 * 3)
    before = launches()
    with plain_kernels():
        masked_plain = s_run("masked")
    if launches() != before:
        raise AssertionError("the plain masked route launched a kernel")
    for name in ("S", "dlogits", "dh_src", "dh", "dmask_weights"):
        compare(masked[name], masked_plain[name], 1e-5, f"large-masked {name} vs plain on the card")
    del masked_plain
    for route in ("wide", "lean"):
        other = s_run(route)
        for name in ("S", "dh", "dmask_weights"):
            compare(masked[name], other[name], 1e-5, f"large-masked {name} vs the {route} route")
        del other
    masked_in = (masked["logits"], masked["h_src"])
    del masked, res

    zinc_kernels = run_zinc(dev, paths)

    # --------------------------------------------- per-kernel, large shapes
    row_ptr = big.real_row_ptr
    col_ptr = big.real_col_ptr
    e_cov = int(row_ptr[-1])
    n_rows = big.n_node
    kernels = {}
    with torch.no_grad():
        support = (x_big @ big_model.gc1.w).contiguous()
        dst_long = big.dst.long()
        src_long = big.src.long()

        # Kernel 1, the main paths' uses: binary_spmm forward (index=src) and
        # its backward over the CSC (index=dst_csc), at C=64 (the first
        # layer's width) and C=16 (the classes, the second product's width),
        # and the non-indexed sum of pre-gathered rows (the half-fused
        # route's use).
        classes = (torch.randn((n_rows, 16), generator=torch.Generator().manual_seed(SEED + 4))
                   .to(dev) * big.node_mask[:, None])
        with warnings.catch_warnings():  # "sparse CSR support is in beta"
            warnings.simplefilter("ignore")
            adj = torch.sparse_csr_tensor(row_ptr, big.src, torch.ones(e_big, device=dev),
                                          size=(n_rows, n_rows))
            torch.sparse.mm(adj, support)

        def spmm_uses(x):
            ch = x.shape[1]
            return {
                f"spmm fwd (index=src) C={ch}": (
                    (x, row_ptr, big.src),
                    lambda: torch.sparse.mm(adj, x),
                    "torch.sparse.mm"),
                f"spmm bwd (CSC, index=dst_csc) C={ch}": (
                    (x, col_ptr, big.dst_csc),
                    lambda: torch.zeros(n_rows, ch, device=dev).index_add_(
                        0, src_long, x.index_select(0, big.dst)),
                    "index_add_ over src of ct[dst]"),
            }

        uses = {
            **spmm_uses(support), **spmm_uses(classes),
            "gathered rows (no index) C=64": (
                (support.index_select(0, big.src), row_ptr, None),
                None, "index_add_"),
        }
        for what, (args, lib_fn, lib_name) in uses.items():
            data, rp, index = args
            ch = data.shape[1]
            got = fused_mma.segment_sum_csr(data, rp, index)
            if not torch.equal(got, fused_mma.segment_sum_csr(data, rp, index)):
                raise AssertionError(f"segment_sum_csr {what} differs run to run")
            err = compare(got, fused_mma.segment_sum_reference(data, rp, index), 1e-5,
                          f"segment_sum_csr {what} vs plain")
            ms = device_ms(lambda: fused_mma.segment_sum_csr(data, rp, index))
            plain_ms = device_ms(lambda: fused_mma.segment_sum_reference(data, rp, index))
            if lib_fn is None:
                lib_fn = lambda: torch.zeros(n_rows, ch, device=dev).index_add_(0, dst_long, data)  # noqa: E731
            library_ms = device_ms(lib_fn)
            # Bytes: each input read once (the node table when indexed, the
            # edge rows otherwise), the CSR and index, the output written once.
            rows_in = n_rows if index is not None else e_cov
            nbytes = 4 * (rows_in * ch + (n_rows + 1) + (e_cov if index is not None else 0)
                          + n_rows * ch)
            entry = {
                "name": "segment_sum_csr", "route": "cuda", "source": SOURCE,
                "replaces": REPLACES["segment_sum_csr"],
                "max_abs_err": err["max_abs_err"], "ms": ms, "plain_ms": plain_ms,
                **bound(nbytes, e_cov * ch), "library_ms": library_ms,
                "shape": f"{what}: E={e_cov} N={n_rows}",
            }
            print(f"segment_sum_csr {what}: ms {ms:.4f} plain_ms {plain_ms:.4f} "
                  f"{lib_name} ms {library_ms:.4f} bound_ms {entry['bound_ms']:.4f} "
                  f"({entry['bound_by']})")
            kernels.setdefault("segment_sum_csr", entry)
        k1 = kernels["segment_sum_csr"]
        # Skew: the heaviest row alone at C=64 indexed (binary_spmm forward's
        # form), its edges split over chunks and joined by the fixup.
        deg = row_ptr[1:] - row_ptr[:-1]
        top = int(torch.argmax(deg))
        one_row = row_ptr[top:top + 2].contiguous()
        compare(fused_mma.segment_sum_csr(support, one_row, big.src),
                fused_mma.segment_sum_reference(support, one_row, big.src), 1e-5,
                "segment_sum_csr heaviest row alone vs plain")
        k1["heaviest_row_ms"] = device_ms(
            lambda: fused_mma.segment_sum_csr(support, one_row, big.src))
        print(f"segment_sum_csr: the heaviest row alone ({int(deg[top])} edges, C=64, "
              f"index=src) ms {k1['heaviest_row_ms']:.4f}")
        # Cora's binary_spmm forward shapes (index=src): the first layer's
        # C=64 and the classes' C=7 (scalar loads).
        cg = cora.graph
        cora_x = {64: cora.features @ cora_model.gc1.w,
                  7: torch.randn((cg.n_node, 7), generator=torch.Generator().manual_seed(SEED + 8))
                  .to(dev) * cg.node_mask[:, None]}
        for ch, x in cora_x.items():
            args = (x.contiguous(), cg.real_row_ptr, cg.src)
            got = fused_mma.segment_sum_csr(*args)
            if not torch.equal(got, fused_mma.segment_sum_csr(*args)):
                raise AssertionError(f"segment_sum_csr Cora C={ch} differs run to run")
            compare(got, fused_mma.segment_sum_reference(*args), 1e-5,
                    f"segment_sum_csr Cora spmm fwd C={ch} vs plain")
            k1[f"cora_spmm_fwd_c{ch}_ms"] = device_ms(lambda: fused_mma.segment_sum_csr(*args))
            print(f"segment_sum_csr Cora spmm fwd (index=src) C={ch}: "
                  f"E={int(cg.num_edges)} N={cg.n_node} ms {k1[f'cora_spmm_fwd_c{ch}_ms']:.4f}")
        gather_ms = device_ms(lambda: support.index_select(0, big.src))
        print(f"binary_spmm forward, gather + sum: index_select {gather_ms:.4f} ms + "
              f"kernel 1 {kernels['segment_sum_csr']['ms']:.4f} ms (indexed form above)")

        # Kernels 2 and 3 on the large-train model's own tensors: the
        # arguments of its edge program and the cotangent its loss gives.
        def one_step():
            with torch.enable_grad():
                train_model.zero_grad(set_to_none=True)
                out = train_model(x_big, big, training=True, generator=step_gen)
                (-out[idx_train, labels[idx_train]].mean()).backward()

        args, _, ct = capture_call(masked_aggregate, "edge_program_lean", one_step)
        c, w_bot, h, pat, src, rp, cp, dst_csc = (t.detach() for t in args)
        f, kf = w_bot.shape
        fwd_args = (c, w_bot, h, pat, src, rp)
        got = fused_mma.edge_program_lean(*fwd_args, cp, dst_csc)
        if not torch.equal(got, fused_mma.edge_program_lean(*fwd_args, cp, dst_csc)):
            raise AssertionError("edge_program_lean_fwd differs run to run")
        err = compare(got, fused_mma.edge_program_lean_reference(*fwd_args), 1e-5,
                      "edge_program_lean_fwd vs plain")
        ms = device_ms(lambda: fused_mma.edge_program_lean(*fwd_args, cp, dst_csc))
        plain_ms = device_ms(lambda: fused_mma.edge_program_lean_reference(*fwd_args), iters=10)
        nbytes = 4 * (n_rows * kf + n_rows * f + f * kf + kf + e_cov + (n_rows + 1)
                      + n_rows * kf)
        # The work these inputs need: the node-level product h @ W_bot once,
        # then per edge and lane the add of c, the product with h and the
        # accumulation (the sigmoid not counted).
        kernels["edge_program_lean_fwd"] = {
            "name": "edge_program_lean_fwd", "route": "cuda", "source": SOURCE,
            "replaces": REPLACES["edge_program_lean_fwd"],
            "max_abs_err": err["max_abs_err"], "ms": ms, "plain_ms": plain_ms,
            **bound(nbytes, 2 * n_rows * f * kf + 3 * e_cov * kf), "library_ms": None,
            # The random D and h rows the edge pass gathers, once per edge.
            "gather_bound_ms": 4 * e_cov * (kf + f) / PEAK_BYTES_PER_S * 1e3,
            "shape": f"E={e_cov} N={n_rows} F={f} K·F={kf}",
        }
        k2 = kernels["edge_program_lean_fwd"]
        print(f"edge_program_lean_fwd: ms {ms:.4f} plain_ms {plain_ms:.4f} "
              f"bound_ms {k2['bound_ms']:.4f} ({k2['bound_by']}); gathered rows alone "
              f"{k2['gather_bound_ms']:.4f} ms; bitwise equal run to run")
        # Its three launches: the node pass alone, then the edge pass alone.
        d_tab = fused_mma._lean_node_pass(h, w_bot)
        k2["node_pass_ms"] = device_ms(lambda: fused_mma._lean_node_pass(h, w_bot))
        k2["edge_pass_ms"] = device_ms(
            lambda: fused_mma._lean_edge_pass(c, pat, d_tab, h, src, rp))
        print(f"edge_program_lean_fwd: node pass {k2['node_pass_ms']:.4f} ms "
              f"({k2['node_pass_ms'] / ms:.3f} of the call), edge pass "
              f"{k2['edge_pass_ms']:.4f} ms")
        # Skew: the heaviest row alone, as a whole call on a CSR of N rows
        # that covers its edges only (the node pass still covers all N nodes
        # of h) and through the edge pass alone on its own CSR slice (its
        # edges split over chunks, joined by the fixup).
        deg = rp[1:] - rp[:-1]
        top = int(torch.argmax(deg))
        only_top = rp.clamp(int(rp[top]), int(rp[top + 1]))
        heavy = (c, w_bot, h, pat, src, only_top)
        compare(fused_mma.edge_program_lean(*heavy, cp, dst_csc),
                fused_mma.edge_program_lean_reference(*heavy), 1e-5,
                "edge_program_lean_fwd heaviest row alone vs plain")
        one_row, c_top = rp[top:top + 2].contiguous(), c[top:top + 1]
        compare(fused_mma._lean_edge_pass(c_top, pat, d_tab, h, src, one_row),
                fused_mma.edge_program_lean_reference(c_top, w_bot, h, pat, src, one_row),
                1e-5, "edge_program_lean_fwd heaviest row alone, edge pass vs plain")
        k2["heaviest_row_call_ms"] = device_ms(
            lambda: fused_mma.edge_program_lean(*heavy, cp, dst_csc))
        k2["heaviest_row_ms"] = device_ms(
            lambda: fused_mma._lean_edge_pass(c_top, pat, d_tab, h, src, one_row))
        print(f"edge_program_lean_fwd: the heaviest row alone ({int(deg[top])} edges, "
              f"N={n_rows}): whole call ms {k2['heaviest_row_call_ms']:.4f}, edge pass alone "
              f"ms {k2['heaviest_row_ms']:.4f}")
        # Cora's shape: the eval forward's own edge program.
        cora_args, _, _ = capture_call(masked_aggregate, "edge_program_lean",
                                       lambda: cora_model(requests[0], cora.graph))
        cora_fwd = tuple(t.detach() for t in cora_args[:6])
        compare(fused_mma.edge_program_lean(*cora_args),
                fused_mma.edge_program_lean_reference(*cora_fwd), 1e-5,
                "edge_program_lean_fwd Cora vs plain")
        k2["cora_ms"] = device_ms(lambda: fused_mma.edge_program_lean(*cora_args))
        print(f"edge_program_lean_fwd Cora: E={int(cora.graph.num_edges)} N={cora.graph.n_node} "
              f"F={cora_fwd[2].shape[1]} K·F={cora_fwd[0].shape[1]} ms {k2['cora_ms']:.4f}")

        # Kernel 3 on the same tensors and the cotangent of the step's loss.
        bwd_args = fwd_args + (cp, dst_csc, ct.contiguous())
        got = fused_mma.edge_program_lean_bwd(*bwd_args)
        again = fused_mma.edge_program_lean_bwd(*bwd_args)
        if not all(torch.equal(a, b) for a, b in zip(got, again)):
            raise AssertionError("edge_program_lean_bwd differs run to run")
        print("edge_program_lean_bwd: dc, dW_bot and dh bitwise equal run to run")
        want = fused_mma.edge_program_lean_bwd_reference(*bwd_args)
        errs = [compare(g, w, 1e-5, f"edge_program_lean_bwd {name} vs plain")
                for g, w, name in zip(got, want, ("dc", "dW_bot", "dh"))]
        del got, again, want
        ms = device_ms(lambda: fused_mma.edge_program_lean_bwd(*bwd_args), iters=15)
        plain_ms = device_ms(lambda: fused_mma.edge_program_lean_bwd_reference(*bwd_args),
                             iters=5)
        # Bytes: c, ct, h, W_bot, the pattern, src, dst_csc and both pointer
        # arrays read once; dc, dW_bot and dh written once. The work these
        # inputs need: three node-level products (D = h @ W_bot, dD @
        # W_botᵀ, hᵀ · dD: 6 N F K·F) and about 10 operations per edge and
        # lane (the mask chain, dlog, its two sums, ct ⊙ mask and its sum),
        # the sigmoid not counted.
        nbytes = 4 * (3 * n_rows * kf + 2 * n_rows * f + 2 * f * kf + kf + 2 * e_cov
                      + 2 * (n_rows + 1))
        # The same function under the per-edge contract kept beside it: an
        # (E, F) payload written, and dlog_e @ W_botᵀ done per edge.
        old = bound(4 * (3 * n_rows * kf + n_rows * f + 2 * f * kf + kf + e_cov
                         + (n_rows + 1) + big.n_edge * f),
                    4 * n_rows * f * kf + e_cov * (2 * f * kf + 10 * kf))
        kernels["edge_program_lean_bwd"] = {
            "name": "edge_program_lean_bwd", "route": "cuda", "source": SOURCE,
            "replaces": REPLACES["edge_program_lean_bwd"],
            "max_abs_err": max(e["max_abs_err"] for e in errs), "ms": ms,
            "plain_ms": plain_ms, **bound(nbytes, 6 * n_rows * f * kf + 10 * e_cov * kf),
            # No single PyTorch call gives dc, dW_bot and dh.
            "library_ms": None,
            "payload_contract_bound_ms": old["bound_ms"],
            # The random node rows the two edge passes gather, once per edge:
            # D[src] and h[src] (dst pass), c[dst] and ct[dst] (src pass).
            "gather_bound_ms": 4 * e_cov * (kf + f + 2 * kf) / PEAK_BYTES_PER_S * 1e3,
            "shape": f"E={e_cov} N={n_rows} F={f} K·F={kf}",
        }
        k3 = kernels["edge_program_lean_bwd"]
        print(f"edge_program_lean_bwd: ms {ms:.4f} plain_ms {plain_ms:.4f} "
              f"bound_ms {k3['bound_ms']:.4f} ({k3['bound_by']}); the payload contract's "
              f"bound {k3['payload_contract_bound_ms']:.4f}; gathered rows alone "
              f"{k3['gather_bound_ms']:.4f} ms")
        # Its parts alone: D, the dst pass, the src pass, the node pass (with
        # sum_slabs), each held against the plain formula of the same sums
        # (kernels 10 and 11's plain versions with D in place of d).
        ct3 = bwd_args[-1]
        d_tab = fused_mma._lean_node_pass(h, w_bot)
        ddg = fused_mma._lean_bwd_src_pass(c, ct3, pat, d_tab, h, dst_csc, cp)

        def hold_dst(row_ptr, what):
            compare(fused_mma._lean_bwd_dst_pass(c, ct3, pat, d_tab, h, src, row_ptr)[0],
                    fused_mma.edge_program_bwd_reference(c, d_tab, h, pat, src, row_ptr, ct3,
                                                         emit_payload=False)[0],
                    1e-5, f"edge_program_lean_bwd dst pass{what} vs plain")

        def hold_src(col_ptr, what):
            got = fused_mma._lean_bwd_src_pass(c, ct3, pat, d_tab, h, dst_csc, col_ptr)
            want = fused_mma.edge_program_bwd_csc_reference(c, d_tab, h, pat, dst_csc,
                                                            col_ptr, ct3)
            compare(got[:, :kf], want[:, :kf], 1e-5, f"edge_program_lean_bwd src pass{what} "
                    "dD vs plain")
            compare(got[:, kf:].reshape(n_rows, kf // f, f).sum(dim=1), want[:, kf:], 1e-5,
                    f"edge_program_lean_bwd src pass{what} fold_K(G) vs plain")

        hold_dst(rp, "")
        hold_src(cp, "")
        k3["d_ms"] = device_ms(lambda: fused_mma._lean_node_pass(h, w_bot))
        k3["dst_pass_ms"] = device_ms(
            lambda: fused_mma._lean_bwd_dst_pass(c, ct3, pat, d_tab, h, src, rp))
        k3["src_pass_ms"] = device_ms(
            lambda: fused_mma._lean_bwd_src_pass(c, ct3, pat, d_tab, h, dst_csc, cp))
        k3["node_pass_ms"] = device_ms(lambda: fused_mma._lean_bwd_node_pass(ddg, h, w_bot))
        print(f"edge_program_lean_bwd parts: D {k3['d_ms']:.4f} ms, dst pass "
              f"{k3['dst_pass_ms']:.4f}, src pass {k3['src_pass_ms']:.4f}, node pass "
              f"{k3['node_pass_ms']:.4f}")
        # Skew: each edge pass alone on its heaviest row, on a CSR (CSC) of
        # N rows that covers that row's edges only.
        for what, ptr, hold, run in (
                ("dst", rp, hold_dst,
                 lambda p: fused_mma._lean_bwd_dst_pass(c, ct3, pat, d_tab, h, src, p)),
                ("src", cp, hold_src,
                 lambda p: fused_mma._lean_bwd_src_pass(c, ct3, pat, d_tab, h, dst_csc, p))):
            deg = ptr[1:] - ptr[:-1]
            top = int(torch.argmax(deg))
            only_top = ptr.clamp(int(ptr[top]), int(ptr[top + 1]))
            hold(only_top, " heaviest row alone")
            k3[f"heaviest_{what}_row_ms"] = device_ms(lambda: run(only_top))
            print(f"edge_program_lean_bwd {what} pass, the heaviest row alone ({int(deg[top])} "
                  f"edges, N={n_rows}): ms {k3[f'heaviest_{what}_row_ms']:.4f}")
        del d_tab, ddg
        # Cora's shape: the eval forward's captured arguments and a cotangent
        # from a seed.
        ct_cora = (torch.randn((cora.graph.n_node, cora_fwd[0].shape[1]),
                               generator=torch.Generator().manual_seed(SEED + 9)).to(dev)
                   * cora.graph.node_mask[:, None])
        cora_bwd = cora_fwd + tuple(t.detach() for t in cora_args[6:8]) + (ct_cora,)
        for g, w, name in zip(fused_mma.edge_program_lean_bwd(*cora_bwd),
                              fused_mma.edge_program_lean_bwd_reference(*cora_bwd),
                              ("dc", "dW_bot", "dh")):
            compare(g, w, 1e-5, f"edge_program_lean_bwd Cora {name} vs plain")
        k3["cora_ms"] = device_ms(lambda: fused_mma.edge_program_lean_bwd(*cora_bwd))
        print(f"edge_program_lean_bwd Cora: ms {k3['cora_ms']:.4f}")

        # Kernels 9-11 and kernel 1 at the payload's width on the large-wide
        # path's own tensors: the arguments of its edge program and the
        # cotangent the loss gives it.
        args, _, ct = capture_call(masked_aggregate, "edge_program",
                                   lambda: wide_run("payload_permute"))
        c, d, h, pat, src, rp, cp, perm, dst_csc, _ = args
        c, d, h = (t.detach() for t in (c, d, h))
        ct = ct.contiguous()
        f, kf = h.shape[1], c.shape[1]
        shape = f"E={e_cov} N={n_rows} F={f} K·F={kf}"

        def hold(name, run, plain, outs, nbytes, flops, gather_bytes=None, iters=25,
                 library=None):
            got = run()
            got = got if isinstance(got, tuple) else (got,)
            again = run()
            again = again if isinstance(again, tuple) else (again,)
            if not all(torch.equal(a, b) for a, b in zip(got, again)):
                raise AssertionError(f"{name} differs run to run")
            want = plain()
            want = want if isinstance(want, tuple) else (want,)
            errs = [compare(g_, w_, 1e-5, f"{name} {o} vs plain")
                    for g_, w_, o in zip(got, want, outs)]
            ms = device_ms(run, iters=iters)
            plain_ms = device_ms(plain, iters=5)
            kernels[name] = {
                "name": name, "route": "cuda", "source": SOURCE, "replaces": REPLACES[name],
                "max_abs_err": max(e["max_abs_err"] for e in errs), "ms": ms,
                "plain_ms": plain_ms, **bound(nbytes, flops),
                "library_ms": None if library is None else device_ms(library),
                "shape": shape,
            }
            e = kernels[name]
            note = ""
            if gather_bytes is not None:
                # The random row reads alone, each gathered row counted once
                # per edge: what sets the wide kernels' time.
                e["gather_bound_ms"] = gather_bytes / PEAK_BYTES_PER_S * 1e3
                note = f"; gathered rows alone {e['gather_bound_ms']:.4f} ms"
            print(f"{name}: ms {ms:.4f} plain_ms {plain_ms:.4f} library_ms {e['library_ms']} "
                  f"bound_ms {e['bound_ms']:.4f} ({e['bound_by']}){note}; bitwise equal run "
                  "to run")
            return got

        fwd = (c, d, h, pat, src, rp)
        # Bytes: c, d, h, the pattern, src and the CSR read once, S written
        # once. Per edge and lane: the add, the product with h and the
        # accumulation (the sigmoid not counted).
        hold("edge_program_fwd", lambda: fused_mma.edge_program_fwd(*fwd),
             lambda: fused_mma.edge_program_fwd_reference(*fwd), ("S",),
             4 * (3 * n_rows * kf + n_rows * f + kf + e_cov + (n_rows + 1)),
             3 * e_cov * kf, 4 * e_cov * (kf + f))
        # Bytes: c, d, ct, h, the pattern, src and the CSR read once; dc and
        # the (E, K·F+F) payload written once. Per edge and lane about 8
        # operations (the mask chain, dlog, dc, ct ⊙ mask and its K-fold sum).
        _, payload = hold(
            "edge_program_bwd", lambda: fused_mma.edge_program_bwd(*fwd, ct),
            lambda: fused_mma.edge_program_bwd_reference(*fwd, ct), ("dc", "payload"),
            4 * (4 * n_rows * kf + n_rows * f + kf + e_cov + (n_rows + 1)
                 + big.n_edge * (kf + f)),
            8 * e_cov * kf, 4 * e_cov * (kf + f), iters=15)
        k10 = kernels["edge_program_bwd"]
        k10["ms_without_payload"] = device_ms(
            lambda: fused_mma.edge_program_bwd(*fwd, ct, emit_payload=False), iters=15)
        # Without the payload (csc_gather's use) the output is dc alone, and
        # per edge and lane about 6 operations (the mask chain, dlog, dc).
        k10["bound_without_payload"] = bound(
            4 * (4 * n_rows * kf + n_rows * f + kf + e_cov + (n_rows + 1)), 6 * e_cov * kf)
        print(f"edge_program_bwd without the payload (csc_gather's use): ms "
              f"{k10['ms_without_payload']:.4f} bound_ms "
              f"{k10['bound_without_payload']['bound_ms']:.4f} "
              f"({k10['bound_without_payload']['bound_by']})")
        # Skew: kernels 9 and 10 alone on the heaviest row, each as a whole
        # call on a CSR of N rows that covers that row's edges only (its
        # edges split over chunks, joined by the fixup; every other payload
        # row zeroed).
        deg = rp[1:] - rp[:-1]
        top = int(torch.argmax(deg))
        only_top = rp.clamp(int(rp[top]), int(rp[top + 1]))
        heavy = (c, d, h, pat, src, only_top)
        compare(fused_mma.edge_program_fwd(*heavy), fused_mma.edge_program_fwd_reference(*heavy),
                1e-5, "edge_program_fwd heaviest row alone vs plain")
        kernels["edge_program_fwd"]["heaviest_row_call_ms"] = device_ms(
            lambda: fused_mma.edge_program_fwd(*heavy))
        for emit in (False, True):
            got = fused_mma.edge_program_bwd(*heavy, ct, emit_payload=emit)
            want = fused_mma.edge_program_bwd_reference(*heavy, ct, emit_payload=emit)
            for name, g_, w_ in zip(("dc", "payload"), got, want):
                if w_ is not None:
                    compare(g_, w_, 1e-5, f"edge_program_bwd heaviest row alone {name} "
                            f"(emit_payload={emit}) vs plain")
            if not all(a is None or torch.equal(a, b) for a, b in zip(
                    got, fused_mma.edge_program_bwd(*heavy, ct, emit_payload=emit))):
                raise AssertionError("edge_program_bwd heaviest row alone differs run to run")
            del got, want
            k10["heaviest_row_call_ms" + ("" if emit else "_without_payload")] = device_ms(
                lambda: fused_mma.edge_program_bwd(*heavy, ct, emit_payload=emit), iters=15)
        print(f"edge_program_fwd / _bwd without / with the payload: the heaviest row alone "
              f"({int(deg[top])} edges, N={n_rows}), whole call ms "
              f"{kernels['edge_program_fwd']['heaviest_row_call_ms']:.4f} / "
              f"{k10['heaviest_row_call_ms_without_payload']:.4f} / "
              f"{k10['heaviest_row_call_ms']:.4f}")
        csc_args = (c, d, h, pat, dst_csc, cp, ct)
        # Bytes: c, d, ct, h, the pattern, dst_csc and the CSC read once,
        # [dd ‖ dh] written once; per edge it gathers c and ct of the dst.
        hold("edge_program_bwd_csc", lambda: fused_mma.edge_program_bwd_csc(*csc_args),
             lambda: fused_mma.edge_program_bwd_csc_reference(*csc_args), ("[dd ‖ dh]",),
             4 * (3 * n_rows * kf + n_rows * f + kf + e_cov + (n_rows + 1)
                  + n_rows * (kf + f)),
             8 * e_cov * kf, 4 * e_cov * 2 * kf, iters=15)

        # Kernel 1 at C = K·F+F: payload_permute's by-source sum of the payload.
        ch = payload.shape[1]
        got = fused_mma.segment_sum_csr(payload, cp, perm)
        if not torch.equal(got, fused_mma.segment_sum_csr(payload, cp, perm)):
            raise AssertionError("segment_sum_csr C=192 differs run to run")
        err = compare(got, fused_mma.segment_sum_reference(payload, cp, perm), 1e-5,
                      f"segment_sum_csr payload by source C={ch} vs plain")
        ms = device_ms(lambda: fused_mma.segment_sum_csr(payload, cp, perm))
        plain_ms = device_ms(lambda: fused_mma.segment_sum_reference(payload, cp, perm))
        library_ms = device_ms(lambda: torch.zeros(n_rows, ch, device=dev).index_add_(
            0, src_long, payload))
        b1 = bound(4 * (e_cov * ch + (n_rows + 1) + e_cov + n_rows * ch), e_cov * ch)
        kernels["segment_sum_csr"]["payload_by_source"] = {
            "shape": f"E={e_cov} N={n_rows} C={ch}", "ms": ms, "plain_ms": plain_ms,
            "library_ms": library_ms, "max_abs_err": err["max_abs_err"], **b1}
        print(f"segment_sum_csr payload by source (index=src_perm) C={ch}: ms {ms:.4f} "
              f"plain_ms {plain_ms:.4f} index_add_ over src ms {library_ms:.4f} bound_ms "
              f"{b1['bound_ms']:.4f} ({b1['bound_by']})")

        # Kernel 12 on the large-masked path's own inputs: the pre-gathered
        # logits and source rows of its first run. The library call sums the
        # pre-built message by dst: no single PyTorch call also applies the
        # activation.
        logits, h_src = masked_in
        margs = (logits, h_src, pat_big, row_ptr)
        msg = (torch.where(pat_big.bool(), torch.sigmoid(logits[:e_cov]), logits[:e_cov])
               * h_src[:e_cov].repeat(1, kf // f))
        ids = dst_long[:e_cov]
        # Bytes: each covered edge's logits and h_src rows, the pattern and
        # the CSR read once, S written once. Per edge and lane about 6
        # operations: the sigmoid's exp, add and division, the select, the
        # product with h_src and the accumulation.
        hold("masked_segment_sum", lambda: fused_mma.masked_segment_sum(*margs),
             lambda: fused_mma.masked_segment_sum_reference(*margs), ("S",),
             4 * (e_cov * (kf + f) + kf + (n_rows + 1) + n_rows * kf), 6 * e_cov * kf,
             library=lambda: torch.zeros(n_rows, kf, device=dev).index_add_(0, ids, msg))
        kernels["masked_segment_sum"]["shape"] += (" (library: index_add_ over dst of the "
                                                   "pre-built message)")
        # Skew: the heaviest row alone, one warp's loop over its edges.
        deg = row_ptr[1:] - row_ptr[:-1]
        top = int(torch.argmax(deg))
        one_row = row_ptr[top:top + 2].contiguous()
        heavy_ms = device_ms(lambda: fused_mma.masked_segment_sum(logits, h_src, pat_big, one_row))
        kernels["masked_segment_sum"]["heaviest_row_ms"] = heavy_ms
        print(f"masked_segment_sum: the heaviest row alone ({int(deg[top])} edges, one warp) "
              f"ms {heavy_ms:.4f}")
        del msg, masked_in, logits, h_src

    kernels.update(zinc_kernels)
    launch_keys = {"segment_sum_csr": "segment_sum", "edge_program_lean_fwd": "edge_program_lean"}
    for name, entry in kernels.items():
        entry["launches"] = sum(p[launch_keys.get(name, name)] for p in paths.values())
    print("launches per main path:", json.dumps(paths))
    print(json.dumps({"kernels": list(kernels.values())}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU: ``python3 chip_smoke.py``.

1. Prints the card's name and power limit (``nvidia-smi``), then builds
   every CUDA kernel of the port from ``mma_tpu_torch/csrc`` (one ``nvcc``
   per source, all started together).
2. Forty-seven main paths in this process and seven in each rank of a
   two-rank world, each with the kernels' launch counters set to 0 just
   before it and read just after:

   - **serve**: the node classifier's eval forward answers 3 requests on
     Cora at the README preset (1433 features, hidden 64, 7 classes,
     ``mean,mean2``, parity mode), then runs 3 forwards of the
     synthetic-large model (131072-node / 2.1M-edge power-law graph, F=64,
     16 classes). Weights are random from a seed.
   - **cora-neighbor-lists**: Cora's graph built on the card by
     ``graph_from_neighbor_lists`` from the Planetoid adjacency lists and
     by ``graph_from_dense``, every tensor bitwise equal to the serve
     path's graph, and the first request's forward on each (kernels 1 and
     2) bitwise equal to the serve path's; ``segment_mean``,
     ``segment_softmax_denom`` and ``mma_mask_logits`` at synthetic-large
     within 1e-5 of the same calls on the CPU.
   - **cora-train**: ``train_node_classification`` at the README preset
     (``NODE_CLS_PRESETS["cora"]``: 200 epochs, mask dropout 0.75, so
     kernels 2-3 with the keep), seeds 0, 1, 2 and 42. The mean test accuracy must
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
   - **large-wide-bf16**: the same work with ``compute_dtype=bfloat16``,
     3 times with each mode: bf16 ``c``, ``d`` and ``h`` through the bf16
     variants of kernels 9-11 (and kernel 1 on the float32 payload), held
     against the all-plain bf16 run, the other mode, the lean bf16 route
     and the f32 wide route, timed beside the f32 runs in turns.
   - **large-masked**: the same work's aggregate ``S`` (no combine) through
     ``fused_masked_aggregate`` on the pre-gathered logits ``c[dst] +
     d[src]`` and rows ``h[src]``, forward and backward to ``h`` and
     ``mask_weights``, 3 times: kernel 12, and kernel 1 for the gathers'
     VJPs. **large-masked-bf16**: the same on the bf16 logits and rows that
     the half-fused route builds in bf16: kernel 12 in bf16 and kernel 1
     on the bf16 cotangents, held against the all-plain run and the wide
     bf16 route's ``S``.
   - **zinc-serve**: the ZincNet eval forward at the README preset
     (``min,max``; ``identity,amplification,linear``; hidden 75, edge 50,
     towers 5, 4 layers; the fused min/max edge program, kernel 6) answers
     3 requests on the flagship batch: the first 1,024 synthetic ZINC train
     molecules, padded as the JAX package's benchmark pads them.
   - **zinc-exact-serve**: the same model and molecules in the
     degree-exact layout (the JAX package's zero-config production batch,
     ``bench.py:671-680``): the ELL route, plain PyTorch slot reductions,
     and kernel 1 for the pool.
   - **zinc-train**: ``train_zinc`` at the README preset (lr 1e-4, wd 3e-4,
     batch 64) for 5 epochs on a 2,000-molecule subset, seeds 0, 1, 2 and
     42, on the layout ``batch_layout="auto"`` resolves to. The mean val
     MAE after epoch 5 must lie in the JAX package's CPU band, widened by
     3 sd (``ZINC_VAL_MAE_BAND``). **zinc-train-plain** or
     **zinc-train-exact**: seed 0 on the other layout, held to the same
     band.
   - **zinc-train-default** / **zinc-exact-train-default**: 3
     ``zinc_train_step``s of the command line's default ``mean,max,min`` at
     the flagship batch (the general CSR route: kernels 1, 4 and 5; the ELL
     route: kernel 1).
   - **zinc-train-pna** / **zinc-exact-train-pna**: 3 ``zinc_train_step``s
     of the PNA set ``mean,min,max,std`` (``identity,amplification,
     attenuation``, the command line's other defaults) at the flagship
     batch: kernels 1, 4, 5 and 8; the ELL route: kernel 1.
   - **sampled-train**: ``mma_tpu_torch.cli.train_sampled.main`` at its
     defaults (a 200,000-node power-law graph from the seed, ``--avg-deg
     25``, batch 512, fanouts 10,10,5, hidden 64, 100 features, 47
     classes, ``mean,mean2``, dropout 0.5, the ``device_finish``
     pipeline) for 20 steps: kernel 1, kernels 2-3 with the keep.
     **sampled-train-lean**: ``--dropout 0``, 5 steps (kernels 1, 2, 3).
     **sampled-train-ell**: ``--use-ell``, 10 steps (the ELL route; kernel
     1 for the products and the slot gather's VJP).
     **sampled-train-hostbuilt**: ``--host-built``, 5 steps (kernel 1,
     kernels 2-3 with the keep).
   - **sampled-quality**: the community graph of
     ``tests/test_sampling.py:260-345`` on the card, sampled training
     against full-graph training (full accuracy above 0.6, sampled within
     0.08 of it).
   - The bf16 edge pipeline (``compute_dtype="bfloat16"``; kernels 1-3 read
     bf16 rows and sum in float32, and count under their ``_bf16`` keys):
     **cora-serve-bf16** and **synthetic-large-serve-bf16**, the serve
     path's requests and forwards on bf16 twins of its models (the same
     weights); **synthetic-large-train-bf16**, large-train's 3 Adam steps
     from its initial weights in bf16 (kernels 1, 2 and 3);
     **cora-train-bf16**, cora-train in bf16 (the loop's model built with
     ``compute_dtype="bfloat16"``; the half-fused route's bf16 messages),
     held to the same 0.834 gate; **sampled-train-bf16** (the sampled
     command line with ``--compute-dtype bfloat16``, 5 steps, the
     half-fused route), **sampled-train-lean-bf16** (``--dropout 0``, 5
     steps) and **sampled-train-ell-bf16** (``--use-ell``, 5 steps).
   - ZINC in bf16 (``compute_dtype="bfloat16"``; kernels 4-8 read bf16 edge
     operands and compute in float32, under their ``_bf16`` keys):
     **zinc-serve-bf16**, zinc-serve's model (the same weights) in bf16 on
     the flagship batch (kernel 6 in bf16); **zinc-train-bf16**,
     zinc-train's ``train_zinc`` run in bf16 (4 seeds, 5 epochs, 2,000
     molecules), its mean val MAE held to the JAX package's bf16 CPU band
     widened by 3 sd (``ZINC_BF16_VAL_MAE_BAND``);
     **zinc-train-default-bf16** (kernels 1, 4 and 5 in bf16),
     **zinc-train-pna-bf16** (and kernel 8) and
     **zinc-exact-train-default-bf16** (the ELL route), 3 steps each.

   - Checkpoint/resume, the resilient runner and the serving export:
     **cora-train-resume**, cora-train's preset (seed 0) for 100 epochs
     with a checkpoint every 50, then a fresh call resumed to 200, against
     200 straight under deterministic algorithms: every record, the test
     accuracy and every weight bit for bit, with the save and restore
     times; **zinc-train-resume**, zinc-train's config 3 epochs straight
     and 2 then a resume to 3: parameters, BatchNorm state and the
     schedule's lr within 1e-5 (and whether bitwise);
     **synthetic-large-train-resilient**, ``ResilientRunner`` over 8
     large-train steps on 8 node halves with an injected bad batch (fails
     twice, skipped), a transient fault and a raising step, against a
     clean run without the bad batch within 1e-5, its failure records
     printed and checked; **cora-serve-export**,
     **synthetic-large-serve-export**, **synthetic-large-serve-bf16-export**,
     **zinc-serve-export** (the flagship batch, ``min,max``) and
     **zinc-serve-bf16-export** (its bf16 twin): each
     model exported on the card (``mma_tpu_torch.serve``), loaded from the
     bytes and serving 10 requests, every output within 1e-6 of the eager
     forward (bitwise equality printed), the artifact's size, the export
     and load times, and one request served against eager in turns (host
     clock and CUDA events). Then each ``mma_tpu_torch::*`` operator
     (kernel 1 with and without an index, f32 and bf16 rows; kernel 2 with
     f32 and bf16 ``h``; kernels 4, 6 and 8, f32 and bf16) against its
     kernel called directly: bitwise equal, one launch each.

   - The multi-device regimes (``mma_tpu_torch.parallel``). A world of one
     on NCCL in this process, each path bitwise equal to its single-device
     twin under deterministic algorithms and timed beside it in turns:
     **synthetic-large-edge-sharded** (the large-train model's forward and
     3 Adam steps on the one shard with its kernel structure: kernels 1-3),
     **zinc-dp** (3 data-parallel steps of the README preset at the
     flagship batch, dropout on: kernels 1, 6 and 7) and
     **sampled-train-dp** (the sampled-train command line with
     ``--data-parallel``, 3 steps: kernel 1). Then a world of two processes
     sharing the card over gloo (``two_rank_worker``, spawned once after the
     build; the ranks load the kernels), whose paths count per rank:
     **edge-sharded** (synthetic-large's forward and one step on two edge
     shards, within 1e-5 of the single-device forward and gradients:
     kernels 1-3 on each rank), **zinc-dp** (one step on two 1,024-molecule
     micro-batches, the summed gradients within 1e-5 of the two shares
     computed one after the other), **zinc-dp-edge** (the command line's
     ``mean,max,min`` on the flagship batch at data x edge mesh 1 x 2, the
     forward and one step within 1e-5 of the single-device general route:
     kernels 1, 4 and 5) and **sampled-train-dp** (one step on a sampled
     subgraph per rank, the summed gradients within 1e-5 of the shares).
     Replicated results are bitwise equal across the ranks. Two ranks on
     one card measure correctness, not scaling.
   - The node-sharded (halo) regime and the entry points. In the
     world of one: **synthetic-large-node-sharded** (the large-train
     model's forward and 3 Adam steps, dropout off, on the one-shard plan:
     the messages built plainly and summed by kernel 1 over the shard's
     CSRs; forward, losses and step-1 gradients within 1e-5 of the
     single-device twin, timed beside it in turns, with the all-to-all
     traffic), **entry** (``graft_entry.entry()``'s flagship ZincNet
     forward, within 1e-5 of the all-plain run: kernels 6 and 1) and
     **dryrun-multichip** (``dryrun_multichip(1)`` in that world: six
     regimes, (d) needing an even world). Then ``python -m
     mma_tpu_torch.graft_entry`` in its own process (the entry forward and
     ``dryrun_multichip`` over the host's cards in a world it starts). In
     each rank of the two-rank world: **node-sharded-contiguous** and
     **node-sharded-ldg** (synthetic-large on two node shards, the
     contiguous and the LDG order: the forward and one step within 1e-5 of
     the single-device forward and gradients, the plan's host time, halo
     rows and boundary-edge fraction; kernel 1 on each rank) and
     **dryrun-multichip** (``dryrun_multichip(2)``: all seven regimes).

   Each path's launch counts are derived from the code and checked.
3. Checks every output (finite log-probs of the expected shape whose rows
   sum to 1) and holds it against the same computation with every kernel,
   forward and backward, replaced by its plain PyTorch version on the
   card (under PyTorch's deterministic algorithms, so that the reference
   is the same every run): the serving outputs, every parameter gradient
   of one more Cora train step from a trained state (mask dropout on, the
   same draws on both sides; on kernels 2-3 with the keep and on the
   float32 half-fused route, each against the plain step), and every
   parameter gradient of the first
   synthetic-large train step. The first Cora request is also held against
   the plain forward on the CPU, which the CPU tests hold against the JAX
   package. The wide route's output and gradients, in both modes, against
   the lean route, the all-plain computation and each other; the masked
   route's ``S``, ``dlogits``, ``dh_src``, ``dh`` and ``dmask_weights``
   against the all-plain computation, and its ``S``, ``dh`` and
   ``dmask_weights`` against the wide and the lean route's. For ZINC: the
   first request against the all-plain forward on the card and on the
   CPU, one train step of each aggregator set at the flagship batch with
   dropout on (loss, every parameter gradient, the BatchNorm state) on
   both layouts, the PNA model's first eval forward against the CPU on
   both, and the degree-exact layout against the CSR route on the plain
   collate without dropout (per-graph predictions and every parameter
   gradient; serving's first request too). The host-clock medians of
   the exact and CSR requests and steps print side by side, the README
   preset's train step timed on both layouts in turns. For the sampled
   paths: the native library built; the device-finished graph equal to
   the host-built one field for field (both layouts) with full-graph
   degrees; one train step per route (lean with the keep, lean, ELL) on one batch
   against the all-plain step (loss, log-probs, every gradient at 1e-5);
   the ELL route's predictions against the CSR route's on a hopped batch
   (dropout off, 1e-5); hole rows moving no seed output and taking no
   gradient; per phase the step's host-clock and CUDA-event medians, the
   pipeline time a batch, both sampled-edges/s rates and the calibrated
   pads; a profiled step per route; the host sampling time a batch. For
   the bf16 paths: each serving output against the f32 one at the stated
   bf16-level tolerance (``BF16_SERVE_TOL``) and against the all-plain bf16
   forward at 1e-5; one bf16 train step per route (synthetic-large's lean
   route, Cora's and the sampled half-fused route, the sampled lean and ELL
   routes) against the all-plain bf16 step: loss and log-probs at 1e-5,
   every gradient at ``BF16_GRAD_TOL`` (2^-8, bf16's resolution: the
   pipeline rounds the backward's float32 sums to bf16, so sums in another
   order may round to neighbouring values); the host-clock and CUDA-event
   medians beside the f32 ones. For ZINC in bf16: the served predictions
   against the f32 ones (``BF16_ZINC_SERVE_TOL``) and the all-plain bf16
   forward (1e-5); one bf16 train step of each route (fused, general,
   PNA, ELL; dropout on) against the all-plain bf16 step, loss at 1e-5 and
   gradients at ``BF16_GRAD_TOL``; the f32 and bf16 steps of each route
   and the serve request timed in turns.
4. Per kernel, at the shapes of the main paths (kernels 1-3 and 9-12 at
   synthetic-large, kernel 1 at the widths of both products, C=64 and
   C=16, and of the wide payload, C=192, and also its heaviest row alone at
   C=64, Cora's spmm forward at C=64 and C=7, and the node-sharded path's
   interior and boundary sums of each of two shards at C=64 and C=128; kernel 2 also as its node
   pass and edge pass alone, its heaviest row alone (as a whole call and
   through the edge pass alone) and at Cora's shape; kernel 3 also as its
   four parts alone (``D``, the dst pass, the src pass, the node pass),
   each edge pass on its heaviest row alone and at Cora's shape; kernels 9
   and 10, both payload modes, also on the heaviest row alone as a whole
   call, and kernel 11 on the heaviest source alone as a whole call;
   kernels 4-8 on the tensors the
   ZINC train steps gave them at the flagship batch, 4-7 for one and two
   ops, with dropout on and off): the
   error against the plain version (kernels 4 and 6, and the routed
   gradients of 5 and 7, must be equal to it), run-to-run equality, the
   kernel's median time, the plain version's time, the time of one
   PyTorch library call for the same function where there is one, and the
   least time the card could take (``bound_ms``). The bf16 variants of
   kernels 2 and 3 with mask dropout's keep the same way, as entries of
   their own (``edge_program_lean_keep``, ``..._keep_bwd``), on the
   arguments, keep and cotangent of a step of the large-train model with
   mask dropout 0.75 (node-large-train's route), each with the keep-free
   kernel's time on the same values in turns, its keep-aware edge passes
   alone and the keep's draw and compare. The bf16 variants of
   kernels 1, 2 and 3 the same way, as entries of their own, on the bf16
   paths' tensors at synthetic-large (kernel 1 at the SpMM widths C=64 and
   16, the half-fused messages and their gathers' VJP at C=128), each
   with the f32 kernel's time on the same values in turns, and bounds on
   the bytes of their bf16 inputs; the bf16 variants of kernels 4-8 the
   same way on the tensors the bf16 ZINC steps gave them at the flagship
   batch (4-6 and the routed gradients equal to the plain versions); the
   bf16 variants of kernels 9, 10 (with and without the payload) and 11
   on large-wide-bf16's edge-program arguments and kernel 12 on
   large-masked-bf16's bf16 logits and rows, the same way.
5. Prints one ``kernels`` JSON line, the ``nvidia-smi`` line again, and as
   the last line ``{"ok": true, "device": {...}}``.

The per-epoch training logs go to ``artifacts/chip_smoke_train.log``,
``artifacts/chip_smoke_train_bf16.log``,
``artifacts/chip_smoke_train_resume.log`` and
``artifacts/chip_smoke_zinc_train*.log`` (``_bf16`` for zinc-train-bf16), the
sampled command line's to
``artifacts/chip_smoke_sampled.log``.
Any failed check raises, so the script exits non-zero and prints no
result; so does a host without a GPU, or a directory without the port.
"""

from __future__ import annotations

import contextlib
import copy
import dataclasses
import functools
import io
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

import numpy as np  # noqa: E402
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
# The same in bf16: the JAX package on the CPU gave 0.2073, 0.2189, 0.2078,
# 0.2670 for these seeds (the command above with --compute-dtype bfloat16),
# mean 0.2253, sd 0.0283: the band is the mean ± 3 sd.
ZINC_BF16_VAL_MAE_BAND = (0.1402, 0.3103)
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
            scale: float = None, verbose: bool = True, slack: float = 0.0) -> dict:
    """``|got - want| <= rel * (|want| + scale) + slack``, ``scale`` the
    largest ``|want|`` unless given: a relative bound per element with a
    floor scaled to the tensor, since f32 sums taken in another order
    differ by a few ulps of their largest partial sums. ``slack`` is an
    absolute allowance for ill-conditioned gradients (std's); the reported
    ``max_rel_err`` is of the excess over it."""
    got, want = got.double(), want.double()
    if scale is None:
        scale = want.abs().max().item()
    diff = (got - want).abs()
    max_abs = diff.max().item()
    over = (diff - slack).clamp(min=0.0)
    # An all-zero reference (the detached pre-NNs' gradients) must be met exactly.
    max_rel = 0.0 if not over.any() else (over / (want.abs() + scale)).max().item()
    if verbose:
        print(f"{what}: max_abs_err {max_abs:.3e} max_rel_err {max_rel:.3e} "
              f"(scale {scale:.3e}, tolerance {rel:g}, slack {slack:.3e})")
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
    try:
        with deterministic():
            yield
    finally:
        for mod, launcher, fn in saved:
            setattr(mod, launcher, fn)


@contextlib.contextmanager
def deterministic():
    """Run the block under ``torch.use_deterministic_algorithms(True)``."""
    before = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(before)


@contextlib.contextmanager
def timed(module, name: str, times: list):
    """Wrap ``module.<name>`` so that each call appends its host-clock
    milliseconds to ``times``."""
    real = getattr(module, name)

    def wrapper(*args, **kwargs):
        t0 = time.perf_counter()
        try:
            return real(*args, **kwargs)
        finally:
            times.append((time.perf_counter() - t0) * 1e3)

    setattr(module, name, wrapper)
    try:
        yield
    finally:
        setattr(module, name, real)


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


def host_ms(fn, n: int = 3) -> list:
    """Host-clock times (ms) of ``n`` calls of ``fn``, each ended by a sync."""
    times = []
    for _ in range(n):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return times


def grads_of(model) -> dict:
    return {n_: p.grad.clone() for n_, p in model.named_parameters() if p.grad is not None}


def zinc_flagship(dev):
    """``(batch, exact, avg)``: the flagship batch on both layouts and the
    degree statistics of its molecules."""
    from mma_tpu_torch.data import load_zinc
    from mma_tpu_torch.data.batching import degree_budgets
    from mma_tpu_torch.nn import mma_conv

    # The flagship batch: the first 1,024 train molecules, padded to the
    # next 1,024 nodes and edges as bench.py:654-667 pads them.
    ds = load_zinc("train", subset_size=1024)
    n_need = int(ds.num_nodes.sum()) + 1
    e_need = int(sum(len(s_) for s_ in ds.edge_src))
    batch = next(ds.batches(1024, n_node=-(-n_need // 1024) * 1024,
                            n_edge=-(-e_need // 1024) * 1024, device=dev))
    g = batch.graph
    # The same molecules in the degree-exact layout, budgeted and padded as
    # the JAX package's zero-config production batch (bench.py:671-680).
    budgets, zero_worst = degree_budgets([int(n_) for n_ in ds.num_nodes], ds.edge_src,
                                         ds.edge_dst, 1024, margin=0.0, include_zero=True)
    rows = sum(budgets) + zero_worst + 1
    slots = sum(b * (i + 1) for i, b in enumerate(budgets))
    exact = next(ds.batches(1024, n_node=max(-(-n_need // 1024) * 1024, -(-rows // 1024) * 1024),
                            n_edge=max(-(-e_need // 1024) * 1024, -(-slots // 1024) * 1024),
                            ell_degree_budgets=budgets, device=dev))
    if not (exact.graph.ell_exact and exact.graph.csc_ell_exact):
        raise AssertionError("the degree-exact flagship batch is not csc_ell_exact")
    print(f"zinc flagship batch: 1024 molecules, {int(g.num_nodes)} nodes (padded {g.n_node}), "
          f"{int(g.num_edges)} edges (padded {g.n_edge}), max in-degree {int(g.deg.max())}; "
          f"degree-exact: budgets {budgets}, {exact.graph.n_node} rows, "
          f"{exact.graph.n_edge} edge slots")
    return batch, exact, mma_conv.compute_avg_deg(ds.degree_histogram(), parity=True)


def run_zinc(dev, paths: dict):
    """The ZINC main paths on both layouts, their checks and the per-kernel
    holds of kernels 4-8; returns the kernels' JSON entries (without
    ``launches``) and the flagship batches, degree statistics and training
    splits for :func:`run_zinc_bf16`."""
    from mma_tpu_torch.data import load_zinc
    from mma_tpu_torch.models import ZincNet
    from mma_tpu_torch.nn import mma_conv
    from mma_tpu_torch.ops.cuda import fused_mma
    from mma_tpu_torch.ops.cuda import segment_minmax as mm
    from mma_tpu_torch.train import ZincConfig, make_optimizer, train_zinc
    from mma_tpu_torch.train.loops import l1_loss, zinc_layout, zinc_train_step

    batch, exact, avg = zinc_flagship(dev)
    g = batch.graph
    layers = 4

    def model_of(aggs_scalers, seed, device=dev):
        aggs, scalers = aggs_scalers
        return ZincNet(aggs, scalers, avg, num_layers=layers, device=device,
                       generator=torch.Generator().manual_seed(seed))

    # ------------------------- main paths: zinc-serve and zinc-exact-serve
    model = model_of(ZINC_PRESET_AGGS, SEED)
    served = {}
    for path, b in (("zinc-serve", batch), ("zinc-exact-serve", exact)):
        outs = []
        with counted(path, paths), torch.no_grad():
            serve_ms = host_ms(lambda: outs.append(model(b)))
        served[path] = (outs, serve_ms)
        print(f"{path}: 3 requests (host clock) {serve_ms} ms; median "
              f"{statistics.median(serve_ms):.4f} ms = "
              f"{layers * int(g.num_edges) / (statistics.median(serve_ms) * 1e-3):.4e} "
              "edge-visits/s")
    # Per forward on the plain collate: kernel 6 once per conv layer, kernel
    # 1 once (pooling). On the degree-exact batch the slot reductions are
    # plain PyTorch and kernel 1 runs once (the pool, index form).
    expect_launches(paths, "zinc-serve", minmax_prog=3 * layers, segment_sum=3)
    expect_launches(paths, "zinc-exact-serve", segment_sum=3)
    print("zinc serve medians (host clock): exact "
          f"{statistics.median(served['zinc-exact-serve'][1]):.4f} ms, CSR "
          f"{statistics.median(served['zinc-serve'][1]):.4f} ms")
    with torch.no_grad():
        for path, b in (("zinc-serve", batch), ("zinc-exact-serve", exact)):
            outs = served[path][0]
            for i, out in enumerate(outs):
                if tuple(out.shape) != (1024,) or not torch.isfinite(out).all():
                    raise AssertionError(f"{path} request {i}: shape {tuple(out.shape)} or "
                                         "non-finite predictions")
                if not torch.equal(out, outs[0]):
                    raise AssertionError(f"{path} request {i} differs from request 0")
            before = launches()
            with plain_kernels():
                plain_out = model(b)
            if launches() != before:
                raise AssertionError("the plain ZINC forward launched a kernel")
            compare(outs[0], plain_out, 1e-5, f"{path} request 0 vs plain on the card")
            cpu_model = model_of(ZINC_PRESET_AGGS, SEED, device="cpu")
            cpu_model.load_state_dict({k: v.cpu() for k, v in model.state_dict().items()})
            compare(outs[0].cpu(), cpu_model(b.to("cpu")), 1e-5,
                    f"{path} request 0 vs plain on the CPU")
        compare(served["zinc-exact-serve"][0][0], served["zinc-serve"][0][0], 1e-5,
                "zinc-exact-serve request 0 vs the CSR route on the plain collate")
    del model, cpu_model, served

    # ------------------------------------------------- main path: zinc-train
    # train_zinc on the layout batch_layout="auto" resolves to, 4 seeds; one
    # seed on the other layout, held to the same band.
    aggs, scalers = ZINC_PRESET_AGGS
    cfg0 = ZincConfig(aggregators=aggs, scalers=scalers, lr=1e-4, weight_decay=3e-4,
                      batch_size=64, epochs=5, subset_size=2000)
    splits = {s: load_zinc(s, subset_size=cfg0.subset_size) for s in ("train", "val", "test")}
    auto_exact = zinc_layout(cfg0, list(splits.values()))[2] is not None
    other = dataclasses.replace(cfg0, batch_layout="plain" if auto_exact else "degree_exact")
    steps = -(-len(splits["train"]) // cfg0.batch_size)
    evals = sum(-(-len(splits[s]) // cfg0.batch_size) for s in ("val", "test"))
    epoch_ms = {}
    for path, cfg, seeds, exact_layout in (
            ("zinc-train", cfg0, ZINC_SEEDS, auto_exact),
            ("zinc-train-exact" if not auto_exact else "zinc-train-plain", other, ZINC_SEEDS[:1],
             not auto_exact)):
        results = {}
        with counted(path, paths), \
                open(os.path.join(LOG_DIR, f"chip_smoke_{path.replace('-', '_')}.log"),
                     "w") as log, contextlib.redirect_stdout(log):
            for seed in seeds:
                results[seed] = train_zinc(dataclasses.replace(cfg, seed=seed), datasets=splits,
                                           device=dev)
        val = [results[s_]["val_mae"] for s_ in seeds]
        epoch_s = [r["time"] for s_ in seeds for r in results[s_]["history"][1:]]
        epoch_ms[path] = statistics.median(epoch_s) * 1e3
        mean_val = statistics.mean(val)
        layout = "degree-exact" if exact_layout else "plain"
        print(f"{path} ({layout} layout): val MAE per seed "
              + ", ".join(f"{s_}: {v:.4f}" for s_, v in zip(seeds, val))
              + "; test MAE " + ", ".join(f"{results[s_]['test_mae']:.4f}" for s_ in seeds)
              + f"; mean val {mean_val:.4f} (band {ZINC_VAL_MAE_BAND}); median epoch "
              f"{epoch_ms[path]:.3f} ms (host clock, train steps + val/test eval, epochs "
              f"2-{cfg.epochs})")
        runs = len(seeds) * cfg.epochs
        if exact_layout:
            # Per train step and per eval forward: kernel 1 once (the pool).
            expect_launches(paths, path, segment_sum=runs * (steps + evals))
        else:
            # Per train step: kernel 6 and kernel 7 once per layer, kernel 1
            # once per layer (the gather_by_src VJP) and once for the
            # pooling; per eval forward kernel 6 once per layer and kernel 1
            # once.
            expect_launches(paths, path, minmax_prog=runs * layers * (steps + evals),
                            minmax_prog_bwd=runs * layers * steps,
                            segment_sum=runs * (steps * (layers + 1) + evals))
        if not ZINC_VAL_MAE_BAND[0] <= mean_val <= ZINC_VAL_MAE_BAND[1]:
            raise AssertionError(f"{path}: mean val MAE {mean_val:.4f} outside "
                                 f"{ZINC_VAL_MAE_BAND}")
        del results
    print("zinc-train median epoch (host clock): " + ", ".join(
        f"{p_} {v:.3f} ms" for p_, v in epoch_ms.items()))

    # --------------- main paths: zinc-[exact-]train-default, -pna on both
    # The command line's defaults: mean,max,min with
    # identity,amplification,attenuation, lr 0.01, weight decay 5e-4; and
    # the PNA set with the command line's other defaults.
    step_ms = {}
    for name, aggs_scalers, seed in (("default", ZINC_DEFAULT_AGGS, SEED + 5),
                                     ("pna", ZINC_PNA_AGGS, SEED + 9)):
        for path, b in ((f"zinc-train-{name}", batch), (f"zinc-exact-train-{name}", exact)):
            m = model_of(aggs_scalers, seed)
            opt = make_optimizer(m.parameters(), 0.01, 5e-4)
            gen = torch.Generator(device=dev).manual_seed(SEED)
            losses = []
            with counted(path, paths):
                step_ms[path] = host_ms(
                    lambda: losses.append(float(zinc_train_step(m, opt, b, gen))))
            print(f"{path}: losses {losses}; step times (host clock) {step_ms[path]} ms; "
                  f"median {statistics.median(step_ms[path]):.4f} ms")
            if not all(math.isfinite(v) for v in losses):
                raise AssertionError(f"{path}: non-finite loss {losses}")
            if name == "pna":
                with torch.no_grad():
                    ev = m(b)
                    if tuple(ev.shape) != (1024,) or not torch.isfinite(ev).all():
                        raise AssertionError(f"{path} eval forward: bad shape or non-finite")
                    cpu_model = model_of(aggs_scalers, seed, device="cpu")
                    cpu_model.load_state_dict({k: v.cpu() for k, v in m.state_dict().items()})
                    compare(ev.cpu(), cpu_model(b.to("cpu")), 1e-5,
                            f"{path} eval forward vs plain on the CPU")
                del cpu_model
            del m, opt
        print(f"zinc {name} step medians (host clock): exact "
              f"{statistics.median(step_ms[f'zinc-exact-train-{name}']):.4f} ms, CSR "
              f"{statistics.median(step_ms[f'zinc-train-{name}']):.4f} ms")
    # Per step and layer on the plain collate: forward kernel 4 once (max and
    # min paired) and kernel 1 once (mean), with std kernel 8 once; backward
    # kernel 5 once and kernel 1 twice (the gather VJPs by dst and by src;
    # the mean's and kernel 8's VJPs are plain gathers); kernel 1 once more
    # for the pooling. On the degree-exact batch: kernel 1 once a step (the
    # pool); gather_by_src's VJP is lane sums there (csc_ell_exact).
    expect_launches(paths, "zinc-train-default", segment_minmax=3 * layers,
                    segment_minmax_bwd=3 * layers, segment_sum=3 * (3 * layers + 1))
    expect_launches(paths, "zinc-train-pna", segment_minmax=3 * layers,
                    segment_minmax_bwd=3 * layers, segment_sum=3 * (3 * layers + 1),
                    segment_sum_sq=3 * layers)
    for name in ("default", "pna"):
        expect_launches(paths, f"zinc-exact-train-{name}", segment_sum=3)

    # ----------------------- one train step of each aggregator set vs plain
    captured = {}
    for aggs_scalers, site in ((ZINC_PRESET_AGGS, "fused_minmax_edge_program"),
                               (ZINC_DEFAULT_AGGS, "fused_segment_minmax"),
                               (ZINC_PNA_AGGS, "segment_sum_sq_csr")):
        for layout, b in (("plain collate", batch), ("degree-exact", exact)):
            steps_out = []
            for plain in (False, True):
                m = model_of(aggs_scalers, SEED + 7)
                opt = make_optimizer(m.parameters(), 1e-4, 3e-4)

                def step():
                    with plain_kernels() if plain else contextlib.nullcontext():
                        loss = zinc_train_step(m, opt, b,
                                               torch.Generator(device=dev).manual_seed(SEED))
                    steps_out.append((float(loss), grads_of(m),
                                      {n_: b_.clone() for n_, b_ in m.named_buffers()}))

                if plain or layout != "plain collate":
                    step()
                else:
                    captured[site] = capture_call(mma_conv, site, step)
            (loss_k, grads_k, bufs_k), (loss_p, grads_p, bufs_p) = steps_out
            what = f"zinc {','.join(aggs_scalers[0])} step, {layout} (dropout on)"
            compare(torch.tensor([loss_k]), torch.tensor([loss_p]), 1e-5,
                    f"{what} loss vs plain")
            for kind, got, want in (("gradients", grads_k, grads_p),
                                    ("BatchNorm buffers", bufs_k, bufs_p)):
                errs = {name: compare(t, want[name], 1e-5, f"{what} {name} vs plain",
                                      scale=bn_fed_scale(name, want) if kind == "gradients"
                                      else None, verbose=False)
                        for name, t in got.items()}
                worst = max(errs, key=lambda k: errs[k]["max_rel_err"])
                print(f"{what}: {len(errs)} {kind} vs plain on the card, max_rel_err "
                      f"{errs[worst]['max_rel_err']:.3e} ({worst}; tolerance 1e-05), "
                      f"max_abs_err {max(e['max_abs_err'] for e in errs.values()):.3e}")

    # ------------- the degree-exact layout vs the CSR route, dropout off
    # The same weights and molecules, a training forward (batch statistics)
    # without dropout: per-graph predictions within 1e-5, and every
    # parameter gradient within 1e-5 plus four times the CSR run's own
    # change when the node embedding table moves by one ulp either way, the
    # allowance of tests/test_torch_zinc_net.py. The layouts sum the
    # BatchNorm statistics and the products in other orders, so their
    # values differ by ulps; std's derivative amplifies the rounding of
    # E[x²] − E[x]², and min/max's first-hit gradient jumps where an ulp
    # flips a near-tie (at 96 molecules on the CPU a one-ulp nudge moved
    # min,max gradients by 2e-3 of their largest, as much as the layout).
    def layout_run(aggs_scalers, b, nudge=0.0):
        m = model_of(aggs_scalers, SEED + 11)
        if nudge:
            with torch.no_grad():
                m.node_emb.table.copy_(torch.nextafter(m.node_emb.table,
                                                       torch.tensor(nudge, device=dev)))
        pred = m(b, training=True)
        l1_loss(pred, b).backward()
        return pred.detach(), grads_of(m)

    for aggs_scalers in (ZINC_PRESET_AGGS, ZINC_DEFAULT_AGGS, ZINC_PNA_AGGS):
        what = f"zinc {','.join(aggs_scalers[0])} degree-exact vs CSR route (dropout off)"
        pred_e, grads_e = layout_run(aggs_scalers, exact)
        pred_c, grads_c = layout_run(aggs_scalers, batch)
        slack = {n_: 0.0 for n_ in grads_c}
        for nudge in (math.inf, -math.inf):
            nudged = layout_run(aggs_scalers, batch, nudge)[1]
            slack = {n_: max(v, 4 * (grads_c[n_] - nudged[n_]).abs().max().item())
                     for n_, v in slack.items()}
        compare(pred_e, pred_c, 1e-5, f"{what}: predictions")
        if set(grads_e) != set(grads_c):
            raise AssertionError(f"{what}: gradients of {sorted(set(grads_c) ^ set(grads_e))} "
                                 "on one layout only")
        errs = {name: compare(t, grads_c[name], 1e-5, f"{what} {name}",
                              scale=bn_fed_scale(name, grads_c), slack=slack[name],
                              verbose=False)
                for name, t in grads_e.items()}
        worst = max(errs, key=lambda k: errs[k]["max_rel_err"])
        loose = max(slack, key=slack.get)
        print(f"{what}: {len(errs)} gradients, max_rel_err beyond the allowance "
              f"{errs[worst]['max_rel_err']:.3e} ({worst}; tolerance 1e-05); largest "
              f"difference {max(e['max_abs_err'] for e in errs.values()):.3e}; largest "
              f"allowance {slack[loose]:.3e} ({loose}, of max "
              f"{grads_c[loose].abs().max().item():.3e})")

    # The README preset's train step (dropout on) on both layouts, turn by
    # turn: the step that batch_layout="auto" decides between.
    preset_ms = {"exact": [], "CSR": []}
    models = {k: model_of(ZINC_PRESET_AGGS, SEED + 13) for k in preset_ms}
    opts = {k: make_optimizer(m_.parameters(), 1e-4, 3e-4) for k, m_ in models.items()}
    gens = {k: torch.Generator(device=dev).manual_seed(SEED) for k in preset_ms}
    for k, b in (("CSR", batch), ("exact", exact)):
        zinc_train_step(models[k], opts[k], b, gens[k])  # warm-up
    for _ in range(5):
        for k, b in (("exact", exact), ("CSR", batch), ("CSR", batch), ("exact", exact)):
            preset_ms[k] += host_ms(lambda: zinc_train_step(models[k], opts[k], b, gens[k]), 1)
    print("zinc min,max train step medians (host clock, 10 each, in turns): exact "
          f"{statistics.median(preset_ms['exact']):.4f} ms, CSR "
          f"{statistics.median(preset_ms['CSR']):.4f} ms")
    del models, opts

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
        shape = (f"E={e_cov} N={n_rows} C={ch} ops={','.join(ops_p)} dropout on (library: "
                 "scatter_reduce_ amax plus amin over the pre-built message)")
        prog_msg = mm._messages(c, hg, rp, seed, rate)[0]
        prog_ids = mm._row_ids(rp)[:, None].expand(e_cov, ch)

        def prog_library():
            return [torch.zeros(n_rows, ch, device=dev).scatter_reduce_(
                0, prog_ids, prog_msg, "amax" if op == "max" else "amin", include_self=False)
                for op in ops_p]

        # Operations per edge and lane: the add, the mask product and one
        # compare per op (the hash's integer operations not counted).
        record("minmax_prog", 0.0,
               device_ms(lambda: mm.minmax_edge_program(c, hg, rp, ops_p, seed, rate)),
               device_ms(lambda: mm.minmax_edge_program_reference(c, hg, rp, ops_p, seed, rate),
                         iters=10),
               4 * (e_cov * ch + n_rows * ch + (n_rows + 1) + 1 + n_rows * p * ch),
               e_cov * ch * (2 + p), device_ms(prog_library), shape)
        del prog_msg, prog_ids
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
    return kernels, {"batch": batch, "exact": exact, "avg": avg, "splits": splits}


def device_turns(run_base, run_other, iters: int = 25):
    """Median device times of two runs on the same values (the f32 and the
    bf16 kernel, or a kernel without and with the keep), taken in turns
    (base, other, other, base): ``(other_ms, base_ms)``."""
    t = {"base": [], "other": []}
    for which in ("base", "other", "other", "base"):
        t[which].append(device_ms(run_base if which == "base" else run_other, iters=iters))
    return statistics.median(t["other"]), statistics.median(t["base"])


def keep_kernel_entries(dev, big, x_big, model, labels, idx_train) -> dict:
    """Kernels 2 and 3 with mask dropout's keep at synthetic-large, on the
    edge program's arguments, keep and cotangent of one step of ``model``'s
    weights with mask dropout 0.75 (node-large-train's route): the
    forward, ``dc``, ``dW_bot`` and ``dh`` held against their plain
    versions (1e-5) and run to run (bitwise), each call timed beside the
    keep-free kernel on the same values in turns (without, with, with,
    without), with its keep-aware edge passes alone and the keep's draw
    and compare; bounds count the keep's bytes once."""
    from mma_tpu_torch.models import NodeClassifier
    from mma_tpu_torch.ops import masked_aggregate
    from mma_tpu_torch.ops.cuda import fused_mma

    rate = 0.75
    drop = NodeClassifier(64, 64, 16, ("mean", "mean2"), dropout_rate=rate, device=dev)
    drop.load_state_dict(model.state_dict())
    step_gen = torch.Generator(device=dev).manual_seed(SEED + 7)

    def one_step():
        with torch.enable_grad():
            o = drop(x_big, big, training=True, generator=step_gen)
            (-o[idx_train, labels[idx_train]].mean()).backward()

    args, kw, ct = capture_call(masked_aggregate, "edge_program_lean", one_step)
    if kw.get("keep") is None or kw.get("rate") != rate:
        raise AssertionError(f"a dropout-{rate} step gave kernel 2 no keep: {sorted(kw)}")
    c, w_bot, h, pat, src, rp, cp, dst_csc = (t.detach() for t in args)
    keep, src_perm = kw["keep"], kw["src_perm"]
    kw = {"keep": keep, "rate": rate, "src_perm": src_perm}
    f, kf = w_bot.shape
    e_cov, n_rows = int(rp[-1]), big.n_node
    shape = f"E={e_cov} N={n_rows} F={f} K·F={kf}, keep {tuple(keep.shape)} at rate {rate}"
    out = {}

    # ------------------------------------------------------------ kernel 2
    fwd_args = (c, w_bot, h, pat, src, rp)
    got = fused_mma.edge_program_lean(*fwd_args, cp, dst_csc, **kw)
    if not torch.equal(got, fused_mma.edge_program_lean(*fwd_args, cp, dst_csc, **kw)):
        raise AssertionError("edge_program_lean_keep differs run to run")
    err = compare(got, fused_mma.edge_program_lean_reference(*fwd_args, keep, rate), 1e-5,
                  "edge_program_lean_keep vs plain")
    ms, free_ms = device_turns(lambda: fused_mma.edge_program_lean(*fwd_args, cp, dst_csc),
                             lambda: fused_mma.edge_program_lean(*fwd_args, cp, dst_csc, **kw))
    plain_ms = device_ms(lambda: fused_mma.edge_program_lean_reference(*fwd_args, keep, rate),
                         iters=5)
    # Kernel 2's bytes and work (its entry), and the keep read once: a
    # byte a lane of the covered edges.
    nbytes = (4 * (n_rows * kf + n_rows * f + f * kf + kf + e_cov + (n_rows + 1) + n_rows * kf)
              + e_cov * kf)
    k2 = out["edge_program_lean_keep"] = {
        "name": "edge_program_lean_keep", "route": "cuda", "source": SOURCE,
        "replaces": REPLACES["edge_program_lean_fwd"], "max_abs_err": err["max_abs_err"],
        "ms": ms, "plain_ms": plain_ms, **bound(nbytes, 2 * n_rows * f * kf + 3 * e_cov * kf),
        "library_ms": None, "keep_free_ms": free_ms,
        "gather_bound_ms": 4 * e_cov * (kf + f) / PEAK_BYTES_PER_S * 1e3, "shape": shape}
    scale = fused_mma._keep_scale(rate)
    d_tab = fused_mma._lean_node_pass(h, w_bot)
    k2["edge_pass_ms"] = device_ms(
        lambda: fused_mma._lean_edge_pass(c, pat, d_tab, h, src, rp, keep, scale))
    draw_gen = torch.Generator(device=dev).manual_seed(SEED)
    k2["draw_ms"] = device_ms(
        lambda: torch.rand(tuple(keep.shape), generator=draw_gen, device=dev) >= rate)
    print(f"edge_program_lean_keep: ms {ms:.4f} (without the keep {free_ms:.4f}, in turns) "
          f"plain_ms {plain_ms:.4f} bound_ms {k2['bound_ms']:.4f} ({k2['bound_by']}); edge "
          f"pass {k2['edge_pass_ms']:.4f} ms; the keep's draw and compare "
          f"{k2['draw_ms']:.4f} ms; bitwise equal run to run; {shape}")

    # ------------------------------------------------------------ kernel 3
    bwd_args = fwd_args + (cp, dst_csc, ct.contiguous())
    got = fused_mma.edge_program_lean_bwd(*bwd_args, **kw)
    again = fused_mma.edge_program_lean_bwd(*bwd_args, **kw)
    if not all(torch.equal(a, b) for a, b in zip(got, again)):
        raise AssertionError("edge_program_lean_keep_bwd differs run to run")
    want = fused_mma.edge_program_lean_bwd_reference(*bwd_args, keep, rate)
    errs = [compare(g, w, 1e-5, f"edge_program_lean_keep_bwd {name} vs plain")
            for g, w, name in zip(got, want, ("dc", "dW_bot", "dh"))]
    del got, again, want
    ms, free_ms = device_turns(lambda: fused_mma.edge_program_lean_bwd(*bwd_args),
                             lambda: fused_mma.edge_program_lean_bwd(*bwd_args, **kw), iters=15)
    plain_ms = device_ms(lambda: fused_mma.edge_program_lean_bwd_reference(*bwd_args, keep, rate),
                         iters=5)
    # Kernel 3's bytes and work (its entry), the keep read once and
    # src_perm; the keep's two reads, one per edge pass, apart.
    nbytes = (4 * (3 * n_rows * kf + 2 * n_rows * f + 2 * f * kf + kf + 2 * e_cov
                   + 2 * (n_rows + 1) + e_cov) + e_cov * kf)
    k3 = out["edge_program_lean_keep_bwd"] = {
        "name": "edge_program_lean_keep_bwd", "route": "cuda", "source": SOURCE,
        "replaces": REPLACES["edge_program_lean_bwd"],
        "max_abs_err": max(e["max_abs_err"] for e in errs), "ms": ms, "plain_ms": plain_ms,
        **bound(nbytes, 6 * n_rows * f * kf + 10 * e_cov * kf), "library_ms": None,
        "keep_free_ms": free_ms,
        "gather_bound_ms": 4 * e_cov * (kf + f + 2 * kf) / PEAK_BYTES_PER_S * 1e3,
        "keep_reads_bound_ms": 2 * e_cov * kf / PEAK_BYTES_PER_S * 1e3, "shape": shape}
    ct3 = bwd_args[-1]
    k3["dst_pass_ms"] = device_ms(lambda: fused_mma._lean_bwd_dst_pass(
        c, ct3, pat, d_tab, h, src, rp, keep=keep, scale=scale))
    k3["src_pass_ms"] = device_ms(lambda: fused_mma._lean_bwd_src_pass(
        c, ct3, pat, d_tab, h, dst_csc, cp, keep=keep, src_perm=src_perm, scale=scale))
    print(f"edge_program_lean_keep_bwd: ms {ms:.4f} (without the keep {free_ms:.4f}, in turns) "
          f"plain_ms {plain_ms:.4f} bound_ms {k3['bound_ms']:.4f} ({k3['bound_by']}); dst pass "
          f"{k3['dst_pass_ms']:.4f} ms, src pass {k3['src_pass_ms']:.4f} ms; the keep's two "
          f"reads alone {k3['keep_reads_bound_ms']:.4f} ms; dc, dW_bot and dh bitwise equal run "
          "to run")
    return out


# The bf16 ZINC predictions against the f32 ones (the same weights and
# molecules): relative to the largest |prediction|, a few bf16 ulps of the
# values the two pipelines round apart.
BF16_ZINC_SERVE_TOL = 3e-2


def run_zinc_bf16(dev, paths: dict, ctx: dict) -> dict:
    """The ZINC main paths in bf16 (``compute_dtype="bfloat16"``) at the
    flagship width: zinc-serve-bf16 (the README preset's eval forward on
    the flagship batch: kernel 6 in bf16), zinc-train-bf16 (``train_zinc``
    at the README preset, 4 seeds, held to ``ZINC_BF16_VAL_MAE_BAND``),
    zinc-train-default-bf16 (kernels 1, 4 and 5 in bf16),
    zinc-train-pna-bf16 (and kernel 8) and zinc-exact-train-default-bf16
    (the ELL route), with their launch counts, holds and times beside the
    f32 twins'; returns the JSON entries of the bf16 variants of kernels
    4-8 (without ``launches``)."""
    from mma_tpu_torch.models import ZincNet
    from mma_tpu_torch.nn import mma_conv
    from mma_tpu_torch.ops.cuda import fused_mma
    from mma_tpu_torch.ops.cuda import segment_minmax as mm
    from mma_tpu_torch.train import ZincConfig, make_optimizer, train_zinc
    from mma_tpu_torch.train.loops import zinc_layout, zinc_train_step

    batch, exact, avg, splits = ctx["batch"], ctx["exact"], ctx["avg"], ctx["splits"]
    g = batch.graph
    layers = 4

    def model_of(aggs_scalers, seed, dtype="bfloat16"):
        aggs, scalers = aggs_scalers
        return ZincNet(aggs, scalers, avg, num_layers=layers, compute_dtype=dtype, device=dev,
                       generator=torch.Generator().manual_seed(seed))

    # ------------------------------------------- main path: zinc-serve-bf16
    # zinc-serve's model (the same seed, so the same weights) in bf16.
    model, model32 = model_of(ZINC_PRESET_AGGS, SEED), model_of(ZINC_PRESET_AGGS, SEED, "float32")
    outs = []
    with counted("zinc-serve-bf16", paths), torch.no_grad():
        serve_ms = host_ms(lambda: outs.append(model(batch)))
    # Per forward: kernel 6 in bf16 once per conv layer; kernel 1 once on the
    # float32 node rows (pooling).
    expect_launches(paths, "zinc-serve-bf16", minmax_prog_bf16=3 * layers, segment_sum=3)
    with torch.no_grad():
        for i, out in enumerate(outs):
            if tuple(out.shape) != (1024,) or out.dtype != torch.float32 \
                    or not torch.isfinite(out).all():
                raise AssertionError(f"zinc-serve-bf16 request {i}: shape {tuple(out.shape)}, "
                                     f"dtype {out.dtype} or non-finite predictions")
            if not torch.equal(out, outs[0]):
                raise AssertionError(f"zinc-serve-bf16 request {i} differs from request 0")
        compare(outs[0], model32(batch), BF16_ZINC_SERVE_TOL,
                "zinc-serve-bf16 request 0 vs the f32 request")
        before = launches()
        with plain_kernels():
            plain_out = model(batch)
        if launches() != before:
            raise AssertionError("the plain bf16 ZINC forward launched a kernel")
        compare(outs[0], plain_out, 1e-5, "zinc-serve-bf16 request 0 vs plain on the card")
        t = {"f32": [], "bf16": []}
        ev = {"f32": [], "bf16": []}
        for dtype in ("f32", "bf16", "bf16", "f32"):
            m_ = model if dtype == "bf16" else model32
            t[dtype] += host_ms(lambda: m_(batch), 5)
            ev[dtype].append(device_ms(lambda: m_(batch), iters=5))
    print(f"zinc-serve-bf16: 3 requests (host clock) {serve_ms} ms; one request (host clock / "
          f"CUDA events, medians, in turns): bf16 {statistics.median(t['bf16']):.4f} / "
          f"{statistics.median(ev['bf16']):.4f} ms, f32 {statistics.median(t['f32']):.4f} / "
          f"{statistics.median(ev['f32']):.4f} ms")
    del model, model32, outs, plain_out

    # ------------------------------------------- main path: zinc-train-bf16
    aggs, scalers = ZINC_PRESET_AGGS
    cfg = ZincConfig(aggregators=aggs, scalers=scalers, lr=1e-4, weight_decay=3e-4,
                     batch_size=64, epochs=5, subset_size=2000, compute_dtype="bfloat16")
    exact_layout = zinc_layout(cfg, list(splits.values()))[2] is not None
    steps = -(-len(splits["train"]) // cfg.batch_size)
    evals = sum(-(-len(splits[s_]) // cfg.batch_size) for s_ in ("val", "test"))
    results = {}
    with counted("zinc-train-bf16", paths), \
            open(os.path.join(LOG_DIR, "chip_smoke_zinc_train_bf16.log"), "w") as log, \
            contextlib.redirect_stdout(log):
        for seed in ZINC_SEEDS:
            results[seed] = train_zinc(dataclasses.replace(cfg, seed=seed), datasets=splits,
                                       device=dev)
    val = [results[s_]["val_mae"] for s_ in ZINC_SEEDS]
    epoch_s = [r["time"] for s_ in ZINC_SEEDS for r in results[s_]["history"][1:]]
    mean_val = statistics.mean(val)
    print(f"zinc-train-bf16 ({'degree-exact' if exact_layout else 'plain'} layout): val MAE per "
          "seed " + ", ".join(f"{s_}: {v:.4f}" for s_, v in zip(ZINC_SEEDS, val))
          + "; test MAE " + ", ".join(f"{results[s_]['test_mae']:.4f}" for s_ in ZINC_SEEDS)
          + f"; mean val {mean_val:.4f} (band {ZINC_BF16_VAL_MAE_BAND}); median epoch "
          f"{statistics.median(epoch_s) * 1e3:.3f} ms (host clock, epochs 2-{cfg.epochs})")
    runs = len(ZINC_SEEDS) * cfg.epochs
    if exact_layout:
        expect_launches(paths, "zinc-train-bf16", segment_sum=runs * (steps + evals))
    else:
        # Per train step: kernels 6 and 7 in bf16 once per layer, kernel 1 on
        # the bf16 cotangent rows once per layer (the gather_by_src VJP) and
        # on the float32 node rows once (pooling); per eval forward kernel 6
        # in bf16 once per layer and kernel 1 once.
        expect_launches(paths, "zinc-train-bf16",
                        minmax_prog_bf16=runs * layers * (steps + evals),
                        minmax_prog_bwd_bf16=runs * layers * steps,
                        segment_sum_bf16=runs * layers * steps, segment_sum=runs * (steps + evals))
    if not ZINC_BF16_VAL_MAE_BAND[0] <= mean_val <= ZINC_BF16_VAL_MAE_BAND[1]:
        raise AssertionError(f"zinc-train-bf16: mean val MAE {mean_val:.4f} outside "
                             f"{ZINC_BF16_VAL_MAE_BAND}")
    del results

    # ---- main paths: zinc-train-default-bf16, -pna-bf16, zinc-exact-train-default-bf16
    # The f32 paths' models, optimizer settings and dropout seed, in bf16.
    for path, aggs_scalers, seed, b in (
            ("zinc-train-default-bf16", ZINC_DEFAULT_AGGS, SEED + 5, batch),
            ("zinc-train-pna-bf16", ZINC_PNA_AGGS, SEED + 9, batch),
            ("zinc-exact-train-default-bf16", ZINC_DEFAULT_AGGS, SEED + 5, exact)):
        m = model_of(aggs_scalers, seed)
        opt = make_optimizer(m.parameters(), 0.01, 5e-4)
        gen = torch.Generator(device=dev).manual_seed(SEED)
        losses = []
        with counted(path, paths):
            step_ms = host_ms(lambda: losses.append(float(zinc_train_step(m, opt, b, gen))))
        print(f"{path}: losses {losses}; step times (host clock) {step_ms} ms")
        if not all(math.isfinite(v) for v in losses):
            raise AssertionError(f"{path}: non-finite loss {losses}")
        del m, opt
    # Per step and layer on the plain collate: forward kernel 4 in bf16 once
    # (max and min paired on the shared bf16 messages) and kernel 1 on them
    # once (mean), with std kernel 8 in bf16 once; backward kernel 5 in bf16
    # once and kernel 1 on the bf16 cotangents of the gathers by dst and by
    # src; kernel 1 on the float32 node rows once a step (pooling). On the
    # degree-exact batch the slot reductions are plain and kernel 1 pools.
    expect_launches(paths, "zinc-train-default-bf16", segment_minmax_bf16=3 * layers,
                    segment_minmax_bwd_bf16=3 * layers, segment_sum_bf16=3 * 3 * layers,
                    segment_sum=3)
    expect_launches(paths, "zinc-train-pna-bf16", segment_minmax_bf16=3 * layers,
                    segment_minmax_bwd_bf16=3 * layers, segment_sum_bf16=3 * 3 * layers,
                    segment_sum_sq_bf16=3 * layers, segment_sum=3)
    expect_launches(paths, "zinc-exact-train-default-bf16", segment_sum=3)

    # ------------- one bf16 train step of each route vs the all-plain step
    # Dropout on; the kernels' arguments kept for the per-kernel section. The
    # f32 and bf16 steps of each route timed in turns.
    captured = {}
    step_turns = {}
    for what, aggs_scalers, site, b in (
            ("min,max (fused route)", ZINC_PRESET_AGGS, "fused_minmax_edge_program", batch),
            ("mean,max,min (general route)", ZINC_DEFAULT_AGGS, "fused_segment_minmax", batch),
            ("mean,min,max,std (general route)", ZINC_PNA_AGGS, "segment_sum_sq_csr", batch),
            ("mean,max,min (ELL route)", ZINC_DEFAULT_AGGS, None, exact)):
        steps_out = []
        for plain in (False, True):
            m = model_of(aggs_scalers, SEED + 7)
            opt = make_optimizer(m.parameters(), 1e-4, 3e-4)

            def step():
                with plain_kernels() if plain else contextlib.nullcontext():
                    loss = zinc_train_step(m, opt, b,
                                           torch.Generator(device=dev).manual_seed(SEED))
                steps_out.append((float(loss), grads_of(m)))

            if site is not None and not plain:
                captured[site] = capture_call(mma_conv, site, step)
            else:
                step()
        (loss_k, grads_k), (loss_p, grads_p) = steps_out
        what = f"zinc-bf16 {what} step (dropout on)"
        compare(torch.tensor([loss_k]), torch.tensor([loss_p]), 1e-5, f"{what} loss vs plain")
        errs = {name: compare(t_, grads_p[name], BF16_GRAD_TOL, f"{what} {name} vs plain",
                              scale=bn_fed_scale(name, grads_p), verbose=False)
                for name, t_ in grads_k.items()}
        worst = max(errs, key=lambda k: errs[k]["max_rel_err"])
        print(f"{what}: {len(errs)} gradients vs plain on the card, max_rel_err "
              f"{errs[worst]['max_rel_err']:.3e} ({worst}; tolerance {BF16_GRAD_TOL:g})")
        models = {"f32": model_of(aggs_scalers, SEED + 13, "float32"),
                  "bf16": model_of(aggs_scalers, SEED + 13)}
        opts = {d: make_optimizer(m_.parameters(), 1e-4, 3e-4) for d, m_ in models.items()}
        gens = {d: torch.Generator(device=dev).manual_seed(SEED) for d in models}
        times = {d: [] for d in models}
        for d in models:
            zinc_train_step(models[d], opts[d], b, gens[d])  # warm-up
        for d in ("f32", "bf16", "bf16", "f32"):
            times[d] += host_ms(lambda: zinc_train_step(models[d], opts[d], b, gens[d]), 3)
        step_turns[what] = {d: statistics.median(v) for d, v in times.items()}
        print(f"{what}: train step medians (host clock, 6 each, in turns): bf16 "
              f"{step_turns[what]['bf16']:.4f} ms, f32 {step_turns[what]['f32']:.4f} ms")
        del m, opt, models, opts, steps_out

    # ------------------- per-kernel: the bf16 variants of kernels 4-8
    rp = g.real_row_ptr
    e_cov, n_rows = int(rp[-1]), g.n_node
    kernels = {}

    def equal(got, want, what):
        if not torch.equal(got, want):
            raise AssertionError(f"{what}: max_abs_err "
                                 f"{(got.float() - want.float()).abs().max().item():.3e}, "
                                 "must be equal")

    def record(name, err, run16, run32, plain, nbytes, flops, library_ms, shape, f32_name,
               source=MINMAX_SOURCE):
        ms, f32_ms = device_turns(run32, run16)
        plain_ms = device_ms(plain, iters=10)
        kernels[name] = {
            "name": name, "route": "cuda", "source": source, "replaces": REPLACES[f32_name],
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms, **bound(nbytes, flops),
            "library_ms": library_ms, "f32_ms": f32_ms, "shape": shape}
        e = kernels[name]
        print(f"{name}: ms {ms:.4f} (the f32 kernel on the same values {f32_ms:.4f}, in turns) "
              f"plain_ms {plain_ms:.4f} library_ms {library_ms} bound_ms {e['bound_ms']:.4f} "
              f"({e['bound_by']})")

    with torch.no_grad():
        # Kernels 4-5 on the bf16 messages and the cotangent of the
        # mean,max,min step (its last layer).
        (msgs, _, ops2), _, ct2 = captured["fused_segment_minmax"]
        msgs, ch = msgs.detach().contiguous(), msgs.shape[1]
        if msgs.dtype != torch.bfloat16:
            raise AssertionError(f"zinc-bf16 general route gave kernel 4 {msgs.dtype} messages")
        for ops in (ops2, ops2[:1]):
            ct = ct2[:, :len(ops) * ch].contiguous()
            out = mm.segment_minmax(msgs, rp, ops)
            grad = mm.segment_minmax_bwd(msgs, rp, ops, out, ct)
            equal(out, mm.segment_minmax_reference(msgs, rp, ops), f"segment_minmax bf16 {ops}")
            equal(grad, mm.segment_minmax_bwd_reference(msgs, rp, ops, out, ct),
                  f"segment_minmax_bwd bf16 {ops}")
            equal(out, mm.segment_minmax(msgs, rp, ops), f"segment_minmax bf16 {ops} run to run")
            equal(grad, mm.segment_minmax_bwd(msgs, rp, ops, out, ct),
                  f"segment_minmax_bwd bf16 {ops} run to run")
            print(f"segment_minmax / _bwd bf16 ops={ops}: equal to plain and run to run")
        ct = ct2.contiguous()
        p = len(ops2)
        out = mm.segment_minmax(msgs, rp, ops2)
        msgs32, out32 = msgs.float(), mm.segment_minmax(msgs.float(), rp, ops2)
        ids = mm._row_ids(rp)[:, None].expand(e_cov, ch)
        live = msgs[:e_cov]

        def library():
            return [torch.zeros(n_rows, ch, dtype=torch.bfloat16, device=dev).scatter_reduce_(
                0, ids, live, "amax" if op == "max" else "amin", include_self=False)
                for op in ops2]

        shape = f"E={e_cov} N={n_rows} C={ch} ops={','.join(ops2)}, bf16 data"
        # Bytes: the bf16 edge rows and the CSR read once, the float32 output.
        record("segment_minmax_bf16", 0.0, lambda: mm.segment_minmax(msgs, rp, ops2),
               lambda: mm.segment_minmax(msgs32, rp, ops2),
               lambda: mm.segment_minmax_reference(msgs, rp, ops2),
               2 * e_cov * ch + 4 * ((n_rows + 1) + n_rows * p * ch), e_cov * ch * p,
               device_ms(library), shape + " (library: one scatter_reduce per op on the bf16 "
               "rows)", "segment_minmax")
        # Bytes: the bf16 rows, out and ct (float32), the CSR, grad (bf16) written.
        record("segment_minmax_bwd_bf16", 0.0,
               lambda: mm.segment_minmax_bwd(msgs, rp, ops2, out, ct),
               lambda: mm.segment_minmax_bwd(msgs32, rp, ops2, out32, ct),
               lambda: mm.segment_minmax_bwd_reference(msgs, rp, ops2, out, ct),
               2 * e_cov * ch + 4 * (2 * n_rows * p * ch + (n_rows + 1)) + 2 * g.n_edge * ch,
               e_cov * ch * 2 * p, None, shape, "segment_minmax_bwd")

        # Kernels 6-7 on the bf16 node projection and edge rest, the seed and
        # the cotangent of the min,max step (its last layer), dropout on and off.
        (c, hg, _, ops_p), kw, ctp = captured["fused_minmax_edge_program"]
        c, hg = c.detach().contiguous(), hg.detach().contiguous()
        seed, rate = kw["seed"], kw["rate"]
        if (c.dtype, hg.dtype) != (torch.bfloat16, torch.bfloat16):
            raise AssertionError(f"zinc-bf16 fused route gave kernel 6 {c.dtype} / {hg.dtype}")
        errs = []
        for ops in (ops_p, ops_p[:1]):
            for sd in (seed, None):
                ct = ctp[:, :len(ops) * ch].contiguous()
                what = f"minmax_prog bf16 ops={ops} dropout={'on' if sd is not None else 'off'}"
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
        c32, hg32 = c.float(), hg.float()
        out = mm.minmax_edge_program(c, hg, rp, ops_p, seed, rate)
        out32 = mm.minmax_edge_program(c32, hg32, rp, ops_p, seed, rate)
        shape = (f"E={e_cov} N={n_rows} C={ch} ops={','.join(ops_p)} dropout on, bf16 c and hg "
                 "(library: scatter_reduce_ amax plus amin over the pre-built float32 message)")
        prog_msg = mm._messages(c, hg, rp, seed, rate)[0]
        prog_ids = mm._row_ids(rp)[:, None].expand(e_cov, ch)

        def prog_library():
            return [torch.zeros(n_rows, ch, device=dev).scatter_reduce_(
                0, prog_ids, prog_msg, "amax" if op == "max" else "amin", include_self=False)
                for op in ops_p]

        record("minmax_prog_bf16", 0.0,
               lambda: mm.minmax_edge_program(c, hg, rp, ops_p, seed, rate),
               lambda: mm.minmax_edge_program(c32, hg32, rp, ops_p, seed, rate),
               lambda: mm.minmax_edge_program_reference(c, hg, rp, ops_p, seed, rate),
               2 * (e_cov * ch + n_rows * ch) + 4 * ((n_rows + 1) + 1 + n_rows * p * ch),
               e_cov * ch * (2 + p), device_ms(prog_library), shape, "minmax_prog")
        del prog_msg, prog_ids
        record("minmax_prog_bwd_bf16", max(errs),
               lambda: mm.minmax_edge_program_bwd(c, hg, rp, ops_p, seed, rate, out, ct),
               lambda: mm.minmax_edge_program_bwd(c32, hg32, rp, ops_p, seed, rate, out32, ct),
               lambda: mm.minmax_edge_program_bwd_reference(c, hg, rp, ops_p, seed, rate, out,
                                                            ct),
               2 * (e_cov * ch + n_rows * ch + g.n_edge * ch + n_rows * ch)
               + 4 * (2 * n_rows * p * ch + (n_rows + 1) + 1),
               e_cov * ch * (4 + 2 * p), None, shape, "minmax_prog_bwd")

        # Kernel 8 on the bf16 messages of the PNA step (its last layer).
        (msgs, rp8), _, _ = captured["segment_sum_sq_csr"]
        msgs = msgs.detach().contiguous()
        if msgs.dtype != torch.bfloat16:
            raise AssertionError(f"zinc-bf16 PNA route gave kernel 8 {msgs.dtype} messages")
        ch = msgs.shape[1]
        got = fused_mma.segment_sum_sq_csr(msgs, rp8)
        want = fused_mma.segment_sum_sq_reference(msgs, rp8)
        err = compare(got, want, 1e-5, "segment_sum_sq bf16 vs plain")
        print(f"segment_sum_sq bf16: equal to plain bit for bit: {torch.equal(got, want)}")
        equal(got, fused_mma.segment_sum_sq_csr(msgs, rp8), "segment_sum_sq bf16 run to run")
        live = msgs[:e_cov].float()
        both = torch.cat([live, fused_mma._round_bf16(live * live)], dim=1)
        ids = mm._row_ids(rp8)
        msgs32 = msgs.float()
        # Bytes: the bf16 edge rows and the CSR read once, [Σx ‖ Σx²] written;
        # operations per element: the square, its rounding and two adds.
        record("segment_sum_sq_bf16", err["max_abs_err"],
               lambda: fused_mma.segment_sum_sq_csr(msgs, rp8),
               lambda: fused_mma.segment_sum_sq_csr(msgs32, rp8),
               lambda: fused_mma.segment_sum_sq_reference(msgs, rp8),
               2 * e_cov * ch + 4 * ((n_rows + 1) + n_rows * 2 * ch), 3 * e_cov * ch,
               device_ms(lambda: torch.zeros(n_rows, 2 * ch, device=dev).index_add_(0, ids, both)),
               f"E={e_cov} N={n_rows} C={ch}, bf16 data (library: index_add_ of a pre-built "
               "float32 [x ‖ x²])", "segment_sum_sq", source=SOURCE)
    return kernels


# ------------------------------------------------------------ sampled paths

# The sampled CLI's phases: (path, extra flags, steps) at the command line's
# defaults otherwise (200,000 nodes, --avg-deg 25, batch 512, fanouts
# 10,10,5, hidden 64, 100 features, 47 classes, mean,mean2, dropout 0.5).
BF16 = ["--compute-dtype", "bfloat16"]
SAMPLED_PHASES = (
    ("sampled-train", [], 20),
    ("sampled-train-lean", ["--dropout", "0"], 5),
    ("sampled-train-ell", ["--use-ell"], 10),
    ("sampled-train-hostbuilt", ["--host-built"], 5),
    ("sampled-train-bf16", BF16, 5),
    ("sampled-train-lean-bf16", BF16 + ["--dropout", "0"], 5),
    ("sampled-train-ell-bf16", BF16 + ["--use-ell"], 5),
)
# Kernel calls per train step on each route. Lean with the keep (mask
# dropout on, the CSR): kernel 1 x2 and kernel 2 with the keep forward,
# kernel 1 x2 and kernel 3 with the keep backward. Half-fused (mask dropout
# on in bf16): kernel 1 x3 forward (two binary_spmm, the message sum) and
# x5 backward (two binary_spmm, the gathers of c by dst and of d and h by
# src). Lean (dropout 0): kernel 1 x2 and kernel 2 forward, kernel 1 x2 and
# kernel 3 backward. ELL (mask dropout on, hopped layout): kernel 1 x2
# forward (binary_spmm; the slot sums are plain) and x3 backward (binary_spmm,
# the [d ‖ h] slot gather's VJP over the CSC). In bf16 the calls on bf16
# rows count under the "_bf16" keys: every forward call of kernel 1, the
# VJPs of the bf16 gathers and slot gather, kernels 2 and 3; the two
# binary_spmm backward calls sum float32 cotangents.
SAMPLED_PER_STEP = {
    "sampled-train": {"segment_sum": 4, "edge_program_lean_keep": 1,
                      "edge_program_lean_keep_bwd": 1},
    "sampled-train-lean": {"segment_sum": 4, "edge_program_lean": 1, "edge_program_lean_bwd": 1},
    "sampled-train-ell": {"segment_sum": 5},
    "sampled-train-hostbuilt": {"segment_sum": 4, "edge_program_lean_keep": 1,
                                "edge_program_lean_keep_bwd": 1},
    "sampled-train-bf16": {"segment_sum_bf16": 6, "segment_sum": 2},
    "sampled-train-lean-bf16": {"segment_sum_bf16": 2, "segment_sum": 2,
                                "edge_program_lean_bf16": 1, "edge_program_lean_bwd_bf16": 1},
    "sampled-train-ell-bf16": {"segment_sum_bf16": 3, "segment_sum": 2},
}
# tests/test_sampling.py:343-344: full-graph accuracy above 0.6, sampled
# within 0.08 of it.
SAMPLED_FULL_MIN_ACC = 0.6
SAMPLED_MAX_ACC_GAP = 0.08


def profile_steps(run, iters: int = 3) -> dict:
    """Device busy time per call of ``run`` from ``torch.profiler`` (kernel
    rows only), the traced window's host clock, and the top kernels."""
    run()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for _ in range(iters):
            run()
        torch.cuda.synchronize()
        window_ms = (time.perf_counter() - t0) * 1e3 / iters
    rows = []
    for ev in prof.key_averages():
        if ev.device_type != torch.autograd.DeviceType.CUDA or getattr(
                ev, "is_user_annotation", False):
            continue
        dev_us = getattr(ev, "self_device_time_total", None)
        if dev_us is None:
            dev_us = getattr(ev, "self_cuda_time_total", 0)
        if dev_us > 0:
            rows.append((dev_us / iters / 1e3, ev.count // iters, ev.key))
    rows.sort(reverse=True)
    busy = sum(r[0] for r in rows)
    return {"window_ms": window_ms, "busy_ms": busy, "busy_share": busy / window_ms,
            "launches": sum(r[1] for r in rows), "top": rows[:5]}


def run_sampled(dev, paths: dict) -> None:
    """The sampled-training phases (the command line's four modes and the
    community-graph quality check), their gates and their timings."""
    from mma_tpu_torch.cli import train_sampled as cli
    from mma_tpu_torch.graph import native
    from mma_tpu_torch.graph.device_build import finish_graph_on_device
    from mma_tpu_torch.models import NodeClassifier
    from mma_tpu_torch.train import make_optimizer
    from mma_tpu_torch.train.sampled import (
        SampledTrainConfig,
        sampled_train_step,
        train_sampled,
    )

    if not native.available():
        raise AssertionError("the native graph library did not build: the sampler would "
                             "run its NumPy backend")
    print(f"native graph library: {native.library_path()}")
    runs = {}
    with open(os.path.join(LOG_DIR, "chip_smoke_sampled.log"), "w") as log:
        for path, flags, steps in SAMPLED_PHASES:
            t0 = time.perf_counter()
            with counted(path, paths), contextlib.redirect_stdout(log):
                res = cli.main(["--device", str(dev), "--steps", str(steps), *flags])
            wall = time.perf_counter() - t0
            s, pads = res["summary"], res["pads"]
            print(f"{path}: pads {pads}; {steps} steps in {wall:.2f} s (graph build and "
                  f"calibration included); medians after {cli.WARMUP_STEPS} warm-up steps: "
                  f"step {s['step_ms']:.4f} ms (host clock), {s['device_ms']:.4f} ms (CUDA "
                  f"events); pipeline {s['pipeline_ms']:.4f} ms a batch, pipeline / device "
                  f"{s['pipeline_ms'] / s['device_ms']:.4f}; {s['edges']} sampled edges a "
                  f"batch: {s['edges_per_s_step']:.4e} edges/s through the step, "
                  f"{s['edges_per_s_pipeline']:.4e} through the pipeline; losses "
                  f"{res['losses'][0]:.4f} -> {res['losses'][-1]:.4f}")
            expect_launches(paths, path, **{k: v * steps for k, v in SAMPLED_PER_STEP[path].items()})
            if not all(math.isfinite(v) for v in res["losses"]):
                raise AssertionError(f"{path}: non-finite loss {res['losses']}")
            runs[path] = res

    base = runs["sampled-train"]
    sampler, assembler, pads = base["sampler"], base["assembler"], base["pads"]
    hop_pads = tuple(pads["hop_node_pads"])
    n_nodes = sampler.num_nodes
    deg_table = torch.from_numpy(sampler.true_deg).to(dev)
    # One batch of the command line's size (the seeds' budget is the batch).
    seeds = np.random.RandomState(SEED + 7).randint(0, n_nodes, hop_pads[0])
    kw = dict(n_node_pad=pads["n_node_pad"], n_edge_pad=pads["n_edge_pad"])

    def finished(smp, hopped):
        ar = smp.sample_arrays(seeds, hop_node_pads=hop_pads if hopped else None, **kw)
        t = {k: torch.from_numpy(getattr(ar, k)).to(dev)
             for k in ("src", "dst", "node_ids", "src_perm")}
        g = finish_graph_on_device(t["src"], t["dst"], t["node_ids"], ar.num_edges, deg_table,
                                   t["src_perm"], ell_hint=ar.ell_hint)
        return ar, g, assembler.assemble(t["node_ids"], ar.num_seeds)

    # ------------------------- the finished graph equals the host-built one
    batches = {}
    for hopped in (False, True):
        host = copy.deepcopy(sampler).sample(
            seeds, hop_node_pads=hop_pads if hopped else None, device=dev, **kw)
        ar, g, xys = finished(copy.deepcopy(sampler), hopped)
        for f in dataclasses.fields(g):
            a, b = getattr(g, f.name), getattr(host.graph, f.name)
            same = (torch.equal(a, b) and a.dtype == b.dtype) if isinstance(a, torch.Tensor) \
                else a == b
            if not same:
                raise AssertionError(f"finished graph (hopped={hopped}) field {f.name} differs "
                                     "from the host-built graph")
        real = g.node_mask
        ids = torch.from_numpy(ar.node_ids).to(dev).long()
        sampled_deg = (g.row_ptr[1:] - g.row_ptr[:-1]).float()
        if not torch.equal(g.deg[real], deg_table[ids[real]]) or torch.equal(
                g.deg[real], sampled_deg[real]):
            raise AssertionError("the finished graph's deg is not the full-graph degree")
        holes = int((~real[: g.ell_hint[-1][0]]).sum()) if hopped else 0
        print(f"finished graph (hopped={hopped}): equal to the host-built graph field for "
              f"field; {ar.num_nodes} nodes, {ar.num_edges} edges, {holes} hole rows in the "
              f"hop ranges, ell_hint {g.ell_hint}; deg is the full-graph degree")
        batches[hopped] = (ar, g, xys)

    # ------------------- one train step per route against the all-plain step
    model_do = runs["sampled-train"]["model"]
    model_lean = runs["sampled-train-lean"]["model"]
    model_do16 = runs["sampled-train-bf16"]["model"]
    routes = {"lean-keep": (model_do, batches[False]), "lean": (model_lean, batches[False]),
              "ell": (model_do, batches[True]),
              "half-fused-bf16": (model_do16, batches[False]),
              "lean-bf16": (runs["sampled-train-lean-bf16"]["model"], batches[False]),
              "ell-bf16": (model_do16, batches[True])}
    for route, (model0, (ar, g, (x, y, sm))) in routes.items():

        def step(plain):
            model = copy.deepcopy(model0)
            opt = make_optimizer(model.parameters(), 3e-3)
            before = launches()
            with plain_kernels() if plain else contextlib.nullcontext():
                loss, logp = sampled_train_step(model, opt, x, g, y, sm,
                                                torch.Generator(device=dev).manual_seed(SEED))
            torch.cuda.synchronize()
            if plain and launches() != before:
                raise AssertionError(f"sampled {route} step: the plain step launched a kernel")
            return loss, logp, grads_of(model)

        (loss_k, logp_k, grads_k), (loss_p, logp_p, grads_p) = (step(p) for p in (False, True))
        check_log_probs(logp_k[g.node_mask], int(g.node_mask.sum()), logp_k.shape[1],
                        int(g.node_mask.sum()), f"sampled {route} step")
        compare(loss_k.reshape(1), loss_p.reshape(1), 1e-5, f"sampled {route} step loss vs plain")
        compare(logp_k[g.node_mask], logp_p[g.node_mask], 1e-5,
                f"sampled {route} step log-probs vs plain")
        tol = BF16_GRAD_TOL if route.endswith("bf16") else 1e-5
        for name, gk in grads_k.items():
            compare(gk, grads_p[name], tol, f"sampled {route} step grad {name} vs plain")
    del grads_k, grads_p

    # ------------- the ELL route against the CSR route, dropout off; holes
    ar, g, (x, y, sm) = batches[True]
    holes = ~g.node_mask
    with torch.no_grad():
        ell_out = model_lean(x, g)
        csr_out = model_lean(x, dataclasses.replace(g, ell_hint=None))
    compare(ell_out[g.node_mask], csr_out[g.node_mask], 1e-5,
            "sampled ELL route vs CSR route, predictions on a hopped batch (dropout off)")
    ns = ar.num_seeds
    for route, graph in (("ell", g), ("csr", dataclasses.replace(g, ell_hint=None))):
        seed_out = []
        for fill in (0.0, 1e6):
            xx = torch.where(holes[:, None], torch.full_like(x, fill), x).requires_grad_()
            out = model_lean(xx, graph)
            out[torch.arange(ns, device=dev), y[:ns]].sum().backward()
            if xx.grad[holes].abs().max().item() != 0.0:
                raise AssertionError(f"sampled {route}: a hole row has a gradient")
            seed_out.append(out[:ns].detach())
        if not torch.equal(seed_out[0], seed_out[1]):
            raise AssertionError(f"sampled {route}: 1e6 in the hole rows moved a seed output")
    print(f"sampled hole rows ({int(holes[: g.ell_hint[-1][0]].sum())} in the hop ranges): "
          "1e6 in them moves no seed output, and their gradient is 0, on both routes")

    # -------------------------------------- where a sampled step's time goes
    for route, (model0, (ar, g, (x, y, sm))) in routes.items():
        model = copy.deepcopy(model0)
        opt = make_optimizer(model.parameters(), 3e-3)
        gen = torch.Generator(device=dev).manual_seed(SEED)
        prof = profile_steps(lambda: sampled_train_step(model, opt, x, g, y, sm, gen))
        print(f"sampled {route} step profile (fixed batch, {ar.num_edges} edges): traced "
              f"{prof['window_ms']:.4f} ms a step (host clock), device busy "
              f"{prof['busy_ms']:.4f} ms, busy share {prof['busy_share']:.4f}, "
              f"{prof['launches']} device launches and copies a step; top: "
              + "; ".join(f"{ms:.4f} ms x{c} {k[:60]}" for ms, c, k in prof["top"]))
    smp = copy.deepcopy(sampler)
    t_host = []
    for i in range(5):
        t0 = time.perf_counter()
        ar = smp.sample_arrays(seeds, **kw)
        t_host.append((time.perf_counter() - t0) * 1e3)
    ar, g, _ = batches[False]
    t_dev = {k: torch.from_numpy(getattr(ar, k)).to(dev)
             for k in ("src", "dst", "node_ids", "src_perm")}
    finish_ms = device_ms(lambda: finish_graph_on_device(
        t_dev["src"], t_dev["dst"], t_dev["node_ids"], ar.num_edges, deg_table,
        t_dev["src_perm"]))
    assemble_ms = device_ms(lambda: assembler.assemble(t_dev["node_ids"], ar.num_seeds))
    ship_mb = 4 * (3 * kw["n_edge_pad"] + kw["n_node_pad"]) / 2**20
    print(f"sampled host side: sample_arrays (native sampler, {sampler.n_threads} threads, "
          f"two counting sorts) median {statistics.median(t_host):.4f} ms a batch of "
          f"{ar.num_edges} edges; {ship_mb:.2f} MiB shipped a batch (src, dst, CSC "
          f"permutation, ids); finish_graph_on_device {finish_ms:.4f} ms and the feature "
          f"gather {assemble_ms:.4f} ms on the card")

    # --------------------------- sampled against full-graph training quality
    rs = np.random.RandomState(3)
    n, k = 500, 4
    comm = rs.randint(0, k, n)
    edges = set()
    for i in range(n):
        for _ in range(6):
            cand = np.flatnonzero(comm == comm[i]) if rs.rand() < 0.85 else np.arange(n)
            j = int(cand[rs.randint(len(cand))])
            if i != j:
                edges.add((min(i, j), max(i, j)))
    e = np.array(sorted(edges), np.int32)
    from mma_tpu_torch import graph_from_edges

    cg = graph_from_edges(np.concatenate([e[:, 0], e[:, 1]]),
                          np.concatenate([e[:, 1], e[:, 0]]), n, device=dev)
    feats = (np.eye(k)[comm] + 1.2 * rs.randn(n, k)).astype(np.float32)
    train_idx, test_idx = np.arange(350), np.arange(350, n)
    x_full = torch.zeros(cg.n_node, k, device=dev)
    x_full[:n] = torch.from_numpy(feats).to(dev)
    y_full = torch.from_numpy(comm.astype(np.int64)).to(dev)

    def accuracy(model):
        with torch.no_grad():
            pred = model(x_full, cg).argmax(dim=1).cpu().numpy()[:n]
        return float((pred[test_idx] == comm[test_idx]).mean())

    full_steps = 60
    cfg = SampledTrainConfig(aggregators=("mean", "max"), hidden=16, batch_size=64,
                             fanouts=(4, 4, 4), n_node_pad=512, n_edge_pad=4096, lr=0.01,
                             dropout=0.0, epochs=12, parity=True, seed=1)
    with counted("sampled-quality", paths), contextlib.redirect_stdout(io.StringIO()):
        model = NodeClassifier(k, 16, k, ("mean", "max"), dropout_rate=0.0, device=dev,
                               generator=torch.Generator().manual_seed(0))
        opt = make_optimizer(model.parameters(), 0.01)
        tr = torch.from_numpy(train_idx).to(dev)
        for _ in range(full_steps):
            opt.zero_grad()
            logp = model(x_full, cg)
            (-logp[tr, y_full[tr]].mean()).backward()
            opt.step()
        acc_full = accuracy(model)
        res = train_sampled(cfg, cg, feats, comm, train_idx, device=dev)
        acc_sampled = accuracy(res["model"])
    sampled_steps = sum(r["batches"] for r in res["history"])
    print(f"sampled-quality: full-graph test accuracy {acc_full:.4f} (must be > "
          f"{SAMPLED_FULL_MIN_ACC}), sampled {acc_sampled:.4f} (must be > full - "
          f"{SAMPLED_MAX_ACC_GAP}); {full_steps} full steps, {sampled_steps} sampled steps")
    # Per step (dropout 0, the lean route): kernel 1 x4, kernels 2 and 3 once;
    # each accuracy forward kernel 1 x2 and kernel 2 once.
    steps = full_steps + sampled_steps
    expect_launches(paths, "sampled-quality", segment_sum=4 * steps + 2 * 2,
                    edge_program_lean=steps + 2, edge_program_lean_bwd=steps)
    if not (acc_full > SAMPLED_FULL_MIN_ACC and acc_sampled > acc_full - SAMPLED_MAX_ACC_GAP):
        raise AssertionError(f"sampled-quality: accuracies full {acc_full:.4f}, sampled "
                             f"{acc_sampled:.4f}")

# Stated bf16-level tolerance of the bf16 serving outputs against the f32
# ones: relative to the largest |log-prob| (compare's floor), a few bf16
# ulps (2^-8 = 3.9e-3 each) of the values the two pipelines round apart.
BF16_SERVE_TOL = 3e-2
# The bf16 train steps' gradients against the all-plain bf16 step's: bf16's
# own resolution, half a bf16 ulp of (|element| + the largest |element|).
# The pipeline rounds float32 sums to bf16 in the backward, as the JAX
# package's VJPs do (kernel 3's dh and dW_bot cast to their inputs' dtype,
# the SpMM operands' and the gathers' cotangents, the mask weights'
# gradient from the bf16 products), so a kernel's sum and the plain
# version's, taken in another order, can round to neighbouring bf16 values,
# one ulp (at most 2^-7 of the element) apart, and such a flip carries into
# the sums after it. On an H100 80GB HBM3 (700 W): 1.3e-5 to 2.5e-5 of the
# scale on synthetic-large's gc1.w and masks, 2.9e-4 on a sampled lean
# step's masks (one ulp of an element at 1/20 of the largest), where the
# float32 steps hold at 1e-5. Loss and log-probs are held at 1e-5.
BF16_GRAD_TOL = 2.0 ** -8
# Two bf16 routes that round in different places, and a bf16 route against
# the f32 one, on the same work (large-wide-bf16, large-masked-bf16): the
# lean bf16 kernels round each message to bf16 and the wide ones do not;
# kernel 12 gets bf16 logits c[dst] + d[src] and rounds each message, the
# wide bf16 program adds both in float32. Relative to each tensor's largest
# value (compare's floor): on the CPU at 8,192 nodes of the same power-law
# graph at most 3.8e-3 (outputs, S and gradients); at 1e-5 of a bound the
# rounding would go unseen, at 1e-2 a mistaken route would not.
BF16_ROUTE_TOL = 1e-2


def run_bf16(dev, paths: dict, ctx: dict) -> dict:
    """The bf16 edge pipeline's main paths (``compute_dtype="bfloat16"``) on
    the f32 paths' weights and inputs: cora-serve-bf16 and
    synthetic-large-serve-bf16 (the eval forward), synthetic-large-train-bf16
    (3 Adam steps, dropout 0: kernels 1-3 in bf16) and cora-train-bf16 (the
    README preset, the half-fused route's bf16 messages), with their launch
    counts, holds and times beside the f32 ones. Returns the bf16 models and
    tensors the per-kernel section times."""
    from unittest import mock

    from mma_tpu_torch import NodeClassifier
    from mma_tpu_torch.train import NODE_CLS_PRESETS, loops, make_optimizer
    from mma_tpu_torch.train.loops import node_train_step

    cora, big, requests, x_big = ctx["cora"], ctx["big"], ctx["requests"], ctx["x_big"]
    n_big, e_big = ctx["n_big"], ctx["e_big"]

    def twin(model, n_feat, n_class, dropout_rate=0.5):
        """``model`` with the same weights, in the bf16 pipeline."""
        m = NodeClassifier(n_feat, 64, n_class, ("mean", "mean2"), dropout_rate=dropout_rate,
                           compute_dtype="bfloat16", device=dev)
        m.load_state_dict(model.state_dict())
        return m

    cora16 = twin(ctx["cora_model"], cora.num_features, cora.num_classes, 0.75)
    big16 = twin(ctx["big_model"], 64, 16)

    # ------------------------------------------- main paths: serve in bf16
    # Per forward: kernel 1 on bf16 rows for each binary_spmm (2), kernel 2
    # with a bf16 h once.
    with counted("cora-serve-bf16", paths), torch.no_grad():
        cora_out = [cora16(x, cora.graph) for x in requests]
    expect_launches(paths, "cora-serve-bf16", segment_sum_bf16=2 * 3, edge_program_lean_bf16=3)
    with counted("synthetic-large-serve-bf16", paths), torch.no_grad():
        big_out = [big16(x_big, big) for _ in range(3)]
    expect_launches(paths, "synthetic-large-serve-bf16", segment_sum_bf16=2 * 3,
                    edge_program_lean_bf16=3)
    n = cora.num_nodes
    with torch.no_grad():
        for i, out in enumerate(cora_out):
            check_log_probs(out, cora.graph.n_node, cora.num_classes, n, f"cora bf16 request {i}")
            compare(out[:n], ctx["cora_out"][i][:n], BF16_SERVE_TOL,
                    f"cora bf16 request {i} vs the f32 request")
        for out in big_out:
            check_log_probs(out, big.n_node, 16, n_big, "synthetic-large bf16 forward")
        compare(big_out[0][:n_big], ctx["big_out"][:n_big], BF16_SERVE_TOL,
                "synthetic-large bf16 forward vs the f32 forward")
        before = launches()
        with plain_kernels():
            cora_plain = cora16(requests[0], cora.graph)
            big_plain = big16(x_big, big)
        if launches() != before:
            raise AssertionError("the plain bf16 forward launched a kernel")
        compare(cora_out[0][:n], cora_plain[:n], 1e-5, "cora bf16 request 0 vs plain on the card")
        compare(big_out[0][:n_big], big_plain[:n_big], 1e-5,
                "synthetic-large bf16 forward vs plain on the card")
        # The f32 and bf16 models in turns (f32, bf16, bf16, f32): host-clock
        # and CUDA-event medians of one request.
        serve = {}
        for what, models, x, g, reps in (
                ("cora request", (ctx["cora_model"], cora16), requests[0], cora.graph, 10),
                ("synthetic-large forward", (ctx["big_model"], big16), x_big, big, 5)):
            t = {"f32": [], "bf16": []}
            ev = {"f32": [], "bf16": []}
            for dtype in ("f32", "bf16", "bf16", "f32"):
                model = models[dtype == "bf16"]
                t[dtype] += host_ms(lambda: model(x, g), reps)
                ev[dtype].append(device_ms(lambda: model(x, g), iters=reps))
            serve[what] = {k: (statistics.median(t[k]), statistics.median(ev[k])) for k in t}
            print(f"{what} (host clock / CUDA events, medians, in turns): f32 "
                  f"{serve[what]['f32'][0]:.4f} / {serve[what]['f32'][1]:.4f} ms; bf16 "
                  f"{serve[what]['bf16'][0]:.4f} / {serve[what]['bf16'][1]:.4f} ms")
        big_bf16_ms = serve["synthetic-large forward"]["bf16"][0]
        print(f"synthetic-large-serve-bf16: {e_big / (big_bf16_ms * 1e-3):.4e} edges/s "
              "(host clock)")
    del cora_plain, big_plain, big_out

    # -------------------------------- main path: synthetic-large-train-bf16
    labels, idx_train = ctx["labels"], ctx["idx_train"]
    train16 = twin(ctx["big_model"], 64, 16, dropout_rate=0.0)
    train16.load_state_dict(ctx["init_state"])
    opt = make_optimizer(train16.parameters(), 1e-3)
    step_gen = torch.Generator(device=dev).manual_seed(SEED)
    step_ms, step_ev, losses = [], [], []
    with counted("synthetic-large-train-bf16", paths):
        for step in range(3):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            t0 = time.perf_counter()
            start.record()
            loss, logp = node_train_step(train16, opt, x_big, big, labels, idx_train, step_gen)
            end.record()
            torch.cuda.synchronize()
            step_ms.append((time.perf_counter() - t0) * 1e3)
            step_ev.append(start.elapsed_time(end))
            losses.append(float(loss))
            if step == 0:
                logp1, grads1 = logp.clone(), grads_of(train16)
                check_log_probs(logp, big.n_node, 16, n_big, "synthetic-large-train-bf16 step 1")
    print(f"synthetic-large-train-bf16: losses {losses} (f32 {ctx['losses']}); step times "
          f"(host clock) {step_ms}, median {statistics.median(step_ms):.4f} ms (f32 "
          f"{statistics.median(ctx['step_ms']):.4f}); CUDA events {step_ev}, median "
          f"{statistics.median(step_ev):.4f} ms")
    # Per step: forward kernel 1 on bf16 rows x2 (binary_spmm) and kernel 2
    # in bf16; backward kernel 1 x2 on the float32 cotangents (binary_spmm)
    # and kernel 3 in bf16.
    expect_launches(paths, "synthetic-large-train-bf16", segment_sum_bf16=3 * 2,
                    segment_sum=3 * 2, edge_program_lean_bf16=3, edge_program_lean_bwd_bf16=3)
    if not all(math.isfinite(v) for v in losses):
        raise AssertionError(f"synthetic-large-train-bf16: non-finite loss {losses}")
    compare(torch.tensor(losses), torch.tensor(ctx["losses"]), BF16_SERVE_TOL,
            "synthetic-large-train-bf16 losses vs f32")

    def plain_step(x):
        """Step 1 from the same weights with every kernel plain."""
        model = twin(ctx["big_model"], 64, 16, dropout_rate=0.0)
        model.load_state_dict(ctx["init_state"])
        before = launches()
        with plain_kernels():
            loss, logp = node_train_step(model, make_optimizer(model.parameters(), 1e-3), x, big,
                                         labels, idx_train,
                                         torch.Generator(device=dev).manual_seed(SEED))
        if launches() != before:
            raise AssertionError("the plain bf16 train step launched a kernel")
        return float(loss), logp, grads_of(model)

    plain_loss, plain_logp, plain_g = plain_step(x_big)
    compare(torch.tensor([losses[0]]), torch.tensor([plain_loss]), 1e-5,
            "synthetic-large-train-bf16 step 1 loss vs plain on the card")
    compare(logp1[:n_big], plain_logp[:n_big], 1e-5,
            "synthetic-large-train-bf16 step 1 log-probs vs plain on the card")
    for name, g in plain_g.items():
        compare(grads1[name], g, BF16_GRAD_TOL,
                f"synthetic-large-train-bf16 step 1 grad {name} vs plain")
    del plain_g, grads1, plain_logp

    # ------------------------------------------ main path: cora-train-bf16
    # The loop builds its model itself (the JAX package's loop has no
    # compute_dtype either): the same loop, its NodeClassifier in bf16.
    cfg0 = NODE_CLS_PRESETS["cora"]
    results = {}
    model16 = functools.partial(NodeClassifier, compute_dtype="bfloat16")
    with counted("cora-train-bf16", paths), mock.patch.object(loops, "NodeClassifier", model16), \
            open(os.path.join(LOG_DIR, "chip_smoke_train_bf16.log"), "w") as log, \
            contextlib.redirect_stdout(log):
        for seed in CORA_SEEDS:
            results[seed] = loops.train_node_classification(
                dataclasses.replace(cfg0, seed=seed), data=cora, device=dev)
    accs = [results[s]["acc_test"] for s in CORA_SEEDS]
    epoch_s = [r["time"] for s in CORA_SEEDS for r in results[s]["history"][1:]]
    mean_acc = statistics.mean(accs)
    print("cora-train-bf16: test accuracy per seed "
          + ", ".join(f"{s}: {a:.4f}" for s, a in zip(CORA_SEEDS, accs))
          + f"; mean {mean_acc:.4f} (must be >= {CORA_MIN_MEAN_ACC}; f32 {ctx['cora_acc']:.4f});"
          f" median epoch {statistics.median(epoch_s) * 1e3:.3f} ms (f32 "
          f"{ctx['cora_epoch_ms']:.3f}; host clock)")
    # Per epoch: the train forward runs kernel 1 on bf16 rows three times
    # (2 binary_spmm, the bf16 messages' sum); its backward on bf16
    # cotangents three times (the gathers of c by dst, of d and h by src)
    # and on the float32 ones twice (2 binary_spmm); the eval forward kernel
    # 1 twice and kernel 2 once, in bf16. Each run ends with one more eval
    # forward.
    runs, epochs = len(CORA_SEEDS), cfg0.epochs
    expect_launches(paths, "cora-train-bf16", segment_sum_bf16=runs * (epochs * 8 + 2),
                    segment_sum=runs * epochs * 2, edge_program_lean_bf16=runs * (epochs + 1))
    if not mean_acc >= CORA_MIN_MEAN_ACC:
        raise AssertionError(f"cora-train-bf16: mean test accuracy {mean_acc:.4f} < "
                             f"{CORA_MIN_MEAN_ACC}")
    # One more step from seed 0's trained state, with the kernels and with
    # every kernel plain (the same dropout draws on both sides).

    def cora_step(plain):
        model = copy.deepcopy(results[CORA_SEEDS[0]]["model"])
        opt = make_optimizer(model.parameters(), cfg0.lr, cfg0.weight_decay)
        before = launches()
        with plain_kernels() if plain else contextlib.nullcontext():
            loss, logp = node_train_step(model, opt, cora.features, cora.graph,
                                         cora.labels.long(), cora.idx_train.long(),
                                         torch.Generator(device=dev).manual_seed(SEED))
        torch.cuda.synchronize()
        launched = launches()["segment_sum_bf16"] - before["segment_sum_bf16"]
        if launched != (0 if plain else 6):
            raise AssertionError(f"cora-train-bf16 step (plain={plain}): {launched} bf16 "
                                 "kernel-1 launches")
        return float(loss), logp, grads_of(model)

    (loss_k, logp_k, grads_k), (loss_p, logp_p, grads_p) = (
        cora_step(plain) for plain in (False, True))
    compare(torch.tensor([loss_k]), torch.tensor([loss_p]), 1e-5,
            "cora-train-bf16 step loss vs plain on the card")
    compare(logp_k[:n], logp_p[:n], 1e-5, "cora-train-bf16 step log-probs vs plain on the card")
    for name, g in grads_k.items():
        compare(g, grads_p[name], BF16_GRAD_TOL, f"cora-train-bf16 step grad {name} vs plain")
    return {"cora16": cora16, "big16": big16, "train16": train16, "step_gen": step_gen}



def bf16_kernel_entries(dev, big, x_big, big_model, classes, mw0, train16, labels,
                        idx_train) -> dict:
    """The bf16 variants of kernels 1, 2 and 3 at synthetic-large, each held
    against its plain version (1e-5) and run to run (bitwise), timed beside
    the f32 kernel on the same values (in turns: f32, bf16, bf16, f32), with
    a bound on the bytes of its bf16 inputs. Kernel 1 at the widths the bf16
    paths give it: the SpMM forward's C=64 and C=16 (bf16 supports read
    through src), the half-fused route's (E, 128) bf16 messages and its
    gathers' VJP over the CSC (bf16 cotangent rows read through src_perm);
    kernels 2 and 3 on synthetic-large-train-bf16's own arguments and
    cotangent."""
    from mma_tpu_torch.ops import get_agg_spec, masked_aggregate
    from mma_tpu_torch.ops.cuda import fused_mma

    row_ptr, col_ptr = big.real_row_ptr, big.real_col_ptr
    e_cov, n_rows = int(row_ptr[-1]), big.n_node
    out = {}

    # ------------------------------------------------------------ kernel 1
    specs = [get_agg_spec(a) for a in ("mean", "mean2")]
    pat = masked_aggregate.sigmoid_lane_pattern(specs, "new_sigmoid", True, 64, dev)
    msgs = masked_aggregate._edge_messages(x_big.bfloat16(), big, mw0.bfloat16(), pat, 0.0, None)
    uses = {
        "spmm fwd (index=src) C=64": ((x_big @ big_model.gc1.w).bfloat16(), row_ptr, big.src),
        "spmm fwd (index=src) C=16": (classes.bfloat16(), row_ptr, big.src),
        "half-fused messages (no index) C=128": (msgs, row_ptr, None),
        "gather VJP (CSC, index=src_perm) C=128": (msgs, col_ptr, big.src_perm),
    }
    for what, (data, rp, index) in uses.items():
        ch = data.shape[1]
        got = fused_mma.segment_sum_csr(data, rp, index)
        if not torch.equal(got, fused_mma.segment_sum_csr(data, rp, index)):
            raise AssertionError(f"segment_sum_csr bf16 {what} differs run to run")
        err = compare(got, fused_mma.segment_sum_reference(data, rp, index), 1e-5,
                      f"segment_sum_csr bf16 {what} vs plain")
        data32 = data.float()
        ms, f32_ms = device_turns(lambda: fused_mma.segment_sum_csr(data32, rp, index),
                                lambda: fused_mma.segment_sum_csr(data, rp, index))
        plain_ms = device_ms(lambda: fused_mma.segment_sum_reference(data, rp, index), iters=10)
        # Bytes: the bf16 rows (the node table when indexed, the edge rows
        # otherwise) read once, the CSR and index, the float32 output.
        rows_in = n_rows if index is not None else e_cov
        nbytes = (2 * rows_in * ch + 4 * ((n_rows + 1) + (e_cov if index is not None else 0)
                                          + n_rows * ch))
        entry = {"name": "segment_sum_csr_bf16", "route": "cuda", "source": SOURCE,
                 "replaces": REPLACES["segment_sum_csr"], "max_abs_err": err["max_abs_err"],
                 "ms": ms, "plain_ms": plain_ms, **bound(nbytes, e_cov * ch),
                 # No one PyTorch call sums bf16 rows into float32.
                 "library_ms": None, "f32_ms": f32_ms,
                 "shape": f"{what}: E={e_cov} N={n_rows}, bf16 rows"}
        print(f"segment_sum_csr bf16 {what}: ms {ms:.4f} (the f32 kernel on the same values "
              f"{f32_ms:.4f}, in turns) plain_ms {plain_ms:.4f} bound_ms {entry['bound_ms']:.4f} "
              f"({entry['bound_by']}); bitwise equal run to run")
        if "segment_sum_csr_bf16" in out:
            out["segment_sum_csr_bf16"].setdefault("uses", {})[what] = {
                k: entry[k] for k in ("ms", "f32_ms", "plain_ms", "bound_ms", "bound_by",
                                      "max_abs_err", "shape")}
        else:
            out["segment_sum_csr_bf16"] = entry
    del msgs, uses

    # --------------------------------------------------------- kernels 2, 3
    step_gen = torch.Generator(device=dev).manual_seed(SEED)

    def one_step():
        with torch.enable_grad():
            train16.zero_grad(set_to_none=True)
            o = train16(x_big, big, training=True, generator=step_gen)
            (-o[idx_train, labels[idx_train]].mean()).backward()

    args, _, ct = capture_call(masked_aggregate, "edge_program_lean", one_step)
    c, w_bot, h, pat, src, rp, cp, dst_csc = (t.detach() for t in args)
    if h.dtype != torch.bfloat16:
        raise AssertionError(f"synthetic-large-train-bf16 gave kernel 2 a {h.dtype} h")
    f, kf = w_bot.shape
    fwd_args = (c, w_bot, h, pat, src, rp)
    h32 = h.float()
    got = fused_mma.edge_program_lean(*fwd_args, cp, dst_csc)
    if not torch.equal(got, fused_mma.edge_program_lean(*fwd_args, cp, dst_csc)):
        raise AssertionError("edge_program_lean_fwd bf16 differs run to run")
    err = compare(got, fused_mma.edge_program_lean_reference(*fwd_args), 1e-5,
                  "edge_program_lean_fwd bf16 vs plain")
    ms, f32_ms = device_turns(lambda: fused_mma.edge_program_lean(c, w_bot, h32, pat, src, rp, cp,
                                                               dst_csc),
                            lambda: fused_mma.edge_program_lean(*fwd_args, cp, dst_csc))
    plain_ms = device_ms(lambda: fused_mma.edge_program_lean_reference(*fwd_args), iters=5)
    # Bytes: c, W_bot, the pattern, src, the CSR and S as the f32 kernel's,
    # h in bf16.
    nbytes = 4 * (n_rows * kf + f * kf + kf + e_cov + (n_rows + 1) + n_rows * kf) + 2 * n_rows * f
    k2 = out["edge_program_lean_fwd_bf16"] = {
        "name": "edge_program_lean_fwd_bf16", "route": "cuda", "source": SOURCE,
        "replaces": REPLACES["edge_program_lean_fwd"], "max_abs_err": err["max_abs_err"],
        "ms": ms, "plain_ms": plain_ms, **bound(nbytes, 2 * n_rows * f * kf + 3 * e_cov * kf),
        "library_ms": None, "f32_ms": f32_ms,
        # The random D (f32) and h (bf16) rows the edge pass gathers.
        "gather_bound_ms": e_cov * (4 * kf + 2 * f) / PEAK_BYTES_PER_S * 1e3,
        "shape": f"E={e_cov} N={n_rows} F={f} K·F={kf}, bf16 h"}
    d_tab = fused_mma._lean_node_pass(h, w_bot)
    if not torch.equal(d_tab, fused_mma._node_product(h, w_bot)):
        raise AssertionError("edge_program_lean_fwd bf16 node pass differs from the plain D")
    k2["node_pass_ms"], k2["f32_node_pass_ms"] = device_turns(
        lambda: fused_mma._lean_node_pass(h32, w_bot), lambda: fused_mma._lean_node_pass(h, w_bot))
    k2["edge_pass_ms"], k2["f32_edge_pass_ms"] = device_turns(
        lambda: fused_mma._lean_edge_pass(c, pat, d_tab, h32, src, rp),
        lambda: fused_mma._lean_edge_pass(c, pat, d_tab, h, src, rp))
    print(f"edge_program_lean_fwd bf16: ms {ms:.4f} (f32 {f32_ms:.4f}, in turns) plain_ms "
          f"{plain_ms:.4f} bound_ms {k2['bound_ms']:.4f} ({k2['bound_by']}); node pass "
          f"{k2['node_pass_ms']:.4f} (f32 {k2['f32_node_pass_ms']:.4f}), edge pass "
          f"{k2['edge_pass_ms']:.4f} (f32 {k2['f32_edge_pass_ms']:.4f}) ms; gathered rows alone "
          f"{k2['gather_bound_ms']:.4f} ms; the node pass equals the plain D bit for bit")

    bwd_args = fwd_args + (cp, dst_csc, ct.contiguous())
    got = fused_mma.edge_program_lean_bwd(*bwd_args)
    if not all(torch.equal(a, b) for a, b in zip(got, fused_mma.edge_program_lean_bwd(*bwd_args))):
        raise AssertionError("edge_program_lean_bwd bf16 differs run to run")
    errs = [compare(g, w, 1e-5, f"edge_program_lean_bwd bf16 {name} vs plain")
            for g, w, name in zip(got, fused_mma.edge_program_lean_bwd_reference(*bwd_args),
                                  ("dc", "dW_bot", "dh"))]
    del got
    bwd32 = (c, w_bot, h32) + bwd_args[3:]
    ms, f32_ms = device_turns(lambda: fused_mma.edge_program_lean_bwd(*bwd32),
                            lambda: fused_mma.edge_program_lean_bwd(*bwd_args), iters=15)
    plain_ms = device_ms(lambda: fused_mma.edge_program_lean_bwd_reference(*bwd_args), iters=5)
    # Bytes: as the f32 kernel's (c, ct, dc; W_bot in and dW_bot out; the
    # pattern, src, dst_csc and both pointer arrays; dh out in f32), h in bf16.
    nbytes = (4 * (3 * n_rows * kf + n_rows * f + 2 * f * kf + kf + 2 * e_cov
                   + 2 * (n_rows + 1)) + 2 * n_rows * f)
    k3 = out["edge_program_lean_bwd_bf16"] = {
        "name": "edge_program_lean_bwd_bf16", "route": "cuda", "source": SOURCE,
        "replaces": REPLACES["edge_program_lean_bwd"],
        "max_abs_err": max(e["max_abs_err"] for e in errs), "ms": ms, "plain_ms": plain_ms,
        **bound(nbytes, 6 * n_rows * f * kf + 10 * e_cov * kf), "library_ms": None,
        "f32_ms": f32_ms,
        # D (f32) and h (bf16) by src in the dst pass, c and ct by dst in the
        # src pass.
        "gather_bound_ms": e_cov * (4 * kf + 2 * f + 8 * kf) / PEAK_BYTES_PER_S * 1e3,
        "shape": f"E={e_cov} N={n_rows} F={f} K·F={kf}, bf16 h"}
    ct3 = bwd_args[-1]
    ddg = fused_mma._lean_bwd_src_pass(c, ct3, pat, d_tab, h, dst_csc, cp)
    for part, run32, run16 in (
            ("dst_pass", lambda: fused_mma._lean_bwd_dst_pass(c, ct3, pat, d_tab, h32, src, rp),
             lambda: fused_mma._lean_bwd_dst_pass(c, ct3, pat, d_tab, h, src, rp)),
            ("src_pass", lambda: fused_mma._lean_bwd_src_pass(c, ct3, pat, d_tab, h32, dst_csc, cp),
             lambda: fused_mma._lean_bwd_src_pass(c, ct3, pat, d_tab, h, dst_csc, cp)),
            ("node_pass", lambda: fused_mma._lean_bwd_node_pass(ddg, h32, w_bot),
             lambda: fused_mma._lean_bwd_node_pass(ddg, h, w_bot))):
        k3[f"{part}_ms"], k3[f"f32_{part}_ms"] = device_turns(run32, run16, iters=15)
    print(f"edge_program_lean_bwd bf16: ms {ms:.4f} (f32 {f32_ms:.4f}, in turns) plain_ms "
          f"{plain_ms:.4f} bound_ms {k3['bound_ms']:.4f} ({k3['bound_by']}); parts: dst pass "
          f"{k3['dst_pass_ms']:.4f} (f32 {k3['f32_dst_pass_ms']:.4f}), src pass "
          f"{k3['src_pass_ms']:.4f} (f32 {k3['f32_src_pass_ms']:.4f}), node pass "
          f"{k3['node_pass_ms']:.4f} (f32 {k3['f32_node_pass_ms']:.4f}) ms; gathered rows alone "
          f"{k3['gather_bound_ms']:.4f} ms; bitwise equal run to run")
    return out


def wide_bf16_kernel_entries(dev, big, wide_run, masked16_in, pat) -> dict:
    """The bf16 variants of kernels 9-12 at synthetic-large, each on its
    path's own tensors, held against its plain version (1e-5) and run to run
    (bitwise), timed beside the f32 kernel on the same values (in turns:
    f32, bf16, bf16, f32), with a bound on the bytes of its inputs (bf16 at
    2 bytes an element). Kernels 9-11 on large-wide-bf16's edge-program
    arguments and cotangent (``c`` as the float32 table the autograd
    Function hands the kernels); kernel 12 on large-masked-bf16's bf16
    logits and rows, with ``index_add_`` of the pre-built bf16 message as
    its library time."""
    from mma_tpu_torch.ops import masked_aggregate
    from mma_tpu_torch.ops.cuda import fused_mma

    args, _, ct = capture_call(masked_aggregate, "edge_program",
                               lambda: wide_run("payload_permute", torch.bfloat16))
    c, d, h, pat_w, src, rp, cp, _, dst_csc, _ = args
    c, d, h = (t.detach() for t in (c, d, h))
    if (c.dtype, d.dtype, h.dtype) != (torch.bfloat16,) * 3:
        raise AssertionError(f"large-wide-bf16 gave kernels 9-11 {c.dtype}, {d.dtype}, {h.dtype}")
    c, ct = c.float(), ct.contiguous()
    d32, h32 = d.float(), h.float()
    n, f, kf = h.shape[0], h.shape[1], c.shape[1]
    e_cov = int(rp[-1])
    out = {}

    def entry(name, run16, run32, plain, outs, nbytes, flops, gather_bytes, shape,
              library=None, iters=25):
        got = run16()
        got = got if isinstance(got, tuple) else (got,)
        again = run16()
        again = again if isinstance(again, tuple) else (again,)
        if not all(torch.equal(a, b) for a, b in zip(got, again)):
            raise AssertionError(f"{name} differs run to run")
        want = plain()
        want = want if isinstance(want, tuple) else (want,)
        errs = [compare(g_, w_, 1e-5, f"{name} {o} vs plain") for g_, w_, o in zip(got, want, outs)]
        ms, f32_ms = device_turns(run32, run16, iters=iters)
        plain_ms = device_ms(plain, iters=5)
        e = out[name] = {
            "name": name, "route": "cuda", "source": SOURCE,
            "replaces": REPLACES[name[:-len("_bf16")]],
            "max_abs_err": max(x["max_abs_err"] for x in errs), "ms": ms, "plain_ms": plain_ms,
            **bound(nbytes, flops), "library_ms": None if library is None else device_ms(library),
            "f32_ms": f32_ms, "gather_bound_ms": gather_bytes / PEAK_BYTES_PER_S * 1e3,
            "shape": shape}
        print(f"{name}: ms {ms:.4f} (the f32 kernel on the same values {f32_ms:.4f}, in turns) "
              f"plain_ms {plain_ms:.4f} library_ms {e['library_ms']} bound_ms {e['bound_ms']:.4f} "
              f"({e['bound_by']}); gathered rows alone {e['gather_bound_ms']:.4f} ms; bitwise "
              "equal run to run")
        return got

    shape = f"E={e_cov} N={n} F={f} K·F={kf}, bf16 d and h, float32 c"
    fwd16, fwd32 = (c, d, h, pat_w, src, rp), (c, d32, h32, pat_w, src, rp)
    # Bytes: c (f32), d and h (bf16), the pattern, src and the CSR read once,
    # S (f32) written once; per edge and lane the add, the product, the sum.
    small = 4 * (kf + e_cov + (n + 1)) + 2 * (n * kf + n * f)
    entry("edge_program_fwd_bf16", lambda: fused_mma.edge_program_fwd(*fwd16),
          lambda: fused_mma.edge_program_fwd(*fwd32),
          lambda: fused_mma.edge_program_fwd_reference(*fwd16), ("S",),
          small + 4 * 2 * n * kf, 3 * e_cov * kf, 2 * e_cov * (kf + f), shape)
    # Bytes: c, ct (f32), d, h (bf16), the pattern, src and the CSR read once;
    # dc and the (E, K·F+F) payload (f32) written once.
    payload_bytes = 4 * big.n_edge * (kf + f)
    entry("edge_program_bwd_bf16", lambda: fused_mma.edge_program_bwd(*fwd16, ct),
          lambda: fused_mma.edge_program_bwd(*fwd32, ct),
          lambda: fused_mma.edge_program_bwd_reference(*fwd16, ct), ("dc", "payload"),
          small + 4 * 3 * n * kf + payload_bytes, 8 * e_cov * kf, 2 * e_cov * (kf + f), shape,
          iters=15)
    k10 = out["edge_program_bwd_bf16"]
    k10["ms_without_payload"], k10["f32_ms_without_payload"] = device_turns(
        lambda: fused_mma.edge_program_bwd(*fwd32, ct, emit_payload=False),
        lambda: fused_mma.edge_program_bwd(*fwd16, ct, emit_payload=False), iters=15)
    k10["bound_without_payload"] = bound(small + 4 * 3 * n * kf, 6 * e_cov * kf)
    print(f"edge_program_bwd_bf16 without the payload (csc_gather's use): ms "
          f"{k10['ms_without_payload']:.4f} (f32 {k10['f32_ms_without_payload']:.4f}, in turns) "
          f"bound_ms {k10['bound_without_payload']['bound_ms']:.4f}")
    # Bytes: c, ct (f32), d, h (bf16), the pattern, dst_csc and the CSC read
    # once, [dd ‖ dh] (f32) written once; per edge it gathers c and ct (f32)
    # of the dst.
    entry("edge_program_bwd_csc_bf16",
          lambda: fused_mma.edge_program_bwd_csc(c, d, h, pat_w, dst_csc, cp, ct),
          lambda: fused_mma.edge_program_bwd_csc(c, d32, h32, pat_w, dst_csc, cp, ct),
          lambda: fused_mma.edge_program_bwd_csc_reference(c, d, h, pat_w, dst_csc, cp, ct),
          ("[dd ‖ dh]",), small + 4 * (2 * n * kf + n * (kf + f)), 8 * e_cov * kf,
          4 * e_cov * 2 * kf, shape, iters=15)

    # Kernel 12 on large-masked-bf16's pre-gathered bf16 logits and rows.
    logits, h_src = masked16_in
    if (logits.dtype, h_src.dtype) != (torch.bfloat16, torch.bfloat16):
        raise AssertionError("large-masked-bf16 gave kernel 12 float32 operands")
    row_ptr = big.real_row_ptr
    margs = (logits, h_src, pat, row_ptr)
    msg = fused_mma._round_bf16(
        torch.where(pat.bool(), torch.sigmoid(logits[:e_cov].float()), logits[:e_cov].float())
        * h_src[:e_cov].float().repeat(1, kf // f)).bfloat16()
    ids = big.dst[:e_cov].long()
    l32, h32s = logits.float(), h_src.float()
    # Bytes: each covered edge's bf16 logits and h_src rows, the pattern and
    # the CSR read once, S (f32) written once; about 6 operations an edge
    # and lane.
    entry("masked_segment_sum_bf16", lambda: fused_mma.masked_segment_sum(*margs),
          lambda: fused_mma.masked_segment_sum(l32, h32s, pat, row_ptr),
          lambda: fused_mma.masked_segment_sum_reference(*margs), ("S",),
          2 * e_cov * (kf + f) + 4 * (kf + (n + 1) + n * kf), 6 * e_cov * kf,
          2 * e_cov * (kf + f), f"E={e_cov} N={n} F={f} K·F={kf}, bf16 logits and h_src "
          "(library: index_add_ over dst of the pre-built bf16 message)",
          library=lambda: torch.zeros(n, kf, dtype=torch.bfloat16, device=dev).index_add_(
              0, ids, msg))
    # Skew: the heaviest row alone, split over kernel 1's chunks and
    # joined by the fixup, beside the f32 kernel on the same values.
    deg = row_ptr[1:] - row_ptr[:-1]
    top = int(torch.argmax(deg))
    one_row = row_ptr[top:top + 2].contiguous()
    k12 = out["masked_segment_sum_bf16"]
    k12["heaviest_row_ms"], k12["f32_heaviest_row_ms"] = device_turns(
        lambda: fused_mma.masked_segment_sum(l32, h32s, pat, one_row),
        lambda: fused_mma.masked_segment_sum(logits, h_src, pat, one_row))
    print(f"masked_segment_sum_bf16: the heaviest row alone ({int(deg[top])} edges) "
          f"ms {k12['heaviest_row_ms']:.4f} (f32 {k12['f32_heaviest_row_ms']:.4f}, in turns)")
    return out


def records(history) -> list:
    """A loop's per-epoch records without their host-clock times."""
    return [{k: v for k, v in r.items() if k != "time"} for r in history]


def hold_weights(got: dict, want: dict, rel: float, what: str) -> bool:
    """Every tensor of ``got`` within ``rel`` of ``want`` (``compare``'s
    rule); returns whether all are bitwise equal."""
    if list(got) != list(want):
        raise AssertionError(f"{what}: tensors {sorted(got)} != {sorted(want)}")
    worst = 0.0
    for k in want:
        worst = max(worst, compare(got[k], want[k], rel, f"{what} {k}", verbose=False)[
            "max_abs_err"])
    equal = all(torch.equal(got[k], want[k]) for k in want)
    print(f"{what}: {len(want)} tensors within {rel:g}, max_abs_err {worst:.3e}, bitwise equal "
          f"{equal}")
    return equal


def run_resume_and_serving(dev, paths: dict, ctx: dict) -> None:
    """Checkpoint/resume, the resilient step runner and the exported
    artifacts: the main paths cora-train-resume, zinc-train-resume,
    synthetic-large-train-resilient, cora-serve-export,
    synthetic-large-serve-export, synthetic-large-serve-bf16-export and
    zinc-serve-export, their checks, launch counts and times, and the holds
    of the ``mma_tpu_torch::*`` operators against their kernels."""
    import tempfile

    from mma_tpu_torch import NodeClassifier
    from mma_tpu_torch.data import load_zinc
    from mma_tpu_torch.models import ZincNet
    from mma_tpu_torch.ops.cuda import fused_mma
    from mma_tpu_torch.ops.cuda import segment_minmax as mm
    from mma_tpu_torch.serve import export_node_classifier, export_zinc_predictor, load_forward
    from mma_tpu_torch.train import (NODE_CLS_PRESETS, ResilientRunner, ZincConfig, checkpoint,
                                     make_optimizer, train_node_classification, train_zinc)
    from mma_tpu_torch.train.loops import node_train_step, zinc_layout

    cora, big, x_big, n_big = ctx["cora"], ctx["big"], ctx["x_big"], ctx["n_big"]
    layers = 4

    # ------------------------------------------ main path: cora-train-resume
    # The README preset 100 epochs with a checkpoint every 50, then a fresh
    # call resumes to 200, against 200 straight: every record, the test
    # accuracy and every weight bit for bit (deterministic algorithms).
    cfg = dataclasses.replace(NODE_CLS_PRESETS["cora"], seed=SEED)
    io_ms = {"save": [], "restore": []}
    run_s = {}
    with tempfile.TemporaryDirectory() as d, counted("cora-train-resume", paths), \
            deterministic(), timed(checkpoint, "save_checkpoint", io_ms["save"]), \
            timed(checkpoint, "restore_checkpoint", io_ms["restore"]), \
            open(os.path.join(LOG_DIR, "chip_smoke_train_resume.log"), "w") as log, \
            contextlib.redirect_stdout(log):
        ck = dict(checkpoint_dir=d, checkpoint_every=50)
        for name, c in (("straight", cfg), ("first", dataclasses.replace(cfg, epochs=100, **ck)),
                        ("resumed", dataclasses.replace(cfg, resume=True, **ck))):
            t0 = time.perf_counter()
            run_s[name] = (train_node_classification(c, data=cora, device=dev),
                           time.perf_counter() - t0)
    straight, first, resumed = (run_s[k][0] for k in ("straight", "first", "resumed"))
    if ([r["epoch"] for r in first["history"]] != list(range(1, 101))
            or [r["epoch"] for r in resumed["history"]] != list(range(101, 201))):
        raise AssertionError("cora-train-resume: the runs trained the wrong epochs")
    if records(resumed["history"]) != records(straight["history"][100:]):
        raise AssertionError("cora-train-resume: the resumed records differ from the straight run")
    if (resumed["acc_test"], resumed["loss_test"]) != (straight["acc_test"], straight["loss_test"]):
        raise AssertionError("cora-train-resume: test accuracy or loss differs")
    if not hold_weights(resumed["model"].state_dict(), straight["model"].state_dict(), 0.0,
                        "cora-train-resume weights vs the straight run"):
        raise AssertionError("cora-train-resume: weights not bitwise equal")
    print(f"cora-train-resume: 100 + 100 epochs equal 200 straight bit for bit (test accuracy "
          f"{resumed['acc_test']:.4f}); runs {', '.join(f'{k} {v[1]:.3f} s' for k, v in run_s.items())}"
          f"; {len(io_ms['save'])} saves, median {statistics.median(io_ms['save']):.3f} ms; "
          f"{len(io_ms['restore'])} restore, {io_ms['restore'][0]:.3f} ms (host clock)")
    # 400 epochs over 3 runs, as cora-train counts them (kernel 1 six times,
    # kernel 2 once and kernels 2-3 with the keep once an epoch, one more
    # eval forward a run).
    expect_launches(paths, "cora-train-resume", segment_sum=400 * 6 + 3 * 2,
                    edge_program_lean=400 + 3, edge_program_lean_keep=400,
                    edge_program_lean_keep_bwd=400)
    del run_s, straight, first, resumed

    # ------------------------------------------ main path: zinc-train-resume
    # zinc-train's config 3 epochs straight, and 2 epochs then a resume to 3.
    aggs, scalers = ZINC_PRESET_AGGS
    zcfg = ZincConfig(aggregators=aggs, scalers=scalers, lr=1e-4, weight_decay=3e-4,
                      batch_size=64, epochs=3, subset_size=2000, seed=SEED)
    splits = {s_: load_zinc(s_, subset_size=zcfg.subset_size) for s_ in ("train", "val", "test")}
    if zinc_layout(zcfg, list(splits.values()))[2] is not None:
        raise AssertionError("zinc-train-resume: expected the plain collate")
    steps = -(-len(splits["train"]) // zcfg.batch_size)
    evals = sum(-(-len(splits[s_]) // zcfg.batch_size) for s_ in ("val", "test"))
    io_ms = {"save": [], "restore": []}
    with tempfile.TemporaryDirectory() as d, counted("zinc-train-resume", paths), \
            timed(checkpoint, "save_checkpoint", io_ms["save"]), \
            timed(checkpoint, "restore_checkpoint", io_ms["restore"]), \
            open(os.path.join(LOG_DIR, "chip_smoke_zinc_train_resume.log"), "w") as log, \
            contextlib.redirect_stdout(log):
        ck = dict(checkpoint_dir=d, checkpoint_every=1)
        straight = train_zinc(zcfg, datasets=splits, device=dev)
        train_zinc(dataclasses.replace(zcfg, epochs=2, **ck), datasets=splits, device=dev)
        resumed = train_zinc(dataclasses.replace(zcfg, resume=True, **ck), datasets=splits,
                             device=dev)
    if [r["epoch"] for r in resumed["history"]] != [2]:
        raise AssertionError("zinc-train-resume: the resumed run trained the wrong epochs")
    hold_weights(resumed["model"].state_dict(), straight["model"].state_dict(), 1e-5,
                 "zinc-train-resume params and BatchNorm state vs the straight run")
    lr_got, lr_want = resumed["history"][-1]["lr"], straight["history"][-1]["lr"]
    compare(torch.tensor([lr_got]), torch.tensor([lr_want]), 1e-5, "zinc-train-resume lr")
    print(f"zinc-train-resume: val MAE {resumed['val_mae']:.6f} (straight "
          f"{straight['val_mae']:.6f}); {len(io_ms['save'])} saves, median "
          f"{statistics.median(io_ms['save']):.3f} ms; restore {io_ms['restore'][0]:.3f} ms "
          "(host clock)")
    # 6 epochs over 3 runs, as zinc-train counts them on the plain collate.
    expect_launches(paths, "zinc-train-resume", minmax_prog=6 * layers * (steps + evals),
                    minmax_prog_bwd=6 * layers * steps,
                    segment_sum=6 * (steps * (layers + 1) + evals))
    del straight, resumed, splits

    # ------------------------------ main path: synthetic-large-train-resilient
    # ResilientRunner over 8 train steps of large-train's model, each on its
    # own half of the nodes: batch 2 fails twice (skipped), batch 5 once
    # (retried), and the first step on batch 6 raises. Against a clean run
    # over the same batches without batch 2.
    labels = ctx["labels"]
    model = NodeClassifier(64, 64, 16, ("mean", "mean2"), dropout_rate=0.0, device=dev,
                           generator=torch.Generator().manual_seed(SEED + 3))
    opt = make_optimizer(model.parameters(), 1e-3)
    bgen = torch.Generator().manual_seed(SEED + 6)
    batches = [(i, torch.randperm(n_big, generator=bgen)[: n_big // 2].to(dev)) for i in range(8)]
    state0 = {"params": {k: v.clone() for k, v in model.state_dict().items()},
              "opt": copy.deepcopy(opt.state_dict())}
    ran, calls = [], {}

    def step_fn(state, batch, faults=True):
        i, idx = batch
        calls[i] = calls.get(i, 0) + 1
        if faults and i == 6 and calls[i] == 1:
            raise RuntimeError("injected device error")
        model.load_state_dict(state["params"])
        opt.load_state_dict(copy.deepcopy(state["opt"]))
        loss, _ = node_train_step(model, opt, x_big, big, labels, idx, None)
        ran.append(i)
        return ({"params": {k: v.clone() for k, v in model.state_dict().items()},
                 "opt": copy.deepcopy(opt.state_dict())}, loss)

    visits = {}

    def inject(i):
        visits[i] = visits.get(i, 0) + 1
        return "injected" if (i == 2 and visits[i] <= 2) or (i == 5 and visits[i] == 1) else None

    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as d, counted("synthetic-large-train-resilient", paths):
        runner = ResilientRunner(os.path.join(d, "faults"), checkpoint_every=2, max_restarts=5,
                                 inject_fault=inject)
        final = runner.run(step_fn, state0, batches)
        faulty_s = time.perf_counter() - t0
        calls.clear()
        clean = ResilientRunner(os.path.join(d, "clean"), checkpoint_every=0).run(
            functools.partial(step_fn, faults=False), state0,
            [b for b in batches if b[0] != 2])
    for f in runner.failures:
        print(f"synthetic-large-train-resilient: {f}")
    kinds = [(f.step, f.kind, f.restored_step) for f in runner.failures]
    if kinds != [(2, "injected", 2), (2, "injected", 2), (5, "injected", 4),
                 (6, "exception", 6)]:
        raise AssertionError(f"synthetic-large-train-resilient: failures {kinds}")
    hold_weights(final["params"], clean["params"], 1e-5,
                 "synthetic-large-train-resilient weights vs the clean run without batch 2")
    print(f"synthetic-large-train-resilient: {len(ran)} steps run ({ran}); the run with faults "
          f"took {faulty_s:.3f} s (host clock)")
    # Per step run, as large-train: kernel 1 four times, kernels 2 and 3 once.
    expect_launches(paths, "synthetic-large-train-resilient", segment_sum=4 * len(ran),
                    edge_program_lean=len(ran), edge_program_lean_bwd=len(ran))
    del model, opt, final, clean, state0, batches

    # ------------------------------------------ main paths: exported serving
    zbatch, _, avg = zinc_flagship(dev)
    zmodel = ZincNet(*ZINC_PRESET_AGGS, avg, num_layers=layers, device=dev,
                     generator=torch.Generator().manual_seed(SEED))
    buffers = {k for k, _ in zmodel.named_buffers()}
    zweights = zmodel.state_dict()
    zparams = {k: v for k, v in zweights.items() if k not in buffers}
    zstate = {k: v for k, v in zweights.items() if k in buffers}
    zmodel16 = ZincNet(*ZINC_PRESET_AGGS, avg, num_layers=layers, compute_dtype="bfloat16",
                       device=dev)
    zmodel16.load_state_dict(zweights)
    requests = ctx["requests"]
    node = {"cora": (ctx["cora_model"], cora.graph, cora.num_nodes),
            "big": (ctx["big_model"], big, n_big), "big16": (ctx["big16"], big, n_big)}

    def node_case(key, xs):
        model, g, n = node[key]
        p = model.state_dict()
        return (lambda: export_node_classifier(model, p, xs[0], g),
                [(p, xs[i % len(xs)], g) for i in range(10)],
                lambda p_, x_, g_: model(x_, g_), n)

    cases = (
        ("cora-serve-export", node_case("cora", requests), dict(segment_sum=2, edge_program_lean=1)),
        ("synthetic-large-serve-export", node_case("big", [x_big]),
         dict(segment_sum=2, edge_program_lean=1)),
        ("synthetic-large-serve-bf16-export", node_case("big16", [x_big]),
         dict(segment_sum_bf16=2, edge_program_lean_bf16=1)),
        ("zinc-serve-export", (lambda: export_zinc_predictor(zmodel, zparams, zstate, zbatch),
                               [(zparams, zstate, zbatch)] * 10, lambda p_, s_, b_: zmodel(b_),
                               1024),
         dict(minmax_prog=layers, segment_sum=1)),
        ("zinc-serve-bf16-export",
         (lambda: export_zinc_predictor(zmodel16, zparams, zstate, zbatch),
          [(zparams, zstate, zbatch)] * 10, lambda p_, s_, b_: zmodel16(b_), 1024),
         dict(minmax_prog_bf16=layers, segment_sum=1)),
    )
    for path, (make_blob, reqs, eager, n_real), per_request in cases:
        t0 = time.perf_counter()
        blob = make_blob()
        export_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        served = load_forward(blob)
        load_s = time.perf_counter() - t0
        with counted(path, paths), torch.no_grad():
            outs = [served(*r) for r in reqs]
        # Export and load launch nothing: every launch is a served request's.
        expect_launches(paths, path, **{k: 10 * v for k, v in per_request.items()})
        bitwise = True
        with torch.no_grad():
            for i, (r, out) in enumerate(zip(reqs, outs)):
                want = eager(*r)
                if out.shape != want.shape or not torch.isfinite(out[:n_real]).all():
                    raise AssertionError(f"{path} request {i}: shape {tuple(out.shape)} or "
                                         "non-finite output")
                compare(out[:n_real], want[:n_real], 1e-6, f"{path} request {i} vs eager",
                        verbose=i == 0)
                bitwise &= torch.equal(out[:n_real], want[:n_real])
            # Eager and served in turns (eager, served, served, eager): the
            # host-clock and CUDA-event medians of one request.
            t = {"eager": [], "served": []}
            ev = {"eager": [], "served": []}
            for which in ("eager", "served", "served", "eager"):
                fn = eager if which == "eager" else served
                t[which] += host_ms(lambda: fn(*reqs[0]), 10)
                ev[which].append(device_ms(lambda: fn(*reqs[0]), iters=10))
        print(f"{path}: artifact {len(blob)} bytes, export {export_s:.3f} s, load {load_s:.3f} s; "
              f"10 requests within 1e-6 of eager, bitwise equal {bitwise}; one request (host "
              f"clock / CUDA events, medians, in turns): served "
              f"{statistics.median(t['served']):.4f} / {statistics.median(ev['served']):.4f} ms, "
              f"eager {statistics.median(t['eager']):.4f} / "
              f"{statistics.median(ev['eager']):.4f} ms")

    # ------------------------------ the operators against their kernels
    # Each mma_tpu_torch::* operator on the card equals its kernel called
    # directly, bit for bit, and each call launches once.
    with torch.no_grad():
        rp, src = big.real_row_ptr, big.src
        rows = x_big.index_select(0, src.long())
        lean_args, _, _ = capture_call(fused_mma, "_edge_program_lean_kernel",
                                       lambda: ctx["big_model"](x_big, big))
        lean16_args, _, _ = capture_call(fused_mma, "_edge_program_lean_kernel",
                                         lambda: ctx["big16"](x_big, big))
        prog_args, _, _ = capture_call(mm, "_minmax_prog_kernel", lambda: zmodel(zbatch))
        prog16_args, _, _ = capture_call(mm, "_minmax_prog_kernel", lambda: zmodel16(zbatch))
        zrp = zbatch.graph.real_row_ptr
        zrows = torch.randn((zbatch.graph.n_edge, prog_args[0].shape[1]),
                            generator=torch.Generator().manual_seed(SEED + 7)).to(dev)
        ops = torch.ops.mma_tpu_torch
        holds = (
            ("segment_sum_csr", "segment_sum", ops.segment_sum_csr, (rows, rp),
             lambda *a: fused_mma._segment_sum_kernel(*a)),
            ("segment_sum_csr bf16", "segment_sum_bf16", ops.segment_sum_csr,
             (rows.bfloat16(), rp), lambda *a: fused_mma._segment_sum_kernel(*a)),
            ("segment_sum_csr index", "segment_sum", ops.segment_sum_csr, (x_big, rp, src),
             lambda *a: fused_mma._segment_sum_kernel(*a)),
            ("segment_sum_csr index bf16", "segment_sum_bf16", ops.segment_sum_csr,
             (x_big.bfloat16(), rp, src), lambda *a: fused_mma._segment_sum_kernel(*a)),
            ("edge_program_lean", "edge_program_lean", ops.edge_program_lean, lean_args,
             lambda *a: fused_mma._edge_program_lean_kernel(*a)),
            ("edge_program_lean bf16", "edge_program_lean_bf16", ops.edge_program_lean,
             lean16_args, lambda *a: fused_mma._edge_program_lean_kernel(*a)),
            ("segment_minmax", "segment_minmax", ops.segment_minmax,
             (zrows, zrp, ["min", "max"]),
             lambda d_, r_, o_: mm._segment_minmax_kernel(d_, r_, tuple(o_))),
            ("minmax_edge_program", "minmax_prog", ops.minmax_edge_program,
             prog_args[:3] + (list(prog_args[3]),) + prog_args[4:],
             lambda c_, h_, r_, o_, s_, t_: mm._minmax_prog_kernel(c_, h_, r_, tuple(o_), s_, t_)),
            ("segment_sum_sq_csr", "segment_sum_sq", ops.segment_sum_sq_csr, (zrows, zrp),
             lambda *a: fused_mma._segment_sum_sq_kernel(*a)),
            ("segment_minmax bf16", "segment_minmax_bf16", ops.segment_minmax,
             (zrows.bfloat16(), zrp, ["min", "max"]),
             lambda d_, r_, o_: mm._segment_minmax_kernel(d_, r_, tuple(o_))),
            ("minmax_edge_program bf16", "minmax_prog_bf16", ops.minmax_edge_program,
             prog16_args[:3] + (list(prog16_args[3]),) + prog16_args[4:],
             lambda c_, h_, r_, o_, s_, t_: mm._minmax_prog_kernel(c_, h_, r_, tuple(o_), s_, t_)),
            ("segment_sum_sq_csr bf16", "segment_sum_sq_bf16", ops.segment_sum_sq_csr,
             (zrows.bfloat16(), zrp), lambda *a: fused_mma._segment_sum_sq_kernel(*a)),
        )
        for what, key, op, args, direct in holds:
            before = launches()[key]
            got = op(*args)
            torch.cuda.synchronize()
            mid = launches()[key]
            want = direct(*args)
            torch.cuda.synchronize()
            if (mid - before, launches()[key] - mid) != (1, 1):
                raise AssertionError(f"operator {what}: launches {mid - before} and "
                                     f"{launches()[key] - mid}, expected 1 and 1")
            if not torch.equal(got, want):
                raise AssertionError(f"operator {what}: differs from its kernel called directly")
        print(f"mma_tpu_torch operators: {len(holds)} holds, each bitwise equal to its kernel "
              "called directly, one launch each")


# ------------------------------------------------------------ parallel paths
#
# The multi-device regimes (mma_tpu_torch.parallel). The card is one H100,
# so they run as a world of one on NCCL in this process, each held bitwise
# against its single-device twin, then as a world of two processes sharing
# the card over gloo, held within 1e-5 of single-device computations. Two
# ranks on one card measure correctness, not scaling: no time of theirs is
# a multi-card figure.

TWO_RANK_DIR = os.path.join(LOG_DIR, "chip_smoke_two_ranks")


def zinc_step_launches(layers: int) -> dict:
    """Kernel calls of one ZincNet train step of the README preset (min,max)
    on the plain collate: kernels 6 and 7 once per layer, kernel 1 once per
    layer (the gather_by_src VJP) and once for the pool."""
    return {"minmax_prog": layers, "minmax_prog_bwd": layers, "segment_sum": layers + 1}


def zinc_general_launches(layers: int, steps: int, evals: int) -> dict:
    """Kernel calls of ``mean,max,min`` on the general CSR route, as
    zinc-train-default counts them: per step and layer kernel 4 and kernel 1
    forward, kernel 5 and kernel 1 twice backward, and kernel 1 for the
    pool; per eval forward kernel 4 and kernel 1 per layer and the pool."""
    return {"segment_minmax": layers * (steps + evals), "segment_minmax_bwd": layers * steps,
            "segment_sum": steps * (3 * layers + 1) + evals * (layers + 1)}


def scaled(per_step: dict, n: int) -> dict:
    return {k: v * n for k, v in per_step.items()}


def collective_stats() -> str:
    from mma_tpu_torch.parallel import collectives

    s = collectives.STATS
    return ", ".join(f"{op} {s[op + '_calls']} calls / {s[op + '_bytes']} B"
                     for op in ("all_reduce", "all_gather", "reduce_scatter", "all_to_all"))


NODE_SHARDED_FWD_SEG_SUMS = 6   # gc1's, the masked sums' and the final SpMM's interior and boundary
NODE_SHARDED_STEP_SEG_SUMS = 8  # the forward's and the VJPs of c's interior and boundary gathers


def node_sharded_pieces(big, x_big, labels, idx_train, mesh, dev, num_shards: int,
                        method: str = "contiguous"):
    """The node-sharded plan of the synthetic-large graph (``method``: the
    contiguous or the LDG order) and this rank's pieces: ``(sg_local, x,
    labels, train mask, report)``, the report holding the plan's host time,
    pads, halo rows and boundary-edge fraction."""
    from mma_tpu_torch.parallel import build_node_sharded_ordered, place_on_mesh, shard_node_values

    n = int(big.node_mask.sum())
    t0 = time.perf_counter()
    sg, cuts, order = build_node_sharded_ordered(big, num_shards, method)
    build_s = time.perf_counter() - t0
    n_m = sg.node_mask.shape[1]
    tmask = np.zeros(n, bool)
    tmask[idx_train.cpu().numpy()] = True

    def local(values):
        return place_on_mesh(shard_node_values(values, cuts, n_m, order=order), mesh, "node",
                             device=dev)

    rank = mesh.get_local_rank("node")
    report = {"plan_build_s": build_s, "N_m": n_m, "E_m": sg.ext_src.shape[1],
              "B_m": sg.bnd_halo.shape[1], "H_m": sg.send_idx.shape[2],
              "edges_on_rank": int(sg.edge_mask[rank].sum()),
              "boundary_edges_on_rank": int(sg.bnd_mask[rank].sum()),
              "boundary_fraction": float(sg.bnd_mask.sum() / sg.edge_mask.sum()),
              "halo_rows_sent": int(sg.send_mask[rank].sum()),
              "halo_rows_received": int(sg.send_mask[:, rank].sum())}
    return (place_on_mesh(sg, mesh, "node", device=dev), local(x_big.cpu().numpy()[:n]),
            local(labels.cpu().numpy()[:n, None])[:, 0], local(tmask[:, None])[:, 0], report)


def worst(errs: dict) -> dict:
    """The largest of several ``compare`` results, by relative error."""
    name = max(errs, key=lambda k: errs[k]["max_rel_err"])
    return {"of": name, "tensors": len(errs), **errs[name]}


def params_equal(a: torch.nn.Module, b: torch.nn.Module) -> bool:
    return all(torch.equal(x, y) for x, y in zip(a.state_dict().values(),
                                                 b.state_dict().values()))


def in_turns(first, second, n: int = 10):
    """Host-clock ms of ``n`` calls of each, alternating, each call ended
    by a sync."""
    times = ([], [])
    for _ in range(n):
        for fn, out in ((first, times[0]), (second, times[1])):
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            out.append((time.perf_counter() - t0) * 1e3)
    return times


def zinc_micro_batches(dev, count: int, size: int = 1024):
    """``count`` ZINC train batches of ``size`` molecules each (the first is
    the flagship batch's molecules), padded alike to the next 1,024 nodes
    and edges of the largest."""
    from mma_tpu_torch.data import load_zinc
    from mma_tpu_torch.nn import mma_conv

    ds = load_zinc("train", subset_size=count * size)
    nodes = [int(ds.num_nodes[i * size:(i + 1) * size].sum()) + 1 for i in range(count)]
    edges = [sum(len(s_) for s_ in ds.edge_src[i * size:(i + 1) * size]) for i in range(count)]
    batches = list(ds.batches(size, n_node=-(-max(nodes) // 1024) * 1024,
                              n_edge=-(-max(edges) // 1024) * 1024, device=dev))
    return batches, mma_conv.compute_avg_deg(ds.degree_histogram(), parity=True)


def run_parallel(dev, paths: dict, ctx: dict) -> None:
    """World of one on NCCL in this process: the edge-sharded
    synthetic-large forward and 3 steps, 3 data-parallel ZINC steps at the
    flagship batch and 3 data-parallel sampled steps, each bitwise equal to
    its single-device twin under deterministic algorithms, timed beside it
    in turns (10 steps each after the checked ones, in the default mode)."""
    import torch.distributed as dist

    from mma_tpu_torch import NodeClassifier, graft_entry
    from mma_tpu_torch.cli import train_sampled as cli
    from mma_tpu_torch.models import ZincNet
    from mma_tpu_torch.parallel import (
        collectives,
        initialize_distributed,
        make_dp_train_step,
        make_edge_sharded_forward,
        make_edge_sharded_train_step,
        make_mesh,
        make_node_sharded_forward,
        make_node_sharded_train_step,
        shard_graph,
        shard_stacked_batch,
        stack_batches,
    )
    from mma_tpu_torch.train import make_optimizer
    from mma_tpu_torch.train.loops import node_train_step, zinc_train_step

    rank_dev = initialize_distributed(str(dev))
    print(f"world of one: {dist.get_backend()} on {rank_dev}")
    try:
        # ------------------------ main path: synthetic-large-edge-sharded
        big, x_big, labels, idx_train = ctx["big"], ctx["x_big"], ctx["labels"], ctx["idx_train"]
        mesh = make_mesh(("edge",))

        def model():
            m = NodeClassifier(64, 64, 16, ("mean", "mean2"), dropout_rate=0.0, device=dev,
                               generator=torch.Generator().manual_seed(SEED + 3))
            m.load_state_dict(ctx["init_state"])
            return m

        sharded, twin = model(), model()
        shard = shard_graph(big, mesh, "edge", kernel_structure=True)
        for f in ("src", "dst", "row_ptr", "src_perm", "col_ptr", "dst_csc"):
            if not torch.equal(getattr(shard, f), getattr(big, f)):
                raise AssertionError(f"the one shard's {f} differs from the graph's")
        opt_s = make_optimizer(sharded.parameters(), 1e-3)
        opt_t = make_optimizer(twin.parameters(), 1e-3)
        step = make_edge_sharded_train_step(sharded, opt_s, mesh, labels, idx_train, "edge")
        losses = ([], [])
        collectives.reset_stats()
        with deterministic():
            with counted("synthetic-large-edge-sharded", paths):
                with torch.no_grad():
                    out = make_edge_sharded_forward(sharded, mesh, "edge")(x_big, shard)
                fwd_stats = collective_stats()
                collectives.reset_stats()
                for _ in range(3):
                    losses[0].append(float(step(x_big, shard)))
            step_stats = collective_stats()
            with torch.no_grad():
                want = twin(x_big, big)
            for _ in range(3):
                losses[1].append(float(node_train_step(twin, opt_t, x_big, big, labels,
                                                       idx_train, None)[0]))
            same = (torch.equal(out, want) and losses[0] == losses[1]
                    and params_equal(sharded, twin))
        ms = in_turns(lambda: step(x_big, shard),
                      lambda: node_train_step(twin, opt_t, x_big, big, labels, idx_train, None))
        print(f"synthetic-large-edge-sharded (1 shard, kernel structure): forward and 3 Adam "
              f"steps bitwise equal to the single-device twin: {same}; losses {losses[0]}; "
              f"step (host clock, in turns) sharded {ms[0]} ms, median "
              f"{statistics.median(ms[0]):.4f}; twin {ms[1]} ms, median "
              f"{statistics.median(ms[1]):.4f}; collectives: forward {fwd_stats}; 3 steps "
              f"{step_stats}")
        if not same:
            raise AssertionError("synthetic-large-edge-sharded differs from its twin")
        # The forward: kernel 1 x2 and kernel 2; then 3 lean steps.
        expect_launches(paths, "synthetic-large-edge-sharded", segment_sum=2 + 3 * 4,
                        edge_program_lean=1 + 3, edge_program_lean_bwd=3)
        del sharded, twin, shard, opt_s, opt_t, step, out, want

        # ------------------------ main path: synthetic-large-node-sharded
        # The large-train model on the node-sharded plan of one shard: its
        # messages built plainly and summed by kernel 1, where the twin takes
        # the lean route (kernels 2-3), so within 1e-5 and not bitwise.
        nmesh = make_mesh(("node",))
        sgl, x_l, labels_l, tmask_l, plan = node_sharded_pieces(big, x_big, labels, idx_train,
                                                                 nmesh, rank_dev, 1)
        n_big = int(big.node_mask.sum())
        sharded, twin = model(), model()
        opt_s = make_optimizer(sharded.parameters(), 1e-3)
        opt_t = make_optimizer(twin.parameters(), 1e-3)
        nstep = make_node_sharded_train_step(sharded, opt_s, nmesh, "node", dropout=False)
        losses, grads1 = ([], []), [None, None]
        collectives.reset_stats()
        with counted("synthetic-large-node-sharded", paths):
            with torch.no_grad():
                out = make_node_sharded_forward(sharded, nmesh, "node")(x_l, sgl)
            fwd_stats = collective_stats()
            collectives.reset_stats()
            for i in range(3):
                losses[0].append(float(nstep(x_l, sgl, labels_l, tmask_l)))
                if i == 0:
                    grads1[0] = {n_: p.grad.clone() for n_, p in sharded.named_parameters()}
        step_stats = collective_stats()
        with torch.no_grad():
            want = twin(x_big, big)
        for i in range(3):
            losses[1].append(float(node_train_step(twin, opt_t, x_big, big, labels, idx_train,
                                                   None)[0]))
            if i == 0:
                grads1[1] = {n_: p.grad.clone() for n_, p in twin.named_parameters()}
        errs = {
            "forward": compare(out[:n_big], want[:n_big], 1e-5, "synthetic-large-node-sharded "
                               "forward vs the single-device twin"),
            "losses": compare(torch.tensor(losses[0]), torch.tensor(losses[1]), 1e-5,
                              "synthetic-large-node-sharded 3 step losses vs the twin's"),
            "grads": worst({n_: compare(g, grads1[1][n_], 1e-5, f"synthetic-large-node-sharded "
                                        f"step 1 grad {n_}", verbose=False)
                            for n_, g in grads1[0].items()})}
        ms = in_turns(lambda: nstep(x_l, sgl, labels_l, tmask_l),
                      lambda: node_train_step(twin, opt_t, x_big, big, labels, idx_train, None))
        print(f"synthetic-large-node-sharded (1 shard, plan {plan}): forward, 3 step losses and "
              f"step-1 gradients within 1e-5 of the single-device twin: {errs}; losses "
              f"{losses[0]}; step (host clock, in turns) node-sharded {ms[0]} ms, median "
              f"{statistics.median(ms[0]):.4f}; twin {ms[1]} ms, median "
              f"{statistics.median(ms[1]):.4f}; collectives: forward {fwd_stats}; 3 steps "
              f"{step_stats}")
        expect_launches(paths, "synthetic-large-node-sharded",
                        segment_sum=NODE_SHARDED_FWD_SEG_SUMS + 3 * NODE_SHARDED_STEP_SEG_SUMS)
        del sharded, twin, opt_s, opt_t, nstep, out, want, sgl, x_l, grads1

        # --------------------------------------------- main path: zinc-dp
        layers = 4
        (batch,), avg = zinc_micro_batches(dev, 1)
        dmesh = make_mesh(("data",))

        def zmodel():
            return ZincNet(*ZINC_PRESET_AGGS, avg, num_layers=layers, device=dev,
                           generator=torch.Generator().manual_seed(SEED + 11))

        dp_model, twin = zmodel(), zmodel()
        opt_d = make_optimizer(dp_model.parameters(), 1e-4, 3e-4)
        opt_t = make_optimizer(twin.parameters(), 1e-4, 3e-4)
        dp_step = make_dp_train_step(dp_model, opt_d, dmesh, "data")
        piece = shard_stacked_batch(stack_batches([batch]), dmesh)
        gens = [torch.Generator(device=dev).manual_seed(SEED) for _ in range(2)]
        losses = ([], [])
        collectives.reset_stats()
        with deterministic():
            with counted("zinc-dp", paths):
                for _ in range(3):
                    losses[0].append(float(dp_step(piece, gens[0])))
            stats = collective_stats()
            for _ in range(3):
                losses[1].append(float(zinc_train_step(twin, opt_t, batch, gens[1])))
            same = losses[0] == losses[1] and params_equal(dp_model, twin)
        ms = in_turns(lambda: dp_step(piece, gens[0]),
                      lambda: zinc_train_step(twin, opt_t, batch, gens[1]))
        print(f"zinc-dp (1 rank, the flagship batch, {'/'.join(ZINC_PRESET_AGGS[0])}, dropout "
              f"on): 3 steps bitwise equal to zinc_train_step (parameters and BatchNorm "
              f"buffers): {same}; losses {losses[0]}; step (host clock, in turns) DP {ms[0]} "
              f"ms, median {statistics.median(ms[0]):.4f}; twin {ms[1]} ms, median "
              f"{statistics.median(ms[1]):.4f}; collectives over 3 steps: {stats}")
        if not same:
            raise AssertionError("zinc-dp differs from its twin")
        expect_launches(paths, "zinc-dp", **scaled(zinc_step_launches(layers), 3))
        del dp_model, twin, opt_d, opt_t, dp_step, piece

        # ------------------------------------ main path: sampled-train-dp
        flags = ["--device", str(dev), "--steps", "3"]
        with open(os.path.join(LOG_DIR, "chip_smoke_sampled_dp.log"), "w") as log, \
                contextlib.redirect_stdout(log):
            with deterministic():
                with counted("sampled-train-dp", paths):
                    dp = cli.main(flags + ["--data-parallel"])
                single = cli.main(flags)
            # In turns, in the default mode: each run's third step (after
            # the command line's warm-up steps).
            step_ms = ([], [])
            for _ in range(4):
                for extra, out_ in ((["--data-parallel"], step_ms[0]), ([], step_ms[1])):
                    out_.append(cli.main(flags + extra)["summary"]["step_ms"])
        same = dp["losses"] == single["losses"] and params_equal(dp["model"], single["model"])
        print(f"sampled-train-dp (1 rank, the sampled-train command line with "
              f"--data-parallel, 3 steps): losses and weights bitwise equal to the "
              f"single-device command line: {same}; losses {dp['losses']}; step (host clock, "
              f"the third step of 4 runs each, in turns) DP {step_ms[0]} ms, median "
              f"{statistics.median(step_ms[0]):.4f}; single {step_ms[1]} ms, median "
              f"{statistics.median(step_ms[1]):.4f}")
        if not same:
            raise AssertionError("sampled-train-dp differs from its twin")
        expect_launches(paths, "sampled-train-dp", **scaled(SAMPLED_PER_STEP["sampled-train"], 3))

        # ------------------------------------------------ main path: entry
        fn, args = graft_entry.entry()
        with counted("entry", paths), torch.no_grad():
            pred = fn(*args)
        with plain_kernels(), torch.no_grad():
            pred_plain = fn(*args)
        compare(pred, pred_plain, 1e-5, "entry forward (the flagship ZincNet, 8 val molecules) "
                "vs plain on the card")
        # Kernel 6 once per conv layer, kernel 1 once (the pool).
        expect_launches(paths, "entry", minmax_prog=4, segment_sum=1)

        # -------------------------------------- main path: dryrun-multichip
        t0 = time.perf_counter()
        with counted("dryrun-multichip", paths):
            graft_entry.dryrun_multichip(1)
        print(f"dryrun-multichip (world of one on NCCL, regimes (a)-(c), (e)-(g)): "
              f"{time.perf_counter() - t0:.2f} s; launches {paths['dryrun-multichip']}")
        require_launches(paths, "dryrun-multichip", "segment_sum", "minmax_prog",
                         "minmax_prog_bwd")
    finally:
        dist.destroy_process_group()


def require_launches(paths: dict, path: str, *kernels: str) -> None:
    """Check that each of ``kernels`` ran at least once on the path."""
    missing = [k for k in kernels if not paths[path][k]]
    if missing:
        raise AssertionError(f"{path}: no launch of {missing}")


def run_graft_entry_cli() -> None:
    """``python -m mma_tpu_torch.graft_entry`` as a user runs it: the entry
    forward on the card, then the dry run over every card of the host, in a
    world it starts itself (NCCL, one process a card)."""
    here = os.path.dirname(os.path.abspath(__file__))
    t0 = time.perf_counter()
    res = subprocess.run([sys.executable, "-m", "mma_tpu_torch.graft_entry"], cwd=here,
                         capture_output=True, text=True, timeout=600)
    out = (res.stdout + res.stderr).splitlines()
    print(f"python -m mma_tpu_torch.graft_entry: rc {res.returncode}, "
          f"{time.perf_counter() - t0:.2f} s")
    for line in out:
        if "dryrun_multichip" in line or "entry forward" in line:
            print("  " + line)
    if res.returncode != 0 or "dryrun_multichip OK" not in res.stdout:
        raise AssertionError("python -m mma_tpu_torch.graft_entry failed:\n"
                             + "\n".join(out[-40:]))


def two_rank_worker(outdir: str, device: str = "cuda:0") -> None:
    """One rank of the two-rank world (gloo, both ranks on ``cuda:0``):
    the edge-sharded synthetic-large forward and one step, one data-parallel
    ZINC step, one data-parallel sampled step and the 1 x 2 data x edge ZINC
    forward and step, each held within 1e-5 of single-device computations;
    writes this rank's results to ``outdir``. Run by ``run_two_ranks``."""
    import torch.distributed as dist

    from mma_tpu_torch import NodeClassifier, graft_entry, synthetic_powerlaw
    from mma_tpu_torch.cli import train_sampled as cli
    from mma_tpu_torch.models import ZincNet
    from mma_tpu_torch.parallel import (
        collectives,
        initialize_distributed,
        make_dp_edge_forward,
        make_dp_edge_train_step,
        make_dp_train_step,
        make_edge_sharded_forward,
        make_edge_sharded_train_step,
        make_mesh,
        make_node_sharded_forward,
        make_node_sharded_train_step,
        shard_batches_dp_edge,
        shard_graph,
        shard_stacked_batch,
        stack_batches,
    )
    from mma_tpu_torch.train import make_optimizer
    from mma_tpu_torch.train.loops import l1_loss, node_train_step
    from mma_tpu_torch.train.sampled import make_sampled_dp_step, sampled_batch_producer

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    # Both ranks share the one card: init_device_mesh sets the device from
    # LOCAL_RANK, which the launcher numbers per rank.
    os.environ["LOCAL_RANK"] = "0"
    dev = initialize_distributed(device, backend="gloo")
    rank = dist.get_rank()
    paths, report = {}, {"rank": rank}

    def gather_equal(t: torch.Tensor, what: str) -> None:
        """Replicated results must be bitwise equal on both ranks."""
        both = [None, None]
        dist.all_gather_object(both, t.detach().cpu())
        if not torch.equal(both[0], both[1]):
            raise AssertionError(f"{what} differs between the ranks")

    # ------------------------------------------- edge-sharded synthetic-large
    big = synthetic_powerlaw(131072, avg_deg=16, seed=1, device=dev)
    x_big = torch.randn((big.n_node, 64), generator=torch.Generator().manual_seed(SEED)).to(dev)
    x_big = x_big * big.node_mask[:, None]
    lgen = torch.Generator().manual_seed(SEED + 2)
    labels = torch.randint(0, 16, (big.n_node,), generator=lgen).to(dev)
    idx_train = torch.randperm(131072, generator=lgen)[: 131072 // 2].to(dev)

    def node_model():
        return NodeClassifier(64, 64, 16, ("mean", "mean2"), dropout_rate=0.0, device=dev,
                              generator=torch.Generator().manual_seed(SEED + 3))

    mesh = make_mesh(("edge",))
    shard = shard_graph(big, mesh, "edge", kernel_structure=True)
    model, twin = node_model(), node_model()
    step = make_edge_sharded_train_step(model, make_optimizer(model.parameters(), 1e-3), mesh,
                                        labels, idx_train, "edge")
    collectives.reset_stats()
    with counted("edge-sharded", paths):
        with torch.no_grad():
            out = make_edge_sharded_forward(model, mesh, "edge")(x_big, shard)
        loss = step(x_big, shard)
    report["edge_sharded_collectives"] = collective_stats()
    with torch.no_grad():
        want = twin(x_big, big)
    twin_loss, _ = node_train_step(twin, make_optimizer(twin.parameters(), 1e-3), x_big, big,
                                   labels, idx_train, None)
    n = 131072
    report["edge_sharded"] = {
        "edges_on_rank": int(shard.num_edges),
        "forward": compare(out[:n], want[:n], 1e-5, f"rank {rank} edge-sharded forward vs "
                           "single device"),
        "loss": compare(loss[None], twin_loss[None], 1e-5, f"rank {rank} edge-sharded loss"),
        "grads": worst({n_: compare(p.grad, dict(twin.named_parameters())[n_].grad, 1e-5,
                                    f"rank {rank} edge-sharded grad {n_}", verbose=False)
                        for n_, p in model.named_parameters()}),
    }
    gather_equal(out, "edge-sharded forward")
    expect_launches(paths, "edge-sharded", segment_sum=2 + 4, edge_program_lean=2,
                    edge_program_lean_bwd=1)

    # ------------------------------------------ node-sharded synthetic-large
    # Two node shards, on the contiguous and the LDG order: the forward and
    # the first step (dropout off) against the single-device forward and
    # step above (the twin's gradients are its step's).
    nmesh = make_mesh(("node",))
    twin_grads = {n_: p.grad for n_, p in twin.named_parameters()}
    for method in ("contiguous", "ldg"):
        sgl, x_l, labels_l, tmask_l, plan = node_sharded_pieces(big, x_big, labels, idx_train,
                                                                 nmesh, dev, 2, method)
        nmodel = node_model()
        nstep = make_node_sharded_train_step(nmodel, make_optimizer(nmodel.parameters(), 1e-3),
                                             nmesh, "node", dropout=False)
        path = f"node-sharded-{method}"
        collectives.reset_stats()
        with counted(path, paths):
            with torch.no_grad():
                out_l = make_node_sharded_forward(nmodel, nmesh, "node")(x_l, sgl)
            fwd_stats = collective_stats()
            collectives.reset_stats()
            nloss = nstep(x_l, sgl, labels_l, tmask_l)
        step_stats = collective_stats()
        rows = sgl.node_mask
        report[f"node_sharded_{method}"] = {
            **plan, "collectives_forward": fwd_stats, "collectives_step": step_stats,
            "forward": compare(out_l[rows], want[sgl.global_ids[rows].long()], 1e-5,
                               f"rank {rank} {path} forward vs single device"),
            "loss": compare(nloss[None], twin_loss[None], 1e-5, f"rank {rank} {path} loss"),
            "grads": worst({n_: compare(p.grad, twin_grads[n_], 1e-5,
                                        f"rank {rank} {path} grad {n_}", verbose=False)
                            for n_, p in nmodel.named_parameters()}),
        }
        expect_launches(paths, path,
                        segment_sum=NODE_SHARDED_FWD_SEG_SUMS + NODE_SHARDED_STEP_SEG_SUMS)
        gather_equal(torch.cat([p.grad.flatten() for p in nmodel.parameters()]),
                     f"{path} gradients")
        del sgl, x_l, nmodel, nstep, out_l
    del big, x_big, shard, model, twin, step, out, want, twin_grads

    # -------------------------------------------------------------- zinc-dp
    layers = 4
    batches, avg = zinc_micro_batches(dev, 2)

    def zmodel(aggs_scalers, seed):
        return ZincNet(*aggs_scalers, avg, num_layers=layers, device=dev,
                       generator=torch.Generator().manual_seed(seed))

    init = zmodel(ZINC_PRESET_AGGS, SEED + 11)
    model = copy.deepcopy(init)
    dmesh = make_mesh(("data",))
    dp_step = make_dp_train_step(model, make_optimizer(model.parameters(), 1e-4, 3e-4), dmesh)
    collectives.reset_stats()
    with counted("zinc-dp", paths):
        loss = dp_step(shard_stacked_batch(stack_batches(batches), dmesh))
    report["zinc_dp_collectives"] = collective_stats()
    expect_launches(paths, "zinc-dp", **zinc_step_launches(layers))
    gather_equal(torch.cat([p.grad.flatten() for p in model.parameters()]), "zinc-dp gradients")
    # The two micro-batches' shares one after the other, each on its own copy.
    total = sum(float(b.graph_mask.sum()) for b in batches)
    shares = {n_: torch.zeros_like(p) for n_, p in init.named_parameters()}
    for b in batches:
        m = copy.deepcopy(init)
        pred = m(b, training=True)
        ((torch.abs(pred - b.target) * b.graph_mask.float()).sum() / total).backward()
        for n_, p in m.named_parameters():
            if p.grad is not None:
                shares[n_] += p.grad
    grads = {n_: p.grad for n_, p in model.named_parameters()}
    report["zinc_dp"] = {"loss": float(loss), "grads_vs_shares": worst({
        n_: compare(grads[n_], shares[n_], 1e-5, f"rank {rank} zinc-dp summed grad {n_} vs the "
                    "shares one after the other", scale=bn_fed_scale(n_, shares),
                    verbose=False) for n_ in shares})}
    del init, model, dp_step

    # --------------------------------------------------------- zinc-dp-edge
    (batch,) = batches[:1]
    emesh = make_mesh(("data", "edge"), shape=(1, 2))
    piece = shard_batches_dp_edge([batch], emesh)
    init = zmodel(ZINC_DEFAULT_AGGS, SEED + 5)
    model, twin = copy.deepcopy(init), copy.deepcopy(init)
    collectives.reset_stats()
    with counted("zinc-dp-edge", paths):
        with torch.no_grad():
            pred = make_dp_edge_forward(model, emesh)(piece)
        loss = make_dp_edge_train_step(model, make_optimizer(model.parameters(), 1e-4, 3e-4),
                                       emesh)(piece)
    report["zinc_dp_edge_collectives"] = collective_stats()
    expect_launches(paths, "zinc-dp-edge", **zinc_general_launches(layers, 1, 1))
    with torch.no_grad():
        want = twin(batch)

    def twin_step(nudge=0.0):
        """The single-device training forward and L1 gradients, the node
        embedding table moved by one ulp towards ``nudge`` when given."""
        m = copy.deepcopy(init)
        if nudge:
            with torch.no_grad():
                m.node_emb.table.copy_(torch.nextafter(m.node_emb.table,
                                                       torch.tensor(nudge, device=dev)))
        loss_ = l1_loss(m(batch, training=True), batch)
        loss_.backward()
        return loss_.detach(), grads_of(m)

    twin_loss, twin_grads = twin_step()
    grads = {n_: p.grad for n_, p in model.named_parameters()}
    # min/max's first-hit gradient jumps where an ulp flips a near-tie, and
    # the psum-ed means reach the next layer in another summation order: each
    # gradient is held within 1e-5 plus four times the single-device run's own
    # change under a one-ulp nudge of the embedding table (the layout check's
    # allowance in run_zinc).
    slack = {n_: 0.0 for n_ in twin_grads}
    for nudge in (math.inf, -math.inf):
        nudged = twin_step(nudge)[1]
        slack = {n_: max(v, 4 * (twin_grads[n_] - nudged[n_]).abs().max().item())
                 for n_, v in slack.items()}
    report["zinc_dp_edge"] = {
        "edges_on_rank": int(piece.graph.num_edges),
        "forward": compare(pred, want, 1e-5, f"rank {rank} zinc-dp-edge forward vs the "
                           "single-device general route"),
        "loss": compare(loss[None], twin_loss[None], 1e-5, f"rank {rank} zinc-dp-edge loss"),
        "grads": worst({n_: compare(grads[n_], g_, 1e-5, f"rank {rank} zinc-dp-edge grad {n_}",
                                    scale=bn_fed_scale(n_, twin_grads), slack=slack[n_],
                                    verbose=False) for n_, g_ in twin_grads.items()}),
        "largest_allowance": max(slack.values())}
    # The detached pre-NNs (parity, N7) take no gradient on one device and a
    # zero one from psum_grads.
    if any(grads[n_].any() for n_ in set(grads) - set(twin_grads)):
        raise AssertionError("zinc-dp-edge: a gradient the single-device run does not have")
    gather_equal(pred, "zinc-dp-edge forward")
    del batches, batch, piece, init, model, twin

    # ----------------------------------------------------- sampled-train-dp
    res = cli.main(["--device", str(dev), "--steps", "0"])  # data-parallel: WORLD_SIZE is set
    sampler, pads = res["sampler"], res["pads"]
    seeds = np.random.RandomState(SEED + 7).randint(0, sampler.num_nodes,
                                                    (2, pads["hop_node_pads"][0]))
    kw = dict(n_node_pad=pads["n_node_pad"], n_edge_pad=pads["n_edge_pad"], device_finish=True,
              deg_table=torch.from_numpy(sampler.true_deg).to(dev))
    (x, g, y, sm), = sampled_batch_producer(sampler, iter([seeds]), res["assembler"], rank=rank,
                                            **kw)
    init = res["model"]
    model = copy.deepcopy(init)
    dp_step = make_sampled_dp_step(model, make_optimizer(model.parameters(), 3e-3), dmesh)
    collectives.reset_stats()
    with counted("sampled-train-dp", paths):
        loss = dp_step(x, g, y, sm, torch.Generator(device=dev).manual_seed(SEED + rank))
    report["sampled_dp_collectives"] = collective_stats()
    expect_launches(paths, "sampled-train-dp", **SAMPLED_PER_STEP["sampled-train"])
    gather_equal(torch.cat([p.grad.flatten() for p in model.parameters()]),
                 "sampled-train-dp gradients")
    pieces = [None, None]
    dist.all_gather_object(pieces, (x.cpu(), g.to("cpu"), y.cpu(), sm.cpu()))
    if rank == 0:
        total = sum(float(p_[3].sum()) for p_ in pieces)
        shares = {n_: torch.zeros_like(p) for n_, p in init.named_parameters()}
        for r, (px, pg, py, psm) in enumerate(pieces):
            m = copy.deepcopy(init)
            px, pg, py, psm = px.to(dev), pg.to(dev), py.to(dev), psm.to(dev)
            logp = m(px, pg, training=True,
                     generator=torch.Generator(device=dev).manual_seed(SEED + r))
            ((-logp[torch.arange(py.shape[0], device=dev), py] * psm).sum() / total).backward()
            for n_, p in m.named_parameters():
                shares[n_] += p.grad
        report["sampled_dp"] = {"loss": float(loss), "edges_per_rank": [
            int(p_[1].num_edges) for p_ in pieces], "grads_vs_shares": worst({
                n_: compare(p.grad, shares[n_], 1e-5, f"sampled-train-dp summed grad {n_} vs "
                            "the shares one after the other", verbose=False)
                for n_, p in model.named_parameters()})}

    # ----------------------------------------------------- dryrun-multichip
    t0 = time.perf_counter()
    with counted("dryrun-multichip", paths):
        graft_entry.dryrun_multichip(2, dev)
    report["dryrun_multichip_s"] = time.perf_counter() - t0
    require_launches(paths, "dryrun-multichip", "segment_sum", "minmax_prog", "minmax_prog_bwd",
                     "segment_minmax", "segment_minmax_bwd")
    report["paths"] = paths
    with open(os.path.join(outdir, f"rank{rank}.json"), "w") as f:
        json.dump(report, f)


def run_two_ranks(paths: dict) -> None:
    """The two-rank world: two processes on this card over gloo, spawned once
    after this process built the kernels (the ranks load them). Their launch
    counts join ``paths`` as ``<path>@rank<r>``."""
    from mma_tpu_torch.parallel import launch_local

    os.makedirs(TWO_RANK_DIR, exist_ok=True)
    torch.cuda.empty_cache()
    here = os.path.dirname(os.path.abspath(__file__))
    t0 = time.perf_counter()
    launch_local("chip_smoke:two_rank_worker", 2, [os.path.abspath(TWO_RANK_DIR)], cwd=here,
                 env={"PYTHONPATH": os.pathsep.join([here, os.environ.get("PYTHONPATH", "")])},
                 timeout=600)
    print(f"two-rank world (gloo, both ranks on cuda:0): {time.perf_counter() - t0:.2f} s; "
          "collectives staged through host memory by the port: none (gloo took all_reduce, "
          "all_gather_into_tensor, reduce_scatter_tensor and all_to_all_single on the CUDA "
          "tensors; its CUDA work copies them through host memory inside the backend)")
    for rank in range(2):
        with open(os.path.join(TWO_RANK_DIR, f"rank{rank}.json")) as f:
            report = json.load(f)
        for path, counts in report.pop("paths").items():
            paths[f"{path}@rank{rank}"] = counts
        print(f"two-rank world, rank {rank}: {json.dumps(report)}")


def cora_neighbor_lists(num_nodes: int) -> list:
    """Cora's neighbour lists in the reference's format: ``add_all[i]`` the
    neighbours of node ``i`` in the symmetric adjacency built from the
    Planetoid ``ind.cora.graph`` adjacency lists, ascending."""
    import pickle

    from mma_tpu_torch.graph.build import symmetrize

    here = os.path.dirname(os.path.abspath(__file__))
    with open(os.path.join(here, "datasets", "ind.cora.graph"), "rb") as fh:
        lists = pickle.load(fh, encoding="latin1")
    src = np.array([i for i, nbrs in lists.items() for _ in nbrs], np.int32)
    dst = np.array([j for nbrs in lists.values() for j in nbrs], np.int32)
    src, dst = symmetrize(src, dst)  # sorted by (dst, src)
    return np.split(src, np.searchsorted(dst, np.arange(1, num_nodes)))


GRAPH_FIELDS = ("src", "dst", "edge_mask", "node_mask", "deg", "row_ptr", "src_perm",
                "col_ptr", "src_csc", "dst_csc", "real_row_ptr", "real_col_ptr")


def run_cora_neighbor_lists(dev, paths: dict, cora, cora_model, cora_out0, big, x_big) -> None:
    """Path cora-neighbor-lists: Cora's graph built on the card from its
    neighbour lists and from its dense adjacency, each tensor bitwise equal
    to cora-serve's graph (``graph_from_edges``), and cora-serve's first
    request answered on each, bitwise equal to cora-serve's answer (kernels
    1 and 2). Then ``segment_mean``, ``segment_softmax_denom`` (over
    ``x[src]`` by destination) and ``mma_mask_logits`` (K=2) at
    synthetic-large, each within 1e-5 of the largest magnitude of the same
    call on the CPU."""
    from mma_tpu_torch import graph_from_dense, graph_from_neighbor_lists
    from mma_tpu_torch.ops import mma_mask_logits, segment_mean, segment_softmax_denom

    t0 = time.perf_counter()
    n = cora.num_nodes
    add_all = cora_neighbor_lists(n)
    adj = np.zeros((n, n), np.float32)
    adj[np.repeat(np.arange(n), [len(a) for a in add_all]), np.concatenate(add_all)] = 1.0
    errs = {}
    with counted("cora-neighbor-lists", paths), torch.no_grad():
        graphs = {"neighbor lists": graph_from_neighbor_lists(add_all, device=dev),
                  "dense": graph_from_dense(adj, device=dev)}
        for what, g in graphs.items():
            for name in GRAPH_FIELDS:
                got, want = getattr(g, name), getattr(cora.graph, name)
                if got.dtype != want.dtype or not torch.equal(got, want):
                    raise AssertionError(f"cora-neighbor-lists: {what} graph's {name} "
                                         "differs from cora-serve's")
            if not torch.equal(cora_model(cora.features, g), cora_out0):
                raise AssertionError(f"cora-neighbor-lists: the forward on the {what} graph "
                                     "differs from cora-serve's")
        e = int(big.num_edges)
        src, dst = big.src[:e], big.dst[:e]
        cpu_big = big.to("cpu")
        data = x_big[src]
        mw = (torch.randn((2, 128, 64), generator=torch.Generator().manual_seed(SEED + 7))
              / 8.0).to(dev)
        calls = {
            "segment_mean": lambda d, i, g, w: (segment_mean(d, i, g.n_node),),
            "segment_softmax_denom": lambda d, i, g, w: segment_softmax_denom(d, i, g.n_node),
            "mma_mask_logits": lambda d, i, g, w: (mma_mask_logits(x_big.to(d.device), w, g),),
        }
        for name, call in calls.items():
            on_card = call(data, dst, big, mw)
            on_cpu = call(data.cpu(), dst.cpu(), cpu_big, mw.cpu())
            for i, (got, want) in enumerate(zip(on_card, on_cpu)):
                errs[f"{name}[{i}]"] = compare(got.cpu(), want, 1e-5, f"{name}[{i}]",
                                               verbose=False)["max_rel_err"]
            del on_card, on_cpu
    wall = time.perf_counter() - t0
    print(f"cora-neighbor-lists: graph_from_neighbor_lists and graph_from_dense give "
          f"cora-serve's graph ({len(GRAPH_FIELDS)} tensors each bitwise equal) and its "
          f"request-0 answer bitwise; synthetic-large (E = {e}, F = 64, K = 2), card against "
          f"CPU, max_rel_err "
          + ", ".join(f"{k} {v:.3e}" for k, v in errs.items())
          + f" (tolerance 1e-5); wall {wall:.2f} s")
    # Per forward: kernel 1 for each binary_spmm (2), kernel 2 once.
    expect_launches(paths, "cora-neighbor-lists", segment_sum=2 * 2, edge_program_lean=2)


def main() -> int:
    t_main = time.perf_counter()
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
    big_ref = big_out[0]
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

    # ---------------------------------------- main path: cora-neighbor-lists
    run_cora_neighbor_lists(dev, paths, cora, cora_model, cora_out[0], big, x_big)

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
    # Per epoch: the train forward runs kernel 1 twice (2 binary_spmm) and
    # kernel 2 with the keep once, its backward kernel 1 twice (2
    # binary_spmm) and kernel 3 with the keep once; the eval forward runs
    # kernel 1 twice and kernel 2 once. Each run ends with one more eval
    # forward. Kernel 3 without a keep belongs to dropout-free training only.
    runs = len(CORA_SEEDS)
    epochs = cfg0.epochs
    print(f"cora-train: per epoch kernel 1 x6, kernel 2 x1, kernels 2 and 3 with the keep x1; "
          f"{runs} runs x {epochs} epochs + {runs} test forwards")
    expect_launches(paths, "cora-train", segment_sum=runs * (epochs * 6 + 2),
                    edge_program_lean=runs * (epochs + 1),
                    edge_program_lean_keep=runs * epochs,
                    edge_program_lean_keep_bwd=runs * epochs)
    if not mean_acc >= CORA_MIN_MEAN_ACC:
        raise AssertionError(f"cora-train: mean test accuracy {mean_acc:.4f} < {CORA_MIN_MEAN_ACC}")

    # One more cora-train step from seed 0's trained state on each float32
    # route of mask dropout, then with every kernel plain: kernels 2-3 with
    # the keep (the graph's CSC), the half-fused route (the same graph
    # without its CSC view, kernel 1 x3 forward and x5 backward; the SpMMs
    # derive the CSC order on the device) and the all-plain step. A fresh
    # generator of one seed gives all three the same dropout draws, which
    # depend neither on the kernels nor on the route.
    cora_routes = {
        "lean-keep": (cora.graph, {"segment_sum": 4, "edge_program_lean_keep": 1,
                                   "edge_program_lean_keep_bwd": 1}),
        "half-fused": (dataclasses.replace(cora.graph, src_perm=None), {"segment_sum": 8}),
        "plain": (cora.graph, {}),
    }
    steps = {}
    for route, (graph, expected) in cora_routes.items():
        model = copy.deepcopy(results[CORA_SEEDS[0]]["model"])
        opt = make_optimizer(model.parameters(), cfg0.lr, cfg0.weight_decay)
        before = launches()
        with plain_kernels() if route == "plain" else contextlib.nullcontext():
            loss, _ = node_train_step(model, opt, cora.features, graph,
                                      cora.labels.long(), cora.idx_train.long(),
                                      torch.Generator(device=dev).manual_seed(SEED))
        torch.cuda.synchronize()
        launched = {k: v - before[k] for k, v in launches().items() if v != before[k]}
        if launched != expected:
            raise AssertionError(f"cora-train step ({route}): launches {launched} != {expected}")
        steps[route] = (float(loss), {n_: p.grad for n_, p in model.named_parameters()})
    loss_p, grads_p = steps.pop("plain")
    for route, (loss_k, grads_k) in steps.items():
        compare(torch.tensor([loss_k]), torch.tensor([loss_p]), 1e-5,
                f"cora-train step ({route}) loss vs plain on the card")
        for name, g in grads_k.items():
            compare(g, grads_p[name], 1e-5, f"cora-train step ({route}) grad {name} vs plain")
    print("cora-train step: the keep-aware and the half-fused route each against the all-plain "
          f"step, launches {', '.join(f'{r} {e}' for r, (_, e) in cora_routes.items())}")
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

    def wide_run(mode, dtype=torch.float32):
        """Forward and backward of the masked aggregate in the edge pipeline's
        ``dtype``: (out, dh, dmask_weights)."""
        h = x_big.clone().requires_grad_()
        mw = mw0.clone().requires_grad_()
        with torch.enable_grad():
            out = masked_aggregate.masked_multi_aggregate(h, big, mw, wide_specs,
                                                          pallas_bwd_mode=mode,
                                                          compute_dtype=dtype)
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
    del wide_plain, lean

    # -------------------------------------------- main path: large-wide-bf16
    # The large-wide work in the bf16 edge pipeline (compute_dtype bfloat16,
    # the same h, weights and cotangent): bf16 c, d and h through the bf16
    # variants of kernels 9-11, which round no message.
    wide16, wide16_ms = {}, {}
    with counted("large-wide-bf16", paths):
        for mode in modes:
            wide16_ms[mode] = []
            for rep in range(3):
                t0 = time.perf_counter()
                res = wide_run(mode, torch.bfloat16)
                torch.cuda.synchronize()
                wide16_ms[mode].append((time.perf_counter() - t0) * 1e3)
                if rep == 0:
                    wide16[mode] = res
    # Per run: kernel 9 in bf16 forward and kernel 10 in bf16 backward, then
    # payload_permute sums the float32 payload by source with kernel 1 and
    # csc_gather runs kernel 11 in bf16. The bf16 projections and their
    # backward are matrix products (no kernel of the port).
    expect_launches(paths, "large-wide-bf16", edge_program_fwd_bf16=6, edge_program_bwd_bf16=6,
                    segment_sum=3, edge_program_bwd_csc_bf16=3)
    turns = {(m, t): [] for m in modes for t in ("f32", "bf16")}
    for m in modes:
        for which in ("f32", "bf16", "bf16", "f32"):
            turns[(m, which)] += host_ms(
                lambda: wide_run(m, torch.bfloat16 if which == "bf16" else torch.float32))
    print("large-wide-bf16: forward + backward (host clock, medians of 6 in turns f32, bf16, "
          "bf16, f32): " + ", ".join(
              f"{m} bf16 {statistics.median(turns[(m, 'bf16')]):.4f} ms / f32 "
              f"{statistics.median(turns[(m, 'f32')]):.4f} ms" for m in modes)
          + f" (the counted runs {wide16_ms})")
    before = launches()
    with plain_kernels():
        wide16_plain = {mode: wide_run(mode, torch.bfloat16) for mode in modes}
    if launches() != before:
        raise AssertionError("the plain bf16 wide route launched a kernel")
    lean16 = wide_run(None, torch.bfloat16)
    for mode in modes:
        for name, got, plain, other, f32 in zip(names, wide16[mode], wide16_plain[mode], lean16,
                                                wide[mode]):
            tol = 1e-5 if name == "output" else BF16_GRAD_TOL
            compare(got, plain, tol, f"large-wide-bf16 {mode} {name} vs plain on the card")
            compare(got, other, BF16_ROUTE_TOL,
                    f"large-wide-bf16 {mode} {name} vs the lean bf16 route")
            compare(got, f32, BF16_ROUTE_TOL, f"large-wide-bf16 {mode} {name} vs the f32 wide route")
    if torch.equal(wide16[modes[0]][0], lean16[0]):
        raise AssertionError("large-wide-bf16: the wide and the lean bf16 route round alike")
    for name, a, b in zip(names, *(wide16[m] for m in modes)):
        compare(a, b, 1e-5 if name == "output" else BF16_GRAD_TOL,
                f"large-wide-bf16 {name}: {modes[0]} vs {modes[1]}")
    del wide, wide16, wide16_plain, lean16

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

    def s_run(route, dtype=torch.float32):
        """Forward and backward of S by ``route`` ("masked", "wide" or "lean")
        from h and mask_weights, the "masked" and "wide" routes on c, d and
        h in ``dtype``: S, dh and dmask_weights, and for "masked" the
        pre-gathered logits and h_src and their gradients."""
        h = x_big.clone().requires_grad_()
        mw = mw0.clone().requires_grad_()
        with torch.enable_grad():
            h_c = h.to(dtype)
            c, d = masked_aggregate.mma_mask_projections(h_c, mw.to(dtype))
            if route == "masked":
                logits = gather_by_dst(c, big) + gather_by_src(d, big)
                h_src = gather_by_src(h_c, big)
                logits.retain_grad()
                h_src.retain_grad()
                s = fused_masked_aggregate(logits, h_src, pat_big, big, k_big)
            elif route == "wide":
                s = fused_mma.edge_program(c, d, h_c, pat_big, big.src, rp_big, cp_big,
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

    # ------------------------------------------ main path: large-masked-bf16
    # fused_masked_aggregate on the bf16 logits c[dst] + d[src] and rows
    # h[src] that the half-fused route builds in bf16 from the same h and
    # weights: kernel 12 in bf16, each message rounded to bf16.
    masked16_ms = []
    with counted("large-masked-bf16", paths):
        for rep in range(3):
            t0 = time.perf_counter()
            res = s_run("masked", torch.bfloat16)
            torch.cuda.synchronize()
            masked16_ms.append((time.perf_counter() - t0) * 1e3)
            if rep == 0:
                masked16 = res
    print(f"large-masked-bf16: fused_masked_aggregate forward + backward from h and mask_weights "
          f"(host clock) {masked16_ms} ms; median {statistics.median(masked16_ms):.4f} ms "
          f"(f32 {statistics.median(masked_ms):.4f} ms)")
    if (masked16["logits"].dtype, masked16["h_src"].dtype) != (torch.bfloat16, torch.bfloat16):
        raise AssertionError("large-masked-bf16 gave kernel 12 float32 operands")
    # Per run: kernel 12 in bf16 forward; backward the Function's
    # elementwise VJP in bf16, then the three gathers' VJPs sum bf16
    # cotangents with kernel 1 in bf16.
    expect_launches(paths, "large-masked-bf16", masked_segment_sum_bf16=3, segment_sum_bf16=3 * 3)
    before = launches()
    with plain_kernels():
        masked16_plain = s_run("masked", torch.bfloat16)
    if launches() != before:
        raise AssertionError("the plain bf16 masked route launched a kernel")
    for name in ("S", "dlogits", "dh_src", "dh", "dmask_weights"):
        compare(masked16[name], masked16_plain[name], 1e-5 if name == "S" else BF16_GRAD_TOL,
                f"large-masked-bf16 {name} vs plain on the card")
    # The wide bf16 route reads the same bf16 c, d and h but adds c[dst] +
    # d[src] and each message in float32; kernel 12 gets that sum rounded
    # to bf16 and rounds each message.
    compare(masked16["S"], s_run("wide", torch.bfloat16)["S"], BF16_ROUTE_TOL,
            "large-masked-bf16 S vs the wide bf16 route")
    masked16_in = (masked16["logits"], masked16["h_src"])
    del masked16, masked16_plain, res

    bf16_models = run_bf16(dev, paths, {
        "cora": cora, "cora_model": cora_model, "requests": requests, "cora_out": cora_out,
        "cora_acc": mean_acc, "cora_epoch_ms": statistics.median(epoch_s) * 1e3,
        "big": big, "big_model": big_model, "x_big": x_big, "big_out": big_ref,
        "n_big": n_big, "e_big": e_big, "labels": labels, "idx_train": idx_train,
        "init_state": init_state, "losses": losses, "step_ms": step_ms})
    del big_ref
    zinc_kernels, zinc_ctx = run_zinc(dev, paths)
    zinc_kernels.update(run_zinc_bf16(dev, paths, zinc_ctx))
    del zinc_ctx
    run_resume_and_serving(dev, paths, {
        "cora": cora, "cora_model": cora_model, "requests": requests, "big": big,
        "big_model": big_model, "big16": bf16_models["big16"], "x_big": x_big, "n_big": n_big,
        "labels": labels})
    run_sampled(dev, paths)
    run_parallel(dev, paths, {"big": big, "x_big": x_big, "labels": labels,
                              "idx_train": idx_train, "init_state": init_state})
    run_graft_entry_cli()
    run_two_ranks(paths)

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
        # The node-sharded path's kernel-1 calls, per rank at S = 2: the
        # interior sum (E_m rows over row_ptr) and the boundary sum (B_m rows
        # over bnd_row_ptr) of each shard, at gc1's C=64 and the masked
        # messages' C=128 (K·F). The sums cover every row slot, padding
        # included (padding rows are zero and sit in the last row).
        from mma_tpu_torch.parallel import build_node_sharded

        sg2, _ = build_node_sharded(big, 2)
        n_m2 = sg2.node_mask.shape[1]
        k1["node_sharded"] = []
        for r in range(2):
            interior = (sg2.ext_src[r] < n_m2) & sg2.edge_mask[r]
            for part, dst_f, rp_f, valid_np in (
                    ("interior", "dst_local", "row_ptr", interior),
                    ("boundary", "bnd_dst", "bnd_row_ptr", sg2.bnd_mask[r])):
                rp = torch.from_numpy(getattr(sg2, rp_f)[r]).to(dev)
                dst_l = torch.from_numpy(getattr(sg2, dst_f)[r]).to(dev).long()
                valid = torch.from_numpy(valid_np).to(dev)
                rows = dst_l.shape[0]
                for ch in (64, 128):
                    data = (torch.randn((rows, ch), generator=torch.Generator().manual_seed(
                        SEED + 9 + r)).to(dev) * valid[:, None]).contiguous()
                    got = fused_mma.segment_sum_csr(data, rp)
                    if not torch.equal(got, fused_mma.segment_sum_csr(data, rp)):
                        raise AssertionError(f"segment_sum_csr node-sharded {part} differs run "
                                             "to run")
                    err = compare(got, fused_mma.segment_sum_reference(data, rp), 1e-5,
                                  f"segment_sum_csr node-sharded rank {r} {part} C={ch} vs plain")
                    use = {"rank": r, "part": part, "C": ch, "rows": rows, "N_m": n_m2,
                           "real_rows": int(valid.sum()),
                           "max_abs_err": err["max_abs_err"],
                           "ms": device_ms(lambda: fused_mma.segment_sum_csr(data, rp)),
                           "plain_ms": device_ms(
                               lambda: fused_mma.segment_sum_reference(data, rp)),
                           "library_ms": device_ms(lambda: torch.zeros(
                               n_m2, ch, device=dev).index_add_(0, dst_l, data)),
                           **bound(4 * (rows * ch + n_m2 + 1 + n_m2 * ch), rows * ch)}
                    k1["node_sharded"].append(use)
                    print(f"segment_sum_csr node-sharded (S=2) rank {r} {part}: E={rows} "
                          f"({use['real_rows']} real) N_m={n_m2} C={ch}: ms {use['ms']:.4f} "
                          f"plain_ms {use['plain_ms']:.4f} index_add_ ms "
                          f"{use['library_ms']:.4f} bound_ms {use['bound_ms']:.4f} "
                          f"({use['bound_by']})")
        del sg2
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
        kernels.update(keep_kernel_entries(dev, big, x_big, train_model, labels, idx_train))

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
        # Skew: kernel 11 alone on the heaviest source, as a whole call on a
        # CSC of N columns that covers that source's edges only (split over
        # chunks, joined by the fixup; every other row zeroed).
        deg = cp[1:] - cp[:-1]
        top = int(torch.argmax(deg))
        heavy = (c, d, h, pat, dst_csc, cp.clamp(int(cp[top]), int(cp[top + 1])), ct)
        got = fused_mma.edge_program_bwd_csc(*heavy)
        if not torch.equal(got, fused_mma.edge_program_bwd_csc(*heavy)):
            raise AssertionError("edge_program_bwd_csc heaviest source alone differs run to run")
        compare(got, fused_mma.edge_program_bwd_csc_reference(*heavy), 1e-5,
                "edge_program_bwd_csc heaviest source alone vs plain")
        del got
        k11 = kernels["edge_program_bwd_csc"]
        k11["heaviest_row_call_ms"] = device_ms(
            lambda: fused_mma.edge_program_bwd_csc(*heavy), iters=15)
        print(f"edge_program_bwd_csc: the heaviest source alone ({int(deg[top])} edges, "
              f"N={n_rows}), whole call ms {k11['heaviest_row_call_ms']:.4f}; bitwise equal run "
              "to run")

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
        # Skew: the heaviest row alone, split over kernel 1's chunks and
        # joined by the fixup.
        deg = row_ptr[1:] - row_ptr[:-1]
        top = int(torch.argmax(deg))
        one_row = row_ptr[top:top + 2].contiguous()
        heavy_ms = device_ms(lambda: fused_mma.masked_segment_sum(logits, h_src, pat_big, one_row))
        kernels["masked_segment_sum"]["heaviest_row_ms"] = heavy_ms
        print(f"masked_segment_sum: the heaviest row alone ({int(deg[top])} edges) "
              f"ms {heavy_ms:.4f}")
        del msg, masked_in, logits, h_src
        kernels.update(bf16_kernel_entries(dev, big, x_big, big_model, classes, mw0,
                                           bf16_models["train16"], labels, idx_train))
        kernels.update(wide_bf16_kernel_entries(dev, big, wide_run, masked16_in, pat_big))
        del masked16_in

    kernels.update(zinc_kernels)
    launch_keys = {"segment_sum_csr": "segment_sum", "edge_program_lean_fwd": "edge_program_lean",
                   "segment_sum_csr_bf16": "segment_sum_bf16",
                   "edge_program_lean_fwd_bf16": "edge_program_lean_bf16"}
    for name, entry in kernels.items():
        entry["launches"] = sum(p[launch_keys.get(name, name)] for p in paths.values())
    print("launches per main path:", json.dumps(paths))
    print(f"chip_smoke: {time.perf_counter() - t_main:.1f} s (host clock, the build included)")
    print(json.dumps({"kernels": list(kernels.values())}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

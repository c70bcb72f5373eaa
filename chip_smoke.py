#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU: ``python3 chip_smoke.py``.

1. Prints the card's name and power limit (``nvidia-smi``), then builds
   every CUDA kernel of the port from ``mma_tpu_torch/csrc`` (one ``nvcc``
   per source, all started together).
2. Three main paths, each with the kernels' launch counters set to 0 just
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
   package.
4. Per kernel, at the synthetic-large shapes of the main paths (kernel 1
   at the widths of both products, C=64 and C=16): the error
   against the plain version, run-to-run equality, the kernel's median
   time, the plain version's time, the time of one PyTorch library call
   for the same function where there is one, and the least time the card
   could take (``bound_ms``).
5. Prints one ``kernels`` JSON line, the ``nvidia-smi`` line again, and as
   the last line ``{"ok": true, "device": {...}}``.

The per-epoch training log goes to ``artifacts/chip_smoke_train.log``.
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
# Published peaks of one H100 SXM (NVIDIA data sheet): HBM3 bandwidth and
# dense float32 outside the tensor cores. The kernels run f32 on CUDA cores.
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_FLOP_PER_S = 67e12
# TPU kernels each port replaces (file:line of the Pallas kernel).
REPLACES = {
    "segment_sum_csr": "mma_tpu/ops/pallas/fused_mma.py:176",
    "edge_program_lean_fwd": "mma_tpu/ops/pallas/fused_mma.py:488",
    "edge_program_lean_bwd": "mma_tpu/ops/pallas/fused_mma.py:540",
}
SOURCE = "mma_tpu_torch/csrc/fused_mma.cu"
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


def compare(got: torch.Tensor, want: torch.Tensor, rel: float, what: str) -> dict:
    """``|got - want| <= rel * (|want| + max|want|)``: a relative bound per
    element with a floor scaled to the tensor, since f32 sums taken in
    another order differ by a few ulps of their largest partial sums."""
    got, want = got.double(), want.double()
    scale = want.abs().max().item()
    diff = (got - want).abs()
    max_abs = diff.max().item()
    max_rel = (diff / (want.abs() + scale)).max().item()
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


@contextlib.contextmanager
def plain_kernels(fused_mma):
    """Route every kernel launch, forward and backward, to its plain version,
    under PyTorch's deterministic algorithms: the plain versions sum with
    ``index_add_``, whose atomic order otherwise changes run to run, so the
    reference would not be the same from one run to the next."""
    names = ("_segment_sum_kernel", "_edge_program_lean_kernel",
             "_edge_program_lean_bwd_kernel")
    saved = [getattr(fused_mma, n) for n in names]
    deterministic = torch.are_deterministic_algorithms_enabled()
    fused_mma._segment_sum_kernel = fused_mma.segment_sum_reference
    fused_mma._edge_program_lean_kernel = fused_mma.edge_program_lean_reference
    fused_mma._edge_program_lean_bwd_kernel = fused_mma.edge_program_lean_bwd_reference
    torch.use_deterministic_algorithms(True)
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(deterministic)
        for n, f in zip(names, saved):
            setattr(fused_mma, n, f)


@contextlib.contextmanager
def counted(fused_mma, path: str, paths: dict):
    """Count the kernel launches of one main path into ``paths[path]``."""
    for key in fused_mma.LAUNCHES:
        fused_mma.LAUNCHES[key] = 0
    yield
    torch.cuda.synchronize()
    paths[path] = dict(fused_mma.LAUNCHES)


def expect_launches(paths: dict, path: str, expected: dict) -> None:
    print(f"{path}: launches {paths[path]} (expected {expected})")
    if paths[path] != expected:
        raise AssertionError(f"{path}: launch counts {paths[path]} != {expected}")


def capture_edge_program(masked_aggregate, run):
    """Run ``run()`` with ``masked_aggregate.edge_program_lean`` wrapped so
    that its arguments and the cotangent of its output are kept; returns
    ``(args, ct)`` of the last call."""
    real = masked_aggregate.edge_program_lean
    kept = {}

    def wrapper(*args):
        out = real(*args)
        kept["args"] = args
        out.register_hook(lambda g: kept.__setitem__("ct", g.detach().clone()))
        return out

    masked_aggregate.edge_program_lean = wrapper
    try:
        run()
    finally:
        masked_aggregate.edge_program_lean = real
    return kept["args"], kept["ct"]


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False", file=sys.stderr)
        return 1
    from mma_tpu_torch import NodeClassifier, load_planetoid, synthetic_powerlaw
    from mma_tpu_torch.ops import masked_aggregate
    from mma_tpu_torch.ops.cuda import build, fused_mma
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
    with counted(fused_mma, "serve", paths), torch.no_grad():
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
    expect_launches(paths, "serve", {"segment_sum": 2 * 6, "edge_program_lean": 6,
                                     "edge_program_lean_bwd": 0})

    cpu_model = NodeClassifier(cora.num_features, 64, cora.num_classes,
                               ("mean", "mean2"), device="cpu")
    cpu_model.load_state_dict({k: v.cpu() for k, v in cora_model.state_dict().items()})
    with torch.no_grad():
        for i, out in enumerate(cora_out):
            check_log_probs(out, cora.graph.n_node, cora.num_classes, cora.num_nodes,
                            f"cora request {i}")
        for i, out in enumerate(big_out):
            check_log_probs(out, big.n_node, 16, n_big, f"synthetic-large forward {i}")
        before = dict(fused_mma.LAUNCHES)
        with plain_kernels(fused_mma):
            cora_plain = [cora_model(x, cora.graph) for x in requests]
            big_plain = big_model(x_big, big)
        if fused_mma.LAUNCHES != before:
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
    with counted(fused_mma, "cora-train", paths), \
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
    expect_launches(paths, "cora-train", {
        "segment_sum": runs * (epochs * 10 + 2),
        "edge_program_lean": runs * (epochs + 1),
        "edge_program_lean_bwd": 0,
    })
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
        with plain_kernels(fused_mma) if plain else contextlib.nullcontext():
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
    with counted(fused_mma, "large-train", paths):
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
    # kernel 1 x3 (2 binary_spmm, the payload's by-source reduce) and
    # kernel 3 x1.
    expect_launches(paths, "large-train", {"segment_sum": 3 * 5, "edge_program_lean": 3,
                                           "edge_program_lean_bwd": 3})
    if not all(math.isfinite(v) for v in losses):
        raise AssertionError(f"large-train: non-finite loss {losses}")

    # Step 1 again with every kernel, forward and backward, plain.
    plain_model = NodeClassifier(64, 64, 16, ("mean", "mean2"), dropout_rate=0.0,
                                 device=dev, generator=torch.Generator().manual_seed(SEED + 3))
    plain_model.load_state_dict(init_state)
    before = dict(fused_mma.LAUNCHES)
    with plain_kernels(fused_mma):
        plain_loss, _ = node_train_step(
            plain_model, make_optimizer(plain_model.parameters(), 1e-3), x_big, big,
            labels, idx_train, torch.Generator(device=dev).manual_seed(SEED))
    if fused_mma.LAUNCHES != before:
        raise AssertionError("the plain train step launched a kernel")
    compare(torch.tensor([losses[0]]), torch.tensor([float(plain_loss)]), 1e-5,
            "large-train step 1 loss vs plain on the card")
    for name, p in plain_model.named_parameters():
        compare(grads1[name], p.grad, 1e-5, f"large-train step 1 grad {name} vs plain")
    del plain_model, grads1

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

        args, ct = capture_edge_program(masked_aggregate, one_step)
        c, w_bot, h, pat, src, rp, cp, perm = (t.detach() for t in args)
        f, kf = w_bot.shape
        fwd_args = (c, w_bot, h, pat, src, rp)
        got = fused_mma.edge_program_lean(*fwd_args, cp, perm)
        if not torch.equal(got, fused_mma.edge_program_lean(*fwd_args, cp, perm)):
            raise AssertionError("edge_program_lean_fwd differs run to run")
        err = compare(got, fused_mma.edge_program_lean_reference(*fwd_args), 1e-5,
                      "edge_program_lean_fwd vs plain")
        ms = device_ms(lambda: fused_mma.edge_program_lean(*fwd_args, cp, perm))
        plain_ms = device_ms(lambda: fused_mma.edge_program_lean_reference(*fwd_args), iters=10)
        nbytes = 4 * (n_rows * kf + n_rows * f + f * kf + kf + e_cov + (n_rows + 1)
                      + n_rows * kf)
        # Per edge: the (1 x F)(F x K·F) product, then per lane the add of
        # c, the product with h and the accumulation (sigmoid not counted).
        kernels["edge_program_lean_fwd"] = {
            "name": "edge_program_lean_fwd", "route": "cuda", "source": SOURCE,
            "replaces": REPLACES["edge_program_lean_fwd"],
            "max_abs_err": err["max_abs_err"], "ms": ms, "plain_ms": plain_ms,
            **bound(nbytes, e_cov * (2 * f * kf + 3 * kf)), "library_ms": None,
            "shape": f"E={e_cov} N={n_rows} F={f} K·F={kf}",
        }
        k2 = kernels["edge_program_lean_fwd"]
        print(f"edge_program_lean_fwd: ms {ms:.4f} plain_ms {plain_ms:.4f} "
              f"bound_ms {k2['bound_ms']:.4f} ({k2['bound_by']})")

        bwd_args = fwd_args + (ct.contiguous(),)
        got = fused_mma.edge_program_lean_bwd(*bwd_args)
        again = fused_mma.edge_program_lean_bwd(*bwd_args)
        if not all(torch.equal(a, b) for a, b in zip(got, again)):
            raise AssertionError("edge_program_lean_bwd differs run to run")
        print("edge_program_lean_bwd: dc, dW_bot and payload bitwise equal run to run")
        want = fused_mma.edge_program_lean_bwd_reference(*bwd_args)
        errs = [compare(g, w, 1e-5, f"edge_program_lean_bwd {name} vs plain")
                for g, w, name in zip(got, want, ("dc", "dW_bot", "payload"))]
        del got, again, want
        ms = device_ms(lambda: fused_mma.edge_program_lean_bwd(*bwd_args), iters=15)
        plain_ms = device_ms(lambda: fused_mma.edge_program_lean_bwd_reference(*bwd_args),
                             iters=5)
        # Bytes: c, ct, h, W_bot, pattern, src, row_ptr read once; dc, dW_bot
        # and the (E, F) payload written once. Operations per edge: three
        # (1 x F)(F x K·F) products (the logits, dlog @ W_botᵀ, the dW_bot
        # outer product) and about 10 per lane (the mask chain, dlog, dc,
        # ct ⊙ mask), the sigmoid not counted.
        nbytes = 4 * (2 * n_rows * kf + n_rows * f + f * kf + kf + e_cov + (n_rows + 1)
                      + n_rows * kf + f * kf + big.n_edge * f)
        kernels["edge_program_lean_bwd"] = {
            "name": "edge_program_lean_bwd", "route": "cuda", "source": SOURCE,
            "replaces": REPLACES["edge_program_lean_bwd"],
            "max_abs_err": max(e["max_abs_err"] for e in errs), "ms": ms,
            "plain_ms": plain_ms, **bound(nbytes, e_cov * (6 * f * kf + 10 * kf)),
            # No single PyTorch call computes dc, dW_bot and the payload.
            "library_ms": None,
            "shape": f"E={e_cov} N={n_rows} F={f} K·F={kf}",
        }
        k3 = kernels["edge_program_lean_bwd"]
        print(f"edge_program_lean_bwd: ms {ms:.4f} plain_ms {plain_ms:.4f} "
              f"bound_ms {k3['bound_ms']:.4f} ({k3['bound_by']})")

    launch_keys = {"segment_sum_csr": "segment_sum", "edge_program_lean_fwd": "edge_program_lean",
                   "edge_program_lean_bwd": "edge_program_lean_bwd"}
    for name, entry in kernels.items():
        entry["launches"] = sum(p[launch_keys[name]] for p in paths.values())
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

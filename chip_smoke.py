#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU: ``python3 chip_smoke.py``.

1. Prints the card's name and power limit (``nvidia-smi``), then builds
   every CUDA kernel of the port from ``mma_tpu_torch/csrc`` (one ``nvcc``
   per source, all started together).
2. Main path, with the kernels' launch counters set to 0 just before and
   read just after: the node classifier's eval forward serves 3 requests
   on Cora at the README preset (1433 features, hidden 64, 7 classes,
   ``mean,mean2``, parity mode), then runs 3 forwards of the
   synthetic-large model (131072-node / 2.1M-edge power-law graph, F=64,
   16 classes). Weights are random from a seed.
3. Checks every output (finite log-probs of the expected shape whose rows
   sum to 1) and holds it against the same forward with every kernel
   replaced by its plain PyTorch version on the card; the first Cora
   request is also held against the plain forward on the CPU, which the
   CPU tests hold against the JAX package.
4. Per kernel, at the synthetic-large shapes of the main path: the error
   against the plain version, the kernel's median time, the plain
   version's time, the time of one PyTorch library call for the same
   function where there is one, and the least time the card could take
   (``bound_ms``).
5. Prints one ``kernels`` JSON line, the ``nvidia-smi`` line again, and as
   the last line ``{"ok": true, "device": {...}}``.

Any failed check raises, so the script exits non-zero and prints no
result; so does a host without a GPU, or a directory without the port.
"""

from __future__ import annotations

import contextlib
import json
import re
import statistics
import subprocess
import sys
import time

import torch

SEED = 0
# Published peaks of one H100 SXM (NVIDIA data sheet): HBM3 bandwidth and
# dense float32 outside the tensor cores. The kernels run f32 on CUDA cores.
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_FLOP_PER_S = 67e12
# TPU kernels each port replaces (file:line of the Pallas kernel).
REPLACES = {
    "segment_sum_csr": "mma_tpu/ops/pallas/fused_mma.py:176",
    "edge_program_lean_fwd": "mma_tpu/ops/pallas/fused_mma.py:488",
}
SOURCE = "mma_tpu_torch/csrc/fused_mma.cu"


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


@contextlib.contextmanager
def plain_kernels(fused_mma, spmm, masked_aggregate):
    """Route the model's kernel calls to their plain versions."""
    saved = spmm.segment_sum_csr, masked_aggregate.edge_program_lean
    spmm.segment_sum_csr = fused_mma.segment_sum_reference
    masked_aggregate.edge_program_lean = fused_mma.edge_program_lean_reference
    try:
        yield
    finally:
        spmm.segment_sum_csr, masked_aggregate.edge_program_lean = saved


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False", file=sys.stderr)
        return 1
    from mma_tpu_torch import NodeClassifier, load_planetoid, synthetic_powerlaw
    from mma_tpu_torch.ops import masked_aggregate, spmm
    from mma_tpu_torch.ops.cuda import build, fused_mma
    from mma_tpu_torch.ops.masked_aggregate import _flat_lanes, sigmoid_lane_pattern

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
            if re.search(r"registers|spill", line):
                print("  ptxas:", line.strip())

    # ---------------------------------------------------------------- set-up
    gen = torch.Generator().manual_seed(SEED)
    cora = load_planetoid("cora")
    cora_model = NodeClassifier(cora.num_features, 64, cora.num_classes, ("mean", "mean2"),
                                dropout_rate=0.75, generator=gen)
    noise = torch.Generator().manual_seed(SEED + 1)
    requests = [cora.features] + [
        (cora.features + 0.1 * torch.randn(cora.features.shape, generator=noise).to(dev))
        * cora.graph.node_mask[:, None]
        for _ in range(2)
    ]
    t0 = time.perf_counter()
    big = synthetic_powerlaw(131072, avg_deg=16, seed=1)
    print(f"synthetic-large graph: {big.n_node} nodes, {int(big.num_edges)} edges "
          f"(padded {big.n_edge}), max in-degree {int(big.deg.max())}, "
          f"built in {time.perf_counter() - t0:.2f} s")
    big_model = NodeClassifier(64, 64, 16, ("mean", "mean2"), generator=gen)
    x_big = torch.randn((big.n_node, 64), generator=torch.Generator().manual_seed(SEED)).to(dev)
    x_big = x_big * big.node_mask[:, None]

    # ------------------------------------------------------------- main path
    for key in fused_mma.LAUNCHES:
        fused_mma.LAUNCHES[key] = 0
    t0 = time.perf_counter()
    with torch.no_grad():
        cora_out = [cora_model(x, cora.graph) for x in requests]
        torch.cuda.synchronize()
        t_cora = time.perf_counter() - t0
        t0 = time.perf_counter()
        big_out = [big_model(x_big, big) for _ in range(3)]
        torch.cuda.synchronize()
        t_big = time.perf_counter() - t0
    launches = dict(fused_mma.LAUNCHES)
    print(f"main path: 3 Cora requests in {t_cora * 1e3:.3f} ms (first includes "
          f"library load), 3 synthetic-large forwards in {t_big * 1e3:.3f} ms; "
          f"launches {launches}")
    expected = {"segment_sum": 2 * 6, "edge_program_lean": 6}
    if launches != expected:
        raise AssertionError(f"launch counts {launches} != {expected}")

    # ---------------------------------------------------------------- checks
    cpu_model = NodeClassifier(cora.num_features, 64, cora.num_classes,
                               ("mean", "mean2"), device="cpu")
    cpu_model.load_state_dict({k: v.cpu() for k, v in cora_model.state_dict().items()})
    with torch.no_grad():
        for i, out in enumerate(cora_out):
            check_log_probs(out, cora.graph.n_node, cora.num_classes, cora.num_nodes,
                            f"cora request {i}")
        for i, out in enumerate(big_out):
            check_log_probs(out, big.n_node, 16, 131072, f"synthetic-large forward {i}")
        with plain_kernels(fused_mma, spmm, masked_aggregate):
            cora_plain = [cora_model(x, cora.graph) for x in requests]
            big_plain = big_model(x_big, big)
        if fused_mma.LAUNCHES != launches:
            raise AssertionError("the plain forward launched a kernel")
        n = cora.num_nodes
        for i, (got, want) in enumerate(zip(cora_out, cora_plain)):
            compare(got[:n], want[:n], 1e-5, f"cora request {i} vs plain on the card")
        compare(big_out[0][:131072], big_plain[:131072], 1e-5,
                "synthetic-large forward vs plain on the card")
        cpu_out = cpu_model(requests[0].cpu(), cora.graph.to("cpu"))
        compare(cora_out[0][:n].cpu(), cpu_out[:n], 1e-5, "cora request 0 vs plain on the CPU")

    # ------------------------------------- serving latency, warm, host clock
    def latency_ms(fn, n: int) -> float:
        times = []
        for _ in range(n):
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        return statistics.median(times)

    with torch.no_grad():
        cora_ms = latency_ms(lambda: cora_model(requests[0], cora.graph), 20)
        big_ms = latency_ms(lambda: big_model(x_big, big), 10)
    print(f"serving latency (host clock, median): cora request {cora_ms:.4f} ms; "
          f"synthetic-large forward {big_ms:.4f} ms = "
          f"{int(big.num_edges) / (big_ms * 1e-3):.4e} edges/s")

    # ------------------------------------------------- per-kernel, big shapes
    # The main path reduces over the CSR without the padding edges.
    row_ptr = big.real_row_ptr
    e_cov = int(row_ptr[-1])
    n_rows = big.n_node
    kernels = []
    with torch.no_grad():
        support = (x_big @ big_model.gc1.w) * big.node_mask[:, None]
        h = torch.relu(spmm.binary_spmm(big, support) + big_model.gc1.b)
        f = h.shape[1]
        masks = big_model.mma.masks
        w_top = _flat_lanes(masks[:, :f, :])
        w_bot = _flat_lanes(masks[:, f:, :]).contiguous()
        c = (h @ w_top).contiguous()
        pat = sigmoid_lane_pattern(big_model.mma.specs, "new_sigmoid", True, f, dev)
        kf = c.shape[1]
        dst_long = big.dst.long()

        for ch, data in ((64, support.index_select(0, big.src)),
                         (16, (torch.randn(n_rows, 16, generator=gen).to(dev)
                               * big.node_mask[:, None]).index_select(0, big.src))):
            got = fused_mma.segment_sum_csr(data, row_ptr)
            if not torch.equal(got, fused_mma.segment_sum_csr(data, row_ptr)):
                raise AssertionError("segment_sum_csr differs run to run")
            want = fused_mma.segment_sum_reference(data, row_ptr)
            err = compare(got, want, 1e-5, f"segment_sum_csr C={ch} vs plain")
            ms = device_ms(lambda: fused_mma.segment_sum_csr(data, row_ptr))
            plain_ms = device_ms(lambda: fused_mma.segment_sum_reference(data, row_ptr))
            library_ms = device_ms(
                lambda: torch.zeros(n_rows, ch, device=dev).index_add_(0, dst_long, data))
            nbytes = 4 * (e_cov * ch + (n_rows + 1) + n_rows * ch)
            flops = e_cov * ch
            t_bytes, t_ops = nbytes / PEAK_BYTES_PER_S * 1e3, flops / PEAK_F32_FLOP_PER_S * 1e3
            entry = {
                "name": "segment_sum_csr", "route": "cuda", "source": SOURCE,
                "replaces": REPLACES["segment_sum_csr"],
                "launches": launches["segment_sum"],
                "max_abs_err": err["max_abs_err"], "ms": ms, "plain_ms": plain_ms,
                "bound_ms": max(t_bytes, t_ops),
                "bound_by": "bytes" if t_bytes >= t_ops else "operations",
                "library_ms": library_ms, "shape": f"E={e_cov} C={ch} N={n_rows}",
            }
            print(f"segment_sum_csr C={ch}: ms {ms:.4f} plain_ms {plain_ms:.4f} "
                  f"index_add_ ms {library_ms:.4f} bound_ms {entry['bound_ms']:.4f} "
                  f"({entry['bound_by']})")
            if ch == 64:
                kernels.append(entry)

        args = (c, w_bot, h.contiguous(), pat, big.src, row_ptr)
        got = fused_mma.edge_program_lean(*args)
        if not torch.equal(got, fused_mma.edge_program_lean(*args)):
            raise AssertionError("edge_program_lean_fwd differs run to run")
        want = fused_mma.edge_program_lean_reference(*args)
        err = compare(got, want, 1e-5, "edge_program_lean_fwd vs plain")
        ms = device_ms(lambda: fused_mma.edge_program_lean(*args))
        plain_ms = device_ms(lambda: fused_mma.edge_program_lean_reference(*args), iters=20)
        nbytes = 4 * (n_rows * kf + n_rows * f + f * kf + kf + e_cov + (n_rows + 1)
                      + n_rows * kf)
        # Per edge: the (1 x F)(F x K·F) product, then per lane the add of
        # c, the product with h and the accumulation (sigmoid not counted).
        flops = e_cov * (2 * f * kf + 3 * kf)
        t_bytes, t_ops = nbytes / PEAK_BYTES_PER_S * 1e3, flops / PEAK_F32_FLOP_PER_S * 1e3
        kernels.append({
            "name": "edge_program_lean_fwd", "route": "cuda", "source": SOURCE,
            "replaces": REPLACES["edge_program_lean_fwd"],
            "launches": launches["edge_program_lean"],
            "max_abs_err": err["max_abs_err"], "ms": ms, "plain_ms": plain_ms,
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": None, "shape": f"E={e_cov} N={n_rows} F={f} K·F={kf}",
        })
        print(f"edge_program_lean_fwd: ms {ms:.4f} plain_ms {plain_ms:.4f} "
              f"bound_ms {kernels[-1]['bound_ms']:.4f} ({kernels[-1]['bound_by']})")

    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""The trace reduction on a hand-made Chrome trace."""

import pytest

from h100_bench import trace as T


def _x(cat, name, ts, dur, tid=1, **args):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, "tid": tid, "pid": 0,
            "args": args}


EVENTS = [
    _x("user_annotation", "bench.window", 0, 100),
    _x("user_annotation", "bench.step", 0, 50),
    _x("user_annotation", "bench.mma_layer.fwd", 10, 10),
    _x("cpu_op", "aten::mm", 11, 1, **{"Sequence number": 5}),
    _x("cpu_op", "aten::add", 15, 1, **{"Sequence number": 6}),
    _x("cpu_op", "aten::relu", 25, 1, **{"Sequence number": 7}),
    _x("cpu_op", "autograd::engine::evaluate_function: MmBackward0", 30, 5, tid=2,
       **{"Sequence number": 5}),
    _x("cpu_op", "autograd::engine::evaluate_function: ReluBackward0", 26, 3, tid=2,
       **{"Sequence number": 7}),
    _x("cuda_runtime", "cudaLaunchKernel", 11.5, 0.2, correlation=1),
    _x("cuda_runtime", "cudaLaunchKernel", 31, 0.2, tid=2, correlation=2),
    _x("cuda_runtime", "cudaLaunchKernel", 45, 0.2, correlation=3),
    _x("kernel", "k1", 12, 2, tid=7, correlation=1),
    _x("kernel", "k2", 32, 4, tid=7, correlation=2),
    _x("kernel", "k3", 60, 10, tid=7, correlation=3),
    _x("gpu_memcpy", "copy", 70, 2, tid=7, correlation=99),
]


def test_reduce_events():
    r = T.reduce_events(EVENTS, units=1, module_spans=("mma_layer.fwd",))
    assert r.window_s == pytest.approx(100e-6)
    assert r.busy_s == pytest.approx(18e-6)
    spans = {op.name: op.span for op in r.ops}
    assert spans == {"k1": "mma_layer.fwd", "k2": "mma_layer.bwd", "k3": "step", "copy": "step"}
    assert r.device_seconds("mma_layer") == pytest.approx(6e-6)
    assert r.device_seconds("mma_layer", kernels_only=True) == pytest.approx(6e-6)
    assert r.device_seconds(kernels_only=True) == pytest.approx(16e-6)
    gaps = dict((k, v) for k, v in r.breakdown()["idle_gaps"])
    assert gaps["step"] == pytest.approx((12 + 18 + 24) * 1e-6)
    assert gaps["outside spans"] == pytest.approx(28e-6)
    assert r.breakdown()["device_ops"][0] == ["k3", pytest.approx(10e-6)]


def test_no_window_no_reduction():
    assert T.reduce_events([e for e in EVENTS if e["name"] != "bench.window"], 1) is None

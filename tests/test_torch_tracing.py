"""The port's tracer (``mma_tpu_torch.utils.profiling``): spans, the record,
the counters, the spans of the training steps and the served callable, and
the benchmark's readers of them.

This file imports neither JAX nor ``mma_tpu``, so its ``gpu`` test also runs
on the card, past the repository's JAX-importing ``conftest.py``:

    python -m pytest --noconftest -m gpu tests/test_torch_tracing.py
"""

import json
import os
import threading
import types
import warnings

import numpy as np
import pytest
import torch

from mma_tpu_torch import NodeClassifier, graph_from_edges
from mma_tpu_torch.data import load_zinc
from mma_tpu_torch.models import ZincNet
from mma_tpu_torch.nn.mma_conv import compute_avg_deg
from mma_tpu_torch.serve import export_zinc_predictor, load_forward
from mma_tpu_torch.train.loops import node_train_step, zinc_train_step
from mma_tpu_torch.train.optim import make_optimizer
from mma_tpu_torch.utils import annotate_fn, profile_to, trace
from mma_tpu_torch.utils import profiling as P

CPU = [torch.profiler.ProfilerActivity.CPU]


@pytest.fixture(autouse=True)
def empty_record():
    P.RECORD.clear()
    yield
    P.RECORD.clear()


def _spans(name=None):
    return [s for s in P.RECORD.spans if name is None or s.name == name]


def _children(span):
    return sorted((s for s in P.RECORD.spans if s.parent == span.id), key=lambda s: s.start_ns)


def _node_setup(device="cpu", n=60, seed=0):
    rs = np.random.RandomState(seed)
    src, dst = rs.randint(0, n, 400), rs.randint(0, n, 400)
    keep = src != dst
    graph = graph_from_edges(np.concatenate([src[keep], dst[keep]]),
                             np.concatenate([dst[keep], src[keep]]), n, device=device)
    model = NodeClassifier(12, 8, 3, ("mean", "mean2"), dropout_rate=0.5, device=device,
                           generator=torch.Generator().manual_seed(seed))
    x = torch.from_numpy(rs.randn(graph.n_node, 12).astype(np.float32)).to(device)
    labels = torch.from_numpy(rs.randint(0, 3, graph.n_node)).to(device)
    idx = torch.arange(n // 2, device=device)
    gen = torch.Generator(device=device).manual_seed(seed)
    return model, make_optimizer(model.parameters(), 1e-3, 3e-4), x, graph, labels, idx, gen


def _zinc_setup():
    avg = compute_avg_deg(load_zinc("val", subset_size=8).degree_histogram(), parity=True)
    model = ZincNet(("min", "max"), ("identity", "amplification", "linear"), avg, towers=5,
                    num_layers=2, device="cpu", generator=torch.Generator().manual_seed(0))
    batch = next(load_zinc("val", subset_size=8).batches(4, n_node=160, n_edge=400,
                                                         device="cpu"))
    return model, batch


# ------------------------------------------------------------------ the tracer

def test_off_the_tracer_records_nothing_and_enters_no_range(monkeypatch):
    def refuse(*a, **kw):
        raise AssertionError("entered while no profiler records")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.cuda.nvtx, "range_push", refuse)
    monkeypatch.setattr(torch.cuda.nvtx, "range_pop", refuse)
    assert not torch.autograd._profiler_enabled()

    @annotate_fn("decorated")
    def work(x):
        with trace("inner"):
            P.count("things")
            return x + 1

    with trace("outer"):
        assert work(1) == 2
    assert not _spans() and P.RECORD.dropped == 0


def test_recording_gives_the_span_tree():
    with torch.profiler.profile(activities=CPU) as prof:
        for _ in range(2):
            with trace("a"):
                with trace("a.b"):
                    with trace("a.b.c"):
                        pass
                with trace("a.d"):
                    pass
    assert {"a", "a.b", "a.b.c", "a.d"} <= {e.name for e in prof.events()}
    roots = _spans("a")
    assert len(roots) == 2 and all(r.parent is None and r.root == r.id for r in roots)
    assert roots[0].id != roots[1].id
    for r in roots:
        b, d = _children(r)
        assert (b.name, d.name) == ("a.b", "a.d")
        (c,) = _children(b)
        assert c.name == "a.b.c"
        for s in (b, c, d):
            assert s.root == r.id and s.thread == threading.get_ident()
        # Nested and in order on one clock; siblings do not overlap.
        assert r.start_ns <= b.start_ns <= c.start_ns <= c.end_ns <= b.end_ns
        assert b.end_ns <= d.start_ns <= d.end_ns <= r.end_ns
    # A span enters the record when it closes: children before their parent.
    names = [s.name for s in P.RECORD.spans]
    assert names == ["a.b.c", "a.b", "a.d", "a"] * 2


def test_a_span_on_another_thread_joins_the_open_tree(monkeypatch):
    """The autograd engine runs a CUDA backward on a thread of its own, which
    takes the profiler's state along, with no span open there: its spans
    hang under the root thread's innermost. (A plain thread does not take
    the profiler's state along: here every thread is told one records.)"""
    def worker():
        with trace("elsewhere"):
            P.count("hits")

    monkeypatch.setattr(torch.autograd, "_profiler_enabled", lambda: True)
    with trace("root"):
        with trace("root.wait"):
            t = threading.Thread(target=worker)
            t.start()
            t.join(timeout=30)
    assert not t.is_alive()
    (root,), (wait,), (other,) = _spans("root"), _spans("root.wait"), _spans("elsewhere")
    assert other.parent == wait.id and other.root == root.id
    assert other.thread != root.thread and other.counts == {"hits": 1}


def test_the_record_is_bounded_and_counts_what_it_drops(monkeypatch):
    rec = P.Record(capacity=3)
    for i in range(5):
        rec.add(P.SpanRecord(i + 1, f"s{i}", None, i + 1, 0))
    assert [s.name for s in rec.spans] == ["s2", "s3", "s4"] and rec.dropped == 2
    rec.clear()
    assert not rec.spans and rec.dropped == 0

    monkeypatch.setattr(P, "RECORD", P.Record(capacity=4))
    with torch.profiler.profile(activities=CPU):
        for i in range(3):
            with trace("r"):
                with trace("r.x"):
                    pass
    assert len(P.RECORD.spans) == 4 and P.RECORD.dropped == 2
    assert [s.name for s in P.RECORD.spans] == ["r.x", "r", "r.x", "r"]


def test_a_counter_lands_on_its_innermost_span():
    P.count("lost")  # no span open: counted nowhere
    with torch.profiler.profile(activities=CPU):
        with trace("outer"):
            P.count("n")
            with trace("outer.inner"):
                P.count("n", 2)
                P.count("m")
    (outer,), (inner,) = _spans("outer"), _spans("outer.inner")
    assert outer.counts == {"n": 1} and inner.counts == {"n": 2, "m": 1}


def test_sync_warnings_count_on_the_innermost_span_while_a_root_is_open(monkeypatch):
    """The sync counter's mechanism, with torch's sync debug mode stubbed:
    on the card torch emits the warning itself."""
    modes = []
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    monkeypatch.setattr(torch.cuda, "get_sync_debug_mode", lambda: 0)
    monkeypatch.setattr(torch.cuda, "set_sync_debug_mode", modes.append)
    with warnings.catch_warnings(record=True) as seen:
        warnings.simplefilter("default")
        with torch.profiler.profile(activities=CPU):
            with trace("step"):
                with trace("sync.thing"):
                    for _ in range(2):  # each one counts, not once per place
                        warnings.warn(P.SYNC_WARNING + " (Triggered internally)")
                warnings.warn("an unrelated warning")
            warnings.warn(P.SYNC_WARNING)  # after the root: not counted
    (step,), (sync,) = _spans("step"), _spans("sync.thing")
    assert sync.counts == {"sync": 2} and step.counts == {}
    assert modes == ["warn", 0]
    assert [str(w.message) for w in seen] == ["an unrelated warning", P.SYNC_WARNING]


# ------------------------------------------------------ the port's spans

def _check_step(root, forward_children):
    parts = _children(root)
    assert [s.name for s in parts] == ["step.forward", "step.loss", "step.backward",
                                       "step.optimizer"]
    assert [s.name for s in _children(parts[0])] == forward_children
    return parts


def test_node_train_step_spans():
    model, opt, x, graph, labels, idx, gen = _node_setup()
    with torch.profiler.profile(activities=CPU):
        for _ in range(2):
            node_train_step(model, opt, x, graph, labels, idx, gen)
    roots = _spans("step")
    assert len(roots) == 2
    for root in roots:
        forward = _check_step(root, ["gcn.layer", "mma.layer"])[0]
        mma = _children(forward)[1]
        assert "sync.lane_pattern" in [s.name for s in _children(mma)]
        # The layer's aggregation counts its route: mask dropout on the lean program.
        assert mma.counts == {"mma.route.lean_keep": 1}
        assert all(s.root == root.id for s in P.RECORD.spans if s.start_ns >= root.start_ns
                   and s.end_ns <= root.end_ns)
    # The CPU counts no syncs, and nothing but the two routes.
    assert not any("sync" in s.counts for s in P.RECORD.spans)
    assert [s.name for s in P.RECORD.spans if s.counts] == ["mma.layer", "mma.layer"]


def test_zinc_train_step_spans():
    model, batch = _zinc_setup()
    opt = make_optimizer(model.parameters(), 1e-3)
    with torch.profiler.profile(activities=CPU):
        zinc_train_step(model, opt, batch, torch.Generator().manual_seed(0))
    (root,) = _spans("step")
    _check_step(root, [])


def test_the_served_call_spans_and_bitwise_outputs():
    model, batch = _zinc_setup()
    buffers = {name for name, _ in model.named_buffers()}
    weights = model.state_dict()
    params = {k: v for k, v in weights.items() if k not in buffers}
    state = {k: v for k, v in weights.items() if k in buffers}
    served = load_forward(export_zinc_predictor(model, params, state, batch))
    off = served(params, state, batch)
    with torch.profiler.profile(activities=CPU) as prof:
        on = [served(params, state, batch) for _ in range(3)]
    assert all(torch.equal(o, off) for o in on)
    assert torch.equal(served(params, state, batch), off)
    assert {"serve.call", "serve.check", "serve.inputs", "serve.graph"} <= {
        e.name for e in prof.events()}
    roots = _spans("serve.call")
    assert len(roots) == 3
    for root in roots:
        parts = _children(root)
        assert [s.name for s in parts] == ["serve.check", "serve.inputs", "serve.graph"]
        assert parts[0].end_ns <= parts[1].start_ns and parts[1].end_ns <= parts[2].start_ns
        assert sum(s.end_ns - s.start_ns for s in parts) <= root.end_ns - root.start_ns


# ------------------------------------------ the benchmark's readers of them

READERS = {
    "node-large-train": ["host_syncs.train", "host_sync_ms.train"],
    "zinc-serve": ["host_syncs.serve", "host_sync_ms.serve", "served_inputs_host_ms.serve",
                   "served_graph_host_ms.serve", "kernel_wrapper_host_ms.serve"],
}
TINY = {
    "node-large-train": {"config": {"num_nodes": 2000, "avg_deg": 8},
                         "params": {"trace_steps": 3}},
    "zinc-serve": {"config": {"dataset_size": 300},
                   "params": {"min_molecules": 16, "max_molecules": 32, "pool": 4,
                              "trace_requests": 5}},
}


@pytest.mark.parametrize("cell", sorted(READERS))
def test_the_readers_on_a_tiny_traced_cpu_run(cell, monkeypatch):
    from h100_bench import core

    spec = {m["name"]: m for m in core.benchmark_spec()["per_layer"]}
    assert all(spec[name]["workloads"] == [cell] for name in READERS[cell])
    torch.manual_seed(0)
    result, outcome = core.run_cell(cell, 2**31 + 7, 0.1, True, "cpu", overrides=TINY[cell])
    assert result["correct"]
    # The CPU trace holds no device operations, so the run reduces it to
    # nothing and the readers report nothing ...
    assert outcome.trace is None
    assert not set(READERS[cell]) & set(result["metrics"])
    # ... though the port recorded the profiled stretch: read it as the
    # stretch of a trace would be read.
    units = TINY[cell]["params"]["trace_steps" if cell.startswith("node") else "trace_requests"]
    ctx = dict(outcome.layer, trace=types.SimpleNamespace(units=units), config=None)
    got = {name: core.load_module("metrics", name).read(ctx) for name in READERS[cell]}
    assert all(isinstance(v, float) for v in got.values()), got
    if cell == "node-large-train":
        assert got["host_syncs.train"] == 0.0  # the CPU counts no syncs
        assert got["host_sync_ms.train"] > 0.0  # the lane pattern's copy, a no-op here
    else:
        assert got["host_syncs.serve"] == got["host_sync_ms.serve"] == 0.0
        assert got["kernel_wrapper_host_ms.serve"] == 0.0  # the plain versions run
        assert got["served_inputs_host_ms.serve"] > 0.0 and got["served_graph_host_ms.serve"] > 0.0
        calls = [s.ms for s in _spans("serve.call")][-units:]
        parts = got["served_inputs_host_ms.serve"] + got["served_graph_host_ms.serve"]
        assert parts <= sum(calls) / units
    # A run with more units than the record holds, and a program without
    # the record (one older than it), give nothing.
    more = dict(ctx, trace=types.SimpleNamespace(units=10**6))
    monkeypatch.delattr(P, "RECORD")
    for name in READERS[cell]:
        reader = core.load_module("metrics", name).read
        assert reader(dict(ctx, trace=None)) is None
        assert reader(ctx) is None
    monkeypatch.undo()
    assert all(core.load_module("metrics", n).read(more) is None for n in READERS[cell])


# ---------------------------------------------------------------- the card

@pytest.mark.gpu
def test_the_lane_pattern_copy_is_counted_once_a_forward_on_the_card(tmp_path):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc")
    torch.backends.cuda.matmul.allow_tf32 = False
    model, opt, x, graph, labels, idx, gen = _node_setup("cuda", n=2000)
    node_train_step(model, opt, x, graph, labels, idx, gen)  # build and warm up
    torch.cuda.synchronize()
    with profile_to(str(tmp_path)):
        for _ in range(3):
            node_train_step(model, opt, x, graph, labels, idx, gen)
        torch.cuda.synchronize()
    roots = _spans("step")
    assert len(roots) == 3
    by_id = {s.id: s for s in P.RECORD.spans}
    for root in roots:
        mine = [s for s in P.RECORD.spans if s.root == root.id]
        counted = [s for s in mine if s.counts.get("sync")]
        assert [(s.name, s.counts["sync"]) for s in counted] == [("sync.lane_pattern", 1)]
        assert by_id[by_id[counted[0].parent].parent].name == "step.forward"
        assert any(s.name.startswith("kernel.segment_sum") for s in mine)
    (name,) = os.listdir(tmp_path)
    with open(tmp_path / name) as f:
        events = [e for e in json.load(f)["traceEvents"] if e.get("ph") == "X"]
    spans = {e["name"] for e in events if e.get("cat") == "user_annotation"}
    assert {"step", "step.forward", "step.backward", "mma.layer", "gcn.layer",
            "sync.lane_pattern", "kernel.segment_sum"} <= spans
    steps = sorted((e["ts"], e["ts"] + e["dur"]) for e in events if e["name"] == "step")
    kernels = [e["ts"] for e in events if e.get("cat") == "kernel"]
    # One timeline: the device's kernels run from the first step's start on.
    assert kernels and steps[0][0] <= min(kernels) and max(kernels) < steps[-1][1] + 1e6

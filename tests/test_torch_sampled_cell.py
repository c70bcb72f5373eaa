"""The neighbour-sampled benchmark cell ``products-sampled-train`` at a tiny
size on the CPU (a 2,000-node power-law graph, fan-outs 3, 3, 2, batches
of 32 seeds), through the port's plain versions: the check against its
reference, the planted faults, the reference's determinism, the sampled
pipeline's spans and counters, and the readers of the ``sampling
pipeline`` layer.

This file imports neither JAX nor ``mma_tpu``.
"""

import threading
import types

import numpy as np
import pytest
import torch

from h100_bench import control, core
from h100_bench.draws import Recorder
from h100_bench.inputs.powerlaw import powerlaw_edges
from mma_tpu_torch.data.device_sampling import DeviceSampler
from mma_tpu_torch.data.sampling import NeighborSampler
from mma_tpu_torch.train.sampled import (DeviceTableAssembler, sampled_batch_producer,
                                         sampled_train_step)
from mma_tpu_torch.models import NodeClassifier
from mma_tpu_torch.train.optim import make_optimizer
from mma_tpu_torch.utils import profiling as P

CELL = "products-sampled-train"
TINY = {"config": {"num_nodes": 2000, "avg_deg": 8, "num_train": 400, "batch_size": 32,
                   "fanouts": [3, 3, 2], "sampler_threads": 2},
        "params": {"trace_steps": 3}}
CPU = [torch.profiler.ProfilerActivity.CPU]
READERS = ("batch_wait_ms.train", "sampler_host_ms.train")


@pytest.fixture(autouse=True)
def _quiet():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    P.RECORD.clear()
    yield
    P.RECORD.clear()
    torch.set_num_threads(before)


def _spans(name):
    return [s for s in P.RECORD.spans if s.name == name]


def _children(span):
    return sorted((s for s in P.RECORD.spans if s.parent == span.id), key=lambda s: s.start_ns)


# ------------------------------------------------------------- the check

def test_the_sound_run_is_correct():
    r, outcome = core.run_cell(CELL, 2**31 + 17, 0.2, False, "cpu", overrides=TINY)
    assert r["correct"] and r["failed"] == 0 and r["attempted"] >= 1, (r["attempted"], r["checks"])
    for name, c in r["checks"].items():
        assert c["value"] < 1e-5, (name, c)
    assert set(r["metrics"]) == {"setup_s", "train_edges_per_s"}
    work = outcome.layer["work"]
    assert 0 < work["mma_layer"]["flops"] < work["step"]["flops"]


@pytest.mark.parametrize("fault", ["stale_batch", "half_seeds"])
def test_each_fault_is_not_correct(fault):
    assert fault in core.find_cell(CELL).program().FAULTS
    with control.planted(CELL, fault):
        r, _ = core.run_cell(CELL, 99, 0.2, False, "cpu", overrides=TINY)
    assert not r["correct"], r["checks"]
    assert r["checks"]["loss_gap"]["value"] > 100 * r["checks"]["loss_gap"]["limit"]


def _three_checked_steps(seed=5):
    cell = core.find_cell(CELL, TINY)
    program = cell.program()
    obj = program.Train(cell.config, seed, "cpu")
    p0, draws = obj.params(), []
    with program.precision(cell.config):
        for _ in range(3):
            with Recorder() as rec:
                obj.step()
            draws.append(rec.draws)
    inputs = dict(obj.reference_inputs(), draws=draws)
    obj.free()
    return cell, inputs, p0


def test_the_reference_repeats_itself_bit_for_bit():
    cell, inputs, p0 = _three_checked_steps()
    assert len(inputs["batches"]) >= 3
    for b in inputs["batches"]:
        real = b["real"]
        assert real.sum() > 0 and not real[int(real.sum()):].any()  # the real edges first
    ref = cell.reference()
    one = ref.train_steps(inputs, p0, cell.config, 3)
    two = ref.train_steps(inputs, p0, cell.config, 3)
    assert one["losses"] == two["losses"]
    for part in ("grad1", "params"):
        assert all(torch.equal(one[part][k], two[part][k]) for k in one[part])
    with pytest.raises(ValueError):
        ref.train_steps(inputs, p0, cell.config, len(inputs["batches"]) + 1)


@pytest.mark.parametrize("layout", ["hub", "distinct", "random", "empty"])
def test_the_reference_segment_sums_match_a_plain_sum(layout):
    ref = core.load_module("reference", "mma-sampled-products")
    rs = np.random.RandomState(3)
    n = 50
    keys = {"hub": np.r_[np.zeros(300, np.int64), rs.randint(0, n, 40)],
            "distinct": rs.permutation(n)[:30],
            "random": rs.randint(0, n, 500),
            "empty": np.zeros(0, np.int64)}[layout]
    keys = torch.from_numpy(keys.astype(np.int64))
    seg = ref.Segments(keys, n)
    v = torch.from_numpy(rs.randn(keys.shape[0], 6)).requires_grad_()
    want = torch.zeros(n, 6, dtype=torch.float64).index_add_(0, keys, v.detach())
    got = seg.sum(v)
    assert torch.allclose(got, want, rtol=1e-12, atol=1e-12)
    rows = torch.from_numpy(rs.randn(n, 6)).requires_grad_()
    assert torch.equal(seg.gather(rows), rows[keys])
    g = torch.from_numpy(rs.randn(n, 6))
    (dv,) = torch.autograd.grad(seg.sum(v), v, g)
    assert torch.equal(dv, g[keys])
    (drows,) = torch.autograd.grad(seg.gather(rows), rows, g[keys] if keys.numel() else
                                   torch.zeros(0, 6, dtype=torch.float64))
    assert torch.allclose(drows, torch.zeros(n, 6, dtype=torch.float64).index_add_(
        0, keys, g[keys]), rtol=1e-12, atol=1e-12)


def test_the_pads_hold_every_batch():
    program = core.find_cell(CELL).program()
    cfg = core.find_cell(CELL, TINY).config
    row_ptr, src_sorted, deg = program.csr(cfg["num_nodes"], cfg["avg_deg"], cfg["graph_seed"])
    src, dst = powerlaw_edges(cfg["num_nodes"], cfg["avg_deg"], cfg["graph_seed"])
    assert np.array_equal(deg, np.bincount(dst, minlength=cfg["num_nodes"]))
    # The cached CSR gives the sampler that the unsorted edges give.
    sampler = NeighborSampler.from_host_arrays(src, dst, cfg["num_nodes"], (3, 3, 2), seed=1,
                                               n_threads=2, device="cpu")
    program.csr.cache_clear()  # read back from the file
    again = NeighborSampler.from_csr(*program.csr(cfg["num_nodes"], cfg["avg_deg"],
                                                  cfg["graph_seed"])[:2], (3, 3, 2), seed=1,
                                     n_threads=2, device="cpu")
    for name in ("row_ptr", "src_sorted", "src", "dst", "true_deg"):
        a, b = getattr(sampler, name), getattr(again, name)
        assert a.dtype == b.dtype and np.array_equal(a, b), name
    assert again.num_nodes == sampler.num_nodes
    n_node_pad, n_edge_pad = program.pads(sampler, 32)
    seeds = np.arange(0, cfg["num_nodes"], 60)[:32]
    one = sampler.sample_arrays(seeds, n_node_pad=n_node_pad, n_edge_pad=n_edge_pad)
    two = again.sample_arrays(seeds, n_node_pad=n_node_pad, n_edge_pad=n_edge_pad)
    assert all(np.array_equal(getattr(one, k), getattr(two, k))
               for k in ("src", "dst", "node_ids", "src_perm"))
    assert n_node_pad % 4096 == 0 and n_node_pad >= 32 * (1 + 3 + 9 + 18) + 1
    assert n_edge_pad % 4096 == 0 and n_edge_pad >= 32 * (3 + 9 + 18)
    # Seeds of the largest in-degrees reach the most nodes.
    hubs = np.argsort(-deg, kind="stable")[:32]
    walk = program.seed_walk(np.arange(cfg["num_nodes"]), 32, np.random.RandomState(0))
    for seeds in [hubs] + [next(walk)[0] for _ in range(20)]:
        ar = sampler.sample_arrays(seeds, n_node_pad=n_node_pad, n_edge_pad=n_edge_pad)
        assert ar.num_nodes < n_node_pad and ar.num_edges <= n_edge_pad
    assert next(walk).shape == (1, 32)
    with pytest.raises(ValueError):
        NeighborSampler.from_csr(row_ptr[::-1], src_sorted, (3,), device="cpu")
    with pytest.raises(ValueError):
        NeighborSampler.from_csr(row_ptr, src_sorted + cfg["num_nodes"], (3,), device="cpu")


# --------------------------------------------- the sampled pipeline's spans

def _pipeline(device_finish, steps=3, seed=0):
    """Losses of ``steps`` steps through the producer: ``device_finish`` True
    or False with the host sampler, or ``"device_sampler"`` (a
    ``DeviceSampler`` on the CPU, the structure finished on the device)."""
    n = 300
    rs = np.random.RandomState(seed)
    a, b = rs.randint(0, n, 3000), rs.randint(0, n, 3000)
    keep = a != b
    src = np.concatenate([a[keep], b[keep]]).astype(np.int32)
    dst = np.concatenate([b[keep], a[keep]]).astype(np.int32)
    sampler = NeighborSampler.from_host_arrays(src, dst, n, (3, 2), seed=seed, n_threads=2,
                                               device="cpu")
    deg_table = torch.from_numpy(sampler.true_deg)
    if device_finish == "device_sampler":
        sampler, device_finish = DeviceSampler(sampler), True
    feats = rs.randn(n, 6).astype(np.float32)
    labels = rs.randint(0, 3, n)
    model = NodeClassifier(6, 8, 3, ("mean", "mean2"), dropout_rate=0.5, device="cpu",
                           generator=torch.Generator().manual_seed(seed))
    opt = make_optimizer(model.parameters(), 1e-3)
    gen = torch.Generator().manual_seed(seed)
    batches = (rs.randint(0, n, (1, 16)) for _ in range(steps))
    losses = []
    for x, g, y, sm in sampled_batch_producer(
            sampler, batches, DeviceTableAssembler(feats, labels, device="cpu"),
            n_node_pad=4096, n_edge_pad=4096, device_finish=device_finish,
            deg_table=deg_table):
        losses.append(float(sampled_train_step(model, opt, x, g, y.long(), sm, gen)[0]))
    return losses


@pytest.mark.parametrize("device_finish", [True, False, "device_sampler"])
def test_the_pipeline_spans_while_a_profiler_records(device_finish):
    with torch.profiler.profile(activities=CPU):
        _pipeline(device_finish)
    main = threading.get_ident()
    produced = _spans("sampled.produce")
    assert len(produced) == 3
    for root in produced:
        assert root.parent is None and root.root == root.id and root.thread != main
        parts = _children(root)
        sample = parts[0]
        # A device sampler copies nothing but its seeds: no ship.
        assert [s.name for s in parts] == (["sampled.sample"] if device_finish == "device_sampler"
                                           else ["sampled.sample", "sampled.ship"])
        assert all(s.thread == root.thread and s.root == root.id for s in parts)
        assert set(sample.counts) == {"sampled.edges", "sampled.nodes"}
        assert 0 < sample.counts["sampled.edges"] <= 16 * (3 + 6)
        assert 16 <= sample.counts["sampled.nodes"] <= 16 * (1 + 3 + 6)
        assert sample.end_ns <= parts[-1].start_ns or len(parts) == 1
        assert parts[-1].end_ns <= root.end_ns
    # The consumer's parts are roots of the main thread, one of each a batch,
    # before the step; the step has node_train_step's parts.
    for name in ("sampled.wait", "sampled.finish", "sampled.assemble"):
        spans = _spans(name)
        assert len(spans) == 3 + (name == "sampled.wait")  # the last wait finds the end
        assert all(s.parent is None and s.thread == main and not _children(s) for s in spans)
    steps = _spans("step")
    assert len(steps) == 3
    for step, assemble in zip(steps, _spans("sampled.assemble")):
        assert assemble.end_ns <= step.start_ns
        assert [s.name for s in _children(step)] == ["step.forward", "step.loss",
                                                     "step.backward", "step.optimizer"]
        mma = [s for s in P.RECORD.spans if s.root == step.id and s.name == "mma.layer"]
        assert [s.counts for s in mma] == [{"mma.route.lean_keep": 1}]
    assert not any(s.root in {p.id for p in produced} and s.thread == main
                   for s in P.RECORD.spans)


def test_the_pipeline_records_nothing_without_a_profiler():
    plain = _pipeline(True)
    assert not P.RECORD.spans and P.RECORD.dropped == 0
    with torch.profiler.profile(activities=CPU):
        traced = _pipeline(True)
    assert traced == plain  # the spans change nothing that is computed
    # The device sampler draws the same subgraphs, so the steps are the same.
    assert _pipeline("device_sampler") == plain


# ------------------------------------------------------------ the readers

def _rec(sid, name, parent, root, start, end, thread=1):
    return P.SpanRecord(sid, name, parent, root, thread, int(start * 1e6), int(end * 1e6))


def test_the_pipeline_readers_on_a_hand_built_record(monkeypatch):
    """Times in ms. Three steps, each a wait then a step; the producer's
    batches on another thread, one closing before the stretch."""
    spans = [
        _rec(1, "sampled.produce", None, 1, 0, 10, 2), _rec(2, "sampled.sample", 1, 1, 0, 8, 2),
        _rec(3, "sampled.wait", None, 3, 5, 11),
        _rec(4, "step", None, 4, 12, 15),
        _rec(5, "sampled.sample", 6, 6, 11, 20, 2), _rec(7, "sampled.ship", 6, 6, 20, 21, 2),
        _rec(6, "sampled.produce", None, 6, 11, 21, 2),
        _rec(8, "sampled.wait", None, 8, 16, 21.5),
        _rec(9, "step", None, 9, 22, 25),
        _rec(10, "sampled.sample", 11, 11, 21, 32, 2), _rec(11, "sampled.produce", None, 11, 21, 33, 2),
        _rec(12, "sampled.wait", None, 12, 26, 33.5),
        _rec(13, "step", None, 13, 34, 37),
        _rec(14, "sampled.produce", None, 14, 33, 40, 2),  # closes after the stretch
    ]
    record = P.Record()
    for s in sorted(spans, key=lambda s: s.end_ns):
        record.add(s)
    monkeypatch.setattr(P, "RECORD", record)
    read = {name: core.load_module("metrics", name).read for name in READERS}
    ctx = {"trace": types.SimpleNamespace(units=2)}
    # The stretch: the last two waits (16 to 21.5, 26 to 33.5) to the last step's end (37).
    assert read["batch_wait_ms.train"](ctx) == pytest.approx((5.5 + 7.5) / 2)
    # Produced inside it: batches 6 (closed at 21) and 11 (at 33); sampling 9 and 11 ms.
    assert read["sampler_host_ms.train"](ctx) == pytest.approx((9 + 11) / 2)
    ctx3 = {"trace": types.SimpleNamespace(units=3)}
    assert read["batch_wait_ms.train"](ctx3) == pytest.approx((6 + 5.5 + 7.5) / 3)
    # From the first wait (5 ms) on, batch 1 (closed at 10 ms) is inside too.
    assert read["sampler_host_ms.train"](ctx3) == pytest.approx((8 + 9 + 11) / 3)
    # More units than the record holds, no trace, a program older than the
    # spans (steps but no waits), and one without the record: nothing.
    for bad in ({"trace": types.SimpleNamespace(units=4)}, {"trace": None}):
        assert all(r(bad) is None for r in read.values())
    older = P.Record()
    for s in spans:
        if not s.name.startswith("sampled."):
            older.add(s)
    monkeypatch.setattr(P, "RECORD", older)
    assert all(r(ctx) is None for r in read.values())
    monkeypatch.delattr(P, "RECORD")
    assert all(r(ctx) is None for r in read.values())


def test_the_readers_on_a_tiny_traced_cpu_run():
    spec = {m["name"]: m for m in core.benchmark_spec()["per_layer"]}
    for name in READERS:
        assert spec[name]["workloads"] == [CELL] and spec[name]["layer"] == "sampling pipeline"
    # The producer runs up to three batches ahead of the stretch (two queued,
    # one held), so the stretch's fourth step takes the first batch sampled
    # inside it: six steps always hold one.
    units = 6
    over = dict(TINY, params={"trace_steps": units})
    result, outcome = core.run_cell(CELL, 2**31 + 7, 0.1, True, "cpu", overrides=over)
    assert result["correct"]
    # The CPU trace holds no device operations: the run reduces it to nothing.
    assert outcome.trace is None and not set(READERS) & set(result["metrics"])
    ctx = dict(outcome.layer, trace=types.SimpleNamespace(units=units), config=None)
    got = {name: core.load_module("metrics", name).read(ctx)
           for name in READERS + ("host_syncs.train", "host_sync_ms.train")}
    assert all(isinstance(v, float) for v in got.values()), got
    assert got["sampler_host_ms.train"] > 0.0 and got["batch_wait_ms.train"] >= 0.0
    assert got["host_syncs.train"] == 0.0  # the CPU counts no syncs
    steps = _spans("step")[-units:]
    assert [[s.counts for s in P.RECORD.spans if s.root == st.id and s.counts]
            for st in steps] == [[{"mma.route.lean_keep": 1}]] * units

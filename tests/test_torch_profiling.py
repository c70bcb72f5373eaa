"""The port's tracing helpers (``mma_tpu_torch.utils.profiling``) on the CPU."""

import json
import os

import torch

from mma_tpu_torch.utils import annotate_fn, profile_to, trace


def _names(prof):
    return {e.name for e in prof.events()}


def test_named_ranges_appear_in_a_profiler_trace():
    @annotate_fn("decorated_call")
    def work(x):
        return x @ x

    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with trace("outer_range"):
            work(torch.randn(8, 8))
    assert {"outer_range", "decorated_call"} <= _names(prof)


def test_profile_to_writes_a_chrome_trace(tmp_path):
    log_dir = str(tmp_path / "profile")
    with profile_to(log_dir) as prof:
        with trace("train_step"):
            torch.randn(16, 16).sum()
    assert "train_step" in _names(prof)
    (name,) = os.listdir(log_dir)
    with open(os.path.join(log_dir, name)) as f:
        events = json.load(f)["traceEvents"]
    assert any(e.get("name") == "train_step" for e in events)


def test_the_training_loop_marks_its_steps(tmp_path):
    from mma_tpu_torch.train import NodeClassificationConfig, train_node_classification

    cfg = NodeClassificationConfig(dataset="cora", aggregators=("mean",), hidden=8, epochs=2)
    with profile_to(str(tmp_path)) as prof:
        train_node_classification(cfg, device="cpu")
    assert sum(e.name == "step" for e in prof.events()) == 2

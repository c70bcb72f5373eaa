"""The harness finds every file of a cell, configuration, traffic kind and
metric by name, and picks up a new workload file with no other edit."""

import importlib.util
import json
import os
import shutil
import sys

import pytest
import torch

from h100_bench import core

from bench_sizes import TINY


def test_every_name_in_benchmark_json_has_its_files():
    spec = core.benchmark_spec()
    assert spec["paths"] == ["h100_bench"]
    for cfg in spec["configs"]:
        assert os.path.exists(os.path.join(core.ROOT, cfg["file"]))
        assert core.load_module("configs", cfg["name"]) is not None
        assert core.load_module("reference", cfg["name"]) is not None
    for w in spec["workloads"]:
        cell = core.find_cell(w["name"])
        assert cell.workload["config"] == w["config"]
        assert cell.traffic == w["traffic"]
        assert cell.workload["chips"] == w["chips"]
        assert cell.workload["why"] == w["why"]
        assert core.load_module("traffic", cell.traffic).run is not None
        assert cell.limits
    for m in spec["per_layer"]:
        assert callable(core.load_module("metrics", m["name"]).read)


def test_each_cell_reports_its_end_to_end_metrics():
    spec = core.benchmark_spec()
    for w in spec["workloads"]:
        names = [m["name"] for m in spec["end_to_end"] if core.applies(m, w["name"])]
        assert "setup_s" in names and len(names) >= 2
        assert any(core.applies(m, w["name"]) for m in spec["per_layer"])


def _copy_of_the_benchmark(tmp_path):
    root = tmp_path / "checkout"
    shutil.copytree(core.BENCH_DIR, root / "h100_bench",
                    ignore=shutil.ignore_patterns("_cache", "__pycache__", "tests"))
    shutil.copy(os.path.join(core.ROOT, "BENCHMARK.json"), root / "BENCHMARK.json")
    spec = importlib.util.spec_from_file_location("h100_bench_copy_core",
                                                  root / "h100_bench" / "core.py")
    mod = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = mod
    spec.loader.exec_module(mod)
    return root, mod


def test_a_new_workload_file_is_picked_up(tmp_path):
    root, copy = _copy_of_the_benchmark(tmp_path)
    with pytest.raises(FileNotFoundError):
        copy.find_cell("zinc-serve-small")
    new = dict(json.loads((root / "h100_bench/workloads/zinc-serve.json").read_text()),
               name="zinc-serve-small", why="a smaller pool of smaller requests")
    new["params"] = dict(new["params"], **TINY["zinc-serve"]["params"])
    (root / "h100_bench/workloads/zinc-serve-small.json").write_text(json.dumps(new))
    cell = copy.find_cell("zinc-serve-small")
    assert cell.traffic == "serve_closed_loop" and cell.params["pool"] == 4
    torch.manual_seed(0)
    r, _ = copy.run_cell("zinc-serve-small", 3, 0.2, False, "cpu",
                      overrides={"config": TINY["zinc-serve"]["config"]})
    assert r["correct"] and r["attempted"] > 0
    # A cell that BENCHMARK.json does not list yet reports set-up alone.
    assert set(r["metrics"]) == {"setup_s"}


def test_sub_seeds_take_any_whole_seed():
    for seed in (0, 1, -5, 2**31 + 3, 2**70):
        s = core.sub_seeds(seed, 3)
        assert len(s) == 3 and all(0 <= v < 2**31 for v in s)
    assert core.sub_seeds(2**31 + 3, 2) == core.sub_seeds(2**31 + 3, 2)
    assert core.sub_seeds(1, 2) != core.sub_seeds(2, 2)

"""``correct`` on the CPU at tiny sizes: the port's plain path agrees with the
references, and a run with the timed path broken underneath comes out not
correct, once for each fault the cell can have."""

import pytest
import torch

from h100_bench import control, core

from bench_sizes import TINY


@pytest.fixture(autouse=True)
def _threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


@pytest.mark.parametrize("cell", ["node-large-train", "zinc-serve"])
def test_sound_run_is_correct(cell):
    r, _ = core.run_cell(cell, 2**31 + 17, 0.2, False, "cpu", overrides=TINY[cell])
    assert r["correct"], r["checks"]
    for name, c in r["checks"].items():
        assert c["value"] < 1e-5, (name, c)


@pytest.mark.parametrize("cell,fault", [("node-large-train", "half_batch"),
                                        ("node-large-train", "unchanged"),
                                        ("zinc-serve", "altered_answer")])
def test_fault_is_not_correct(cell, fault):
    with control.planted(cell, fault):
        r, _ = core.run_cell(cell, 99, 0.2, False, "cpu", overrides=TINY[cell])
    assert not r["correct"], r["checks"]


def test_unchanged_state_reads_one_on_the_update():
    with control.planted("node-large-train", "unchanged"):
        r, _ = core.run_cell("node-large-train", 5, 0.1, False, "cpu",
                          overrides=TINY["node-large-train"])
    assert r["checks"]["update_gap"]["value"] == pytest.approx(1.0)


def test_the_control_runner_summarises():
    runs, summary = control.readings("node-large-train", [1, 2], [3], 0.1, "cpu",
                                     overrides=TINY["node-large-train"],
                                     variants=("half_batch",), log=lambda s: None)
    assert [r["variant"] for r in runs] == ["sound", "sound", "half_batch"]
    assert summary["sound.loss_gap"] == max(r["checks"]["loss_gap"] for r in runs[:2])
    assert summary["half_batch.loss_gap"] > summary["sound.loss_gap"]

"""The control on the card: a sound run is correct and the configuration's
float32 products in TF32 are not, at a size that a test run holds.

Runs on a CUDA card only (``python -m pytest h100_bench/tests -m gpu`` on
the GPU host); skips elsewhere."""

import pytest
import torch

from h100_bench import control

SMALL = {
    "node-large-train": {"config": {"num_nodes": 32768, "avg_deg": 16}},
    "zinc-serve": {"params": {"min_molecules": 256, "max_molecules": 512, "pool": 8}},
}


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    control.core.set_cache_dirs()


@pytest.mark.gpu
@pytest.mark.parametrize("cell", sorted(SMALL))
def test_control_is_not_correct(card, cell):
    runs, _ = control.readings(cell, [11, 12, 13], [21, 22, 23], 0.5, "cuda",
                               overrides=SMALL[cell], variants=("tf32",), log=lambda s: None)
    sound = [r for r in runs if r["variant"] == "sound"]
    tf32 = [r for r in runs if r["variant"] == "tf32"]
    assert all(r["correct"] for r in sound), sound
    assert not any(r["correct"] for r in tf32), tf32

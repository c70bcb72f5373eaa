"""The port's ZINC training loop and command line, on the CPU: the records
and results of the JAX package's loop, a falling loss, the padding budgets
of the JAX package's formula, and the JAX command line's flags."""

import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from mma_tpu.cli import train_zinc as jax_cli
from mma_tpu.train import ZincConfig as JaxZincConfig
from mma_tpu.train import train_zinc as jax_train_zinc

from mma_tpu_torch.cli import train_zinc as cli
from mma_tpu_torch.data import load_zinc
from mma_tpu_torch.train import ZINC_PRESET, ZincConfig, train_zinc
from mma_tpu_torch.train.loops import zinc_padding

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL = dict(hidden=10, edge_hidden=6, towers=2, num_layers=2, mlp_sizes=(10, 6, 1),
             batch_size=32, subset_size=96)


def test_config_fields_and_preset_equal_jax():
    assert dataclasses.asdict(ZincConfig()) == dataclasses.asdict(JaxZincConfig())
    from mma_tpu.train.config import ZINC_PRESET as JAX_PRESET

    assert dataclasses.asdict(ZINC_PRESET) == dataclasses.asdict(JAX_PRESET)


@pytest.fixture(scope="module")
def splits():
    return {s: load_zinc(s, subset_size=96) for s in ("train", "val", "test")}


@pytest.mark.parametrize("aggs", [("min", "max"), ("mean", "max", "min")])
def test_train_zinc_records_match_jax_and_loss_falls(splits, aggs):
    cfg = ZincConfig(aggregators=aggs, epochs=3, lr=3e-3, **SMALL)
    res = train_zinc(cfg, datasets=splits, device="cpu")
    jres = jax_train_zinc(JaxZincConfig(aggregators=aggs, epochs=1, lr=3e-3, **SMALL))
    assert set(jres) <= set(res)
    assert [set(r) for r in res["history"]] == [set(jres["history"][0])] * 3
    assert [r["epoch"] for r in res["history"]] == [0, 1, 2]
    losses = [r["loss"] for r in res["history"]]
    assert losses[2] < losses[0], losses
    values = [v for r in res["history"] for v in r.values()]
    assert np.isfinite(values).all()
    assert res["val_mae"] == res["history"][-1]["val_mae"]
    assert set(res["params"]) == set(jres["params"])
    assert set(res["state"]) == set(jres["state"])


def test_padding_budgets_follow_the_jax_formula(splits):
    """``mma_tpu/train/loops.py:230-242``: the batch_size largest molecules
    over all splits (+1 padding node), rounded up to 256, capped by the
    per-graph-slot budgets."""
    for cfg in (ZincConfig(**SMALL), ZincConfig(batch_size=8, n_node_per_graph=20)):
        sets = list(splits.values())

        def budget(values):
            return int(np.sort(np.asarray(values))[::-1][: cfg.batch_size].sum())

        n_node = 1 + max(budget(d.num_nodes) for d in sets)
        n_edge = max(budget([len(s) for s in d.edge_src]) for d in sets)
        want = (min(-(-n_node // 256) * 256, cfg.batch_size * cfg.n_node_per_graph),
                min(-(-n_edge // 256) * 256, cfg.batch_size * cfg.n_edge_per_graph))
        assert zinc_padding(cfg, sets) == want


def test_train_zinc_raises_on_what_is_not_ported(splits, tmp_path):
    # Ported: the degree-exact layout, the ELL route on the plain collate
    # (max_degree_hint's single width), remat, checkpoints and
    # compute_dtype="bfloat16" each train an epoch.
    for kw in (dict(batch_layout="degree_exact"), dict(batch_layout="plain", edge_format="ell"),
               dict(remat=True), dict(checkpoint_dir=str(tmp_path), checkpoint_every=1),
               dict(compute_dtype="bfloat16")):
        res = train_zinc(ZincConfig(epochs=1, **SMALL, **kw), datasets=splits, device="cpu")
        assert np.isfinite([v for r in res["history"] for v in r.values()]).all(), kw
    assert (tmp_path / "step_00000001").exists()


def test_cli_parses_the_jax_flags():
    argv = ["--aggregators", "min,max", "--scalers", "identity,amplification,linear",
            "--weight_decay", "3e-4", "--lr", "0.0001", "--epochs", "7", "--seed", "3",
            "--batch_size", "16", "--hidden_dim", "20", "--edge_dim", "8", "--tower", "2",
            "--L", "3", "--no-parity", "--subset", "50", "--use-pallas", "--compute-dtype",
            "float32", "--edge-format", "csr", "--max-degree-hint", "0", "--matmul_precision",
            "high", "--log", "x.jsonl", "--checkpoint-every", "0"]
    ours = vars(cli.build_parser().parse_args(argv))
    theirs = vars(jax_cli.build_parser().parse_args(argv))
    assert ours.pop("device") == "cuda"
    assert ours == theirs
    cfg = cli.config_from_args(cli.build_parser().parse_args(argv))
    assert (cfg.aggregators, cfg.towers, cfg.num_layers, cfg.parity, cfg.max_degree_hint,
            cfg.subset_size) == (("min", "max"), 2, 3, False, None, 50)


def test_train_zinc_cli_runs_on_the_cpu():
    res = subprocess.run(
        [sys.executable, "-m", "mma_tpu_torch.cli.train_zinc", "--device", "cpu", "--epochs",
         "1", "--subset", "64", "--L", "1", "--tower", "1", "--aggregators", "min,max"],
        cwd=ROOT, capture_output=True, text=True, timeout=300,
    )
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip().splitlines()[-1].startswith("Final: Val: ")


def test_zinc_net_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("this host has a GPU")
    from mma_tpu_torch.models import ZincNet

    with pytest.raises(RuntimeError, match="no CUDA device"):
        ZincNet(("min", "max"), ("identity",), {"lin": 1.0, "log": 1.0})
    with pytest.raises(RuntimeError, match="no CUDA device"):
        next(load_zinc("val", subset_size=4).batches(4, n_node=160, n_edge=400))

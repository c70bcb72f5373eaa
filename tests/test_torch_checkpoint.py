"""Checkpoint/resume in the port (``mma_tpu_torch.train.checkpoint`` and the
two training loops), against ``tests/test_training.py``'s checks and
stronger: on the CPU a resumed run repeats the uninterrupted one bit for
bit."""

import os
import pickle

import numpy as np
import pytest
import torch

from mma_tpu_torch.cli import train_node as node_cli
from mma_tpu_torch.cli import train_zinc as zinc_cli
from mma_tpu_torch.data import load_zinc
from mma_tpu_torch.train import (
    NodeClassificationConfig,
    ZincConfig,
    train_node_classification,
    train_zinc,
)
from mma_tpu_torch.train.checkpoint import latest_step, restore_checkpoint, save_checkpoint

SMALL_ZINC = dict(hidden=10, edge_hidden=6, towers=2, num_layers=2, mlp_sizes=(10, 5, 1),
                  batch_size=32, subset_size=96)


def _payload():
    gen = torch.Generator().manual_seed(3)
    torch.rand(5, generator=gen)  # a state past the seed
    model = torch.nn.Linear(4, 3)
    opt = torch.optim.Adam(model.parameters(), lr=1e-3, weight_decay=1e-4)
    model(torch.randn(2, 4)).sum().backward()
    opt.step()
    return {"params": model.state_dict(), "opt_state": opt.state_dict(),
            "key": gen.get_state(), "sched": [1e-4, float("inf"), 2],
            "misc": (torch.arange(3, dtype=torch.int32), None, "text", True)}


def _assert_same(a, b):
    if isinstance(a, torch.Tensor):
        assert isinstance(b, torch.Tensor) and a.dtype == b.dtype and torch.equal(a, b)
    elif isinstance(a, dict):
        assert set(a) == set(b)
        for k in a:
            _assert_same(a[k], b[k])
    elif isinstance(a, (list, tuple)):
        assert type(a) is type(b) and len(a) == len(b)
        for x, y in zip(a, b):
            _assert_same(x, y)
    else:
        assert type(a) is type(b) and a == b


def test_round_trip_of_a_nested_payload(tmp_path):
    payload = _payload()
    path = save_checkpoint(str(tmp_path), 12, payload)
    assert os.path.basename(path) == "step_00000012"
    assert os.listdir(tmp_path) == ["step_00000012"]  # no temporary left behind
    step, got = restore_checkpoint(str(tmp_path))
    assert step == 12
    _assert_same(payload, got)
    # The generator state restores the stream.
    gen = torch.Generator()
    gen.set_state(got["key"])
    want = torch.Generator()
    want.set_state(payload["key"])
    assert torch.equal(torch.rand(4, generator=gen), torch.rand(4, generator=want))
    assert restore_checkpoint(str(tmp_path / "empty")) == (None, None)


def test_latest_step_skips_names_that_do_not_parse(tmp_path):
    assert latest_step(str(tmp_path / "missing")) is None
    assert latest_step(str(tmp_path)) is None
    for name in ("step_junk", "step_", "step_7_old", "other_00000099", ".step_00000050.1.tmp"):
        (tmp_path / name).write_bytes(b"")
    assert latest_step(str(tmp_path)) is None
    save_checkpoint(str(tmp_path), 3, {"a": 1})
    save_checkpoint(str(tmp_path), 10, {"a": 2})
    assert latest_step(str(tmp_path)) == 10
    assert restore_checkpoint(str(tmp_path), 3) == (3, {"a": 1})
    save_checkpoint(str(tmp_path), 10, {"a": 3})  # a step is replaced whole
    assert restore_checkpoint(str(tmp_path)) == (10, {"a": 3})


def test_target_checks_structure_and_places_tensors(tmp_path):
    payload = {"w": torch.randn(3, 2), "seq": [torch.ones(2), 4], "step": 5}
    save_checkpoint(str(tmp_path), 1, payload)
    # Tensors land on the target's devices and dtypes ("meta" stands in for
    # a second device on a host without a card).
    target = {"w": torch.zeros(3, 2, dtype=torch.float64, device="meta"),
              "seq": [torch.zeros(2), 0], "step": 0}
    _, got = restore_checkpoint(str(tmp_path), target=target)
    assert got["w"].device.type == "meta" and got["w"].dtype == torch.float64
    assert got["seq"][0].device.type == "cpu" and torch.equal(got["seq"][0], torch.ones(2))
    assert got["seq"][1] == 4 and got["step"] == 5
    for bad, match in (({"w": torch.zeros(3, 2), "seq": [torch.zeros(2), 0]}, "keys"),
                       ({**target, "w": torch.zeros(2, 3)}, "shape"),
                       ({**target, "seq": (torch.zeros(2), 0)}, "tuple"),
                       ({**target, "seq": [torch.zeros(2)]}, "list of 1"),
                       ({**target, "step": 0.0}, "float")):
        with pytest.raises(ValueError, match=match):
            restore_checkpoint(str(tmp_path), target=bad)


class _Executes:
    ran = False

    def __reduce__(self):
        return (_Executes._run, ())

    @staticmethod
    def _run():
        _Executes.ran = True
        return "ran"


def test_restore_loads_weights_only(tmp_path):
    """A checkpoint that names code is refused, and the code does not run."""
    save_checkpoint(str(tmp_path), 1, {"obj": _Executes()})
    with pytest.raises(pickle.UnpicklingError, match="[Ww]eights only"):
        restore_checkpoint(str(tmp_path))
    assert not _Executes.ran


NODE = dict(dataset="cora", aggregators=("mean",), hidden=8, lr=0.01, weight_decay=5e-4,
            dropout=0.5)


def test_node_cls_resume_from_checkpoint(tmp_path):
    """``tests/test_training.py:108-126``: a restart with nothing left to
    train has an empty history, and a longer run resumes at the saved epoch."""
    base = dict(NODE, weight_decay=0.0, dropout=0.0, epochs=4, checkpoint_dir=str(tmp_path),
                checkpoint_every=2)
    train_node_classification(NodeClassificationConfig(**base), device="cpu")
    assert latest_step(str(tmp_path)) == 4
    r2 = train_node_classification(NodeClassificationConfig(**base, resume=True), device="cpu")
    assert len(r2["history"]) == 0
    r3 = train_node_classification(NodeClassificationConfig(**{**base, "epochs": 6}, resume=True),
                                   device="cpu")
    assert [h["epoch"] for h in r3["history"]] == [5, 6]
    assert np.isfinite(r3["acc_test"])


def _records(history):
    return [{k: v for k, v in r.items() if k != "time"} for r in history]


def _assert_same_weights(a, b):
    sa, sb = a.state_dict(), b.state_dict()
    assert list(sa) == list(sb)
    for k in sa:
        assert torch.equal(sa[k], sb[k]), k


def test_node_cls_resumed_run_equals_the_straight_run(tmp_path):
    """Dropout on, so the restored generator state matters: 3 epochs, then
    a fresh call resumes to 6, against 6 straight."""
    ckpt = dict(checkpoint_dir=str(tmp_path), checkpoint_every=3)
    train_node_classification(NodeClassificationConfig(**NODE, epochs=3, **ckpt), device="cpu")
    resumed = train_node_classification(
        NodeClassificationConfig(**NODE, epochs=6, resume=True, **ckpt), device="cpu")
    straight = train_node_classification(NodeClassificationConfig(**NODE, epochs=6), device="cpu")
    assert _records(resumed["history"]) == _records(straight["history"][3:])
    assert (resumed["acc_test"], resumed["loss_test"]) == (straight["acc_test"],
                                                          straight["loss_test"])
    _assert_same_weights(resumed["model"], straight["model"])


@pytest.fixture(scope="module")
def zinc_splits():
    return {s: load_zinc(s, subset_size=96) for s in ("train", "val", "test")}


def test_zinc_resumed_run_equals_the_straight_run(tmp_path, zinc_splits):
    """2 epochs, then a resume to 3, against 3 straight: weights, BatchNorm
    state, records and the schedule's triple, bit for bit (``lr_patience=0``
    lets the schedule move)."""
    cfg = dict(SMALL_ZINC, lr_patience=0, lr_factor=0.5)
    ckpt = dict(checkpoint_dir=str(tmp_path), checkpoint_every=1)
    train_zinc(ZincConfig(epochs=2, **cfg, **ckpt), datasets=zinc_splits, device="cpu")
    step, payload = restore_checkpoint(str(tmp_path))
    assert step == 2 and set(payload) == {"params", "state", "opt_state", "key", "sched"}
    assert payload["state"] and all(k.startswith("bn") for k in payload["state"])
    resumed = train_zinc(ZincConfig(epochs=3, resume=True, **cfg, **ckpt),
                         datasets=zinc_splits, device="cpu")
    straight = train_zinc(ZincConfig(epochs=3, **cfg, **ckpt), datasets=zinc_splits,
                          device="cpu")
    assert [r["epoch"] for r in resumed["history"]] == [2]
    assert _records(resumed["history"]) == _records(straight["history"][2:])
    _assert_same_weights(resumed["model"], straight["model"])
    # The straight run rewrote steps 1-3; both runs saved the same step 3.
    _, last = restore_checkpoint(str(tmp_path), 3)
    assert last["sched"][0] == straight["history"][-1]["lr"]


def test_both_clis_write_checkpoints(tmp_path):
    node_dir, zinc_dir = tmp_path / "node", tmp_path / "zinc"
    node_cli.main(["--dataset", "cora", "--aggregators", "mean", "--hidden", "8", "--epochs",
                   "2", "--device", "cpu", "--checkpoint-dir", str(node_dir),
                   "--checkpoint-every", "1"])
    assert latest_step(str(node_dir)) == 2
    assert set(restore_checkpoint(str(node_dir))[1]) == {"params", "opt_state", "key"}
    zinc_cli.main(["--epochs", "1", "--subset", "64", "--L", "1", "--tower", "1",
                   "--aggregators", "min,max", "--device", "cpu", "--checkpoint-dir",
                   str(zinc_dir), "--checkpoint-every", "1"])
    assert latest_step(str(zinc_dir)) == 1

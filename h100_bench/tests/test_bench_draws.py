"""The recorded draws: the reference reads the program's keeps from them, in
whatever order, shape padding and edge-row order the program draws them;
and each configuration's program plants the faults that it lists."""

import numpy as np
import pytest
import torch

from h100_bench import control, core
from h100_bench.draws import Recorder

REF = core.load_module("reference", "mma-node-large")


def test_the_recorder_keeps_every_random_draw_in_order():
    gen = torch.Generator().manual_seed(3)
    with Recorder() as rec:
        a = torch.rand((4, 3), generator=gen)
        b = torch.empty(5).uniform_(generator=gen)
        c = torch.bernoulli(torch.full((2,), 0.5), generator=gen)
        d = (a * 2).sum() + b.sum() + c.sum()
    assert [op for op, _ in rec.draws] == ["rand", "uniform_", "bernoulli"]
    for (_, got), want in zip(rec.draws, (a, b, c)):
        assert torch.equal(got, want)
    assert d is not None


def test_keeps_are_read_by_row_labels_whatever_the_program_order():
    rng = np.random.default_rng(0)
    n, hdim, k, rate = 6, 2, 2, 0.5
    src = rng.integers(0, n, 20)
    dst = rng.integers(0, n, 20)
    order = np.lexsort((src, dst))
    src, dst = src[order], dst[order]
    # The program's rows: the same edges shuffled, with padding rows between.
    perm = rng.permutation(20)
    rows = np.full(32, -1)
    rows[np.sort(rng.choice(32, 20, replace=False))] = perm
    real = rows >= 0
    p_src = np.where(real, src[np.maximum(rows, 0)], 0)
    p_dst = np.where(real, dst[np.maximum(rows, 0)], 0)
    got_rows = REF.edge_rows(src, dst, n, {"src": p_src, "dst": p_dst, "real": real})
    assert torch.equal(torch.as_tensor(p_src[got_rows.numpy()]), torch.as_tensor(src))
    assert torch.equal(torch.as_tensor(p_dst[got_rows.numpy()]), torch.as_tensor(dst))
    mask_draw = torch.rand((32, k * hdim))
    feat_draw = torch.rand((n + 2, hdim))
    for draws in ([("rand", feat_draw), ("rand", mask_draw)],
                  [("rand", mask_draw), ("rand", feat_draw)]):
        fkeep, mkeep = REF._keeps(draws, n, hdim, k, rate, got_rows, "cpu")
        assert torch.equal(fkeep, feat_draw[:n] >= rate)
        assert torch.equal(mkeep, mask_draw[got_rows] >= rate)


def test_other_edges_are_refused():
    src, dst = np.array([0, 1]), np.array([1, 1])
    with pytest.raises(ValueError):
        REF.edge_rows(src, dst, 2, {"src": np.array([0, 0]), "dst": np.array([1, 1]),
                                    "real": np.array([True, True])})


@pytest.mark.parametrize("cell", ["node-large-train", "zinc-serve"])
def test_each_program_lists_and_plants_its_faults(cell):
    program = core.find_cell(cell).program()
    assert program.FAULTS
    for fault in program.FAULTS:
        with control.planted(cell, fault):
            pass
    with pytest.raises(ValueError):
        with program.plant("no such fault"):
            pass

"""The port's entry points (``mma_tpu_torch/graft_entry.py``) against the
JAX package's ``__graft_entry__.py``, on the CPU.

``entry("cpu")``'s forward is held against the JAX ``entry()`` forward with
the JAX weights carried across (``mma_tpu_torch.convert``), at ZincNet's
tolerance in ``tests/test_torch_zinc_net.py`` (rtol = atol = 1e-5).
``dryrun_multichip`` runs one training step of every regime on a gloo
world of 2 CPU processes that it starts itself, (d) as a 2 × 1 mesh, and on
a world of one this process joins; every loss must be finite, and each
regime reports its loss on every rank.
"""

import numpy as np
import pytest
import torch

from torch_world import numpy_tree, world_of_one

pytestmark = pytest.mark.multichip

REGIMES = ("(a) data-parallel ZINC", "(b) edge-sharded", "(c) node-sharded",
           "(d) 2-D data × edge", "(e) edge-sharded, kernel structure",
           "(f) sampled data-parallel", "(g) LDG-ordered node-sharded")


def test_entry_forward_matches_jax():
    """The flagship ZincNet's eval forward on the 8-molecule val batch
    (320 nodes, 800 edges): the JAX ``entry()``'s predictions, with its
    weights carried into the port's parameters and buffers."""
    import jax
    from __graft_entry__ import entry as jax_entry
    from mma_tpu_torch.convert import zinc_net_from_jax
    from mma_tpu_torch.graft_entry import _zinc_model_and_batch, entry

    jfn, (jparams, jstate, jbatch) = jax_entry()
    want = np.asarray(jax.jit(jfn)(jparams, jstate, jbatch))
    fn, (params, buffers, batch) = entry("cpu")
    assert batch.graph.n_node == 320 and batch.graph.n_edge == 800 and batch.n_graph == 8
    np.testing.assert_array_equal(batch.node_feat.numpy(), np.asarray(jbatch.node_feat))
    carried, _ = _zinc_model_and_batch(torch.device("cpu"))
    zinc_net_from_jax(numpy_tree(jparams), numpy_tree(jstate), carried)
    assert set(dict(carried.named_parameters())) == set(params)
    with torch.no_grad():
        got = fn(dict(carried.named_parameters()), dict(carried.named_buffers()), batch).numpy()
        own = fn(params, buffers, batch).numpy()
    assert got.shape == want.shape == (8,)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    assert np.isfinite(own).all() and not np.allclose(own, got)


def test_entry_runs_on_the_card_unless_told():
    """``entry()`` without a device asks for the card and raises on a host
    without one, instead of continuing on the CPU."""
    from mma_tpu_torch.graft_entry import entry

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        entry()


def test_dryrun_multichip_two_ranks(capsys):
    """``dryrun_multichip(2, "cpu")`` outside a process group starts a gloo
    world of 2 and runs all seven regimes, (d) on a 2 × 1 data × edge mesh:
    each rank reports each regime's finite loss."""
    from mma_tpu_torch.graft_entry import dryrun_multichip

    dryrun_multichip(2, "cpu")
    out = capsys.readouterr().out
    for rank in range(2):
        for regime in REGIMES:
            lines = [line for line in out.splitlines()
                     if line.startswith(f"[rank {rank}] dryrun_multichip {regime}: ")]
            assert len(lines) == 1, (rank, regime)
            assert np.isfinite(float(lines[0].rsplit("loss ", 1)[1]))


def test_dryrun_multichip_in_a_world_of_one(capsys):
    """Inside an initialized world of one, ``dryrun_multichip(1, "cpu")``
    runs on it (no new processes): the six regimes of an odd world, (d)
    needing an even one. A size that is not the world's is refused."""
    from mma_tpu_torch.graft_entry import dryrun_multichip

    with world_of_one():
        with pytest.raises(ValueError, match="n_devices=2"):
            dryrun_multichip(2, "cpu")
        dryrun_multichip(1, "cpu")
    out = capsys.readouterr().out
    for regime in REGIMES:
        ran = f"dryrun_multichip {regime}: rank 0 of 1, loss " in out
        assert ran == (regime != "(d) 2-D data × edge"), regime

"""The plain versions of kernels 6 and 12 against the JAX package, on the
CPU, at the shapes that the card's partitions of those kernels stress.

On the card, kernel 6 (the fused min/max edge program) stages tiles of
consecutive rows by an item budget and walks a row longer than its stage
in pieces; kernel 12 (the masked segment sum) runs on kernel 1's edge
chunks, splitting a long row into partials and writing empty rows from the
fixup. Both are held there against their plain versions
(``minmax_edge_program_reference``, ``masked_segment_sum_reference``), so
those plain versions are held here against the JAX package's kernels, run
as ``tests/test_torch_segment_minmax.py`` and
``tests/test_torch_masked_kernel.py`` run them (Pallas in interpret mode),
on a graph with a 3,000-edge row, runs of empty rows and padding edges.

Tolerances: min/max do not round and the first-hit routing is an exact
f32 ``==``, so kernel 6's output and kernel 7's ``dhg`` must be equal;
kernel 7's ``dc`` sums at most P non-zero terms a row here and a 3-term
bf16 split contraction in the Pallas kernel: within 1e-6 of its largest
magnitude. Kernel 12 sums up to 3,000 float32 terms a row, in another
order on each side: each side within 1e-5 of the largest value of the
float64 sum of the same messages, since a float32 sum of that many terms
may drift past 1e-5 of the other float32 sum.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from mma_tpu.graph.build import graph_from_edges as jax_graph_from_edges
from mma_tpu.ops.pallas.fused_mma import fused_masked_aggregate as jax_fused_masked_aggregate
from mma_tpu.ops.pallas.segment_minmax import (
    fused_minmax_edge_program as jax_fused_minmax_edge_program,
)

from mma_tpu_torch.graph import graph_from_edges
from mma_tpu_torch.ops.cuda import fused_mma
from mma_tpu_torch.ops.cuda import segment_minmax as mm


@pytest.fixture(scope="module")
def hub_graphs():
    """80 nodes: node 3 takes 3,000 in-edges, nodes 0-2, 40-49 and 70-79
    none (runs of empty rows at the start, inside and at the end), the
    others a few each; the JAX graph pads the edge list."""
    rs = np.random.RandomState(20)
    n = 80
    others = np.concatenate([np.arange(4, 40), np.arange(50, 70)])
    dst = np.concatenate([np.full(3000, 3), rs.choice(others, 300)]).astype(np.int32)
    src = rs.randint(0, n, dst.shape[0]).astype(np.int32)
    jg = jax_graph_from_edges(src, dst, n)
    tg = graph_from_edges(src, dst, n, device="cpu")
    has_edges = np.asarray(jg.deg) > 0
    assert int(np.asarray(jg.deg)[3]) == 3000 and not has_edges[:3].any()
    assert not np.asarray(jg.edge_mask).all()  # padding edges at the tail
    return jg, tg, has_edges


@pytest.mark.parametrize("ops,seed", [
    (("min", "max"), None),
    (("min", "max"), 2024),
    (("max",), 7),
    (("min",), None),
])
def test_minmax_edge_program_reference_matches_jax(hub_graphs, ops, seed):
    """Kernel 6's and kernel 7's plain versions at C = 375 against
    ``fused_minmax_edge_program`` and its VJP with the same hash seed, on a
    3,000-edge row: the output (rows with edges), ``dhg`` equal; ``dc``
    within 1e-6; rows without edges 0. Small integer values, so that many
    of the hub's edges tie and the first hit decides."""
    jg, tg, sel = hub_graphs
    ch = 375
    rs = np.random.RandomState(len(ops) + (seed or 0))
    c = rs.randint(-3, 4, (jg.n_node, ch)).astype(np.float32)
    hg = rs.randint(-3, 4, (jg.n_edge, ch)).astype(np.float32)
    ct = rs.randn(jg.n_node, len(ops) * ch).astype(np.float32) * sel[:, None]
    jseed = None if seed is None else jnp.asarray([seed], jnp.int32)
    tseed = None if seed is None else torch.tensor([seed], dtype=torch.int32)

    def jfwd(c_, h_):
        return jax_fused_minmax_edge_program(c_, h_, jg, ops, seed=jseed, rate=0.5)

    want = np.asarray(jfwd(jnp.asarray(c), jnp.asarray(hg)))
    jdc, jdhg = (np.asarray(g) for g in jax.grad(
        lambda c_, h_: jnp.sum(jfwd(c_, h_) * ct * sel[:, None]), argnums=(0, 1))(
            jnp.asarray(c), jnp.asarray(hg)))
    rp = tg.real_row_ptr
    tc, thg, tct = torch.from_numpy(c), torch.from_numpy(hg), torch.from_numpy(ct)
    out = mm.minmax_edge_program_reference(tc, thg, rp, ops, tseed, 0.5)
    np.testing.assert_array_equal(out.numpy()[sel], want[sel])
    assert (out.numpy()[~sel] == 0).all()
    dhg, dc = mm.minmax_edge_program_bwd_reference(tc, thg, rp, ops, tseed, 0.5, out, tct)
    np.testing.assert_array_equal(dhg.numpy(), jdhg)
    np.testing.assert_allclose(dc.numpy(), jdc, rtol=0, atol=1e-6 * np.abs(jdc).max())


def _f64_sum(logits, h_src, pat, row_ptr, n_rows):
    """The float64 sum by destination of the float32 messages."""
    kf, f = logits.shape[1], h_src.shape[1]
    x = logits.astype(np.float64)
    sig = (1.0 / (1.0 + np.exp(-logits))).astype(np.float32).astype(np.float64)
    msg = np.where(pat, sig, x) * np.tile(h_src, (1, kf // f)).astype(np.float64)
    lo, hi = int(row_ptr[0]), int(row_ptr[-1])
    ids = np.repeat(np.arange(n_rows), np.diff(row_ptr))
    out = np.zeros((n_rows, kf))
    np.add.at(out, ids, msg[lo:hi])
    return out


@pytest.mark.parametrize("k,f", [(2, 5), (3, 6), (4, 7)])
def test_masked_segment_sum_reference_matches_jax(hub_graphs, k, f):
    """Kernel 12's plain version against the JAX ``fused_masked_aggregate``
    (Pallas in interpret mode, ``precision="highest"``) with F % 4 != 0 (the
    card's scalar path) on the 3,000-edge row: both within 1e-5 of the
    float64 sum of the messages on the real rows; rows without edges 0."""
    jg, tg, sel = hub_graphs
    rs = np.random.RandomState(10 * k + f)
    logits = rs.randn(jg.n_edge, k * f).astype(np.float32)
    h_src = rs.randn(jg.n_edge, f).astype(np.float32)
    pat = np.arange(k * f) // f % 2 == 0  # σ on even blocks, the identity on odd ones
    want = np.asarray(jax_fused_masked_aggregate(jnp.asarray(logits), jnp.asarray(h_src),
                                                 jnp.asarray(pat), jg, k, precision="highest"))
    rp = tg.real_row_ptr
    got = fused_mma.masked_segment_sum_reference(
        torch.from_numpy(logits), torch.from_numpy(h_src),
        torch.from_numpy(pat.astype(np.float32)), rp).numpy()
    n = tg.n_node
    exact = _f64_sum(logits, h_src, pat, rp.numpy(), n)
    tol = 1e-5 * np.abs(exact).max()
    np.testing.assert_allclose(got, exact, rtol=0, atol=tol)
    np.testing.assert_allclose(want[:n][sel], exact[sel], rtol=0, atol=tol)
    assert not got[~sel].any()

"""Kernels 4-7 (segmented min/max and the fused min/max edge program) on
the CPU, where the port's wrappers take the plain PyTorch versions, against
the JAX package's Pallas kernels run in interpret mode (as
``tests/test_segment_minmax.py`` runs them), and the dropout hash bit for
bit.

Tolerances: min/max do not round and the first-hit routing is an exact
f32 ``==``, so forward outputs and the routed edge gradients (``grad``,
``dhg``) must be equal. ``dc`` sums at most P non-zero terms per row in
the port and a 3-term bf16 split contraction in the Pallas kernel: within
1e-6 of its largest magnitude. Rows without real in-edges are 0 in the
port and the op's neutral (or the padding edges' value) in the Pallas
kernel, whose callers select them away; they are compared only in the
port (0)."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from mma_tpu.graph.build import graph_from_edges as jax_graph_from_edges
from mma_tpu.ops.pallas.segment_minmax import (
    _dropout_keep as jax_dropout_keep,
    fused_minmax_edge_program as jax_fused_minmax_edge_program,
    fused_segment_minmax as jax_fused_segment_minmax,
)

from mma_tpu_torch.graph import graph_from_edges
from mma_tpu_torch.ops.cuda import segment_minmax as mm
from mma_tpu_torch.ops.segment import segment_max, segment_min


@pytest.fixture(scope="module")
def graphs():
    """60 nodes, the last 8 without in-edges, duplicate edges (ties of the
    edge program's ``c[dst]``) and one hub."""
    rs = np.random.RandomState(0)
    n = 60
    src = rs.randint(0, n, 260).astype(np.int32)
    dst = np.concatenate([rs.randint(0, n - 8, 230), np.zeros(30, np.int64)]).astype(np.int32)
    src = np.concatenate([src, src[:20]])
    dst = np.concatenate([dst, dst[:20]])
    jg = jax_graph_from_edges(src, dst, n)
    tg = graph_from_edges(src, dst, n, device="cpu")
    has_edges = np.asarray(jg.deg) > 0
    return jg, tg, has_edges


def _draw(rs, shape, ties):
    a = rs.randint(-2, 3, shape) if ties else rs.randn(*shape)
    return a.astype(np.float32)


def test_dropout_hash_is_bit_for_bit_jax():
    """A grid of seeds, positions and lanes, values near 2³¹ included, at
    three rates: the float32 masks are equal bit for bit."""
    pos = np.concatenate([np.arange(0, 4096, 3),
                          [2**31 - 1, 2**31 - 2, 2**30, 2**31 - 4096, 123456789]]).astype(np.int32)
    lane = np.array([0, 1, 2, 31, 74, 374, 375, 1023, 2**31 - 1], np.int32)
    for seed in (0, 1, 1234, 987654321, 2**31 - 2, 2**31 - 1):
        for rate in (0.5, 0.1, 0.75):
            want = np.asarray(jax_dropout_keep(jnp.int32(seed), jnp.asarray(pos)[:, None],
                                               jnp.asarray(lane)[None, :], rate))
            got = mm.dropout_keep(torch.tensor([seed], dtype=torch.int32),
                                  torch.from_numpy(pos)[:, None],
                                  torch.from_numpy(lane)[None, :], rate).numpy()
            assert got.dtype == np.float32
            np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))
            kept = (got > 0).mean()
            assert abs(kept - (1 - rate)) < 0.02, (seed, rate, kept)


def test_mul32_keeps_the_low_32_bits():
    """The hash's products in 16-bit halves against Python's exact integers,
    at the extremes (a plain int64 product of these would overflow)."""
    xs = torch.tensor([0, 1, 2**16 - 1, 2**31, 2**32 - 1, 0xDEADBEEF, 0x846CA68B])
    for m in (0x9E3779B9, 0x85EBCA6B, 0x7FEB352D, 0x846CA68B):
        got = mm._mul32(xs, m).tolist()
        assert got == [(int(x) * m) % 2**32 for x in xs.tolist()]


def test_plain_segment_min_max_match_scatter_semantics():
    data = torch.tensor([[1.0, -2.0], [3.0, 5.0], [-1.0, 0.0]])
    ids = torch.tensor([0, 0, 2])
    torch.testing.assert_close(segment_max(data, ids, 4),
                               torch.tensor([[3.0, 5.0], [0, 0], [-1.0, 0.0], [0, 0]]))
    torch.testing.assert_close(segment_min(data, ids, 4),
                               torch.tensor([[1.0, -2.0], [0, 0], [-1.0, 0.0], [0, 0]]))


@pytest.mark.parametrize("ch,ops,ties", [
    (24, ("min", "max"), False),
    (24, ("max",), True),
    (375, ("max", "min"), True),
    (375, ("min",), False),
])
def test_segment_minmax_matches_jax(graphs, ch, ops, ties):
    """Kernel 4 forward and kernel 5 gradient (through the port's autograd
    Function) against ``fused_segment_minmax``; with integer data many edges
    tie, and the whole cotangent goes to the first."""
    jg, tg, sel = graphs
    rs = np.random.RandomState(ch)
    data = _draw(rs, (jg.n_edge, ch), ties)
    ct = rs.randn(jg.n_node, len(ops) * ch).astype(np.float32) * sel[:, None]

    def jloss(d):
        return jnp.sum(jax_fused_segment_minmax(d, jg, ops) * ct * sel[:, None])

    want = np.asarray(jax_fused_segment_minmax(jnp.asarray(data), jg, ops))
    want_grad = np.asarray(jax.grad(jloss)(jnp.asarray(data)))
    td = torch.tensor(data, requires_grad=True)
    out = mm.fused_segment_minmax(td, tg, ops)
    (out * torch.from_numpy(ct)).sum().backward()
    np.testing.assert_array_equal(out.detach().numpy()[sel], want[sel])
    assert (out.detach().numpy()[~sel] == 0).all()
    np.testing.assert_array_equal(td.grad.numpy(), want_grad)
    if ties:  # every tied row routes to one edge per (channel, op)
        routed = (td.grad.numpy()[: int(tg.real_row_ptr[-1])] != 0).sum()
        assert routed <= len(ops) * ch * sel.sum()


@pytest.mark.parametrize("ch,ops,seed,ties", [
    (24, ("min", "max"), None, False),
    (24, ("min", "max"), 1234, True),
    (24, ("max",), 2**31 - 2, False),
    (375, ("min", "max"), 77, False),
    (375, ("max",), None, True),
])
def test_minmax_edge_program_matches_jax(graphs, ch, ops, seed, ties):
    """Kernel 6 forward and kernel 7 gradients (``dc`` and ``dhg``, through
    the autograd Function) against ``fused_minmax_edge_program`` with the
    same hash seed; with dropout on, dropped lanes tie at 0."""
    jg, tg, sel = graphs
    rs = np.random.RandomState(ch + 1)
    c = _draw(rs, (jg.n_node, ch), ties)
    hg = _draw(rs, (jg.n_edge, ch), ties)
    ct = rs.randn(jg.n_node, len(ops) * ch).astype(np.float32) * sel[:, None]
    jseed = None if seed is None else jnp.asarray([seed], jnp.int32)
    tseed = None if seed is None else torch.tensor([seed], dtype=torch.int32)

    def jfwd(c_, h_):
        return jax_fused_minmax_edge_program(c_, h_, jg, ops, seed=jseed, rate=0.5)

    want = np.asarray(jfwd(jnp.asarray(c), jnp.asarray(hg)))
    jdc, jdhg = (np.asarray(g) for g in jax.grad(
        lambda c_, h_: jnp.sum(jfwd(c_, h_) * ct * sel[:, None]), argnums=(0, 1))(
            jnp.asarray(c), jnp.asarray(hg)))
    tc = torch.tensor(c, requires_grad=True)
    thg = torch.tensor(hg, requires_grad=True)
    out = mm.fused_minmax_edge_program(tc, thg, tg, ops, seed=tseed, rate=0.5)
    (out * torch.from_numpy(ct)).sum().backward()
    np.testing.assert_array_equal(out.detach().numpy()[sel], want[sel])
    assert (out.detach().numpy()[~sel] == 0).all()
    np.testing.assert_array_equal(thg.grad.numpy(), jdhg)
    np.testing.assert_allclose(tc.grad.numpy(), jdc, rtol=0, atol=1e-6 * np.abs(jdc).max())


def test_minmax_wrappers_reject_what_they_do_not_take(graphs):
    _, tg, _ = graphs
    data = torch.zeros(tg.n_edge, 4)
    with pytest.raises(ValueError, match="ops"):
        mm.fused_segment_minmax(data, tg, ("min", "sum"))
    with pytest.raises(ValueError, match="ops"):
        mm.fused_segment_minmax(data, tg, ("min", "max", "min"))
    with pytest.raises(ValueError, match="rate"):
        mm.dropout_keep(torch.tensor([1], dtype=torch.int32), torch.arange(3), torch.arange(3),
                        1.0)
    with pytest.raises(ValueError, match="CUDA"):
        mm._segment_minmax_kernel(data, tg.real_row_ptr, ("max",))
    before = dict(mm.LAUNCHES)
    mm.fused_segment_minmax(data, tg, ("max",))
    assert mm.LAUNCHES == before  # the CPU takes the plain version

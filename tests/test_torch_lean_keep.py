"""Mask dropout inside the lean edge program, on the CPU.

With mask dropout on, a float32 ``masked_multi_aggregate`` call that would
take the lean program (a CSC, no ``std``/``moment_3``, no ELL layout, no
explicit wide backward) draws the keep as the half-fused route draws it and
hands it to kernels 2-3 as an operand (``edge_program_lean(..., keep=)``).
Here their plain versions stand for the kernels: the route's output and its
gradients in ``h`` and the mask weights against the half-fused route built
by hand from ``_edge_messages`` and ``segment_sum_csr`` on the same seeded
generator, element by element; the draw itself; and the route each call
counts on the port's tracing.
"""

import dataclasses

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from mma_tpu_torch import graph_from_edges
from mma_tpu_torch.data.synthetic import powerlaw_edges
from mma_tpu_torch.ops import get_agg_spec
from mma_tpu_torch.ops import masked_aggregate
from mma_tpu_torch.ops.cuda import fused_mma
from mma_tpu_torch.ops.masked_aggregate import (
    _edge_messages,
    _flat_lanes,
    masked_multi_aggregate,
    sigmoid_lane_pattern,
)
from mma_tpu_torch.utils import profiling as P
from mma_tpu_torch.utils.profiling import trace

F = 8
# (aggregators, lanes): K = 1 and 2; under parity "sum" takes σ and
# "softmax" the raw logits (N1).
PATTERNS = {"K1-sigmoid": ("sum",), "K1-identity": ("softmax",),
            "K2-mixed": ("sum", "softmax"), "K2-sigmoid": ("sum", "sum2")}


@pytest.fixture(scope="module")
def hub_graph():
    """A power-law graph of 300 nodes, with a hub destination (node 0, 400
    more in-edges), a hub source (node 1, 400 more out-edges), node 299
    without in-edges (an empty row), padding edges and a padding node."""
    src, dst = powerlaw_edges(300, 6, seed=3)
    rs = np.random.RandomState(4)
    src = np.concatenate([src, rs.randint(2, 299, 400), np.ones(400, np.int64)])
    dst = np.concatenate([dst, np.zeros(400, np.int64), rs.randint(2, 299, 400)])
    keep = dst != 299
    g = graph_from_edges(src[keep].astype(np.int32), dst[keep].astype(np.int32), 300,
                         device="cpu")
    rp = g.real_row_ptr
    assert g.n_edge > int(rp[-1]) and int(rp[299]) == int(rp[300])
    assert int((rp[1:] - rp[:-1]).max()) >= 400
    return g


def _inputs(g, k, seed=0):
    rs = np.random.RandomState(seed)
    h = torch.from_numpy(rs.randn(g.n_node, F).astype(np.float32))
    mw = torch.from_numpy((rs.randn(k, 2 * F, F) / np.sqrt(F)).astype(np.float32))
    ct = torch.from_numpy(rs.randn(g.n_node, k, F).astype(np.float32))
    return h, mw, ct


def _half_fused_by_hand(h, g, mw, specs, rate, gen):
    """The half-fused route's output for "sum" and "softmax" combines."""
    pat = sigmoid_lane_pattern(specs, "new_sigmoid", True, F, "cpu")
    msgs = _edge_messages(h, g, mw, pat, rate, gen)
    s = fused_mma.segment_sum_csr(msgs, g.real_row_ptr).reshape(-1, len(specs), F)
    return torch.stack([h + s[:, i] if sp.combine == "sum" else s[:, i]
                        for i, sp in enumerate(specs)], dim=1)


def _with_grads(fn, h, mw, ct):
    h, mw = h.clone().requires_grad_(), mw.clone().requires_grad_()
    out = fn(h, mw)
    out.backward(ct)
    return out.detach(), h.grad, mw.grad, out.grad_fn


def _close(got, want, what):
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5 * want.abs().max().item(),
                               msg=what)


def _grad_fns(fn):
    names, stack, seen = set(), [fn], set()
    while stack:
        fn = stack.pop()
        if fn is None or fn in seen:
            continue
        seen.add(fn)
        names.add(type(fn).__name__)
        stack.extend(nxt for nxt, _ in fn.next_functions)
    return names


@pytest.mark.parametrize("rate", [0.5, 0.75])
@pytest.mark.parametrize("pattern", sorted(PATTERNS))
def test_lean_keep_matches_the_half_fused_route_by_hand(hub_graph, pattern, rate):
    """Output and gradients in ``h`` and the mask weights, element by
    element within 1e-5 of each tensor's largest magnitude; the backward
    runs through the keep-aware Function, not torch's gathers."""
    specs = [get_agg_spec(a) for a in PATTERNS[pattern]]
    h, mw, ct = _inputs(hub_graph, len(specs))
    got = _with_grads(lambda h_, mw_: masked_multi_aggregate(
        h_, hub_graph, mw_, specs, mask_dropout_rate=rate,
        generator=torch.Generator().manual_seed(11)), h, mw, ct)
    want = _with_grads(lambda h_, mw_: _half_fused_by_hand(
        h_, hub_graph, mw_, specs, rate, torch.Generator().manual_seed(11)), h, mw, ct)
    for name, g_, w_ in zip(("output", "dh", "dmask_weights"), got[:3], want[:3]):
        _close(g_, w_, f"{pattern} rate {rate} {name}")
    names = _grad_fns(got[3])
    assert "_EdgeProgramLeanKeepBackward" in names, names
    assert not any(n.startswith(("IndexSelect", "IndexAdd", "Where")) for n in names), names


class _Draws(TorchDispatchMode):
    """The name and shape of every random operation in the block."""

    def __init__(self):
        super().__init__()
        self.made = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if torch.Tag.nondeterministic_seeded in func.tags:
            self.made.append((func.overloadpacket.__name__, tuple(out.shape)))
        return out


@pytest.mark.parametrize("k", [1, 2])
def test_lean_keep_draws_as_the_half_fused_route(hub_graph, k):
    """One draw of shape ``(E_pad, K·F)`` a call, from the caller's
    generator, which is left in the state the half-fused route leaves it."""
    specs = [get_agg_spec(a) for a in ("sum", "sum2")[:k]]
    h, mw, _ = _inputs(hub_graph, k)
    gen = torch.Generator().manual_seed(5)
    with _Draws() as rec:
        masked_multi_aggregate(h, hub_graph, mw, specs, mask_dropout_rate=0.75, generator=gen)
    assert rec.made == [("rand", (hub_graph.n_edge, k * F))]
    by_hand = torch.Generator().manual_seed(5)
    _half_fused_by_hand(h, hub_graph, mw, specs, 0.75, by_hand)
    assert torch.equal(gen.get_state(), by_hand.get_state())


def test_lean_keep_program_takes_the_keep_as_an_operand(hub_graph):
    """``edge_program_lean`` with a keep: all kept at rate 0 is the program
    without one, bit for bit, forward and backward; a keep without
    ``src_perm``, or with a rate outside [0, 1), is refused."""
    g = hub_graph
    kf = 2 * F
    h, mw, ct = _inputs(g, 2)
    pat = sigmoid_lane_pattern([get_agg_spec("sum"), get_agg_spec("softmax")], "new_sigmoid",
                               True, F, "cpu")
    c, w_bot = h @ _flat_lanes(mw[:, :F]), _flat_lanes(mw[:, F:]).contiguous()
    args = (c, w_bot, h, pat, g.src, g.real_row_ptr, g.real_col_ptr, g.dst_csc)
    all_kept = torch.ones((g.n_edge, kf), dtype=torch.bool)
    plain = fused_mma.edge_program_lean(*args)
    kept = fused_mma.edge_program_lean(*args, keep=all_kept, rate=0.0, src_perm=g.src_perm)
    assert torch.equal(plain, kept)
    ct = ct.reshape(g.n_node, kf)
    for a, b in zip(fused_mma.edge_program_lean_bwd(*args, ct),
                    fused_mma.edge_program_lean_bwd(*args, ct, keep=all_kept, rate=0.0,
                                                    src_perm=g.src_perm)):
        assert torch.equal(a, b)
    with pytest.raises(ValueError, match="src_perm"):
        fused_mma.edge_program_lean(*args, keep=all_kept, rate=0.5)
    with pytest.raises(ValueError, match="rate"):
        fused_mma.edge_program_lean(*args, keep=all_kept, rate=1.0, src_perm=g.src_perm)


def _bounded_ell_graph():
    """64 nodes of in-degree at most 5, with the one-bucket ELL hint."""
    rs = np.random.RandomState(0)
    srcs, dsts = [], []
    for i in range(64):
        k = rs.randint(0, 6)
        srcs += list(rs.choice(64, size=k, replace=False))
        dsts += [i] * k
    g = graph_from_edges(np.array(srcs, np.int32), np.array(dsts, np.int32), 64, device="cpu")
    return dataclasses.replace(g, ell_hint=((g.n_node, 5),))


# (route, aggregators, parity, keyword arguments, graph change)
ROUTES = {
    "dropout": ("lean_keep", ("mean", "mean2"), True, {}, None),
    "dropout, mixed lanes": ("lean_keep", ("sum", "softmax"), True, {}, None),
    "no dropout": ("lean", ("mean", "mean2"), True, {"rate": None}, None),
    "rate 0 with a generator": ("lean", ("mean", "mean2"), True, {"rate": 0.0}, None),
    "dropout, std": ("half_fused", ("mean", "std"), False, {}, None),
    "dropout, moment_3": ("half_fused", ("mean", "moment_3"), False, {}, None),
    "std, no dropout": ("half_fused", ("mean", "std"), False, {"rate": None}, None),
    "dropout, bf16": ("half_fused", ("mean", "mean2"), True,
                      {"compute_dtype": torch.bfloat16}, None),
    "dropout, pallas_bwd_mode": ("half_fused", ("mean", "mean2"), True,
                                 {"pallas_bwd_mode": "csc_gather"}, None),
    "pallas_bwd_mode, no dropout": ("wide", ("mean", "mean2"), True,
                                    {"pallas_bwd_mode": "payload_permute", "rate": None}, None),
    "dropout, no CSC": ("half_fused", ("mean", "mean2"), True, {}, "no_csc"),
    "dropout, ELL hint": ("ell", ("mean", "mean2"), True, {}, "ell"),
    "dropout, edge shard": ("half_fused", ("mean", "mean2"), True, {}, "shard"),
    "edge shard, no dropout": ("lean", ("mean", "mean2"), True, {"rate": None}, "shard"),
}


@pytest.mark.parametrize("case", sorted(ROUTES))
def test_each_call_counts_its_route(hub_graph, case, monkeypatch):
    """``mma.route.<name>`` once on the innermost open span, for the route
    the call's own arguments choose. An edge shard is a call with an
    ``axis_name``, its ``psum`` made the identity (a world of one)."""
    route, aggs, parity, kw, change = ROUTES[case]
    g = hub_graph
    kw = dict(kw)
    if change == "no_csc":
        g = dataclasses.replace(g, src_perm=None)
    elif change == "ell":
        g = _bounded_ell_graph()
    elif change == "shard":
        monkeypatch.setattr(masked_aggregate, "psum", lambda x, axis_name: x)
        kw["axis_name"] = object()
    specs = [get_agg_spec(a) for a in aggs]
    h, mw, _ = _inputs(g, len(specs))
    rate = kw.pop("rate", 0.5)
    gen = None if rate is None else torch.Generator().manual_seed(2)
    P.RECORD.clear()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        with trace("outer"):
            masked_multi_aggregate(h, g, mw, specs, parity=parity,
                                   mask_dropout_rate=rate or 0.0, generator=gen, **kw)
    (outer,) = [s for s in P.RECORD.spans if s.name == "outer"]
    counted = {k: v for k, v in outer.counts.items() if k.startswith("mma.route.")}
    assert counted == {f"mma.route.{route}": 1}, (case, outer.counts)

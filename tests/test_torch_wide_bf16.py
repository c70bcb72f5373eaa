"""The wide MMA edge program (kernels 9-11) and ``fused_masked_aggregate``
(kernel 12) on bf16 operands, against the JAX package on the CPU (the
port's plain versions; the JAX side runs its Pallas kernels in interpret
mode).

The two bf16 forms round in different places, as the JAX package's do:

- the wide program reads bf16 ``d`` and ``h`` and sums its messages in
  float32 (the JAX kernels' two bf16 passes, ``precision="high"``, about
  2⁻¹⁷ of each term), and rounds ``dc``, ``dd`` and ``dh`` once to bf16;
- kernel 12 on bf16 logits rounds each message to bf16 before the float32
  sum (the JAX wrapper's one pass), whatever ``h_src``'s dtype, and its VJP
  runs in the logits' dtype.

Tolerances, each relative to the largest value of the tensor (``scale``):

- forward sums: ``1e-5 · scale``: the JAX two-pass split and another
  summation order, as ``tests/test_torch_wide_program.py``;
- bf16 gradients of the wide program: ``2⁻⁷ · |want| + 1e-5 · scale``.
  Both sides round float32 sums that differ in their last bits (the JAX
  split, the order) once to bf16, and two such sums can round one bf16 ulp
  apart: at most 2⁻⁷ of the value. Measured: nothing beyond 2⁻⁷ more than
  4.3e-8 of scale;
- ``masked_multi_aggregate``'s gradients: ``2⁻⁷ · |want| + 1e-3 · scale``:
  the bf16 projections' backward (``h_c @ W`` in bf16) rounds its products
  on each side (torch, XLA) on its own; measured at most 1.3e-4 of scale
  beyond 2⁻⁷;
- kernel 12's VJP on bf16 logits: ``2⁻⁷ · |want| + 1e-2 · scale``. The
  port computes the JAX VJP's chain op by op in bf16; XLA on the CPU fuses
  it and rounds elsewhere (no chain of float32 and bf16 steps tried matched
  it bit for bit). A σ that rounds one bf16 ulp (up to 2⁻⁸) apart moves
  σ(1−σ) by up to 2⁻⁸, 2⁻⁶ of its largest value ¼. Measured: at most
  7.3e-3 of scale. With float32 logits every term is float32 on both
  sides: 1e-5.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from mma_tpu.graph.build import graph_from_edges as jax_graph_from_edges
from mma_tpu.ops.aggregators import get_agg_spec as jax_get_agg_spec
from mma_tpu.ops.masked_aggregate import masked_multi_aggregate as jax_masked_multi_aggregate
from mma_tpu.ops.pallas.fused_mma import fused_masked_aggregate as jax_fused_masked_aggregate
from mma_tpu.ops.pallas.fused_mma import fused_mma_edge_program

from test_torch_wide_program import _graphs, _skewed, _wide_inputs

from mma_tpu_torch.graph import graph_from_edges
from mma_tpu_torch.ops import fused_masked_aggregate, get_agg_spec
from mma_tpu_torch.ops.cuda import fused_mma
from mma_tpu_torch.ops.masked_aggregate import masked_multi_aggregate

BF16_ULP = 2.0 ** -7  # one bf16 ulp, as a fraction of the value, at most


def _within(got, want, rtol, atol_rel, what):
    """``|got - want| <= rtol·|want| + atol_rel·scale``, scale the largest
    ``|want|``."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    scale = np.abs(want).max()
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol_rel * scale, err_msg=what)


def _np(t):
    """A torch or JAX array as float64 numpy."""
    if isinstance(t, torch.Tensor):
        return t.detach().double().numpy()
    return np.asarray(jnp.asarray(t).astype(jnp.float32), np.float64)


def _bf16_values(*arrays):
    """Each float32 array rounded to bf16: the JAX inputs and the port's."""
    jx = [jnp.asarray(a).astype(jnp.bfloat16) for a in arrays]
    tx = [torch.from_numpy(np.array(j.astype(jnp.float32))).bfloat16() for j in jx]
    return jx, tx


@pytest.fixture(scope="module")
def skewed_graphs():
    """A 320-edge row among runs of empty rows, and padding edges."""
    return _skewed(transpose=False)


@pytest.fixture(scope="module")
def hub_src_graphs():
    """The same edges reversed: a 320-edge source, which kernel 11 splits."""
    return _skewed(transpose=True)


@pytest.mark.parametrize("which,f,n_agg,bwd_mode", [
    ("skewed_graphs", 16, 2, "payload_permute"),
    ("skewed_graphs", 16, 2, "csc_gather"),
    ("skewed_graphs", 12, 3, "payload_permute"),
    ("skewed_graphs", 12, 3, "csc_gather"),
    ("hub_src_graphs", 16, 2, "csc_gather"),
    ("hub_src_graphs", 8, 1, "csc_gather"),
])
def test_wide_program_bf16_matches_jax(request, which, f, n_agg, bwd_mode):
    """Kernels 9-11 through their plain versions and ``edge_program``'s
    autograd Function on bf16 ``c``, ``d`` and ``h`` against the JAX
    package's ``fused_mma_edge_program`` (its default ``precision="high"``)
    with the same backward mode: ``S`` float32 within 1e-5 of scale;
    ``dc``, ``dd`` and ``dh`` bf16, within one bf16 ulp; padding nodes get
    nothing, and nothing launches on the CPU."""
    jg, tg = request.getfixturevalue(which)
    c, d, ct, h, pat = _wide_inputs(jg, f, n_agg)
    nm = np.asarray(jg.node_mask)
    (jc, jd, jh), tensors = _bf16_values(c, d, h)

    def jloss(c_, d_, h_):
        out = fused_mma_edge_program(c_, d_, h_, jnp.asarray(pat), jg, n_agg, bwd_mode=bwd_mode)
        return jnp.sum(out * ct), out

    (_, want), jgrads = jax.value_and_grad(jloss, argnums=(0, 1, 2), has_aux=True)(jc, jd, jh)
    leaves = [t.requires_grad_() for t in tensors]
    tpat = torch.from_numpy(pat.astype(np.float32))
    before = dict(fused_mma.LAUNCHES)
    got = fused_mma.edge_program(*leaves, tpat, tg.src, tg.real_row_ptr, tg.real_col_ptr,
                                 tg.src_perm, tg.dst_csc, bwd_mode)
    (got * torch.from_numpy(ct)).sum().backward()
    assert fused_mma.LAUNCHES == before  # the plain versions on the CPU
    assert got.dtype == torch.float32
    _within(_np(got)[nm], _np(want)[nm], 0, 1e-5, "S")
    assert not got[~nm].any()
    for name, t, w in zip(("dc", "dd", "dh"), leaves, jgrads):
        assert t.grad.dtype == torch.bfloat16 and w.dtype == jnp.bfloat16, name
        _within(_np(t.grad)[nm], _np(w)[nm], BF16_ULP, 1e-5, name)
        assert not t.grad[~nm].any(), name


def test_wide_plain_versions_round_nothing(skewed_graphs):
    """Kernels 9-11's plain versions on bf16 ``c``, ``d`` and ``h`` equal
    the float32 plain versions on the same values bit for bit: nothing is
    rounded to bf16 on the way (unlike the lean bf16 form, whose message
    is rounded)."""
    jg, tg = skewed_graphs
    c, d, ct, h, pat = _wide_inputs(jg, 16, 2)
    _, (c16, d16, h16) = _bf16_values(c, d, h)
    c32, d32, h32 = c16.float(), d16.float(), h16.float()
    tpat, tct = torch.from_numpy(pat.astype(np.float32)), torch.from_numpy(ct)
    rp, cp = tg.real_row_ptr, tg.real_col_ptr
    for got, want in (
            (fused_mma.edge_program_fwd(c16, d16, h16, tpat, tg.src, rp),
             fused_mma.edge_program_fwd(c32, d32, h32, tpat, tg.src, rp)),
            (fused_mma.edge_program_bwd(c16, d16, h16, tpat, tg.src, rp, tct),
             fused_mma.edge_program_bwd(c32, d32, h32, tpat, tg.src, rp, tct)),
            (fused_mma.edge_program_bwd_csc(c16, d16, h16, tpat, tg.dst_csc, cp, tct),
             fused_mma.edge_program_bwd_csc(c32, d32, h32, tpat, tg.dst_csc, cp, tct))):
        for g, w in zip(got if isinstance(got, tuple) else (got,),
                        want if isinstance(want, tuple) else (want,)):
            assert g.dtype == torch.float32 and torch.equal(g, w)


@pytest.mark.parametrize("bwd_mode", ["payload_permute", "csc_gather"])
def test_masked_multi_aggregate_wide_bf16_matches_jax_and_rounds_unlike_lean(bwd_mode):
    """``masked_multi_aggregate(pallas_bwd_mode=…, compute_dtype=bf16)``
    against the JAX package's ``use_pallas=True`` route in bf16: the output
    within 1e-5 of scale, ``dh`` and ``dmask_weights`` within one bf16 ulp
    and 1e-3 of scale. The port's lean bf16 route rounds each message to
    bf16 and the wide one does not, as in the JAX package: the two differ
    (within 1e-2 of scale), and the lean route misses the JAX wide output
    by more than 100 times the wide route's error."""
    jg, tg = _graphs(150, 0.08, seed=3)
    aggs = ("mean", "max")  # sigmoid and raw-logit lanes
    rs = np.random.RandomState(4)
    f, k = 16, len(aggs)
    h = rs.randn(jg.n_node, f).astype(np.float32)
    h[150:] = 0.0
    mw = (rs.randn(k, 2 * f, f) / np.sqrt(f)).astype(np.float32)
    nm = np.asarray(jg.node_mask)
    ct = np.where(nm[:, None, None], rs.randn(jg.n_node, k, f), 0.0).astype(np.float32)
    jspecs = [jax_get_agg_spec(a) for a in aggs]
    specs = [get_agg_spec(a) for a in aggs]

    def jloss(h_, mw_):
        out = jax_masked_multi_aggregate(h_, jg, mw_, jspecs, use_pallas=True,
                                         pallas_bwd_mode=bwd_mode, compute_dtype=jnp.bfloat16)
        return jnp.sum(out * ct), out

    (_, want), (want_dh, want_dmw) = jax.value_and_grad(jloss, argnums=(0, 1), has_aux=True)(
        jnp.asarray(h), jnp.asarray(mw))

    def port(mode):
        th, tw = torch.from_numpy(h.copy()).requires_grad_(), torch.from_numpy(mw.copy())
        tw.requires_grad_()
        out = masked_multi_aggregate(th, tg, tw, specs, pallas_bwd_mode=mode,
                                     compute_dtype=torch.bfloat16)
        (out * torch.from_numpy(ct)).sum().backward()
        assert out.dtype == th.grad.dtype == tw.grad.dtype == torch.float32
        return _np(out)[nm], _np(th.grad), _np(tw.grad)

    wide, lean = port(bwd_mode), port(None)
    want = _np(want)[nm]
    _within(wide[0], want, 0, 1e-5, "output vs JAX")
    _within(wide[1], _np(want_dh), BF16_ULP, 1e-3, "dh vs JAX")
    _within(wide[2], _np(want_dmw), BF16_ULP, 1e-3, "dmask_weights vs JAX")
    for name, a, b in zip(("output", "dh", "dmask_weights"), wide, lean):
        _within(a, b, 0, 1e-2, f"{name} vs the lean bf16 route")
    assert not np.array_equal(wide[0], lean[0])
    wide_err, lean_err = (np.abs(x - want).max() for x in (wide[0], lean[0]))
    assert lean_err > 100 * wide_err, (lean_err, wide_err)


@pytest.fixture(scope="module")
def masked_graphs():
    """300 nodes, the last 40 without in-edges; padding edges at the tail."""
    rs = np.random.RandomState(0)
    n = 300
    src = rs.randint(0, n, 2400).astype(np.int32)
    dst = rs.randint(0, n - 40, 2400).astype(np.int32)
    return jax_graph_from_edges(src, dst, n), graph_from_edges(src, dst, n, device="cpu"), n


@pytest.mark.parametrize("k,f", [(2, 8), (3, 12)])
@pytest.mark.parametrize("dtypes", ["bf16,bf16", "bf16,f32", "f32,bf16"])
def test_fused_masked_aggregate_bf16_matches_jax(masked_graphs, k, f, dtypes):
    """``fused_masked_aggregate`` on each (logits, h_src) dtype pair against
    the JAX function: ``S`` float32 within 1e-5 of scale, ``dlogits`` and
    ``dh_src`` in their inputs' dtypes at the tolerances of the module
    docstring; padding edges get zero gradient. The message is rounded to
    bf16 iff the logits are bf16: with bf16 logits ``S`` misses the
    unrounded form by more than 100 times its error against JAX, and with
    float32 logits it equals the unrounded form and not the rounded one."""
    jg, tg, n = masked_graphs
    to_jax = {"bf16": jnp.bfloat16, "f32": jnp.float32}
    to_torch = {"bf16": torch.bfloat16, "f32": torch.float32}
    ld, hd = dtypes.split(",")
    rs = np.random.RandomState(10 * k + f)
    pat = np.arange(k * f) // f % 2 == 0  # σ and raw-logit lanes
    jl = jnp.asarray(rs.randn(jg.n_edge, k * f).astype(np.float32)).astype(to_jax[ld])
    jh = jnp.asarray(rs.randn(jg.n_edge, f).astype(np.float32)).astype(to_jax[hd])
    ct = rs.randn(jg.n_node, k * f).astype(np.float32)
    e_mask = np.asarray(jg.edge_mask)

    want, vjp = jax.vjp(lambda l_, h_: jax_fused_masked_aggregate(l_, h_, jnp.asarray(pat), jg, k),
                        jl, jh)
    want_dl, want_dh = vjp(jnp.asarray(ct))
    tl = torch.from_numpy(np.array(jl.astype(jnp.float32))).to(to_torch[ld]).requires_grad_()
    th = torch.from_numpy(np.array(jh.astype(jnp.float32))).to(to_torch[hd]).requires_grad_()
    tpat = torch.from_numpy(pat)
    before = dict(fused_mma.LAUNCHES)
    got = fused_masked_aggregate(tl, th, tpat, tg, k)
    (got * torch.from_numpy(ct)).sum().backward()
    assert fused_mma.LAUNCHES == before  # the plain versions on the CPU
    assert got.dtype == torch.float32 and got.shape == (tg.n_node, k * f)
    want = _np(want)[:n]
    s = _np(got)[:n]
    _within(s, want, 0, 1e-5, "S")
    assert not s[260:].any()

    lf, hf = tl.detach().float(), th.detach().float()
    unrounded = _np(fused_mma.masked_segment_sum_reference(lf, hf, tpat.float(),
                                                           tg.real_row_ptr))[:n]
    rounded = _np(fused_mma.masked_segment_sum_reference(lf.bfloat16(), hf, tpat.float(),
                                                         tg.real_row_ptr))[:n]
    err = np.abs(s - want).max()
    if ld == "bf16":
        assert np.array_equal(s, rounded)
        assert np.abs(unrounded - want).max() > 100 * err
    else:
        assert np.array_equal(s, unrounded) and not np.array_equal(s, rounded)

    atol = 1e-2 if ld == "bf16" else 1e-5
    for name, t, w in (("dlogits", tl, want_dl), ("dh_src", th, want_dh)):
        assert t.grad.dtype == t.dtype, name
        _within(_np(t.grad), _np(w), BF16_ULP, atol, name)
        assert not t.grad[~e_mask].any(), name  # padding edges

"""ZINC graph regression in bf16 (``compute_dtype="bfloat16"`` and
``"auto"``) against the JAX package's Pallas path in interpret mode
(``use_pallas=True``, as ``tests/test_graph_regression.py:293-316`` runs
it), on the CPU.

The JAX XLA path is no reference here: its bf16 reduces run in bf16, where
the Pallas kernels and the port reduce in float32.

- **Kernels 4-8**, through their plain versions, on identical bf16 inputs
  (bf16-representable values fed to both sides), against the JAX launchers
  and their VJPs: ``fused_segment_minmax``, ``fused_minmax_edge_program``
  (without and with a hash seed) and ``fused_segment_sum_sq``. The graphs:
  ``tests/test_torch_segment_minmax.py``'s 60-node graph (duplicate edges,
  a hub, rows without edges) and ``tests/test_torch_bf16.py``'s skewed one
  (a 320-edge row, runs of empty rows, padding edges), with forced ties
  (integer values). Kernels 4 and 6 select exactly computed float32 values
  and the routed edge gradients of 5 and 7 go to the same first hit: equal.
  Kernel 7's ``dc`` and kernel 8's sums are float32 sums in another order:
  relative 1e-5, with a floor of 1e-5 of the tensor's largest value; the
  gradients that the JAX VJPs give in bf16 (kernel 7's ``dc``, kernel 8's
  ``dx``) within half a bf16 ulp (2^-8 of the value) on top of that. The
  port rounds where the JAX kernels' one-pass contractions round: the
  backward's cotangent (kernels 5 and 7) and kernel 8's squares.
  Measured: all equal, ``dc`` and ``dx`` too; kernel 8's sums at most
  4e-8 of their scale.
- **The conv on each route** (fused, general, degree-exact ELL; both parity
  modes; dropout off and with the JAX package's hash seeds where the route
  hashes) and **ZincNet** (forward, gradients, 3 Adam steps) at the bf16
  layer tolerance of ``tests/test_torch_bf16.py``: 1e-2 of each tensor's
  largest value. Both frameworks round the projections, the messages and
  their adds to bf16, but XLA may keep float32 inside a fused chain where
  PyTorch rounds after each op, and a bf16 value of another summation
  order can round the other way. Each test states the largest error it
  measured.
- **``"auto"``** builds a float32 conv, bit for bit the float32 one; the
  **``axis_name``** route on a world of one equals the single-device bf16
  general route; the **CLI** trains one epoch in bf16.
"""

import copy

import numpy as np
import jax
import jax.numpy as jnp
import optax
import pytest
import torch

from mma_tpu.data import load_zinc as jax_load_zinc
from mma_tpu.graph.build import graph_from_edges as jax_graph_from_edges
from mma_tpu.models import ZincNet as JaxZincNet
from mma_tpu.nn.mma_conv import MultiMaskConv as JaxMultiMaskConv
from mma_tpu.ops.pallas.fused_mma import fused_segment_sum_sq as jax_fused_segment_sum_sq
from mma_tpu.ops.pallas.segment_minmax import (
    fused_minmax_edge_program as jax_fused_minmax_edge_program,
    fused_segment_minmax as jax_fused_segment_minmax,
)
from mma_tpu.train.optim import make_optimizer as jax_make_optimizer

from test_torch_ell import _batches, _jax_seeds
from test_torch_zinc_net import _grad_tree, _np, _pop_bn_fed_biases

from mma_tpu_torch.cli import train_zinc as cli_train_zinc
from mma_tpu_torch.convert import (
    multi_mask_conv_from_jax,
    multi_mask_conv_to_numpy,
    zinc_net_from_jax,
    zinc_net_to_numpy,
)
from mma_tpu_torch.data import load_zinc
from mma_tpu_torch.graph import graph_from_edges
from mma_tpu_torch.models import ZincNet
from mma_tpu_torch.nn.layers import dropout
from mma_tpu_torch.nn.mma_conv import MultiMaskConv
from mma_tpu_torch.ops.cuda import fused_mma
from mma_tpu_torch.ops.cuda import segment_minmax as mm
from mma_tpu_torch.train import make_optimizer
from mma_tpu_torch.train.loops import l1_loss, zinc_train_step

KERNEL_TOL = 1e-5
HALF_ULP = 2.0 ** -8
LAYER_TOL = 1e-2
F, EDGE_DIM, TOWERS = 12, 6, 2
AVG_DEG = {"lin": 2.0, "log": 1.0, "exp": 5.0}
PRESET = (("min", "max"), ("identity", "amplification", "linear"))  # README.md:79
DEFAULT = (("mean", "max", "min"), ("identity", "amplification", "attenuation"))  # the CLI's
PNA = (("mean", "min", "max", "std"), ("identity", "amplification", "attenuation"))
SMALL_NET = dict(num_layers=2, hidden=10, edge_hidden=6, towers=2, mlp_sizes=(10, 6, 1))


def _bf16_values(a):
    """``a`` rounded to bf16, as float32 numpy: the same values both sides take."""
    return np.array(jnp.asarray(a, jnp.bfloat16).astype(jnp.float32))


def _f32(a):
    return a.float().numpy() if isinstance(a, torch.Tensor) else np.asarray(
        jnp.asarray(a).astype(jnp.float32))


def _close(got, want, tol=KERNEL_TOL, ulp=0.0, what=""):
    """``|got - want| <= tol·|want| + tol·max|want| + ulp·|want|``."""
    got, want = _f32(got), _f32(want)
    np.testing.assert_allclose(got, want, rtol=tol + ulp, atol=tol * np.abs(want).max(),
                               err_msg=what)


def _scaled_err(got, want):
    """The largest ``|got - want|`` over the largest ``|want|``."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.abs(got - want).max() / (np.abs(want).max() + 1e-30)


# ------------------------------------------------------------- kernel graphs

def _random():
    """``tests/test_torch_segment_minmax.py``'s graph: 60 nodes, the last 8
    without in-edges, duplicate edges and a 30-edge hub."""
    rs = np.random.RandomState(0)
    n = 60
    src = rs.randint(0, n, 260).astype(np.int32)
    dst = np.concatenate([rs.randint(0, n - 8, 230), np.zeros(30, np.int64)]).astype(np.int32)
    src = np.concatenate([src, src[:20]])
    dst = np.concatenate([dst, dst[:20]])
    return jax_graph_from_edges(src, dst, n), graph_from_edges(src, dst, n, device="cpu")


def _skewed():
    """``tests/test_torch_bf16.py``'s skewed graph: 400 nodes, node 5 the
    destination of a 320-edge row, rows 100-159 and the last 30 empty, and
    70 padding edges past the real ones."""
    rs = np.random.RandomState(21)
    n = 400
    live = np.setdiff1d(np.arange(n - 30), np.r_[5, 100:160])
    dst = np.concatenate([np.full(320, 5), rs.choice(live, 2000)]).astype(np.int32)
    src = rs.randint(0, n, dst.shape[0]).astype(np.int32)
    n_edge = dst.shape[0] + 70
    jg = jax_graph_from_edges(src, dst, n, n_edge_pad=n_edge)
    tg = graph_from_edges(src, dst, n, n_node_pad=jg.n_node, n_edge_pad=n_edge, device="cpu")
    return jg, tg


KERNEL_GRAPHS = {"random": _random, "skewed": _skewed}


@pytest.fixture(scope="module")
def kernel_graphs():
    return {name: make() for name, make in KERNEL_GRAPHS.items()}


def _draw(rs, shape, ties):
    """bf16 values: integers in [-2, 2] (ties everywhere) or ``3·randn``
    rounded (ties where bf16 rounds values together)."""
    a = rs.randint(-2, 3, shape) if ties else rs.randn(*shape) * 3
    return _bf16_values(a.astype(np.float32))


def _sel(jg):
    return np.asarray(jg.deg) > 0


def _bf16_param(a):
    return torch.from_numpy(a).bfloat16().requires_grad_()


# --------------------------------------------------------------- kernels 4-5

@pytest.mark.parametrize("which,ch,ops,ties", [
    ("random", 24, ("min", "max"), False),
    ("random", 24, ("max",), True),
    ("random", 375, ("max", "min"), True),
    ("skewed", 16, ("min", "max"), True),
    ("skewed", 16, ("min",), False),
])
def test_bf16_segment_minmax_matches_pallas(kernel_graphs, which, ch, ops, ties):
    """Kernel 4's plain version on bf16 data and kernel 5's gradient
    (through the autograd Function) against ``fused_segment_minmax`` and
    its ``jax.grad`` on the same bf16 data: the outputs (float32) equal on
    the rows with edges and 0 on the others, the bf16 gradients equal."""
    jg, tg = kernel_graphs[which]
    sel = _sel(jg)
    rs = np.random.RandomState(ch + len(ops))
    data = _draw(rs, (jg.n_edge, ch), ties)
    ct = rs.randn(jg.n_node, len(ops) * ch).astype(np.float32) * sel[:, None]
    jd = jnp.asarray(data, jnp.bfloat16)
    want = np.asarray(jax_fused_segment_minmax(jd, jg, ops))
    want_grad = jax.grad(lambda d: jnp.sum(jax_fused_segment_minmax(d, jg, ops) * ct))(jd)
    assert want_grad.dtype == jnp.bfloat16
    td = _bf16_param(data)
    before = dict(mm.LAUNCHES)
    out = mm.fused_segment_minmax(td, tg, ops)
    (out * torch.from_numpy(ct)).sum().backward()
    assert mm.LAUNCHES == before  # the plain versions on the CPU
    assert out.dtype == torch.float32 and td.grad.dtype == torch.bfloat16
    np.testing.assert_array_equal(out.detach().numpy()[sel], want[sel])
    assert (out.detach().numpy()[~sel] == 0).all()
    np.testing.assert_array_equal(_f32(td.grad), _f32(want_grad))
    if ties:  # every tied row routes to one edge per (channel, op)
        routed = (_f32(td.grad)[: int(tg.real_row_ptr[-1])] != 0).sum()
        assert routed <= len(ops) * ch * sel.sum()


def test_bf16_cotangent_is_rounded_where_the_jax_kernel_rounds(kernel_graphs):
    """Kernel 5's one-pass select rounds the cotangent to bf16 before it
    routes it: the port does too. Without that rounding a degree-1 row's
    gradient ``ct_min + ct_max`` rounds twice, and the plain version would
    miss the JAX gradient."""
    jg, tg = kernel_graphs["random"]
    rs = np.random.RandomState(4)
    data = _draw(rs, (jg.n_edge, 32), False)
    ct = (rs.randn(jg.n_node, 64) * _sel(jg)[:, None]).astype(np.float32)
    jd = jnp.asarray(data, jnp.bfloat16)
    want = _f32(jax.grad(lambda d: jnp.sum(jax_fused_segment_minmax(d, jg) * ct))(jd))
    td = torch.from_numpy(data).bfloat16()
    rp = tg.real_row_ptr
    out = mm.segment_minmax_reference(td, rp, ("min", "max"))
    got = mm.segment_minmax_bwd_reference(td, rp, ("min", "max"), out, torch.from_numpy(ct))
    np.testing.assert_array_equal(_f32(got), want)
    unrounded = mm.segment_minmax_bwd_reference(td.float(), rp, ("min", "max"), out,
                                                torch.from_numpy(ct)).bfloat16()
    assert not np.array_equal(_f32(unrounded), want)


# --------------------------------------------------------------- kernels 6-7

@pytest.mark.parametrize("which,ch,ops,seed,ties", [
    ("random", 24, ("min", "max"), None, False),
    ("random", 24, ("min", "max"), 1234, True),
    ("random", 375, ("max", "min"), 77, False),
    ("random", 24, ("max",), 2**31 - 2, True),
    ("skewed", 16, ("min", "max"), None, True),
    ("skewed", 16, ("min", "max"), 5, False),
])
def test_bf16_minmax_edge_program_matches_pallas(kernel_graphs, which, ch, ops, seed, ties):
    """Kernel 6's plain version on bf16 ``c`` and ``hg`` (the add and the
    mask product in float32, the message never rounded to bf16) and kernel
    7's gradients against ``fused_minmax_edge_program`` and its VJP, with
    and without the hash dropout: the outputs equal, ``dhg`` (bf16) equal,
    ``dc`` (bf16) at 1e-5 plus half a bf16 ulp."""
    jg, tg = kernel_graphs[which]
    sel = _sel(jg)
    rs = np.random.RandomState(ch + 1)
    c = _draw(rs, (jg.n_node, ch), ties)
    hg = _draw(rs, (jg.n_edge, ch), ties)
    ct = rs.randn(jg.n_node, len(ops) * ch).astype(np.float32) * sel[:, None]
    jseed = None if seed is None else jnp.asarray([seed], jnp.int32)
    tseed = None if seed is None else torch.tensor([seed], dtype=torch.int32)

    def jfwd(c_, h_):
        return jax_fused_minmax_edge_program(c_, h_, jg, ops, seed=jseed, rate=0.5)

    jc, jh = jnp.asarray(c, jnp.bfloat16), jnp.asarray(hg, jnp.bfloat16)
    want = np.asarray(jfwd(jc, jh))
    jdc, jdhg = jax.grad(lambda c_, h_: jnp.sum(jfwd(c_, h_) * ct), argnums=(0, 1))(jc, jh)
    assert jdc.dtype == jdhg.dtype == jnp.bfloat16
    tc, thg = _bf16_param(c), _bf16_param(hg)
    out = mm.fused_minmax_edge_program(tc, thg, tg, ops, seed=tseed, rate=0.5)
    (out * torch.from_numpy(ct)).sum().backward()
    assert out.dtype == torch.float32
    assert tc.grad.dtype == thg.grad.dtype == torch.bfloat16
    np.testing.assert_array_equal(out.detach().numpy()[sel], want[sel])
    assert (out.detach().numpy()[~sel] == 0).all()
    np.testing.assert_array_equal(_f32(thg.grad), _f32(jdhg))
    _close(tc.grad, jdc, ulp=HALF_ULP, what="dc")
    if not ties:  # the messages are float32 sums that bf16 cannot hold
        x = hg[: int(tg.real_row_ptr[-1])] + c[mm._row_ids(tg.real_row_ptr).numpy()]
        assert not np.array_equal(x, _bf16_values(x))


def test_bf16_edge_program_refuses_mixed_dtypes(kernel_graphs):
    """``c`` and ``hg`` share one dtype on the card; the kernel raises
    otherwise (there is no quiet cast)."""
    _, tg = kernel_graphs["random"]
    c = torch.zeros(tg.n_node, 8, dtype=torch.bfloat16)
    hg = torch.zeros(tg.n_edge, 8)
    with pytest.raises(ValueError, match="share a dtype"):
        mm._check_rows("minmax_prog", tg.real_row_ptr, tg.n_node, c=c, hg=hg)
    with pytest.raises(ValueError, match="float32 or torch.bfloat16"):
        mm._check_rows("segment_minmax", tg.real_row_ptr, tg.n_node, data=hg.half())


# ------------------------------------------------------------------ kernel 8

@pytest.mark.parametrize("which", list(KERNEL_GRAPHS))
@pytest.mark.parametrize("ch", [16, 37])
def test_bf16_segment_sum_sq_matches_pallas(kernel_graphs, which, ch):
    """Kernel 8's plain version on bf16 data against ``fused_segment_sum_sq``
    on the same data (precision ``"fastest"`` for bf16): ``Σx`` exact
    float32 sums, ``Σx²`` of the squares rounded to bf16 as the one-pass
    contraction rounds them; the VJP in float32, cast to bf16. Without the
    rounding ``Σx²`` would miss by far more than the tolerance."""
    jg, tg = kernel_graphs[which]
    n = int(jg.n_node)
    rs = np.random.RandomState(ch)
    data = _bf16_values(rs.randn(jg.n_edge, ch) * 3)
    data[~np.asarray(jg.edge_mask)] = 0.0
    ct = rs.randn(jg.n_node, 2 * ch).astype(np.float32)
    jd = jnp.asarray(data, jnp.bfloat16)

    def jloss(x):
        out = jax_fused_segment_sum_sq(jnp.where(jg.edge_mask[:, None], x, 0.0), jg)
        return jnp.sum(out * ct), out

    (_, want), jgrad = jax.value_and_grad(jloss, has_aux=True)(jd)
    assert jgrad.dtype == jnp.bfloat16
    x = _bf16_param(data)
    before = dict(fused_mma.LAUNCHES)
    got = fused_mma.segment_sum_sq_csr(x, tg.real_row_ptr)
    (got * torch.from_numpy(ct)).sum().backward()
    assert fused_mma.LAUNCHES == before
    assert got.dtype == torch.float32 and x.grad.dtype == torch.bfloat16
    want = np.asarray(want)
    _close(got.detach()[:n], want[:n], what="sums")
    _close(x.grad, jgrad, ulp=HALF_ULP, what="dx")
    assert not x.grad[~torch.from_numpy(np.asarray(jg.edge_mask))].float().any()
    exact_sq = fused_mma.segment_sum_sq_reference(torch.from_numpy(data), tg.real_row_ptr)
    assert _scaled_err(exact_sq[:n, ch:].numpy(), want[:n, ch:]) > 10 * KERNEL_TOL


def test_bf16_dropout_stays_bf16():
    """The general route's dropout on bf16 messages: ``where(keep, x / (1 -
    rate), 0)`` in bf16, as the JAX ``dropout`` computes in ``x``'s dtype."""
    x = torch.from_numpy(_bf16_values(np.random.RandomState(0).randn(64, 8))).bfloat16()
    gen = torch.Generator().manual_seed(0)
    got = dropout(x, 0.5, gen)
    keep = torch.rand(x.shape, generator=torch.Generator().manual_seed(0)) >= 0.5
    assert got.dtype == torch.bfloat16
    assert torch.equal(got, torch.where(keep, x * 2, torch.zeros((), dtype=torch.bfloat16)))


# ---------------------------------------------------------------------- conv

def _conv_pair(aggs, parity, edge_format="csr", compute_dtype="bfloat16"):
    kw = dict(edge_dim=EDGE_DIM, towers=TOWERS, parity=parity, max_degree_hint=4,
              edge_format=edge_format, compute_dtype=compute_dtype)
    scalers = PRESET[1]
    jconv = JaxMultiMaskConv(in_channels=F, out_channels=F, aggregators=aggs, scalers=scalers,
                             avg_deg=tuple(AVG_DEG.items()), **kw)
    params = jconv.init(jax.random.PRNGKey(0))
    conv = MultiMaskConv(F, F, aggs, scalers, AVG_DEG, device="cpu", **kw)
    multi_mask_conv_from_jax(_np(params), conv)
    return jconv, params, conv


def _conv_inputs(tg, seed=1):
    rs = np.random.RandomState(seed)
    return (rs.randn(tg.n_node, F).astype(np.float32),
            rs.randn(tg.n_edge, EDGE_DIM).astype(np.float32),
            rs.randn(tg.n_node, F).astype(np.float32))


def _port_conv(conv, tg, x, e, ct, **kw):
    """Output, ``dx``, ``d edge_attr`` and the parameter gradients (JAX
    tree) of ``Σ where(node_mask, out, 0) · ct``."""
    conv.zero_grad(set_to_none=True)
    tx = torch.tensor(x, requires_grad=True)
    te = torch.tensor(e, requires_grad=True)
    out = conv(tx, tg, te, **kw)
    (torch.where(tg.node_mask[:, None], out, 0.0) * torch.from_numpy(ct)).sum().backward()
    return (out.detach().numpy(), tx.grad.numpy(), te.grad.numpy(),
            _grad_tree(conv, multi_mask_conv_to_numpy))


def _jax_conv(jconv, params, jg, x, e, ct, rng=None):
    def jloss(p, x_, e_):
        out = jconv.apply(p, x_, jg, edge_attr=e_, use_pallas=True, rng=rng)
        return jnp.sum(jnp.where(jg.node_mask[:, None], out, 0.0) * ct), out

    (_, want), (jgp, jgx, jge) = jax.value_and_grad(jloss, argnums=(0, 1, 2), has_aux=True)(
        params, jnp.asarray(x), jnp.asarray(e))
    return np.asarray(want), np.asarray(jgx), np.asarray(jge), _np(jgp)


def _edge_bias_scale(tree, path):
    """For the bias of a pre-NN's first layer (added to every edge's
    message), the largest gradient of the same layer's weight; else None.

    Its gradient is a column sum of the bf16 message cotangent over every
    edge. XLA on the CPU sums it in bf16 (the reduce keeps its operand's
    type), the port in float32: on the 7 molecules (the general route,
    fixed mode) the JAX bf16 gradients lay up to 5.4% of their largest
    value off the JAX float32 ones, the port's 0.9%. So it is held on the
    scale of the weight's gradient, the other sum over the same cotangent,
    as the BatchNorm-fed biases of ``tests/test_torch_zinc_net.py`` are."""
    keys = [getattr(k, "key", getattr(k, "idx", None)) for k in path]
    if "pre_nns" in keys and keys[-2:] == [0, "b"]:
        node = tree
        for k in keys[:-1]:
            node = node[k]
        return np.abs(node["w"]).max()
    return None


def _hold_tree(got, want, what, slack=None):
    """Each gradient leaf within ``LAYER_TOL`` of its largest value (of its
    weight's for the edge biases, :func:`_edge_bias_scale`), beyond the
    leaf's ``slack``; returns the scaled errors by leaf."""
    slacks = jax.tree.leaves(slack) if slack is not None else [0.0] * len(jax.tree.leaves(got))
    errs = {}
    for (path, w), g, extra in zip(jax.tree_util.tree_flatten_with_path(want)[0],
                                   jax.tree.leaves(got), slacks):
        name = jax.tree_util.keystr(path)
        if not np.abs(w).any():  # the detached pre-NNs (parity, N7): 0 on both sides
            assert not np.abs(g).any(), f"{what} {name}"
            continue
        scale = _edge_bias_scale(want, path) or np.abs(w).max()
        errs[name] = max(np.abs(g - w).max() - extra, 0.0) / scale
        assert errs[name] < LAYER_TOL, f"{what} {name}: {errs[name]:.3e}"
    return errs


def _hold_layer(got, want, mask, edge_mask, what):
    """The output, ``dx`` and ``d edge_attr`` within ``LAYER_TOL`` of their
    largest values and the parameter gradients as :func:`_hold_tree`;
    returns the largest scaled error."""
    out, gx, ge, gp = got
    w_out, w_gx, w_ge, w_gp = want
    errs = {"out": _scaled_err(out[mask], w_out[mask]), "dx": _scaled_err(gx[mask], w_gx[mask]),
            "d edge_attr": _scaled_err(ge[edge_mask], w_ge[edge_mask])}
    errs.update(_hold_tree(gp, w_gp, what))
    worst = max(errs, key=errs.get)
    assert errs[worst] < LAYER_TOL, f"{what}: {worst} {errs[worst]:.3e}"
    return errs[worst]


def _csr_graphs():
    """The 7 molecules of ``tests/test_torch_ell.py`` on the plain collate."""
    jb, tb = _batches(seed=3, exact=False)
    return jb.graph, tb.graph


CONV_CASES = [
    # (route, aggregators, parity, dropout)
    ("fused", PRESET[0], True, False),
    ("fused", PRESET[0], True, True),
    ("fused", PRESET[0], False, True),
    ("general", DEFAULT[0], True, False),
    ("general", DEFAULT[0], False, False),
    ("general", PNA[0], True, False),
    ("ell", PRESET[0], True, False),
    ("ell", PRESET[0], False, True),
    ("ell", PNA[0], True, True),
]


@pytest.mark.parametrize("route,aggs,parity,drop", CONV_CASES)
def test_bf16_conv_matches_pallas(route, aggs, parity, drop):
    """The bf16 conv on each route against the JAX ``MultiMaskConv(
    compute_dtype="bfloat16")`` with the same weights, ``use_pallas=True``:
    the fused route (``min,max``: kernels 6-7's plain versions on bf16 ``c``
    and ``hg``), the general route (the CLI's ``mean,max,min``: kernels 1, 4
    and 5; the PNA set adds kernel 8) against the JAX CSR route, and the
    degree-exact ELL route against the JAX ELL route. Dropout: the JAX
    package's hash seeds where the route hashes (the fused and ELL routes).
    The forward and the gradients of ``x``, ``edge_attr``, the edge
    encoder, the pre-NNs (fixed mode), the post-NNs and ``lin`` within
    1e-2 of each tensor's largest value (the pre-NN biases of
    :func:`_edge_bias_scale` on their weight's). Measured: the outputs
    within 4e-7, the gradients at most 7.6e-3 (``dx`` of the ELL route's
    PNA set with dropout)."""
    exact = route == "ell"
    jb, tb = _batches(seed=3, exact=exact)
    jg, tg = jb.graph, tb.graph
    jconv, params, conv = _conv_pair(aggs, parity, "auto" if exact else "csr")
    x, e, ct = _conv_inputs(tg)
    rng, seed = None, None
    if drop:
        rng = jax.random.PRNGKey(11)
        if exact:
            seeds = _jax_seeds(rng, 1 if parity else len(aggs))
        else:  # the fused route's randint(rng, (1,), ...) per message set
            keys = [rng] if parity else list(jax.random.split(rng, len(aggs)))
            seeds = [int(jax.random.randint(k, (1,), 0, 2**31 - 1)[0]) for k in keys]
        seed = seeds[0] if parity else seeds
    before = dict(mm.LAUNCHES), dict(fused_mma.LAUNCHES)
    got = _port_conv(conv, tg, x, e, ct, seed=seed)
    assert (dict(mm.LAUNCHES), dict(fused_mma.LAUNCHES)) == before
    want = _jax_conv(jconv, params, jg, x, e, ct, rng)
    mask, edge_mask = tg.node_mask.numpy(), tg.edge_mask.numpy()
    _hold_layer(got, want, mask, edge_mask, f"{route} {aggs} parity={parity} dropout={drop}")
    if drop:  # the masks were applied
        no_drop = _port_conv(conv, tg, x, e, ct)[0]
        assert not np.allclose(no_drop[mask], got[0][mask])


def test_bf16_conv_messages_are_bf16(monkeypatch):
    """Where the messages live: the fused route hands kernel 6 bf16 ``p_dst``
    and ``hg``, the general route hands kernels 1, 4 and 8 its bf16 messages
    (after dropout), the ELL route's slot blocks are bf16; every reduce and
    the conv's output are float32."""
    import mma_tpu_torch.nn.mma_conv as conv_mod

    seen = {}
    for name in ("fused_minmax_edge_program", "fused_segment_minmax", "segment_sum_csr",
                 "segment_sum_sq_csr"):
        def spy(*args, _fn=getattr(conv_mod, name), _name=name, **kwargs):
            out = _fn(*args, **kwargs)
            seen[_name] = ([a.dtype for a in args[:2] if isinstance(a, torch.Tensor)],
                           out.dtype)
            return out
        monkeypatch.setattr(conv_mod, name, spy)
    _, tg = _csr_graphs()
    x, e, _ = _conv_inputs(tg)
    for aggs in (PRESET[0], PNA[0]):
        out = _conv_pair(aggs, True)[2](torch.from_numpy(x), tg, torch.from_numpy(e),
                                         generator=torch.Generator().manual_seed(0))
        assert out.dtype == torch.float32
    assert seen["fused_minmax_edge_program"] == ([torch.bfloat16] * 2, torch.float32)
    for name in ("fused_segment_minmax", "segment_sum_csr", "segment_sum_sq_csr"):
        assert seen[name][0][0] == torch.bfloat16 and seen[name][1] == torch.float32, name
    _, tb = _batches(seed=3, exact=True)
    x, e, _ = _conv_inputs(tb.graph)
    conv = _conv_pair(PNA[0], True, "auto")[2]
    xs = conv._ell_messages(len(PNA[0]) - 1, torch.from_numpy(x).repeat(1, TOWERS),
                            conv.edge_encoder(torch.from_numpy(e)), tb.graph,
                            conv._ell_spec(tb.graph), torch.tensor([5], dtype=torch.int32))
    assert all(xb.dtype == torch.bfloat16 for xb in xs)


def test_auto_is_float32_bit_for_bit():
    """``compute_dtype="auto"`` on the CPU (and on ``cuda``) is float32: the
    conv and its gradients equal the float32 conv's bit for bit, on the
    fused and the general route."""
    jg, tg = _csr_graphs()
    x, e, ct = _conv_inputs(tg)
    for aggs in (PRESET[0], PNA[0]):
        f32 = _conv_pair(aggs, True, compute_dtype="float32")[2]
        auto = _conv_pair(aggs, True, compute_dtype="auto")[2]
        assert auto.edge_dtype == torch.float32
        for a, b in zip(_port_conv(f32, tg, x, e, ct), _port_conv(auto, tg, x, e, ct)):
            for u, v in zip(jax.tree.leaves(a), jax.tree.leaves(b)):
                np.testing.assert_array_equal(u, v)


def test_bf16_axis_name_route_on_a_world_of_one():
    """The ``axis_name`` route in bf16 (the general route's local partials,
    float32 before ``psum`` and ``all_gather``) on an edge axis of one rank
    equals the single-device bf16 general route, forward and gradients."""
    from torch_world import world_of_one

    jg, tg = _csr_graphs()
    x, e, ct = _conv_inputs(tg)
    conv = _conv_pair(DEFAULT[0], True)[2]
    want = _port_conv(conv, tg, x, e, ct)
    with world_of_one() as mesh:
        got = _port_conv(conv, tg, x, e, ct, axis_name=mesh.get_group("edge"))
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-6 * np.abs(b).max())


# ------------------------------------------------------------------- ZincNet

def _net_pair(aggs, scalers, key=0, **kw):
    avg = dict(AVG_DEG)
    jnet = JaxZincNet(aggregators=aggs, scalers=scalers, avg_deg=tuple(avg.items()),
                      compute_dtype="bfloat16", **SMALL_NET, **kw)
    params, state = jnet.init(jax.random.PRNGKey(key)), jnet.init_state()
    net = ZincNet(aggs, scalers, avg, compute_dtype="bfloat16", device="cpu", **SMALL_NET, **kw)
    zinc_net_from_jax(_np(params), _np(state), net)
    bkw = dict(n_node=24 * 40, n_edge=24 * 100)
    jb = next(jax_load_zinc("val", subset_size=24).batches(16, **bkw))
    tb = next(load_zinc("val", subset_size=24).batches(16, device="cpu", **bkw))
    return jnet, params, state, net, jb, tb


def _jax_loss(jnet, jb):
    def jloss(p, s):
        pred, new_state = jnet.apply(p, s, jb, training=True, use_pallas=True)
        gm = jb.graph_mask.astype(pred.dtype)
        return jnp.sum(jnp.abs(pred - jb.target) * gm) / jnp.sum(gm), (pred, new_state)
    return jax.jit(jax.value_and_grad(jloss, has_aux=True))


def _port_net_grads(net, tb):
    net.zero_grad(set_to_none=True)
    pred = net(tb, training=True)
    loss = l1_loss(pred, tb)
    loss.backward()
    return pred, loss, _grad_tree(net, lambda m: zinc_net_to_numpy(m)[0])


@pytest.mark.parametrize("aggs,scalers", [PRESET, PNA], ids=["preset", "pna"])
def test_bf16_zinc_net_matches_pallas(aggs, scalers):
    """A training forward of the bf16 ZincNet (batch statistics, dropout
    off): predictions, the loss, every gradient and the BatchNorm state it
    leaves, against the JAX bf16 ZincNet with ``use_pallas=True``, within
    1e-2 of each tensor's largest value. Held on another scale: the biases
    that feed a training BatchNorm (each conv's ``lin.b`` and post-NN
    biases; gradient 0 in exact arithmetic, rounding noise on both sides)
    on their conv's ``lin.w`` gradient, as ``tests/test_torch_zinc_net.py``
    holds them. For the PNA set each gradient also gets four times the
    port's own change when the node embedding table moves by one bf16 ulp
    (2^-8 of its values): std's ``1 / (2·sqrt(var + 1e-5))`` multiplies the
    rounding of ``E[x²] − E[x]²``, which bf16 squares make coarse, and at
    layer 0 every atom of a type shares one embedding, so ``var`` is near 0
    on many rows (there the JAX bf16 and float32 gradients of conv1's edge
    encoder bias lay 30% apart). Measured: at most 5.4e-3 (the preset's
    conv0 edge encoder bias); the PNA set within its allowance."""
    jnet, params, state, net, jb, tb = _net_pair(aggs, scalers)
    (jl, (jpred, jstate)), jgrads = _jax_loss(jnet, jb)(params, state)
    slack = None
    if "std" in aggs:
        nudged = copy.deepcopy(net)
        with torch.no_grad():
            nudged.node_emb.table.mul_(1.0 + 2.0 ** -8)
        g1 = _port_net_grads(nudged, tb)[2]
    pred, loss, got = _port_net_grads(net, tb)
    if "std" in aggs:
        slack = jax.tree.map(lambda a, b: 4 * np.abs(a - b).max(), got, g1)
    assert pred.dtype == torch.float32
    assert _scaled_err(pred.detach().numpy(), np.asarray(jpred)) < LAYER_TOL
    assert float(loss) == pytest.approx(float(jl), rel=LAYER_TOL)
    want = _np(jgrads)
    for i in range(SMALL_NET["num_layers"]):
        scale = np.abs(want[f"conv{i}"]["lin"]["w"]).max()
        allow = 0.0 if slack is None else max(_pop_bn_fed_biases(slack[f"conv{i}"]))
        got_b, want_b = (_pop_bn_fed_biases(t[f"conv{i}"]) for t in (got, want))
        for g, w in zip(got_b, want_b):
            assert np.abs(g - w).max() <= LAYER_TOL * scale + allow
    _hold_tree(got, want, "grad", slack=slack)
    _, got_state = zinc_net_to_numpy(net)
    for (path, w), g in zip(jax.tree_util.tree_flatten_with_path(_np(jstate))[0],
                            jax.tree.leaves(got_state)):
        assert _scaled_err(g, w) < LAYER_TOL, jax.tree_util.keystr(path)


def test_bf16_adam_steps_match_pallas():
    """3 Adam steps (lr 1e-3, weight decay 3e-4, dropout off) of the bf16
    ZincNet at the README preset against the JAX bf16 ZincNet's: the loss of
    every step within 1e-2; after 3 steps every parameter within 2·lr·steps
    (Adam moves each element by about lr a step whatever its gradient) and,
    where the step-1 gradient exceeds 1e-1 of its tensor's largest, within
    0.1·lr·steps; the detached pre-NNs (moved by weight decay alone) within
    1e-6; the BatchNorm state within 1e-2 of its largest value. Measured:
    the losses within 4.4e-6, the parameters within 0.011·lr·steps (0.0052
    where the gradient is sure), the pre-NNs within 4.5e-8, the state
    within 2.8e-5."""
    jnet, params, state, net, jb, tb = _net_pair(*PRESET, key=3)
    lr, wd, steps = 1e-3, 3e-4, 3
    opt = jax_make_optimizer(lr, wd)
    opt_state = opt.init(params)
    topt = make_optimizer(net.parameters(), lr, wd)
    step_fn = _jax_loss(jnet, jb)
    grads1 = None
    for step in range(steps):
        (jl, (_, state)), jg = step_fn(params, state)
        updates, opt_state = opt.update(jg, opt_state, params)
        params = optax.apply_updates(params, updates)
        tl = zinc_train_step(net, topt, tb, None)
        assert float(tl) == pytest.approx(float(jl), rel=LAYER_TOL), step
        if step == 0:
            grads1 = _np(jg)
    got, got_state = zinc_net_to_numpy(net)
    for (path, w), g, g1 in zip(jax.tree_util.tree_flatten_with_path(_np(params))[0],
                                jax.tree.leaves(got), jax.tree.leaves(grads1)):
        name = jax.tree_util.keystr(path)
        diff = np.abs(g - w)
        if "pre_nns" in name:
            assert diff.max() <= 1e-6, name
            continue
        sure = np.abs(g1) > 1e-1 * np.abs(g1).max()
        if name.endswith("['b']") and ("['lin']" in name or "post_nns" in name):
            sure[:] = False  # a BatchNorm-fed bias: rounding-noise gradient
        assert diff[sure].max(initial=0.0) <= 0.1 * lr * steps, name
        assert diff.max() <= 2 * lr * steps, name
    for (path, w), g in zip(jax.tree_util.tree_flatten_with_path(_np(state))[0],
                            jax.tree.leaves(got_state)):
        assert _scaled_err(g, w) < LAYER_TOL, jax.tree_util.keystr(path)


# ---------------------------------------------------------------- the CLI

@pytest.mark.parametrize("flags", [["--edge-format", "csr"], ["--edge-format", "ell", "--remat"]],
                         ids=["csr", "ell-remat"])
def test_bf16_cli_trains_one_epoch(flags, capsys):
    """``cli/train_zinc --compute-dtype bfloat16`` trains one epoch of a tiny
    subset on the CPU, on the plain collate and on the degree-exact one with
    ``--remat``, to a finite val MAE."""
    res = cli_train_zinc.main(["--device", "cpu", "--compute-dtype", "bfloat16", "--epochs", "1",
                               "--subset", "32", "--L", "1", "--tower", "1",
                               "--aggregators", "min,max", *flags])
    assert np.isfinite(res["val_mae"]) and np.isfinite(res["test_mae"])
    assert "Final: Val:" in capsys.readouterr().out
    assert all(conv.edge_dtype == torch.bfloat16 for name, conv in res["model"].named_children()
               if name.startswith("conv"))

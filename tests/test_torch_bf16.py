"""The bf16 edge pipeline (``compute_dtype="bfloat16"`` and ``"auto"``) of
node classification against the JAX package's Pallas path in interpret
mode (``use_pallas=True``), on the CPU.

The JAX XLA path is no reference here: it sums the bf16 SpMM rows in bf16
(``mma_tpu/ops/spmm.py:133-142``), where the Pallas path and the port sum
in float32.

- **Kernel modules**, on identical bf16 inputs (bf16-representable values
  fed to both sides): kernel 1's plain version against ``fused_segment_sum``
  on bf16 data, and kernels 2-3's against ``fused_mma_edge_program_lean``
  and its ``jax.vjp`` with a bf16 ``h``, on a random graph, a 3,000-edge row
  and the skewed graph (a 320-edge row, runs of empty rows, padding edges).
  Every product of two bf16 values is exact in float32, and the port
  rounds where the JAX kernel's one-pass contraction rounds (the message;
  ``ct`` and ``dlog``), so the two sides differ by the order of float32
  sums alone: relative 1e-5, with a floor of 1e-5 of the tensor's largest
  value. The JAX VJP returns ``dh`` in ``h``'s dtype, bf16: against it the
  port's float32 ``dh`` is held within half a bf16 ulp (2^-8 of the value)
  on top of that floor.
- **Layers and the model** at bf16 level, 1e-2 of each tensor's largest
  value: both frameworks round ``c = h @ W_top``, the SpMM operands and the
  half-fused route's element-wise chain to bf16, but XLA may keep float32
  inside a fused chain where PyTorch rounds after each op, and a bf16
  product of another summation order can round the other way. Each test
  states the largest error it measured.
- **``"auto"``**: float32 on ``cuda`` and ``cpu`` (``mma_tpu/autotune.py``'s
  rule), bit for bit the float32 layer.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from mma_tpu.autotune import resolve_compute_dtype as jax_resolve_compute_dtype
from mma_tpu.graph.build import graph_from_edges as jax_graph_from_edges
from mma_tpu.models import NodeClassifier as JaxNodeClassifier
from mma_tpu.nn.gcn import GraphConvolution as JaxGraphConvolution
from mma_tpu.nn.mma_layer import MMALayer as JaxMMALayer
from mma_tpu.ops.aggregators import get_agg_spec as jax_get_agg_spec
from mma_tpu.ops.masked_aggregate import _sigmoid_lane_pattern as jax_lane_pattern
from mma_tpu.ops.pallas.fused_mma import fused_mma_edge_program_lean, fused_segment_sum

from mma_tpu_torch import GraphConvolution, MMALayer, NodeClassifier, graph_from_edges
from mma_tpu_torch.autotune import resolve_compute_dtype, torch_compute_dtype
from mma_tpu_torch.convert import node_classifier_from_jax
from mma_tpu_torch.ops import binary_spmm, get_agg_spec, masked_multi_aggregate
from mma_tpu_torch.ops.cuda import fused_mma
from mma_tpu_torch.ops.masked_aggregate import sigmoid_lane_pattern

KERNEL_TOL = 1e-5
LAYER_TOL = 1e-2


def _bf16_values(a):
    """``a`` rounded to bf16, as float32 numpy: the same values both sides take."""
    return np.array(jnp.asarray(a, jnp.bfloat16).astype(jnp.float32))


def _rel_err(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.abs(got - want).max() / (np.abs(want).max() + 1e-30)


def _close(got, want, tol=KERNEL_TOL, err_msg=""):
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(np.asarray(got, np.float32), want, rtol=tol,
                               atol=tol * np.abs(want).max(), err_msg=err_msg)


# ------------------------------------------------------------- kernel graphs

def _random():
    """300 nodes, 2,400 random edges, the last 40 nodes without in-edges."""
    rs = np.random.RandomState(0)
    n = 300
    src = rs.randint(0, n, 2400).astype(np.int32)
    dst = rs.randint(0, n - 40, 2400).astype(np.int32)
    return jax_graph_from_edges(src, dst, n), graph_from_edges(src, dst, n, device="cpu"), n


def _hub():
    """300 nodes: node 0 takes a 3,000-edge row, the last 40 no edges."""
    rs = np.random.RandomState(5)
    n = 300
    src = rs.randint(0, n, 5400).astype(np.int32)
    dst = np.concatenate([np.zeros(3000, np.int32), rs.randint(1, n - 40, 2400)]).astype(np.int32)
    return jax_graph_from_edges(src, dst, n), graph_from_edges(src, dst, n, device="cpu"), n


def _skewed():
    """``tests/test_torch_wide_program.py``'s skewed graph: 400 nodes, node 5
    the destination of a 320-edge row, rows 100-159 and the last 30 empty,
    and 70 padding edges past the real ones."""
    rs = np.random.RandomState(21)
    n = 400
    live = np.setdiff1d(np.arange(n - 30), np.r_[5, 100:160])
    dst = np.concatenate([np.full(320, 5), rs.choice(live, 2000)]).astype(np.int32)
    src = rs.randint(0, n, dst.shape[0]).astype(np.int32)
    n_edge = dst.shape[0] + 70
    jg = jax_graph_from_edges(src, dst, n, n_edge_pad=n_edge)
    tg = graph_from_edges(src, dst, n, n_node_pad=jg.n_node, n_edge_pad=n_edge, device="cpu")
    return jg, tg, n


KERNEL_GRAPHS = {"random": _random, "hub": _hub, "skewed": _skewed}


@pytest.fixture(scope="module")
def kernel_graphs():
    return {name: make() for name, make in KERNEL_GRAPHS.items()}


# ------------------------------------------------------------------ kernel 1

@pytest.mark.parametrize("which", list(KERNEL_GRAPHS))
@pytest.mark.parametrize("ch", [16, 7])
def test_bf16_segment_sum_matches_pallas(kernel_graphs, which, ch):
    """Kernel 1's plain version on bf16 rows (``C % 4 == 0`` and not, as the
    card's 4-lane and scalar loads), edge rows and rows read through the
    index, against ``fused_segment_sum`` on the same bf16 rows (one exact
    pass); the VJP gives ``ct[dst]`` in bf16 on the real edges, as the JAX
    VJP casts it."""
    jg, tg, n = kernel_graphs[which]
    rs = np.random.RandomState(7)
    data = _bf16_values(rs.randn(jg.n_edge, ch) * 3)
    data[~np.asarray(jg.edge_mask)] = 0.0
    jdata = jnp.asarray(data, jnp.bfloat16)
    want = np.asarray(fused_segment_sum(jdata, jg))
    tdata = torch.from_numpy(data).bfloat16()
    got = fused_mma.segment_sum_reference(tdata, tg.real_row_ptr)
    assert got.dtype == torch.float32
    _close(got.numpy()[:n], want[:n])
    # Through the wrapper, CPU tensors take the same plain version.
    np.testing.assert_array_equal(fused_mma.segment_sum_csr(tdata, tg.real_row_ptr).numpy(),
                                  got.numpy())

    # The SpMM form: node rows read through src.
    table = _bf16_values(rs.randn(jg.n_node, ch))
    table[n:] = 0.0
    want_ix = np.asarray(fused_segment_sum(jnp.asarray(table, jnp.bfloat16)[jg.src], jg))
    got_ix = fused_mma.segment_sum_csr(torch.from_numpy(table).bfloat16(), tg.real_row_ptr,
                                       index=tg.src)
    _close(got_ix.numpy()[:n], want_ix[:n])

    ct = rs.randn(jg.n_node, ch).astype(np.float32)
    _, vjp = jax.vjp(lambda d: fused_segment_sum(d, jg), jdata)
    (jct,) = vjp(jnp.asarray(ct))
    leaf = tdata.clone().requires_grad_()
    fused_mma.segment_sum_csr(leaf, tg.real_row_ptr).backward(torch.from_numpy(ct))
    assert leaf.grad.dtype == torch.bfloat16
    real = np.asarray(jg.edge_mask)
    np.testing.assert_array_equal(leaf.grad.float().numpy()[real],
                                  np.asarray(jct.astype(jnp.float32))[real])


# -------------------------------------------------------------- kernels 2, 3

def _lean_inputs(jg, n, f, k, seed=3):
    rs = np.random.RandomState(seed)
    h = _bf16_values(rs.randn(jg.n_node, f))
    c = _bf16_values(rs.randn(jg.n_node, k * f))
    w_bot = _bf16_values(rs.randn(f, k * f) / np.sqrt(f))
    ct = rs.randn(jg.n_node, k * f).astype(np.float32)
    ct[n:] = 0.0  # padding rows: the Pallas forward sums the padding edges there
    return h, c, w_bot, ct


@pytest.mark.parametrize("which", list(KERNEL_GRAPHS))
def test_bf16_edge_program_lean_matches_pallas(kernel_graphs, which):
    """Kernels 2-3's plain versions with a bf16 ``h`` against the Pallas lean
    program and its VJP (one-pass contractions), on the mixed sigmoid / raw
    lanes of ("mean", "max"): ``S``, ``dc`` and ``dW_bot`` at 1e-5, ``dh``
    at 1e-5 plus half a bf16 ulp (the JAX VJP rounds it to bf16). Through
    the autograd Function the gradients come back in the inputs' dtypes."""
    jg, tg, n = kernel_graphs[which]
    aggs, f = ("mean", "max"), 16
    k = len(aggs)
    h, c, w_bot, ct = _lean_inputs(jg, n, f, k)
    jpat = jax_lane_pattern([jax_get_agg_spec(a) for a in aggs], "new_sigmoid", True, f)
    pat = sigmoid_lane_pattern([get_agg_spec(a) for a in aggs], "new_sigmoid", True, f, "cpu")

    jargs = (jnp.asarray(c), jnp.asarray(w_bot), jnp.asarray(h, jnp.bfloat16))
    want_s, vjp = jax.vjp(
        lambda c_, w_, h_: fused_mma_edge_program_lean(c_, w_, h_, jpat, jg, k), *jargs)
    jdc, jdw, jdh = vjp(jnp.asarray(ct))
    assert jdh.dtype == jnp.bfloat16

    th = torch.from_numpy(h).bfloat16()
    tc, tw, tct = torch.from_numpy(c), torch.from_numpy(w_bot), torch.from_numpy(ct)
    fwd_args = (tc, tw, th, pat, tg.src, tg.real_row_ptr)
    s = fused_mma.edge_program_lean_reference(*fwd_args)
    _close(s.numpy()[:n], np.asarray(want_s)[:n], err_msg="S")
    dc, dw, dh = fused_mma.edge_program_lean_bwd_reference(
        *fwd_args, tg.real_col_ptr, tg.dst_csc, tct)
    assert dh.dtype == torch.float32
    _close(dc.numpy()[:n], np.asarray(jdc)[:n], err_msg="dc")
    _close(dw.numpy(), np.asarray(jdw), err_msg="dW_bot")
    jdh32 = np.asarray(jdh.astype(jnp.float32))[:n]
    np.testing.assert_allclose(dh.numpy()[:n], jdh32, rtol=2.0 ** -8,
                               atol=KERNEL_TOL * np.abs(jdh32).max(), err_msg="dh")

    # The autograd Function: the same values, each gradient in its input's dtype.
    leaves = [t.clone().requires_grad_() for t in (tc, tw, th)]
    out = fused_mma.edge_program_lean(*leaves, pat, tg.src, tg.real_row_ptr, tg.real_col_ptr,
                                      tg.dst_csc)
    np.testing.assert_array_equal(out.detach().numpy(), s.numpy())
    out.backward(tct)
    assert [t.grad.dtype for t in leaves] == [torch.float32, torch.float32, torch.bfloat16]
    np.testing.assert_array_equal(leaves[0].grad.numpy(), dc.numpy())
    np.testing.assert_array_equal(leaves[2].grad.float().numpy(), dh.bfloat16().float().numpy())


def test_bf16_messages_round_where_the_jax_kernel_rounds(kernel_graphs):
    """Without the bf16 rounding of each message the port's sum would miss
    the JAX kernel's by far more than 1e-5: the rounding point is part of
    the function, not noise."""
    jg, tg, n = kernel_graphs["random"]
    aggs, f = ("mean", "max"), 16
    h, c, w_bot, _ = _lean_inputs(jg, n, f, 2)
    jpat = jax_lane_pattern([jax_get_agg_spec(a) for a in aggs], "new_sigmoid", True, f)
    pat = sigmoid_lane_pattern([get_agg_spec(a) for a in aggs], "new_sigmoid", True, f, "cpu")
    want = np.asarray(fused_mma_edge_program_lean(
        jnp.asarray(c), jnp.asarray(w_bot), jnp.asarray(h, jnp.bfloat16), jpat, jg, 2))[:n]
    # The same messages in float32, unrounded.
    unrounded = fused_mma.edge_program_lean_reference(
        torch.from_numpy(c), torch.from_numpy(w_bot), torch.from_numpy(h), pat, tg.src,
        tg.real_row_ptr).numpy()[:n]
    assert _rel_err(unrounded, want) > 100 * KERNEL_TOL


# ------------------------------------------------------ layers and the model

@pytest.fixture(scope="module")
def small():
    """``tests/test_torch_node_classifier.py``'s graph: 200 nodes, 1,600
    edges, 20 nodes without in-edges."""
    rs = np.random.RandomState(0)
    n = 200
    src = rs.randint(0, n, 1600).astype(np.int32)
    dst = rs.randint(0, n - 20, 1600).astype(np.int32)
    jg = jax_graph_from_edges(src, dst, n)
    tg = graph_from_edges(src, dst, n, device="cpu")
    x = rs.randn(jg.n_node, 24).astype(np.float32)
    return jg, tg, x, n


def _load(module, params):
    with torch.no_grad():
        for name, value in params.items():
            getattr(module, name).copy_(torch.tensor(np.asarray(value)))


def _layer_case(jlayer, tlayer, x, jg, tg, n, seed):
    """Forward and the gradients of ``Σ out ⊙ g`` over the real rows, with
    respect to every parameter and the input, from both packages."""
    g = np.random.RandomState(seed).randn(jg.n_node, jlayer.out_features).astype(np.float32)
    g[n:] = 0.0
    params = jlayer.init(jax.random.PRNGKey(seed))

    def jloss(p, xx):
        out = jlayer.apply(p, xx, jg, use_pallas=True)
        return jnp.sum(out * g), out

    (_, jout), (jgp, jgx) = jax.value_and_grad(jloss, argnums=(0, 1), has_aux=True)(
        params, jnp.asarray(x))
    _load(tlayer, jax.tree.map(np.asarray, params))
    tx = torch.from_numpy(np.ascontiguousarray(x)).requires_grad_()
    out = tlayer(tx, tg)
    (out * torch.from_numpy(g)).sum().backward()
    got = {"out": (out.detach().numpy()[:n], np.asarray(jout)[:n]),
           "x": (tx.grad.numpy()[:n], np.asarray(jgx)[:n])}
    for name, p in tlayer.named_parameters():
        got[name] = (p.grad.numpy(), np.asarray(jgp[name]))
    return got


def _assert_layer_close(got, tol=LAYER_TOL):
    for name, (a, b) in got.items():
        assert np.isfinite(a).all(), name
        assert _rel_err(a, b) < tol, (name, _rel_err(a, b))


def test_bf16_graph_convolution_matches_pallas(small):
    """Measured: the forward bit for bit (bf16 rows summed in float32 in CSR
    order on both sides), gradients within 3.2e-5 of their scale."""
    jg, tg, x, n = small
    got = _layer_case(JaxGraphConvolution(24, 16, compute_dtype="bfloat16"),
                      GraphConvolution(24, 16, compute_dtype="bfloat16", device="cpu"),
                      x, jg, tg, n, seed=0)
    _assert_layer_close(got)


@pytest.mark.parametrize("aggs,parity", [
    (("mean", "mean2"), True),  # the lean route: kernels 2-3
    (("sum", "max", "min", "softmax"), True),  # mixed sigmoid and raw lanes
    (("mean", "std"), False),  # the half-fused route: bf16 messages, kernel 1
])
def test_bf16_mma_layer_matches_pallas(small, aggs, parity):
    """``MMALayer`` in bf16, forward and gradients, on the lean route and, with
    ``std``, the half-fused one (dropout off). Measured: outputs within
    4.2e-15, gradients within 1.6e-3 of their scale on the lean route and
    3.6e-3 (the masks) on the half-fused one."""
    jg, tg, x, n = small
    got = _layer_case(
        JaxMMALayer(16, 8, aggs, parity=parity, compute_dtype="bfloat16"),
        MMALayer(16, 8, aggs, parity=parity, compute_dtype="bfloat16", device="cpu"),
        np.ascontiguousarray(x[:, :16]), jg, tg, n, seed=1)
    _assert_layer_close(got)


def test_bf16_node_classifier_matches_pallas(small):
    """``NodeClassifier`` in bf16: the eval forward and every parameter
    gradient of the NLL. Measured: log-probs within 4.0e-10, gradients
    within 1.4e-4 of their scale."""
    jg, tg, x, n = small
    labels = np.random.RandomState(4).randint(0, 5, n)
    jmodel = JaxNodeClassifier(n_feat=24, n_hidden=16, n_class=5, aggregators=("mean", "mean2"),
                               dropout_rate=0.0, compute_dtype="bfloat16")
    params = jmodel.init(jax.random.PRNGKey(2))

    def jloss(p):
        logp = jmodel.apply(p, jnp.asarray(x), jg, use_pallas=True)
        return -jnp.mean(logp[jnp.arange(n), labels]), logp

    (_, jlogp), jgrads = jax.value_and_grad(jloss, has_aux=True)(params)
    model = NodeClassifier(24, 16, 5, ("mean", "mean2"), dropout_rate=0.0,
                           compute_dtype="bfloat16", device="cpu")
    node_classifier_from_jax(jax.tree.map(np.asarray, params), model)
    logp = model(torch.from_numpy(x), tg)
    (-logp[torch.arange(n), torch.from_numpy(labels)].mean()).backward()
    assert logp.dtype == torch.float32
    assert _rel_err(logp.detach().numpy()[:n], np.asarray(jlogp)[:n]) < LAYER_TOL
    for layer in ("gc1", "mma"):
        for p, want in jgrads[layer].items():
            grad = getattr(getattr(model, layer), p).grad
            assert grad.dtype == torch.float32
            assert _rel_err(grad.numpy(), want) < LAYER_TOL, f"{layer}.{p}"


def test_bf16_binary_spmm_sums_in_float32(small):
    """A bf16 SpMM operand is summed in float32 (the XLA path's bf16 sum is
    not the function) and its gradient comes back as bf16."""
    jg, tg, x, n = small
    xb = torch.from_numpy(x[:, :16]).bfloat16().requires_grad_()
    out = binary_spmm(tg, xb)
    assert out.dtype == torch.float32
    want = binary_spmm(tg, xb.detach().float())
    torch.testing.assert_close(out, want, rtol=1e-6, atol=1e-6)
    out.sum().backward()
    assert xb.grad.dtype == torch.bfloat16


def test_bf16_routes_of_masked_multi_aggregate(small):
    """The lean and half-fused routes in bf16 compute the same function up
    to the half-fused route's bf16 logits and masks (1e-2); with mask
    dropout the half-fused route keeps its bf16 messages and runs."""
    _, tg, x, n = small
    h = torch.from_numpy(np.ascontiguousarray(x[:, :8]))
    mw = torch.from_numpy(np.random.RandomState(6).randn(2, 16, 8).astype(np.float32) / 3)
    specs = [get_agg_spec(a) for a in ("mean", "mean2")]
    lean = masked_multi_aggregate(h, tg, mw, specs, compute_dtype=torch.bfloat16)
    half = masked_multi_aggregate(h, tg, mw, specs, compute_dtype=torch.bfloat16,
                                  mask_dropout_rate=0.0, generator=torch.Generator())
    torch.testing.assert_close(half, lean, rtol=0, atol=0)  # rate 0 keeps the lean route
    f32 = masked_multi_aggregate(h, tg, mw, specs)
    assert _rel_err(lean.numpy()[:n], f32.numpy()[:n]) < LAYER_TOL
    drop = masked_multi_aggregate(h, tg, mw, specs, compute_dtype=torch.bfloat16,
                                  mask_dropout_rate=0.5, generator=torch.Generator().manual_seed(0))
    assert drop.dtype == torch.float32 and torch.isfinite(drop[:n]).all()


# --------------------------------------------------------------------- auto

@pytest.mark.parametrize("platform", [None, "cuda", "cpu", torch.device("cuda"),
                                      torch.device("cpu")])
def test_resolve_compute_dtype_rules(platform):
    """The JAX package's rules (``tests/test_autotune.py:18-29``): ``auto`` is
    bfloat16 on a TPU only; explicit names pass through on any platform;
    an unknown name raises."""
    assert resolve_compute_dtype("auto", "tpu") == jax_resolve_compute_dtype("auto", "tpu")
    assert resolve_compute_dtype("auto", platform) == "float32"
    assert torch_compute_dtype("auto", platform) == torch.float32
    assert resolve_compute_dtype("float32", "tpu") == "float32"
    assert resolve_compute_dtype("bfloat16", platform) == "bfloat16"
    assert torch_compute_dtype("bfloat16", platform) == torch.bfloat16
    with pytest.raises(ValueError, match="compute_dtype"):
        resolve_compute_dtype("float16", platform)
    with pytest.raises(ValueError, match="compute_dtype"):
        MMALayer(8, 8, ("mean",), compute_dtype="fp32", device="cpu")


def test_auto_is_float32_bit_for_bit(small):
    """``"auto"`` on the CPU is the float32 layer and model, bit for bit, as
    ``tests/test_autotune.py:39-49`` holds it for the JAX package."""
    _, tg, x, n = small
    torch.manual_seed(0)
    la = MMALayer(16, 8, ("mean", "mean2"), compute_dtype="auto", device="cpu")
    lf = MMALayer(16, 8, ("mean", "mean2"), compute_dtype="float32", device="cpu")
    lf.load_state_dict(la.state_dict())
    assert la.edge_dtype == torch.float32
    h = torch.from_numpy(np.ascontiguousarray(x[:, :16]))
    torch.testing.assert_close(la(h, tg), lf(h, tg), rtol=0, atol=0)
    ma = NodeClassifier(24, 16, 5, ("mean", "mean2"), compute_dtype="auto", device="cpu")
    mf = NodeClassifier(24, 16, 5, ("mean", "mean2"), compute_dtype="float32", device="cpu")
    mf.load_state_dict(ma.state_dict())
    tx = torch.from_numpy(x)
    torch.testing.assert_close(ma(tx, tg), mf(tx, tg), rtol=0, atol=0)
    # The training forward (dropout on) draws the same masks too.
    out_a = ma(tx, tg, training=True, generator=torch.Generator().manual_seed(3))
    out_f = mf(tx, tg, training=True, generator=torch.Generator().manual_seed(3))
    torch.testing.assert_close(out_a, out_f, rtol=0, atol=0)

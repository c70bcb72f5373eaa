"""The CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs an NVIDIA GPU and ``nvcc`` and skips elsewhere. This
file imports neither JAX nor ``mma_tpu``, so it also runs on a machine
without them, past the repository's JAX-importing ``conftest.py``:

    python -m pytest --noconftest -m gpu tests/test_torch_cuda_kernels.py
"""

import numpy as np
import pytest
import torch

from mma_tpu_torch.graph import graph_from_edges
from mma_tpu_torch.ops import get_agg_spec
from mma_tpu_torch.ops.cuda import fused_mma
from mma_tpu_torch.ops.masked_aggregate import sigmoid_lane_pattern

pytestmark = pytest.mark.gpu


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc")
    torch.backends.cuda.matmul.allow_tf32 = False  # f32 parity of h @ W_bot
    return torch.device("cuda")


@pytest.fixture(scope="module")
def graph(cuda):
    """300 nodes, the last 40 without in-edges (empty rows), a few hubs."""
    rs = np.random.RandomState(0)
    n = 300
    src = rs.randint(0, n, 4000).astype(np.int32)
    dst = np.concatenate([rs.randint(0, n - 40, 3400), rs.randint(0, 3, 600)]).astype(np.int32)
    return graph_from_edges(src, dst, n, device=cuda)


def _close(got, want):
    """f32 sums in another order: within 1e-5 of the largest magnitude."""
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5 * want.abs().max().item())


@pytest.mark.parametrize("channels", [64, 16, 7, 200, 130])
def test_segment_sum_kernel_matches_plain(cuda, graph, channels):
    rs = np.random.RandomState(3)
    data = torch.from_numpy(rs.randn(graph.n_edge, channels).astype(np.float32)).to(cuda)
    before = fused_mma.LAUNCHES["segment_sum"]
    got = fused_mma.segment_sum_csr(data, graph.row_ptr)
    torch.cuda.synchronize()
    assert fused_mma.LAUNCHES["segment_sum"] == before + 1
    _close(got, fused_mma.segment_sum_reference(data, graph.row_ptr))
    assert torch.equal(got, fused_mma.segment_sum_csr(data, graph.row_ptr))  # deterministic
    assert (got[260:300] == 0).all()


@pytest.mark.parametrize("f,aggs", [(12, ("mean", "max", "sum")), (16, ("mean", "max")),
                                    (64, ("mean", "mean2")),
                                    (128, ("sum", "max", "min", "mean"))])
def test_edge_program_kernel_matches_plain(cuda, graph, f, aggs):
    rs = np.random.RandomState(1)
    k = len(aggs)
    h = torch.from_numpy(rs.randn(graph.n_node, f).astype(np.float32)).to(cuda)
    c = torch.from_numpy(rs.randn(graph.n_node, k * f).astype(np.float32)).to(cuda)
    w_bot = torch.from_numpy((rs.randn(f, k * f) / np.sqrt(f)).astype(np.float32)).to(cuda)
    pat = sigmoid_lane_pattern([get_agg_spec(a) for a in aggs], "new_sigmoid", True, f, cuda)
    args = (c, w_bot, h, pat, graph.src, graph.row_ptr)
    csc = (graph.col_ptr, graph.dst_csc)
    before = fused_mma.LAUNCHES["edge_program_lean"]
    got = fused_mma.edge_program_lean(*args, *csc)
    torch.cuda.synchronize()
    assert fused_mma.LAUNCHES["edge_program_lean"] == before + 1
    _close(got, fused_mma.edge_program_lean_reference(*args))
    assert torch.equal(got, fused_mma.edge_program_lean(*args, *csc))  # deterministic
    assert (got[260:300] == 0).all()


def test_kernels_reject_what_they_do_not_take(cuda, graph):
    data = torch.zeros(graph.n_edge, 8, device=cuda)
    with pytest.raises(ValueError, match="float32"):
        fused_mma.segment_sum_csr(data.double(), graph.row_ptr)
    with pytest.raises(ValueError, match="contiguous"):
        fused_mma.segment_sum_csr(data.t(), graph.row_ptr)
    with pytest.raises(ValueError, match="not differentiable"):
        fused_mma.segment_sum_csr(data.requires_grad_(), graph.real_col_ptr,
                                  index=graph.src_perm)
    f = 132  # above the kernel's F limit
    h = torch.zeros(graph.n_node, f, device=cuda)
    with pytest.raises(ValueError, match="F <= 128"):
        fused_mma.edge_program_lean(torch.zeros(graph.n_node, f, device=cuda),
                                    torch.zeros(f, f, device=cuda), h,
                                    torch.zeros(f, device=cuda), graph.src, graph.row_ptr,
                                    graph.col_ptr, graph.dst_csc)


def test_node_classifier_on_card_matches_cpu(cuda, graph):
    """The whole eval forward through both kernels against the CPU's plain path."""
    from mma_tpu_torch import NodeClassifier

    model = NodeClassifier(24, 64, 5, ("mean", "max"), device=cuda,
                           generator=torch.Generator().manual_seed(0))
    cpu_model = NodeClassifier(24, 64, 5, ("mean", "max"), device="cpu")
    cpu_model.load_state_dict({k: v.cpu() for k, v in model.state_dict().items()})
    x = torch.randn((graph.n_node, 24), generator=torch.Generator().manual_seed(1))
    before = dict(fused_mma.LAUNCHES)
    with torch.no_grad():
        got = model(x.to(cuda), graph)
        want = cpu_model(x, graph.to("cpu"))
    assert fused_mma.LAUNCHES["segment_sum"] == before["segment_sum"] + 2
    assert fused_mma.LAUNCHES["edge_program_lean"] == before["edge_program_lean"] + 1
    _close(got[:300].cpu(), want[:300])


@pytest.mark.parametrize("channels", [64, 16, 7])
def test_segment_sum_kernel_with_index_matches_plain(cuda, graph, channels):
    """The indexed uses: the CSC with ``index=dst_csc`` over a node table
    (binary_spmm's backward) and with ``index=src_perm`` over edge rows (the
    by-source reduce)."""
    rs = np.random.RandomState(4)
    nodes = torch.from_numpy(rs.randn(graph.n_node, channels).astype(np.float32)).to(cuda)
    edges = torch.from_numpy(rs.randn(graph.n_edge, channels).astype(np.float32)).to(cuda)
    for data, index in ((nodes, graph.dst_csc), (edges, graph.src_perm), (nodes, graph.src)):
        row_ptr = graph.real_row_ptr if index is graph.src else graph.real_col_ptr
        before = fused_mma.LAUNCHES["segment_sum"]
        got = fused_mma.segment_sum_csr(data, row_ptr, index)
        torch.cuda.synchronize()
        assert fused_mma.LAUNCHES["segment_sum"] == before + 1
        _close(got, fused_mma.segment_sum_reference(data, row_ptr, index))
        assert torch.equal(got, fused_mma.segment_sum_csr(data, row_ptr, index))


@pytest.fixture(scope="module")
def chunk_graph(cuda):
    """CSRs that exercise kernel 1's edge chunks, as ``name -> (row_ptr,
    n_edges)``. Below 8,192 · 16 edges a chunk holds 16 edge positions;
    rows of at most 64 edges stay whole, longer ones are split."""
    rs = np.random.RandomState(7)
    # Rows 0-1 empty, row 2 a 3,000-edge hub over 188 chunks, rows 4-5 empty
    # at 3,008 = 188 · 16, row 6 starting on that chunk boundary, row 7 (100
    # edges) split across boundaries, row 8 (60) whole across them, then
    # short rows with empty ones among them, and 30 empty rows at the end.
    deg = np.concatenate([[0, 0, 3000, 8, 0, 0, 24, 100, 60],
                          rs.randint(0, 6, 400) * (rs.rand(400) > 0.2), np.zeros(30, int)])
    row_ptr = np.concatenate([[0], np.cumsum(deg)]).astype(np.int32)
    n_edges = int(row_ptr[-1]) + 50  # padding edge positions no row covers
    assert row_ptr[6] == 3008 and deg[6] > 0
    return {
        "hub": (row_ptr, n_edges),
        "slice row_ptr[0] > 0": (row_ptr[5:300], n_edges),
        "hub alone": (row_ptr[2:4], n_edges),
        "smaller than a chunk": (np.array([0, 3, 3, 7, 7], np.int32), 10),
        "covers no edge": (np.array([5, 5, 5, 5], np.int32), 64),
        # Row 700 alone has edges, 3,000 from position 100 on: the 700 empty
        # rows before it and the 1,299 after it each start at one position.
        "hub among empty rows": (np.repeat(np.array([100, 3100], np.int32), [701, 1300]), 3200),
    }


@pytest.mark.parametrize("indexed", [False, True])
@pytest.mark.parametrize("channels", [7, 16, 64, 128, 192, 200, 375, 640])
def test_segment_sum_chunks_match_plain(cuda, chunk_graph, channels, indexed):
    """Kernel 1's two passes against the plain version within 1e-5, over a
    row split across many chunks, a row on a chunk boundary, empty rows
    inside and at both ends, a CSR slice, a graph under one chunk, a CSR
    that covers nothing and one row among long runs of empty rows; one
    launch counted a call, bitwise equal run to run, empty rows 0. C=7 and 375 take scalar loads, 192 three 16-lane
    slots, 640 two rounds over each row's edges."""
    rs = np.random.RandomState(channels)
    for what, (rp_np, n_edges) in chunk_graph.items():
        rp = torch.from_numpy(rp_np).to(cuda)
        if indexed:
            data = torch.from_numpy(rs.randn(97, channels).astype(np.float32)).to(cuda)
            index = torch.from_numpy(rs.randint(0, 97, n_edges).astype(np.int32)).to(cuda)
        else:
            data = torch.from_numpy(rs.randn(n_edges, channels).astype(np.float32)).to(cuda)
            index = None
        before = fused_mma.LAUNCHES["segment_sum"]
        got = fused_mma.segment_sum_csr(data, rp, index)
        torch.cuda.synchronize()
        assert fused_mma.LAUNCHES["segment_sum"] == before + 1, what
        want = fused_mma.segment_sum_reference(data, rp, index)
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5 * want.abs().max().item(),
                                   msg=what)
        assert torch.equal(got, fused_mma.segment_sum_csr(data, rp, index)), what
        empty = torch.from_numpy(rp_np[1:] == rp_np[:-1]).to(cuda)
        assert (got[empty] == 0).all(), what


def test_segment_sum_replays_in_a_cuda_graph(cuda, chunk_graph):
    """One kernel-1 call captured in a CUDA graph and replayed gives the
    eager result: the wrapper sizes its grid and scratch from shapes and
    never reads ``row_ptr`` on the host."""
    rp_np, n_edges = chunk_graph["hub"]
    rp = torch.from_numpy(rp_np).to(cuda)
    rs = np.random.RandomState(11)
    data = torch.from_numpy(rs.randn(97, 64).astype(np.float32)).to(cuda)
    index = torch.from_numpy(rs.randint(0, 97, n_edges).astype(np.int32)).to(cuda)
    eager = fused_mma.segment_sum_csr(data, rp, index)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fused_mma.segment_sum_csr(data, rp, index)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        captured = fused_mma.segment_sum_csr(data, rp, index)
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(captured, eager)


def _lean_inputs(cuda, rs, n, n_edges, f, kf):
    """Kernel 2's inputs on ``n`` nodes: ``(c, w_bot, h, pattern, src)``,
    the pattern's lanes sigmoid or the identity at random."""
    def draw(*shape, scale=1.0):
        return torch.from_numpy((rs.randn(*shape) * scale).astype(np.float32)).to(cuda)

    pat = torch.from_numpy((rs.rand(kf) > 0.5).astype(np.float32)).to(cuda)
    src = torch.from_numpy(rs.randint(0, n, n_edges).astype(np.int32)).to(cuda)
    return draw(n, kf), draw(f, kf, scale=f ** -0.5), draw(n, f), pat, src


def _lean_f64(c, w_bot, h, pattern, src, row_ptr):
    """``edge_program_lean_reference``'s formula in float64. The float32
    plain version is itself up to 1.8e-5 off on the "hub alone" CSR (3,000
    edges from two source rows: its running sum adds the same few terms
    over and over, and they round alike), so the kernel is held against
    the exact sum."""
    f, kf = w_bot.shape
    ids = fused_mma._row_ids(row_ptr)
    lo, hi = int(row_ptr[0]), int(row_ptr[-1])
    h_src = h.double()[src[lo:hi].long()]
    mask, _ = fused_mma._mask_chain(c.double()[ids] + h_src @ w_bot.double(), pattern)
    out = torch.zeros((c.shape[0], kf), dtype=torch.float64, device=c.device)
    return out.index_add_(0, ids, mask * h_src.repeat(1, kf // f))


@pytest.mark.parametrize("f,kf", [(16, 32), (16, 384), (16, 512), (64, 128), (64, 384),
                                  (64, 512), (128, 256), (128, 384), (128, 512)])
def test_edge_program_lean_chunks_match_plain(cuda, chunk_graph, f, kf):
    """Kernel 2 (the node pass, then kernel 1's chunk pass and fixup with
    the lean message) against its plain version's formula (in float64,
    ``_lean_f64``) within 1e-5 over kernel 1's chunk cases: a row split
    over many chunks, a row on a chunk boundary, empty rows inside and at
    both ends, a CSR slice, a graph under one chunk, a CSR that covers
    nothing and one row among long runs of empty rows. One launch counted
    a call, bitwise equal run to run, empty rows 0. K·F = 384 and 512 take
    two rounds over each row's edges. The node pass matches ``h @ W_bot``."""
    rs = np.random.RandomState(f + kf)
    for what, (rp_np, n_edges) in chunk_graph.items():
        n = len(rp_np) - 1
        rp = torch.from_numpy(rp_np).to(cuda)
        c, w_bot, h, pat, src = _lean_inputs(cuda, rs, n, n_edges, f, kf)
        args = (c, w_bot, h, pat, src, rp)
        before = fused_mma.LAUNCHES["edge_program_lean"]
        got = fused_mma.edge_program_lean(*args, rp, src)  # the CSC is the backward's
        torch.cuda.synchronize()
        assert fused_mma.LAUNCHES["edge_program_lean"] == before + 1, what
        want = _lean_f64(*args)
        torch.testing.assert_close(got.double(), want, rtol=1e-5,
                                   atol=1e-5 * want.abs().max().item(), msg=what)
        assert torch.equal(got, fused_mma.edge_program_lean(*args, rp, src)), what
        empty = torch.from_numpy(rp_np[1:] == rp_np[:-1]).to(cuda)
        assert (got[empty] == 0).all(), what

        _close(fused_mma._lean_node_pass(h, w_bot), h @ w_bot)


def test_edge_program_lean_replays_in_a_cuda_graph(cuda, chunk_graph):
    """One kernel-2 call (three launches) captured in a CUDA graph and
    replayed gives the eager result: the wrapper sizes its grids and
    scratch from shapes and never reads ``row_ptr`` on the host."""
    rp_np, n_edges = chunk_graph["hub"]
    rp = torch.from_numpy(rp_np).to(cuda)
    c, w_bot, h, pat, src = _lean_inputs(cuda, np.random.RandomState(12), len(rp_np) - 1,
                                         n_edges, 64, 128)
    args = (c, w_bot, h, pat, src, rp, rp, src)
    eager = fused_mma.edge_program_lean(*args)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fused_mma.edge_program_lean(*args)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        captured = fused_mma.edge_program_lean(*args)
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(captured, eager)


def test_edge_program_lean_alignment(cuda, graph):
    """Kernel 2's edge pass reads ``h`` and ``pattern`` in 16-byte slots, so
    the forward refuses them unaligned; kernel 3, its backward, whose
    passes read them in 16-byte slots too, copies them to a 16-byte
    boundary and takes the same unaligned tensors."""
    n, f, kf = graph.n_node, 64, 128
    c, w_bot, h, pat, _ = _lean_inputs(cuda, np.random.RandomState(5), n, 1, f, kf)

    def unaligned(t):
        """``t``'s values in a contiguous tensor 4 bytes past a 16-byte boundary."""
        return torch.empty(t.numel() + 1, device=cuda)[1:].view(t.shape).copy_(t)

    args = (c, w_bot, h, pat, graph.src, graph.row_ptr)
    csc = (graph.col_ptr, graph.dst_csc)
    for i in (2, 3):  # h, pattern
        bad = args[:i] + (unaligned(args[i]),) + args[i + 1:]
        assert bad[i].is_contiguous() and bad[i].data_ptr() % 16
        with pytest.raises(ValueError, match="16-byte aligned"):
            fused_mma.edge_program_lean(*bad, *csc)
        ct = torch.from_numpy(np.random.RandomState(i).randn(n, kf).astype(np.float32)).to(cuda)
        got = fused_mma.edge_program_lean_bwd(*bad, *csc, ct)
        for g, w in zip(got, fused_mma.edge_program_lean_bwd_reference(*args, *csc, ct)):
            _close(g, w)


@pytest.fixture(scope="module")
def hub_src_graph(cuda):
    """300 nodes: node 0 the source of 3,000 edges (a CSC column that the
    src passes of kernels 3 and 11 split across edge chunks), the last 40
    without in-edges."""
    rs = np.random.RandomState(8)
    n = 300
    src = np.concatenate([np.zeros(3000, np.int32), rs.randint(1, n, 1000)]).astype(np.int32)
    return graph_from_edges(src, rs.randint(0, n - 40, 4000).astype(np.int32), n, device=cuda)


@pytest.mark.parametrize("which", ["graph", "hub_src_graph"])
@pytest.mark.parametrize("f,aggs", [(12, ("mean", "max", "sum")), (16, ("mean", "max")),
                                    (64, ("mean", "mean2")), (96, ("mean", "max")),
                                    (128, ("sum", "max", "min", "mean"))])
def test_edge_program_bwd_kernel_matches_plain(request, cuda, which, f, aggs):
    """Kernel 3 (``D``, the dst pass, the src pass, the node pass) against
    its plain version, ``(dc, dW_bot, dh)``, bitwise equal run to run
    (``dW_bot`` too: its slabs are fixed by N); K·F above 128 (F=96 and
    128 here) takes several lane tiles and two slots a lane, F=12 and 16
    the narrow node-pass layouts. ``hub_src_graph`` has a 3,000-edge
    source; ``graph`` heavy destinations."""
    graph = request.getfixturevalue(which)
    rs = np.random.RandomState(2)
    k = len(aggs)
    h = torch.from_numpy(rs.randn(graph.n_node, f).astype(np.float32)).to(cuda)
    c = torch.from_numpy(rs.randn(graph.n_node, k * f).astype(np.float32)).to(cuda)
    ct = torch.from_numpy(rs.randn(graph.n_node, k * f).astype(np.float32)).to(cuda)
    w_bot = torch.from_numpy((rs.randn(f, k * f) / np.sqrt(f)).astype(np.float32)).to(cuda)
    pat = sigmoid_lane_pattern([get_agg_spec(a) for a in aggs], "new_sigmoid", True, f, cuda)
    args = (c, w_bot, h, pat, graph.src, graph.real_row_ptr, graph.real_col_ptr,
            graph.dst_csc, ct)
    before = fused_mma.LAUNCHES["edge_program_lean_bwd"]
    got = fused_mma.edge_program_lean_bwd(*args)
    torch.cuda.synchronize()
    assert fused_mma.LAUNCHES["edge_program_lean_bwd"] == before + 1
    want = fused_mma.edge_program_lean_bwd_reference(*args)
    for g, w in zip(got, want):
        _close(g, w)
    again = fused_mma.edge_program_lean_bwd(*args)
    assert all(torch.equal(a, b) for a, b in zip(got, again))  # deterministic
    dc, dw, dh = got
    assert torch.equal(dw, again[1])  # dW_bot's slab sums, bit for bit
    assert (dc[260:] == 0).all()  # rows without edges
    assert (dh[300:] == 0).all()  # padding nodes: no real edge leaves them


def _csc_of(ptr_np, index_np, n_edges):
    """The transpose of the edges that a CSR ``ptr_np`` covers, whose other
    endpoint is ``index_np[e]``: ``(ptr, index)`` over the same rows, the
    index padded to ``n_edges`` positions. Its transpose is the CSR again."""
    n = len(ptr_np) - 1
    lo, hi = int(ptr_np[0]), int(ptr_np[-1])
    rows = np.repeat(np.arange(n), np.diff(ptr_np))
    other = index_np[lo:hi]
    order = np.lexsort((rows, other))
    ptr = np.concatenate([[0], np.cumsum(np.bincount(other, minlength=n))]).astype(np.int32)
    index = np.zeros(n_edges, np.int32)
    index[:hi - lo] = rows[order]
    return ptr, index


def _lean_bwd_f64(c, w_bot, h, pattern, src, row_ptr, ct):
    """``edge_program_lean_bwd_reference``'s formula in float64, as
    ``_lean_f64`` is kernel 2's: ``(dc, dW_bot, dh)``."""
    f, kf = w_bot.shape
    ids = fused_mma._row_ids(row_ptr)
    lo, hi = int(row_ptr[0]), int(row_ptr[-1])
    s = src[lo:hi].long()
    h_src, w = h.double()[s], w_bot.double()
    mask, dmask = fused_mma._mask_chain(c.double()[ids] + h_src @ w, pattern)
    ge = ct.double()[ids]
    dlog = ge * h_src.repeat(1, kf // f) * dmask
    zeros = lambda *shape: torch.zeros(shape, dtype=torch.float64, device=c.device)  # noqa: E731
    dh_e = (ge * mask).reshape(-1, kf // f, f).sum(dim=1) + dlog @ w.t()
    return (zeros(c.shape[0], kf).index_add_(0, ids, dlog), h_src.t() @ dlog,
            zeros(*h.shape).index_add_(0, s, dh_e))


@pytest.mark.parametrize("orient", ["csr", "csc"])
@pytest.mark.parametrize("f,kf", [(16, 32), (16, 512), (64, 128), (64, 384), (128, 256),
                                  (128, 512)])
def test_edge_program_lean_bwd_chunks_match_plain(cuda, chunk_graph, f, kf, orient):
    """Kernel 3 against its formula in float64 (``_lean_bwd_f64``) within
    1e-5 over kernel 1's chunk cases, taken as the CSR (the dst pass's
    chunks) or as the CSC (the src pass's), the other order built from it:
    a row split over many chunks, a row on a chunk boundary, empty rows
    inside and at both ends, a slice, a graph under one chunk, nothing
    covered and one row among long runs of empty rows. One launch counted
    a call, bitwise equal run to run, empty rows of dc and dh 0."""
    rs = np.random.RandomState(f + kf)
    for what, (ptr_np, n_edges) in chunk_graph.items():
        n = len(ptr_np) - 1
        index_np = rs.randint(0, n, n_edges).astype(np.int32)
        other_np, other_index = _csc_of(ptr_np, index_np, n_edges)
        if orient == "csr":
            rp_np, src_np, cp_np, dst_np = ptr_np, index_np, other_np, other_index
        else:
            rp_np, src_np, cp_np, dst_np = other_np, other_index, ptr_np, index_np
        rp, src, cp, dst_csc = (torch.from_numpy(a).to(cuda)
                                for a in (rp_np, src_np, cp_np, dst_np))
        c, w_bot, h, pat, _ = _lean_inputs(cuda, rs, n, 1, f, kf)
        ct = torch.from_numpy(rs.randn(n, kf).astype(np.float32)).to(cuda)
        args = (c, w_bot, h, pat, src, rp, cp, dst_csc, ct)
        before = fused_mma.LAUNCHES["edge_program_lean_bwd"]
        got = fused_mma.edge_program_lean_bwd(*args)
        torch.cuda.synchronize()
        assert fused_mma.LAUNCHES["edge_program_lean_bwd"] == before + 1, what
        for name, g, w in zip(("dc", "dW_bot", "dh"), got,
                              _lean_bwd_f64(c, w_bot, h, pat, src, rp, ct)):
            torch.testing.assert_close(g.double(), w, rtol=1e-5,
                                       atol=1e-5 * w.abs().max().item(),
                                       msg=f"{what} {orient} {name}")
        again = fused_mma.edge_program_lean_bwd(*args)
        assert all(torch.equal(a, b) for a, b in zip(got, again)), what
        no_in = torch.from_numpy(rp_np[1:] == rp_np[:-1]).to(cuda)
        no_out = torch.from_numpy(cp_np[1:] == cp_np[:-1]).to(cuda)
        assert (got[0][no_in] == 0).all() and (got[2][no_out] == 0).all(), what


def test_edge_program_lean_bwd_replays_in_a_cuda_graph(cuda, chunk_graph):
    """One kernel-3 call (eight launches) captured in a CUDA graph and
    replayed gives the eager result: the wrapper sizes its grids, slabs and
    scratch from shapes and never reads a pointer array on the host."""
    rp_np, n_edges = chunk_graph["hub"]
    rs = np.random.RandomState(13)
    n = len(rp_np) - 1
    src_np = rs.randint(0, n, n_edges).astype(np.int32)
    cp_np, dst_np = _csc_of(rp_np, src_np, n_edges)
    c, w_bot, h, pat, _ = _lean_inputs(cuda, rs, n, 1, 64, 128)
    ct = torch.from_numpy(rs.randn(n, 128).astype(np.float32)).to(cuda)
    args = (c, w_bot, h, pat, *(torch.from_numpy(a).to(cuda) for a in (src_np, rp_np, cp_np,
                                                                         dst_np)), ct)
    eager = fused_mma.edge_program_lean_bwd(*args)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fused_mma.edge_program_lean_bwd(*args)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        captured = fused_mma.edge_program_lean_bwd(*args)
    graph.replay()
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(captured, eager))


# ------------------------------------------------------- bf16 variants (1-3)

def _sum_f64(data, row_ptr, index=None):
    """Kernel 1's sum in float64: exact for bf16 rows, so the kernel's float32
    sums are held against the exact value."""
    n = row_ptr.shape[0] - 1
    lo, hi = int(row_ptr[0]), int(row_ptr[-1])
    rows = data[lo:hi] if index is None else data.index_select(0, index[lo:hi].long())
    out = torch.zeros((n, data.shape[1]), dtype=torch.float64, device=data.device)
    return out.index_add_(0, fused_mma._row_ids(row_ptr), rows.double())


@pytest.mark.parametrize("indexed", [False, True])
@pytest.mark.parametrize("channels", [7, 16, 47, 64, 128, 192, 200, 640])
def test_bf16_segment_sum_chunks_match_plain(cuda, chunk_graph, channels, indexed):
    """Kernel 1 on bf16 rows (8-byte loads of 4 lanes where C % 4 == 0, 2-byte
    scalars for C = 7 and 47) over kernel 1's chunk cases, against the exact
    sum and the plain version within 1e-5; one launch counted
    under ``segment_sum_bf16`` a call, bitwise equal run to run, empty rows
    0, the output float32."""
    rs = np.random.RandomState(channels + 1)
    for what, (rp_np, n_edges) in chunk_graph.items():
        rp = torch.from_numpy(rp_np).to(cuda)
        rows = 97 if indexed else n_edges
        data = torch.from_numpy(rs.randn(rows, channels).astype(np.float32)).to(cuda).bfloat16()
        index = (torch.from_numpy(rs.randint(0, 97, n_edges).astype(np.int32)).to(cuda)
                 if indexed else None)
        before = dict(fused_mma.LAUNCHES)
        got = fused_mma.segment_sum_csr(data, rp, index)
        torch.cuda.synchronize()
        assert fused_mma.LAUNCHES["segment_sum_bf16"] == before["segment_sum_bf16"] + 1, what
        assert fused_mma.LAUNCHES["segment_sum"] == before["segment_sum"], what
        assert got.dtype == torch.float32
        want = _sum_f64(data, rp, index)
        torch.testing.assert_close(got.double(), want, rtol=1e-5,
                                   atol=1e-5 * want.abs().max().item(), msg=what)
        _close(got, fused_mma.segment_sum_reference(data, rp, index))
        assert torch.equal(got, fused_mma.segment_sum_csr(data, rp, index)), what
        empty = torch.from_numpy(rp_np[1:] == rp_np[:-1]).to(cuda)
        assert (got[empty] == 0).all(), what


def _bf16_lean_inputs(cuda, rs, n, n_edges, f, kf):
    """``_lean_inputs`` with a bf16 ``h`` and a ``W_bot`` of bf16 values, as
    ``masked_multi_aggregate`` hands them to kernels 2-3 in bf16."""
    c, w_bot, h, pat, src = _lean_inputs(cuda, rs, n, n_edges, f, kf)
    return c, w_bot.bfloat16().float(), h.bfloat16(), pat, src


def _lean_bf16_f64(c, w_bot, h, pattern, src, row_ptr):
    """The bf16 plain version's messages (``D`` per node, the mask and the
    product in float32, then rounded to bf16: the kernel's bits) summed in
    float64, so that the kernel is held against the exact sum of the same
    rounded messages."""
    f, kf = w_bot.shape
    ids, h_src, mask, _ = fused_mma._lean_edges(c, w_bot, h, pattern, src, row_ptr)
    msg = fused_mma._round_bf16(mask * h_src.repeat(1, kf // f)).double()
    out = torch.zeros((c.shape[0], kf), dtype=torch.float64, device=c.device)
    return out.index_add_(0, ids, msg)


@pytest.mark.parametrize("f,kf", [(12, 24), (16, 32), (16, 384), (64, 128), (64, 384),
                                  (128, 512)])
def test_bf16_edge_program_lean_chunks_match_plain(cuda, chunk_graph, f, kf):
    """Kernel 2 with a bf16 ``h`` over kernel 1's chunk cases: its node pass
    (bf16 rows staged by 16-byte copies, F = 12 ending 8 bytes past a
    16-byte multiple) equal bit for bit to the plain ``D`` per node; the
    call within 1e-5 of the exact sum of the plain version's bf16-rounded
    messages and of the plain version; one launch counted under
    ``edge_program_lean_bf16``, bitwise equal run to run, empty rows 0."""
    rs = np.random.RandomState(f + kf + 1)
    for what, (rp_np, n_edges) in chunk_graph.items():
        n = len(rp_np) - 1
        rp = torch.from_numpy(rp_np).to(cuda)
        c, w_bot, h, pat, src = _bf16_lean_inputs(cuda, rs, n, n_edges, f, kf)
        args = (c, w_bot, h, pat, src, rp)
        assert torch.equal(fused_mma._lean_node_pass(h, w_bot),
                           fused_mma._node_product(h, w_bot)), what
        before = dict(fused_mma.LAUNCHES)
        got = fused_mma.edge_program_lean(*args, rp, src)
        torch.cuda.synchronize()
        assert fused_mma.LAUNCHES["edge_program_lean_bf16"] == \
            before["edge_program_lean_bf16"] + 1, what
        assert fused_mma.LAUNCHES["edge_program_lean"] == before["edge_program_lean"], what
        want = _lean_bf16_f64(*args)
        torch.testing.assert_close(got.double(), want, rtol=1e-5,
                                   atol=1e-5 * want.abs().max().item(), msg=what)
        assert torch.equal(got, fused_mma.edge_program_lean(*args, rp, src)), what
        empty = torch.from_numpy(rp_np[1:] == rp_np[:-1]).to(cuda)
        assert (got[empty] == 0).all(), what


def _lean_bwd_bf16_f64(c, w_bot, h, pattern, src, row_ptr, ct):
    """The bf16 plain version's per-edge values (``ct`` and ``dlog_e`` rounded
    to bf16 in float32, the kernel's bits) with every sum in float64:
    ``(dc, dW_bot, dh)``."""
    f, kf = w_bot.shape
    ids, h_src, mask, dmask = fused_mma._lean_edges(c, w_bot, h, pattern, src, row_ptr)
    lo, hi = int(row_ptr[0]), int(row_ptr[-1])
    ge = fused_mma._round_bf16(ct)[ids]
    dlog = fused_mma._round_bf16(ge * h_src.repeat(1, kf // f) * dmask).double()
    gm = (ge.double() * mask.double()).reshape(-1, kf // f, f).sum(dim=1)
    zeros = lambda *shape: torch.zeros(shape, dtype=torch.float64, device=c.device)  # noqa: E731
    return (zeros(c.shape[0], kf).index_add_(0, ids, dlog), h_src.double().t() @ dlog,
            zeros(*h.shape).index_add_(0, src[lo:hi].long(), gm + dlog @ w_bot.double().t()))


@pytest.mark.parametrize("orient", ["csr", "csc"])
@pytest.mark.parametrize("f,kf", [(12, 24), (16, 32), (64, 128), (64, 384), (128, 512)])
def test_bf16_edge_program_lean_bwd_chunks_match_plain(cuda, chunk_graph, f, kf, orient):
    """Kernel 3 with a bf16 ``h`` over kernel 1's chunk cases, taken as the
    CSR or as the CSC: ``dc``, ``dW_bot`` and ``dh`` (float32) within 1e-5 of
    the float64 sums of the plain version's rounded per-edge values (the
    float32 plain version is itself 2e-5 off on the 3,000-edge rows, as
    ``_lean_f64`` says of kernel 2's); one launch counted under
    ``edge_program_lean_bwd_bf16``, bitwise equal run to run, empty rows of
    dc and dh 0."""
    rs = np.random.RandomState(f + kf + 2)
    for what, (ptr_np, n_edges) in chunk_graph.items():
        n = len(ptr_np) - 1
        index_np = rs.randint(0, n, n_edges).astype(np.int32)
        other_np, other_index = _csc_of(ptr_np, index_np, n_edges)
        if orient == "csr":
            rp_np, src_np, cp_np, dst_np = ptr_np, index_np, other_np, other_index
        else:
            rp_np, src_np, cp_np, dst_np = other_np, other_index, ptr_np, index_np
        rp, src, cp, dst_csc = (torch.from_numpy(a).to(cuda)
                                for a in (rp_np, src_np, cp_np, dst_np))
        c, w_bot, h, pat, _ = _bf16_lean_inputs(cuda, rs, n, 1, f, kf)
        ct = torch.from_numpy(rs.randn(n, kf).astype(np.float32)).to(cuda)
        args = (c, w_bot, h, pat, src, rp, cp, dst_csc, ct)
        before = dict(fused_mma.LAUNCHES)
        got = fused_mma.edge_program_lean_bwd(*args)
        torch.cuda.synchronize()
        assert fused_mma.LAUNCHES["edge_program_lean_bwd_bf16"] == \
            before["edge_program_lean_bwd_bf16"] + 1, what
        assert all(g.dtype == torch.float32 for g in got), what
        for name, g, w in zip(("dc", "dW_bot", "dh"), got,
                              _lean_bwd_bf16_f64(c, w_bot, h, pat, src, rp, ct)):
            torch.testing.assert_close(g.double(), w, rtol=1e-5,
                                       atol=1e-5 * w.abs().max().item(),
                                       msg=f"{what} {orient} {name}")
        again = fused_mma.edge_program_lean_bwd(*args)
        assert all(torch.equal(a, b) for a, b in zip(got, again)), what
        no_in = torch.from_numpy(rp_np[1:] == rp_np[:-1]).to(cuda)
        no_out = torch.from_numpy(cp_np[1:] == cp_np[:-1]).to(cuda)
        assert (got[0][no_in] == 0).all() and (got[2][no_out] == 0).all(), what


def test_bf16_kernels_reject_what_they_do_not_take(cuda, graph):
    """bf16 goes to kernel 1's rows and kernels 2-3's ``h`` only: a bf16
    ``c``, a bf16 ``h`` for the wide kernels 9-11 and bf16 logits for kernel
    12 raise before any launch."""
    n, f, kf = graph.n_node, 16, 32
    c, w_bot, h, pat, src = _bf16_lean_inputs(cuda, np.random.RandomState(1), n, 1, f, kf)
    before = dict(fused_mma.LAUNCHES)
    with pytest.raises(ValueError, match="float32"):
        fused_mma.edge_program_lean(c.bfloat16(), w_bot, h, pat, graph.src, graph.row_ptr,
                                    graph.col_ptr, graph.dst_csc)
    with pytest.raises(ValueError, match="float32"):
        fused_mma.edge_program_fwd(c, c, h, pat, graph.src, graph.row_ptr)
    with pytest.raises(ValueError, match="float32"):
        fused_mma.segment_sum_csr(torch.zeros(graph.n_edge, 8, device=cuda).half(),
                                  graph.row_ptr)
    assert fused_mma.LAUNCHES == before


def _grads(fn, *inputs):
    leaves = [t.detach().clone().requires_grad_() for t in inputs]
    out = fn(*leaves)
    g = torch.from_numpy(np.random.RandomState(9).randn(*out.shape).astype(np.float32))
    out.backward(g.to(out.device))
    return out.detach().cpu(), [t.grad.cpu() for t in leaves]


def test_autograd_functions_on_card_match_cpu(cuda, graph):
    """Each Function's forward and gradients on the card (kernels) against
    the same Function on the CPU (plain forward and backward)."""
    from mma_tpu_torch.ops import binary_spmm
    from mma_tpu_torch.ops.gather import gather_by_dst, gather_by_src, gather_rows

    cpu_graph = graph.to("cpu")
    rs = np.random.RandomState(5)
    f, aggs = 64, ("mean", "max")
    h = torch.from_numpy(rs.randn(graph.n_node, f).astype(np.float32))
    c = torch.from_numpy(rs.randn(graph.n_node, 2 * f).astype(np.float32))
    w_bot = torch.from_numpy((rs.randn(f, 2 * f) / np.sqrt(f)).astype(np.float32))
    e_data = torch.from_numpy(rs.randn(graph.n_edge, 16).astype(np.float32))
    cases = {
        "edge_program_lean": (
            lambda g: (lambda c_, w_, h_: fused_mma.edge_program_lean(
                c_, w_, h_,
                sigmoid_lane_pattern([get_agg_spec(a) for a in aggs], "new_sigmoid", True, f,
                                     g.src.device),
                g.src, g.real_row_ptr, g.real_col_ptr, g.dst_csc)),
            (c, w_bot, h)),
        "segment_sum_csr": (lambda g: (lambda d: fused_mma.segment_sum_csr(d, g.real_row_ptr)),
                            (e_data,)),
        "binary_spmm": (lambda g: (lambda x: binary_spmm(g, x)), (h,)),
        "gather_by_dst": (lambda g: (lambda x: gather_by_dst(x, g)), (h,)),
        "gather_by_src": (lambda g: (lambda x: gather_by_src(x, g)), (h,)),
        "gather_rows": (lambda g: (lambda t: gather_rows(t, g.src[:200] % 7)), (h[:7],)),
    }
    for name, (make, inputs) in cases.items():
        got, got_g = _grads(make(graph), *(t.to(cuda) for t in inputs))
        want, want_g = _grads(make(cpu_graph), *inputs)
        _close(got, want)
        for g, w in zip(got_g, want_g):
            _close(g, w)


def test_train_step_on_card_matches_cpu(cuda, graph, monkeypatch):
    """One ``node_train_step`` (dropout 0: fused route, kernel 3) on the card
    against the CPU; a step with mask dropout (half-fused route) launches no
    kernel 3 and gives the gradients of the same step with every kernel
    replaced by its plain version on the card (one seed, so the same
    dropout draws)."""
    from mma_tpu_torch import NodeClassifier
    from mma_tpu_torch.train import make_optimizer
    from mma_tpu_torch.train.loops import node_train_step

    x = torch.randn((graph.n_node, 24), generator=torch.Generator().manual_seed(1))
    labels = torch.randint(0, 5, (graph.n_node,), generator=torch.Generator().manual_seed(2))
    idx = torch.arange(0, 300, 2)
    models = {}
    for dev, g in ((cuda, graph), ("cpu", graph.to("cpu"))):
        model = NodeClassifier(24, 64, 5, ("mean", "max"), dropout_rate=0.0, device=dev,
                               generator=torch.Generator().manual_seed(0))
        loss, _ = node_train_step(model, make_optimizer(model.parameters(), 1e-3, 5e-4),
                                  x.to(dev), g, labels.to(dev), idx.to(dev),
                                  torch.Generator(device=dev).manual_seed(0))
        models[str(dev)] = (model, float(loss))
    (gpu_model, gpu_loss), (cpu_model, cpu_loss) = models["cuda"], models["cpu"]
    assert abs(gpu_loss - cpu_loss) <= 1e-5 * abs(cpu_loss)
    for (name, p), q in zip(gpu_model.named_parameters(), cpu_model.parameters()):
        _close(p.grad.cpu(), q.grad)

    def dropout_step():
        model = NodeClassifier(24, 64, 5, ("mean", "max"), dropout_rate=0.5, device=cuda,
                               generator=torch.Generator().manual_seed(0))
        node_train_step(model, make_optimizer(model.parameters(), 1e-3), x.to(cuda), graph,
                        labels.to(cuda), idx.to(cuda),
                        torch.Generator(device=cuda).manual_seed(0))
        return [p.grad for p in model.parameters()]

    before = dict(fused_mma.LAUNCHES)
    got = dropout_step()
    torch.cuda.synchronize()
    assert fused_mma.LAUNCHES["edge_program_lean_bwd"] == before["edge_program_lean_bwd"]
    assert fused_mma.LAUNCHES["segment_sum"] == before["segment_sum"] + 8
    for name, plain in (("_segment_sum_kernel", fused_mma.segment_sum_reference),
                        ("_edge_program_lean_kernel", fused_mma.edge_program_lean_reference)):
        monkeypatch.setattr(fused_mma, name, plain)
    for g, w in zip(got, dropout_step()):
        _close(g, w)


# ---- kernels 4-7: segmented min/max and the fused min/max edge program ----

def _minmax_inputs(cuda, graph, ch, ties, n_ops):
    """Edge data (E, C), node table (N, C) and a cotangent (N, P·C); with
    ``ties`` small integers, so that many edges of a row tie."""
    rs = np.random.RandomState(ch + 10 * ties)

    def draw(*shape):
        a = rs.randint(-2, 3, shape) if ties else rs.randn(*shape)
        return torch.from_numpy(a.astype(np.float32)).to(cuda)

    return draw(graph.n_edge, ch), draw(graph.n_node, ch), draw(graph.n_node, n_ops * ch)


_MINMAX_CASES = [(375, ("min", "max")), (375, ("max",)), (37, ("max", "min")), (37, ("min",))]


@pytest.mark.parametrize("ties", [False, True])
@pytest.mark.parametrize("ch,ops", _MINMAX_CASES)
def test_segment_minmax_kernels_match_plain(cuda, graph, ch, ops, ties):
    """Kernel 4 equal to its plain version (min/max do not round), kernel 5
    too (first-hit routing), both bitwise equal run to run; rows without
    edges give 0 and padding edges a zero gradient."""
    from mma_tpu_torch.ops.cuda import segment_minmax as mm

    data, _, ct = _minmax_inputs(cuda, graph, ch, ties, len(ops))
    rp = graph.real_row_ptr
    before = dict(mm.LAUNCHES)
    out = mm.segment_minmax(data, rp, ops)
    grad = mm.segment_minmax_bwd(data, rp, ops, out, ct)
    torch.cuda.synchronize()
    assert mm.LAUNCHES["segment_minmax"] == before["segment_minmax"] + 1
    assert mm.LAUNCHES["segment_minmax_bwd"] == before["segment_minmax_bwd"] + 1
    assert torch.equal(out, mm.segment_minmax_reference(data, rp, ops))
    assert torch.equal(grad, mm.segment_minmax_bwd_reference(data, rp, ops, out, ct))
    assert torch.equal(out, mm.segment_minmax(data, rp, ops))
    assert torch.equal(grad, mm.segment_minmax_bwd(data, rp, ops, out, ct))
    assert (out[260:] == 0).all()
    assert (grad[int(rp[-1]):] == 0).all()


@pytest.mark.parametrize("seed", [None, 1234])
@pytest.mark.parametrize("ties", [False, True])
@pytest.mark.parametrize("ch,ops", _MINMAX_CASES)
def test_minmax_edge_program_kernels_match_plain(cuda, graph, ch, ops, ties, seed):
    """Kernel 6 equal to its plain version with the hash dropout on and off,
    kernel 7's dhg equal and dc within 1e-5 (it sums at most P non-zero
    terms per row, so it comes out equal too); bitwise run to run."""
    from mma_tpu_torch.ops.cuda import segment_minmax as mm

    hg, c, ct = _minmax_inputs(cuda, graph, ch, ties, len(ops))
    rp = graph.real_row_ptr
    sd = None if seed is None else torch.tensor([seed], dtype=torch.int32, device=cuda)
    before = dict(mm.LAUNCHES)
    out = mm.minmax_edge_program(c, hg, rp, ops, sd, 0.5)
    dhg, dc = mm.minmax_edge_program_bwd(c, hg, rp, ops, sd, 0.5, out, ct)
    torch.cuda.synchronize()
    assert mm.LAUNCHES["minmax_prog"] == before["minmax_prog"] + 1
    assert mm.LAUNCHES["minmax_prog_bwd"] == before["minmax_prog_bwd"] + 1
    assert torch.equal(out, mm.minmax_edge_program_reference(c, hg, rp, ops, sd, 0.5))
    want_dhg, want_dc = mm.minmax_edge_program_bwd_reference(c, hg, rp, ops, sd, 0.5, out, ct)
    assert torch.equal(dhg, want_dhg)
    _close(dc, want_dc)
    assert torch.equal(out, mm.minmax_edge_program(c, hg, rp, ops, sd, 0.5))
    again = mm.minmax_edge_program_bwd(c, hg, rp, ops, sd, 0.5, out, ct)
    assert torch.equal(dhg, again[0]) and torch.equal(dc, again[1])
    assert (out[260:] == 0).all() and (dc[260:] == 0).all()
    assert (dhg[int(rp[-1]):] == 0).all()


@pytest.mark.parametrize("ties", [False, True])
@pytest.mark.parametrize("ch,ops", _MINMAX_CASES)
def test_bf16_segment_minmax_kernels_match_plain(cuda, graph, ch, ops, ties):
    """The bf16 variants of kernels 4 and 5 (bf16 data; the cotangent
    rounded to bf16, the gradient bf16) equal to their plain versions and
    run to run, under their own launch keys."""
    from mma_tpu_torch.ops.cuda import segment_minmax as mm

    data, _, ct = _minmax_inputs(cuda, graph, ch, ties, len(ops))
    data = (data * 3).bfloat16()
    rp = graph.real_row_ptr
    before = dict(mm.LAUNCHES)
    out = mm.segment_minmax(data, rp, ops)
    grad = mm.segment_minmax_bwd(data, rp, ops, out, ct)
    torch.cuda.synchronize()
    assert mm.LAUNCHES["segment_minmax_bf16"] == before["segment_minmax_bf16"] + 1
    assert mm.LAUNCHES["segment_minmax_bwd_bf16"] == before["segment_minmax_bwd_bf16"] + 1
    assert out.dtype == torch.float32 and grad.dtype == torch.bfloat16
    assert torch.equal(out, mm.segment_minmax_reference(data, rp, ops))
    assert torch.equal(grad, mm.segment_minmax_bwd_reference(data, rp, ops, out, ct))
    assert torch.equal(out, mm.segment_minmax(data, rp, ops))
    assert torch.equal(grad, mm.segment_minmax_bwd(data, rp, ops, out, ct))
    assert (out[260:] == 0).all()
    assert (grad[int(rp[-1]):] == 0).all()


@pytest.mark.parametrize("seed", [None, 1234])
@pytest.mark.parametrize("ties", [False, True])
@pytest.mark.parametrize("ch,ops", _MINMAX_CASES)
def test_bf16_minmax_edge_program_kernels_match_plain(cuda, graph, ch, ops, ties, seed):
    """The bf16 variants of kernels 6 and 7 (bf16 ``c`` and ``hg``; the
    message added and masked in float32; ``dhg`` and ``dc`` bf16): the
    output and ``dhg`` equal to the plain versions, ``dc`` within 1e-5,
    bitwise run to run."""
    from mma_tpu_torch.ops.cuda import segment_minmax as mm

    hg, c, ct = _minmax_inputs(cuda, graph, ch, ties, len(ops))
    hg, c = (hg * 3).bfloat16(), (c * 3).bfloat16()
    rp = graph.real_row_ptr
    sd = None if seed is None else torch.tensor([seed], dtype=torch.int32, device=cuda)
    before = dict(mm.LAUNCHES)
    out = mm.minmax_edge_program(c, hg, rp, ops, sd, 0.5)
    dhg, dc = mm.minmax_edge_program_bwd(c, hg, rp, ops, sd, 0.5, out, ct)
    torch.cuda.synchronize()
    assert mm.LAUNCHES["minmax_prog_bf16"] == before["minmax_prog_bf16"] + 1
    assert mm.LAUNCHES["minmax_prog_bwd_bf16"] == before["minmax_prog_bwd_bf16"] + 1
    assert out.dtype == torch.float32 and dhg.dtype == dc.dtype == torch.bfloat16
    assert torch.equal(out, mm.minmax_edge_program_reference(c, hg, rp, ops, sd, 0.5))
    want_dhg, want_dc = mm.minmax_edge_program_bwd_reference(c, hg, rp, ops, sd, 0.5, out, ct)
    assert torch.equal(dhg, want_dhg)
    _close(dc.float(), want_dc.float())
    assert torch.equal(out, mm.minmax_edge_program(c, hg, rp, ops, sd, 0.5))
    again = mm.minmax_edge_program_bwd(c, hg, rp, ops, sd, 0.5, out, ct)
    assert torch.equal(dhg, again[0]) and torch.equal(dc, again[1])
    assert (out[260:] == 0).all() and (dc[260:] == 0).all()
    assert (dhg[int(rp[-1]):] == 0).all()


def _prog_inputs(cuda, rs, n_rows, n_edges, ch, n_ops, dtype):
    """Kernel 6-7 inputs on any CSR: ``c`` (N, C), ``hg`` (E, C) and a
    cotangent (N, P·C); C = 7 and 375 draw small integers, so that edges
    of a row tie, the others normal values."""
    def draw(*shape):
        a = rs.randint(-3, 4, shape) if ch in (7, 375) else rs.randn(*shape)
        return torch.from_numpy(a.astype(np.float32)).to(cuda)

    return (draw(n_rows, ch).to(dtype), draw(n_edges, ch).to(dtype),
            draw(n_rows, n_ops * ch))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("seed", [None, 4321])
@pytest.mark.parametrize("ops", [("min", "max"), ("max",)])
@pytest.mark.parametrize("ch", [7, 37, 375, 640])
def test_minmax_prog_tiles_match_plain(cuda, chunk_graph, ch, ops, seed, dtype):
    """Kernel 6's staged row tiles over the chunk CSRs: a 3,000-edge row
    many times a tile's item budget (walked in pieces through one stage),
    empty rows inside and at both ends, a ``row_ptr[0] > 0`` slice, a
    padding tail no row covers, a CSR that covers nothing and one row among
    2,000 empty ones; odd widths (7, 37, 375) whose rows start off 16-byte
    boundaries, and 640. ``out`` equal to the plain version and run to run,
    empty rows 0, one launch a call; kernel 7 on that ``out``: ``dhg`` equal
    to its plain version and ``dc`` within 1e-5."""
    from mma_tpu_torch.ops.cuda import segment_minmax as mm

    rs = np.random.RandomState(ch)
    sd = None if seed is None else torch.tensor([seed], dtype=torch.int32, device=cuda)
    key = "minmax_prog_bf16" if dtype == torch.bfloat16 else "minmax_prog"
    for what, (rp_np, n_edges) in chunk_graph.items():
        rp = torch.from_numpy(rp_np).to(cuda)
        c, hg, ct = _prog_inputs(cuda, rs, rp_np.shape[0] - 1, n_edges, ch, len(ops), dtype)
        before = mm.LAUNCHES[key]
        out = mm.minmax_edge_program(c, hg, rp, ops, sd, 0.5)
        torch.cuda.synchronize()
        assert mm.LAUNCHES[key] == before + 1, what
        assert torch.equal(out, mm.minmax_edge_program_reference(c, hg, rp, ops, sd, 0.5)), what
        assert torch.equal(out, mm.minmax_edge_program(c, hg, rp, ops, sd, 0.5)), what
        empty = torch.from_numpy(rp_np[1:] == rp_np[:-1]).to(cuda)
        assert (out[empty] == 0).all(), what
        dhg, dc = mm.minmax_edge_program_bwd(c, hg, rp, ops, sd, 0.5, out, ct)
        want_dhg, want_dc = mm.minmax_edge_program_bwd_reference(c, hg, rp, ops, sd, 0.5, out, ct)
        assert torch.equal(dhg, want_dhg), what
        torch.testing.assert_close(dc.float(), want_dc.float(), rtol=1e-5,
                                   atol=1e-5 * want_dc.float().abs().max().item(), msg=what)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_minmax_prog_replays_in_a_cuda_graph(cuda, chunk_graph, dtype):
    """One kernel-6 call (dropout on) captured in a CUDA graph and replayed
    gives the eager result: its tiles come from shapes, and the host never
    reads ``row_ptr``."""
    from mma_tpu_torch.ops.cuda import segment_minmax as mm

    rp_np, n_edges = chunk_graph["hub"]
    rp = torch.from_numpy(rp_np).to(cuda)
    c, hg, _ = _prog_inputs(cuda, np.random.RandomState(5), rp_np.shape[0] - 1, n_edges, 375, 2,
                            dtype)
    sd = torch.tensor([99], dtype=torch.int32, device=cuda)
    eager = mm.minmax_edge_program(c, hg, rp, ("min", "max"), sd, 0.5)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        mm.minmax_edge_program(c, hg, rp, ("min", "max"), sd, 0.5)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        captured = mm.minmax_edge_program(c, hg, rp, ("min", "max"), sd, 0.5)
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(captured, eager)


def test_minmax_hash_on_card_matches_cpu(cuda):
    """The dropout hash's PyTorch form gives the same bits on the card."""
    from mma_tpu_torch.ops.cuda.segment_minmax import dropout_keep

    pos = torch.arange(0, 50000, 7)[:, None]
    lane = torch.arange(0, 375)[None, :]
    seed = torch.tensor([2**31 - 2], dtype=torch.int32)
    want = dropout_keep(seed, pos, lane, 0.5)
    got = dropout_keep(seed.to(cuda), pos.to(cuda), lane.to(cuda), 0.5)
    assert torch.equal(got.cpu(), want)


@pytest.mark.parametrize("aggs", [("min", "max"), ("mean", "max", "min"),
                                  ("mean", "min", "max", "std")])
def test_zinc_train_steps_are_bitwise_repeatable_on_card(cuda, aggs):
    """Two ZincNet train steps with message dropout, twice from the same
    seeds: every parameter and BatchNorm buffer bitwise equal (no atomics on
    the path, the embeddings' VJP included). Without dropout, against the
    CPU's plain path within 1e-4 (two Adam steps at lr 1e-5: a gradient at
    rounding level can move its element by up to lr a step)."""
    from mma_tpu_torch.data import load_zinc
    from mma_tpu_torch.models import ZincNet
    from mma_tpu_torch.train import make_optimizer
    from mma_tpu_torch.train.loops import zinc_train_step

    ds = load_zinc("val", subset_size=48)
    states = []
    for dev, gen_seed in ((cuda, 3), (cuda, 3), (cuda, None), ("cpu", None)):
        batch = next(ds.batches(48, n_node=2048, n_edge=4096, device=dev))
        model = ZincNet(aggs, ("identity", "amplification", "linear"),
                        {"lin": 2.0, "log": 1.0}, num_layers=2, device=dev,
                        generator=torch.Generator().manual_seed(0))
        opt = make_optimizer(model.parameters(), 1e-5, 3e-4)
        gen = None if gen_seed is None else torch.Generator(device=dev).manual_seed(gen_seed)
        for _ in range(2):
            zinc_train_step(model, opt, batch, gen)
        states.append({k: v.detach().cpu() for k, v in model.state_dict().items()})
    for k in states[0]:
        assert torch.equal(states[0][k], states[1][k]), k
        torch.testing.assert_close(states[2][k], states[3][k], rtol=1e-4, atol=1e-4)


# ---- kernel 8 (sum of squares) and the wide edge program (kernels 9-11) ----

@pytest.mark.parametrize("channels", [375, 37, 64])
def test_segment_sum_sq_kernel_matches_plain(cuda, graph, channels):
    """Kernel 8 equal to its plain version bit for bit (both add each row's
    edges in CSR order, the square rounded first) and run to run; rows
    without edges and the padding node give 0."""
    rs = np.random.RandomState(channels)
    data = torch.from_numpy(rs.randn(graph.n_edge, channels).astype(np.float32)).to(cuda)
    rp = graph.real_row_ptr
    before = fused_mma.LAUNCHES["segment_sum_sq"]
    got = fused_mma.segment_sum_sq_csr(data, rp)
    torch.cuda.synchronize()
    assert fused_mma.LAUNCHES["segment_sum_sq"] == before + 1
    assert torch.equal(got, fused_mma.segment_sum_sq_reference(data, rp))
    assert torch.equal(got, fused_mma.segment_sum_sq_csr(data, rp))
    assert (got[260:] == 0).all()


@pytest.mark.parametrize("channels", [375, 37, 64])
def test_bf16_segment_sum_sq_kernel_matches_plain(cuda, graph, channels):
    """Kernel 8's bf16 variant (bf16 data, each square rounded to bf16
    before the float32 sum) equal to its plain version bit for bit and run
    to run, under its own launch key."""
    rs = np.random.RandomState(channels)
    data = torch.from_numpy(rs.randn(graph.n_edge, channels).astype(np.float32) * 3).to(cuda)
    data = data.bfloat16()
    rp = graph.real_row_ptr
    before = fused_mma.LAUNCHES["segment_sum_sq_bf16"]
    got = fused_mma.segment_sum_sq_csr(data, rp)
    torch.cuda.synchronize()
    assert fused_mma.LAUNCHES["segment_sum_sq_bf16"] == before + 1
    assert got.dtype == torch.float32
    assert torch.equal(got, fused_mma.segment_sum_sq_reference(data, rp))
    assert torch.equal(got, fused_mma.segment_sum_sq_csr(data, rp))
    assert (got[260:] == 0).all()


@pytest.mark.parametrize("which", ["graph", "hub_src_graph"])
@pytest.mark.parametrize("f,k", [(12, 3), (16, 2), (64, 2), (96, 2), (128, 4)])
def test_wide_edge_program_kernels_match_plain(request, cuda, which, f, k):
    """Kernels 9, 10 (with and without the payload) and 11 against their
    plain versions within 1e-5 of the largest value, bitwise equal run to
    run; K·F of 36 to 512 takes one to four lane tiles. ``hub_src_graph``
    has a 3,000-edge source, a CSC column that kernel 11 splits across edge
    chunks; ``graph`` heavy destinations."""
    graph = request.getfixturevalue(which)
    rs = np.random.RandomState(6)
    n = graph.n_node
    c, d, ct = (torch.from_numpy(rs.randn(n, k * f).astype(np.float32)).to(cuda)
                for _ in range(3))
    h = torch.from_numpy(rs.randn(n, f).astype(np.float32)).to(cuda)
    pat = torch.from_numpy(np.repeat(np.arange(k) % 2 == 0, f).astype(np.float32)).to(cuda)
    rp, cp = graph.real_row_ptr, graph.real_col_ptr
    fwd = (c, d, h, pat, graph.src, rp)
    csc_args = (c, d, h, pat, graph.dst_csc, cp, ct)
    before = dict(fused_mma.LAUNCHES)
    out = fused_mma.edge_program_fwd(*fwd)
    dc, payload = fused_mma.edge_program_bwd(*fwd, ct)
    dc_only, none = fused_mma.edge_program_bwd(*fwd, ct, emit_payload=False)
    csc = fused_mma.edge_program_bwd_csc(*csc_args)
    torch.cuda.synchronize()
    for key, added in (("edge_program_fwd", 1), ("edge_program_bwd", 2),
                       ("edge_program_bwd_csc", 1)):
        assert fused_mma.LAUNCHES[key] == before[key] + added
    _close(out, fused_mma.edge_program_fwd_reference(*fwd))
    want_dc, want_payload = fused_mma.edge_program_bwd_reference(*fwd, ct)
    _close(dc, want_dc)
    _close(payload, want_payload)
    _close(csc, fused_mma.edge_program_bwd_csc_reference(*csc_args))
    assert none is None and torch.equal(dc_only, dc)
    assert torch.equal(out, fused_mma.edge_program_fwd(*fwd))
    again = fused_mma.edge_program_bwd(*fwd, ct)
    assert torch.equal(dc, again[0]) and torch.equal(payload, again[1])
    assert torch.equal(csc, fused_mma.edge_program_bwd_csc(*csc_args))
    assert (out[260:] == 0).all() and (dc[260:] == 0).all() and (csc[300:] == 0).all()
    assert (payload[int(rp[-1]):] == 0).all()  # padding edges


def _wide_f64(c, d, h, pattern, src, row_ptr, ct):
    """The plain versions of kernels 9 and 10 (``edge_program_fwd_reference``,
    ``edge_program_bwd_reference``) in float64, as ``_lean_f64`` is kernel
    2's: ``(S, dc, payload)``, the payload 0 outside ``[row_ptr[0],
    row_ptr[-1])``."""
    kf, f = c.shape[1], h.shape[1]
    ids = fused_mma._row_ids(row_ptr)
    lo, hi = int(row_ptr[0]), int(row_ptr[-1])
    s = src[lo:hi].long()
    h_src = h.double()[s].repeat(1, kf // f)
    mask, dmask = fused_mma._mask_chain(c.double()[ids] + d.double()[s], pattern)
    ge = ct.double()[ids]
    dlog = ge * h_src * dmask
    zeros = lambda *shape: torch.zeros(shape, dtype=torch.float64, device=c.device)  # noqa: E731
    payload = zeros(src.shape[0], kf + f)
    payload[lo:hi] = torch.cat([dlog, (ge * mask).reshape(-1, kf // f, f).sum(dim=1)], dim=1)
    return (zeros(c.shape[0], kf).index_add_(0, ids, mask * h_src),
            zeros(c.shape[0], kf).index_add_(0, ids, dlog), payload)


def _csc_f64(c, d, h, pattern, dst_csc, col_ptr, ct):
    """The plain version of kernel 11 (``edge_program_bwd_csc_reference``)
    in float64: ``[dd ‖ dh]`` (N, K·F+F)."""
    kf, f = c.shape[1], h.shape[1]
    js = fused_mma._row_ids(col_ptr)
    lo, hi = int(col_ptr[0]), int(col_ptr[-1])
    i = dst_csc[lo:hi].long()
    mask, dmask = fused_mma._mask_chain(c.double()[i] + d.double()[js], pattern)
    ge = ct.double()[i]
    dlog = ge * h.double()[js].repeat(1, kf // f) * dmask
    dh_e = (ge * mask).reshape(-1, kf // f, f).sum(dim=1)
    out = torch.zeros((c.shape[0], kf + f), dtype=torch.float64, device=c.device)
    return out.index_add_(0, js, torch.cat([dlog, dh_e], dim=1))


@pytest.mark.parametrize("f,kf", [(16, 32), (16, 512), (64, 128), (64, 192), (64, 512),
                                  (128, 512), (12, 36), (96, 192)])
def test_wide_edge_program_chunks_match_plain(cuda, chunk_graph, f, kf):
    """Kernel 9 and kernel 10, with and without its payload (kernel 1's
    chunk pass and fixup with kernels 2 and 3's messages over the caller's
    ``d``), against their plain versions' formula in float64
    (``_wide_f64``) within 1e-5 of each tensor's largest value, over kernel
    1's chunk cases: a row longer than many chunks, a row on a chunk
    boundary, runs of empty rows inside and at both ends, a slice with
    ``row_ptr[0] > 0``, padding positions after ``row_ptr[n]`` (whole
    payload rows of 0), a graph under one chunk, a CSR that covers nothing
    and one row among long runs of empty rows. The payload's K-fold takes
    shuffles (F = 16, 64, 128), stays in the thread (K·F = 192 at F = 64:
    16 lanes an edge) or goes through shared memory (F = 12, 96); K·F above
    256 takes two rounds. One launch counted a call, ``dc`` the same bits
    in both modes, bitwise equal run to run, empty rows 0. Kernel 11 takes
    each CSR as a CSC (its index as ``dst_csc``) against ``_csc_f64``, its
    K-fold by the same three ways, as rows and as the split rows' chunk
    partials."""
    rs = np.random.RandomState(f + kf)
    for what, (rp_np, n_edges) in chunk_graph.items():
        n = len(rp_np) - 1
        rp = torch.from_numpy(rp_np).to(cuda)

        def draw(*shape):
            return torch.from_numpy(rs.randn(*shape).astype(np.float32)).to(cuda)

        c, d, ct, h = draw(n, kf), draw(n, kf), draw(n, kf), draw(n, f)
        pat = torch.from_numpy((rs.rand(kf) > 0.5).astype(np.float32)).to(cuda)
        src = torch.from_numpy(rs.randint(0, n, n_edges).astype(np.int32)).to(cuda)
        fwd = (c, d, h, pat, src, rp)
        before = dict(fused_mma.LAUNCHES)
        got = fused_mma.edge_program_fwd(*fwd)
        dc, payload = fused_mma.edge_program_bwd(*fwd, ct)
        dc_only, none = fused_mma.edge_program_bwd(*fwd, ct, emit_payload=False)
        torch.cuda.synchronize()
        assert fused_mma.LAUNCHES["edge_program_fwd"] == before["edge_program_fwd"] + 1, what
        assert fused_mma.LAUNCHES["edge_program_bwd"] == before["edge_program_bwd"] + 2, what
        assert none is None and torch.equal(dc_only, dc), what
        for name, g, w in zip(("S", "dc", "payload"), (got, dc, payload),
                              _wide_f64(c, d, h, pat, src, rp, ct)):
            torch.testing.assert_close(g.double(), w, rtol=1e-5,
                                       atol=1e-5 * w.abs().max().item(), msg=f"{what} {name}")
        assert (payload[:int(rp_np[0])] == 0).all() and (payload[int(rp_np[-1]):] == 0).all()
        assert torch.equal(got, fused_mma.edge_program_fwd(*fwd)), what
        again = fused_mma.edge_program_bwd(*fwd, ct)
        assert torch.equal(dc, again[0]) and torch.equal(payload, again[1]), what
        empty = torch.from_numpy(rp_np[1:] == rp_np[:-1]).to(cuda)
        assert (got[empty] == 0).all() and (dc[empty] == 0).all(), what

        csc_args = (c, d, h, pat, src, rp, ct)  # the CSR taken as a CSC
        csc = fused_mma.edge_program_bwd_csc(*csc_args)
        torch.cuda.synchronize()
        assert (fused_mma.LAUNCHES["edge_program_bwd_csc"]
                == before["edge_program_bwd_csc"] + 1), what
        want = _csc_f64(*csc_args)
        torch.testing.assert_close(csc.double(), want, rtol=1e-5,
                                   atol=1e-5 * want.abs().max().item(), msg=f"{what} [dd ‖ dh]")
        assert torch.equal(csc, fused_mma.edge_program_bwd_csc(*csc_args)), what
        assert (csc[empty] == 0).all(), what


def test_wide_edge_program_replays_in_a_cuda_graph(cuda, chunk_graph):
    """Kernel 9, kernel 10 with its payload and kernel 11 (over the CSR
    taken as a CSC), captured in one CUDA graph and replayed, give the
    eager results: the wrappers size grids and scratch from shapes and
    never read ``row_ptr`` on the host."""
    rp_np, n_edges = chunk_graph["slice row_ptr[0] > 0"]
    rs = np.random.RandomState(14)
    n, f, kf = len(rp_np) - 1, 64, 128
    rp = torch.from_numpy(rp_np).to(cuda)
    c, d, ct = (torch.from_numpy(rs.randn(n, kf).astype(np.float32)).to(cuda) for _ in range(3))
    h = torch.from_numpy(rs.randn(n, f).astype(np.float32)).to(cuda)
    pat = torch.from_numpy((rs.rand(kf) > 0.5).astype(np.float32)).to(cuda)
    src = torch.from_numpy(rs.randint(0, n, n_edges).astype(np.int32)).to(cuda)
    fwd = (c, d, h, pat, src, rp)

    def call():
        return (fused_mma.edge_program_fwd(*fwd), *fused_mma.edge_program_bwd(*fwd, ct),
                fused_mma.edge_program_bwd_csc(*fwd, ct))

    eager = call()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        call()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        captured = call()
    graph.replay()
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(captured, eager))


@pytest.mark.parametrize("bwd_mode", ["payload_permute", "csc_gather"])
def test_wide_edge_program_on_card_matches_cpu(cuda, graph, bwd_mode):
    """``edge_program``'s forward and its three gradients on the card
    (kernels 9, 10 and 1 or 11) against the CPU's plain path."""
    cpu_graph = graph.to("cpu")
    rs = np.random.RandomState(8)
    f, k = 64, 2
    c, d = (torch.from_numpy(rs.randn(graph.n_node, k * f).astype(np.float32))
            for _ in range(2))
    h = torch.from_numpy(rs.randn(graph.n_node, f).astype(np.float32))
    pat = torch.from_numpy(np.repeat(np.array([0.0, 1.0], np.float32), f))

    def make(g):
        return lambda c_, d_, h_: fused_mma.edge_program(
            c_, d_, h_, pat.to(g.src.device), g.src, g.real_row_ptr, g.real_col_ptr,
            g.src_perm, g.dst_csc, bwd_mode)

    before = dict(fused_mma.LAUNCHES)
    got, got_g = _grads(make(graph), *(t.to(cuda) for t in (c, d, h)))
    assert fused_mma.LAUNCHES["edge_program_fwd"] == before["edge_program_fwd"] + 1
    assert fused_mma.LAUNCHES["edge_program_bwd"] == before["edge_program_bwd"] + 1
    want, want_g = _grads(make(cpu_graph), c, d, h)
    _close(got, want)
    for g, w in zip(got_g, want_g):
        _close(g, w)


def test_wide_kernels_reject_what_they_do_not_take(cuda, graph):
    n, f = graph.n_node, 132  # above the kernels' F limit
    c = torch.zeros(n, f, device=cuda)
    with pytest.raises(ValueError, match="F <= 128"):
        fused_mma.edge_program_fwd(c, c, c, torch.zeros(f, device=cuda), graph.src,
                                   graph.real_row_ptr)
    with pytest.raises(ValueError, match="float32"):
        fused_mma.segment_sum_sq_csr(torch.zeros(graph.n_edge, 3, device=cuda).double(),
                                     graph.real_row_ptr)


# ---- kernel 12: the masked segment sum behind fused_masked_aggregate ----

@pytest.fixture(scope="module")
def hub_graph(cuda):
    """300 nodes: node 0 takes 1,000 edges, the last 40 none (empty rows)."""
    rs = np.random.RandomState(12)
    n = 300
    src = rs.randint(0, n, 4000).astype(np.int32)
    dst = np.concatenate([np.zeros(1000, np.int32), rs.randint(1, n - 40, 3000)]).astype(np.int32)
    return graph_from_edges(src, dst, n, device=cuda)


@pytest.mark.parametrize("f,k", [(64, 2), (128, 4), (12, 3), (5, 1), (6, 3), (127, 4)])
def test_masked_segment_sum_kernel_matches_plain(cuda, hub_graph, f, k):
    """Kernel 12 against its plain version within 1e-5 of the largest value,
    bitwise equal run to run, over a 1,000-edge row and empty rows: the
    16-byte path at K·F of 36 to 512 and the scalar path (F % 4 != 0) at
    K·F of 5 to 508. Rows that are not 16-byte aligned take the scalar path
    and give the same bits."""
    g = hub_graph
    rs = np.random.RandomState(f + k)
    logits = torch.from_numpy(rs.randn(g.n_edge, k * f).astype(np.float32)).to(cuda)
    h_src = torch.from_numpy(rs.randn(g.n_edge, f).astype(np.float32)).to(cuda)
    pat = torch.from_numpy((np.arange(k * f) // f % 2 == 0).astype(np.float32)).to(cuda)
    rp = g.real_row_ptr
    assert int(rp[1] - rp[0]) == 1000
    before = fused_mma.LAUNCHES["masked_segment_sum"]
    got = fused_mma.masked_segment_sum(logits, h_src, pat, rp)
    torch.cuda.synchronize()
    assert fused_mma.LAUNCHES["masked_segment_sum"] == before + 1
    _close(got, fused_mma.masked_segment_sum_reference(logits, h_src, pat, rp))
    assert torch.equal(got, fused_mma.masked_segment_sum(logits, h_src, pat, rp))
    assert (got[260:] == 0).all()
    shifted = torch.empty(logits.numel() + 1, device=cuda)[1:].view_as(logits).copy_(logits)
    assert torch.equal(got, fused_mma.masked_segment_sum(shifted, h_src, pat, rp))


def test_fused_masked_aggregate_on_card_matches_cpu(cuda, hub_graph):
    """``fused_masked_aggregate``'s forward (kernel 12) and its gradients on
    the card against the CPU's plain path; padding edges get no gradient."""
    cpu_graph = hub_graph.to("cpu")
    rs = np.random.RandomState(13)
    f, k = 64, 2
    logits = torch.from_numpy(rs.randn(hub_graph.n_edge, k * f).astype(np.float32))
    h_src = torch.from_numpy(rs.randn(hub_graph.n_edge, f).astype(np.float32))
    pat = torch.from_numpy(np.repeat(np.array([True, False]), f))

    def make(g):
        return lambda l_, h_: fused_mma.fused_masked_aggregate(l_, h_, pat.to(g.src.device), g, k)

    before = fused_mma.LAUNCHES["masked_segment_sum"]
    got, got_g = _grads(make(hub_graph), logits.to(cuda), h_src.to(cuda))
    assert fused_mma.LAUNCHES["masked_segment_sum"] == before + 1
    want, want_g = _grads(make(cpu_graph), logits, h_src)
    _close(got, want)
    for g, w in zip(got_g, want_g):
        _close(g, w)
        assert (g[int(cpu_graph.real_row_ptr[-1]):] == 0).all()


def test_masked_kernel_rejects_what_it_does_not_take(cuda, hub_graph):
    e = hub_graph.n_edge
    logits, h_src = torch.zeros(e, 16, device=cuda), torch.zeros(e, 8, device=cuda)
    pat = torch.ones(16, device=cuda)
    rp = hub_graph.real_row_ptr
    before = fused_mma.LAUNCHES["masked_segment_sum"]
    with pytest.raises(ValueError, match="float32"):
        fused_mma.masked_segment_sum(logits.double(), h_src, pat, rp)
    with pytest.raises(ValueError, match="K·F <= 512"):
        fused_mma.masked_segment_sum(torch.zeros(e, 520, device=cuda),
                                     torch.zeros(e, 130, device=cuda),
                                     torch.ones(520, device=cuda), rp)
    with pytest.raises(ValueError, match="contiguous"):
        fused_mma.masked_segment_sum(torch.zeros(16, e, device=cuda).t(), h_src, pat, rp)
    with pytest.raises(ValueError, match="several devices"):
        fused_mma.masked_segment_sum(logits, h_src.cpu(), pat, rp)
    assert fused_mma.LAUNCHES["masked_segment_sum"] == before


def _masked_f64(logits, h_src, pat, row_ptr):
    """Kernel 12's sum in float64 over the plain version's own float32
    messages (rounded to bf16 for bf16 logits): the kernel's chunked order
    against an exact sum, not against the float32 ``index_add_``'s drift."""
    kf, f = logits.shape[1], h_src.shape[1]
    msg = fused_mma._mask_chain(logits.float(), pat)[0] * h_src.float().repeat(1, kf // f)
    if logits.dtype == torch.bfloat16:
        msg = fused_mma._round_bf16(msg)
    return _sum_f64(msg, row_ptr)


@pytest.mark.parametrize("dtypes", ["f32,f32", "bf16,bf16", "bf16,f32", "f32,bf16"])
@pytest.mark.parametrize("f,k", [(64, 2), (128, 4), (12, 3), (5, 1)])
def test_masked_segment_sum_chunks_match_plain(cuda, chunk_graph, f, k, dtypes):
    """Kernel 12 on kernel 1's chunks over the chunk CSRs (a 3,000-edge row
    split over many chunks and joined by the fixup, empty rows written by
    its zeroing warps, a slice, a CSR that covers nothing, one row among
    2,000 empty ones) for every (logits, h_src) dtype pair: within 1e-5 of
    the float64 sum of the plain version's messages, bitwise equal run to
    run, empty rows 0; with F % 4 == 0 the scalar path (rows off their
    4-lane alignment) gives the vector path's bits."""
    types = {"bf16": torch.bfloat16, "f32": torch.float32}
    ld, hd = (types[t] for t in dtypes.split(","))
    key = "masked_segment_sum" if dtypes == "f32,f32" else "masked_segment_sum_bf16"
    rs = np.random.RandomState(f + k)
    pat = torch.from_numpy((np.arange(k * f) // f % 2 == 0).astype(np.float32)).to(cuda)
    for what, (rp_np, n_edges) in chunk_graph.items():
        rp = torch.from_numpy(rp_np).to(cuda)
        logits = torch.from_numpy(rs.randn(n_edges, k * f).astype(np.float32)).to(cuda, ld)
        h_src = torch.from_numpy(rs.randn(n_edges, f).astype(np.float32)).to(cuda, hd)
        before = fused_mma.LAUNCHES[key]
        got = fused_mma.masked_segment_sum(logits, h_src, pat, rp)
        torch.cuda.synchronize()
        assert fused_mma.LAUNCHES[key] == before + 1, what
        want = _masked_f64(logits, h_src, pat, rp)
        torch.testing.assert_close(got.double(), want, rtol=1e-5,
                                   atol=1e-5 * want.abs().max().item(), msg=what)
        assert torch.equal(got, fused_mma.masked_segment_sum(logits, h_src, pat, rp)), what
        empty = torch.from_numpy(rp_np[1:] == rp_np[:-1]).to(cuda)
        assert (got[empty] == 0).all(), what
        if f % 4 == 0:
            shifted = torch.empty(logits.numel() + 1, dtype=ld, device=cuda)[1:]
            shifted = shifted.view_as(logits).copy_(logits)
            assert torch.equal(got, fused_mma.masked_segment_sum(shifted, h_src, pat, rp)), what


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_masked_segment_sum_replays_in_a_cuda_graph(cuda, chunk_graph, dtype):
    """One kernel-12 call captured in a CUDA graph and replayed gives the
    eager result: chunks and scratch from shapes, no host sync."""
    rp_np, n_edges = chunk_graph["hub"]
    rp = torch.from_numpy(rp_np).to(cuda)
    rs = np.random.RandomState(21)
    logits = torch.from_numpy(rs.randn(n_edges, 128).astype(np.float32)).to(cuda, dtype)
    h_src = torch.from_numpy(rs.randn(n_edges, 64).astype(np.float32)).to(cuda, dtype)
    pat = torch.from_numpy((np.arange(128) < 64).astype(np.float32)).to(cuda)
    eager = fused_mma.masked_segment_sum(logits, h_src, pat, rp)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fused_mma.masked_segment_sum(logits, h_src, pat, rp)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        captured = fused_mma.masked_segment_sum(logits, h_src, pat, rp)
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(captured, eager)


# ---- kernels 9-12 on bf16 operands

@pytest.mark.parametrize("f,kf", [(16, 32), (64, 128), (64, 384), (12, 36), (128, 512)])
def test_bf16_wide_edge_program_chunks_match_plain(cuda, chunk_graph, f, kf):
    """Kernels 9, 10 (with and without its payload) and 11 on bf16 ``d`` and
    ``h`` (and a bf16 ``c``, which they read as float32) against their plain
    versions' formula in float64 on the same values (``_wide_f64``,
    ``_csc_f64``; nothing is rounded to bf16), within 1e-5 of each tensor's
    largest value, over kernel 1's chunk cases (the 3,000-edge
    row, and as a CSC the 3,000-edge source, split across chunks; runs of
    empty rows; a slice with ``row_ptr[0] > 0``; padding positions); K·F of
    384 and 512 take two rounds a row. Counted under the ``_bf16`` keys,
    bitwise equal run to run, empty rows 0."""
    rs = np.random.RandomState(f + kf + 1)
    for what, (rp_np, n_edges) in chunk_graph.items():
        n = len(rp_np) - 1
        rp = torch.from_numpy(rp_np).to(cuda)

        def draw(*shape):
            return torch.from_numpy(rs.randn(*shape).astype(np.float32)).to(cuda)

        c, d, h = draw(n, kf).bfloat16(), draw(n, kf).bfloat16(), draw(n, f).bfloat16()
        ct = draw(n, kf)
        pat = torch.from_numpy((rs.rand(kf) > 0.5).astype(np.float32)).to(cuda)
        src = torch.from_numpy(rs.randint(0, n, n_edges).astype(np.int32)).to(cuda)
        fwd = (c, d, h, pat, src, rp)
        before = dict(fused_mma.LAUNCHES)
        got = fused_mma.edge_program_fwd(*fwd)
        dc, payload = fused_mma.edge_program_bwd(*fwd, ct)
        dc_only, none = fused_mma.edge_program_bwd(*fwd, ct, emit_payload=False)
        csc = fused_mma.edge_program_bwd_csc(*fwd, ct)  # the CSR taken as a CSC
        torch.cuda.synchronize()
        for key, added in (("edge_program_fwd", 1), ("edge_program_bwd", 2),
                           ("edge_program_bwd_csc", 1)):
            assert fused_mma.LAUNCHES[key] == before[key], what
            assert fused_mma.LAUNCHES[key + "_bf16"] == before[key + "_bf16"] + added, what
        for name, g, w in zip(("S", "dc", "payload", "[dd ‖ dh]"), (got, dc, payload, csc),
                              (*_wide_f64(*fwd, ct), _csc_f64(*fwd, ct))):
            assert g.dtype == torch.float32, f"{what} {name}"
            torch.testing.assert_close(g.double(), w, rtol=1e-5,
                                       atol=1e-5 * w.abs().max().item(), msg=f"{what} {name}")
        assert none is None and torch.equal(dc_only, dc), what
        assert torch.equal(got, fused_mma.edge_program_fwd(*fwd)), what
        again = fused_mma.edge_program_bwd(*fwd, ct)
        assert torch.equal(dc, again[0]) and torch.equal(payload, again[1]), what
        assert torch.equal(csc, fused_mma.edge_program_bwd_csc(*fwd, ct)), what
        empty = torch.from_numpy(rp_np[1:] == rp_np[:-1]).to(cuda)
        assert (got[empty] == 0).all() and (dc[empty] == 0).all() and (csc[empty] == 0).all()
        assert (payload[int(rp_np[-1]):] == 0).all(), what


@pytest.mark.parametrize("bwd_mode", ["payload_permute", "csc_gather"])
def test_bf16_wide_edge_program_on_card_matches_cpu(cuda, graph, bwd_mode):
    """``edge_program``'s forward and its bf16 gradients on bf16 ``c``,
    ``d`` and ``h`` on the card (kernels 9, 10 and 1 or 11 in bf16) against
    the CPU's plain path: the forward within 1e-5 of scale, each gradient
    within one bf16 ulp (2⁻⁷ of the value, float32 sums in another order
    rounded once) and 1e-5 of scale."""
    cpu_graph = graph.to("cpu")
    rs = np.random.RandomState(9)
    f, k = 64, 2
    c, d = (torch.from_numpy(rs.randn(graph.n_node, k * f).astype(np.float32)).bfloat16()
            for _ in range(2))
    h = torch.from_numpy(rs.randn(graph.n_node, f).astype(np.float32)).bfloat16()
    pat = torch.from_numpy(np.repeat(np.array([0.0, 1.0], np.float32), f))

    def make(g):
        return lambda c_, d_, h_: fused_mma.edge_program(
            c_, d_, h_, pat.to(g.src.device), g.src, g.real_row_ptr, g.real_col_ptr,
            g.src_perm, g.dst_csc, bwd_mode)

    before = dict(fused_mma.LAUNCHES)
    got, got_g = _grads(make(graph), *(t.to(cuda) for t in (c, d, h)))
    assert fused_mma.LAUNCHES["edge_program_fwd_bf16"] == before["edge_program_fwd_bf16"] + 1
    assert fused_mma.LAUNCHES["edge_program_bwd_bf16"] == before["edge_program_bwd_bf16"] + 1
    want, want_g = _grads(make(cpu_graph), c, d, h)
    _close(got, want)
    for g, w in zip(got_g, want_g):
        assert g.dtype == torch.bfloat16
        torch.testing.assert_close(g.float(), w.float(), rtol=2.0 ** -7,
                                   atol=1e-5 * w.float().abs().max().item())


@pytest.mark.parametrize("dtypes", ["bf16,bf16", "bf16,f32", "f32,bf16"])
@pytest.mark.parametrize("f,k", [(64, 2), (128, 4), (12, 3), (5, 1), (6, 3)])
def test_bf16_masked_segment_sum_kernel_matches_plain(cuda, hub_graph, f, k, dtypes):
    """Kernel 12 on each (logits, h_src) dtype pair with a bf16 operand
    against its plain version (the message rounded to bf16 iff the logits
    are bf16) within 1e-5 of the largest value, over a 1,000-edge row and
    empty rows: 8-byte loads of 4 bf16 lanes at K·F of 36 to 512 (two or
    more lane tiles past 128) and the scalar path (F % 4 != 0). Counted
    under ``masked_segment_sum_bf16``, bitwise equal run to run; rows off
    their 4-lane alignment take the scalar path and give the same bits."""
    g = hub_graph
    rs = np.random.RandomState(f + k + 2)
    types = {"bf16": torch.bfloat16, "f32": torch.float32}
    ld, hd = (types[t] for t in dtypes.split(","))
    logits = torch.from_numpy(rs.randn(g.n_edge, k * f).astype(np.float32)).to(cuda, ld)
    h_src = torch.from_numpy(rs.randn(g.n_edge, f).astype(np.float32)).to(cuda, hd)
    pat = torch.from_numpy((np.arange(k * f) // f % 2 == 0).astype(np.float32)).to(cuda)
    rp = g.real_row_ptr
    before = dict(fused_mma.LAUNCHES)
    got = fused_mma.masked_segment_sum(logits, h_src, pat, rp)
    torch.cuda.synchronize()
    assert fused_mma.LAUNCHES["masked_segment_sum_bf16"] == before["masked_segment_sum_bf16"] + 1
    assert fused_mma.LAUNCHES["masked_segment_sum"] == before["masked_segment_sum"]
    assert got.dtype == torch.float32
    _close(got, fused_mma.masked_segment_sum_reference(logits, h_src, pat, rp))
    assert torch.equal(got, fused_mma.masked_segment_sum(logits, h_src, pat, rp))
    assert (got[260:] == 0).all()
    shifted = torch.empty(logits.numel() + 1, dtype=ld, device=cuda)[1:].view_as(logits)
    assert torch.equal(got, fused_mma.masked_segment_sum(shifted.copy_(logits), h_src, pat, rp))


def test_bf16_wide_kernels_reject_what_they_do_not_take(cuda, graph):
    """``d`` and ``h`` of two dtypes, and float64, raise on the card."""
    n, f, kf = graph.n_node, 16, 32
    c, pat = torch.zeros(n, kf, device=cuda), torch.zeros(kf, device=cuda)
    h = torch.zeros(n, f, device=cuda)
    before = dict(fused_mma.LAUNCHES)
    with pytest.raises(ValueError, match="share a dtype"):
        fused_mma.edge_program_fwd(c, c.bfloat16(), h, pat, graph.src, graph.real_row_ptr)
    with pytest.raises(ValueError, match="float32"):
        fused_mma.edge_program_fwd(c, c.double(), h.double(), pat, graph.src, graph.real_row_ptr)
    assert fused_mma.LAUNCHES == before


# ------------------------------------------- the torch.library operators

def _operator_cases(cuda, graph):
    """``(operator, args, the kernel called directly, its LAUNCHES key)``."""
    from mma_tpu_torch.ops.cuda import segment_minmax as mm

    rs = np.random.RandomState(11)
    n, e = graph.n_node, graph.n_edge
    rp = graph.real_row_ptr

    def draw(*shape):
        return torch.from_numpy(rs.randn(*shape).astype(np.float32)).to(cuda)

    lean = _lean_inputs(cuda, rs, n, e, 16, 32) + (rp,)
    lean16 = _bf16_lean_inputs(cuda, rs, n, e, 16, 32) + (rp,)
    seed = torch.tensor([777], dtype=torch.int32, device=cuda)
    k1, k2 = fused_mma._segment_sum_kernel, fused_mma._edge_program_lean_kernel
    ops = torch.ops.mma_tpu_torch
    return [
        (ops.segment_sum_csr, (draw(e, 16), rp), k1, "segment_sum"),
        (ops.segment_sum_csr, (draw(e, 16).bfloat16(), rp), k1, "segment_sum_bf16"),
        (ops.segment_sum_csr, (draw(n, 12), rp, graph.src), k1, "segment_sum"),
        (ops.segment_sum_csr, (draw(n, 12).bfloat16(), rp, graph.src), k1, "segment_sum_bf16"),
        (ops.edge_program_lean, lean, k2, "edge_program_lean"),
        (ops.edge_program_lean, lean16, k2, "edge_program_lean_bf16"),
        (ops.segment_minmax, (draw(e, 37), rp, ["min", "max"]),
         lambda d, r, o: mm._segment_minmax_kernel(d, r, tuple(o)), "segment_minmax"),
        (ops.minmax_edge_program, (draw(n, 37), draw(e, 37), rp, ["max", "min"], None, 0.5),
         lambda c, h, r, o, s, t: mm._minmax_prog_kernel(c, h, r, tuple(o), s, t), "minmax_prog"),
        (ops.minmax_edge_program, (draw(n, 37), draw(e, 37), rp, ["max"], seed, 0.5),
         lambda c, h, r, o, s, t: mm._minmax_prog_kernel(c, h, r, tuple(o), s, t), "minmax_prog"),
        (ops.segment_sum_sq_csr, (draw(e, 16), rp), fused_mma._segment_sum_sq_kernel,
         "segment_sum_sq"),
        (ops.segment_minmax, (draw(e, 37).bfloat16(), rp, ["min", "max"]),
         lambda d, r, o: mm._segment_minmax_kernel(d, r, tuple(o)), "segment_minmax_bf16"),
        (ops.minmax_edge_program, (draw(n, 37).bfloat16(), draw(e, 37).bfloat16(), rp,
                                   ["max", "min"], seed, 0.5),
         lambda c, h, r, o, s, t: mm._minmax_prog_kernel(c, h, r, tuple(o), s, t),
         "minmax_prog_bf16"),
        (ops.segment_sum_sq_csr, (draw(e, 16).bfloat16(), rp), fused_mma._segment_sum_sq_kernel,
         "segment_sum_sq_bf16"),
    ]


def _launches():
    from mma_tpu_torch.ops.cuda import segment_minmax as mm

    return {**fused_mma.LAUNCHES, **mm.LAUNCHES}


@pytest.mark.parametrize("case", range(13))
def test_operators_are_their_kernels(cuda, graph, case):
    """Each ``mma_tpu_torch::*`` operator on the card is the hand-written
    kernel: bitwise equal to the kernel called directly, one launch a call."""
    op, args, direct, key = _operator_cases(cuda, graph)[case]
    before = _launches()[key]
    got = op(*args)
    torch.cuda.synchronize()
    assert _launches()[key] == before + 1
    assert torch.equal(got, direct(*args))
    assert _launches()[key] == before + 2


def test_exported_forwards_launch_the_kernels(cuda, graph):
    """A node classifier and a ZincNet exported on the card, loaded from the
    bytes: the served outputs equal the eager forwards bit for bit, and each
    request launches kernels 1 and 2 (6 and 1)."""
    from mma_tpu_torch.data import load_zinc
    from mma_tpu_torch.models import NodeClassifier, ZincNet
    from mma_tpu_torch.serve import export_node_classifier, export_zinc_predictor, load_forward

    model = NodeClassifier(24, 16, 5, ("mean", "mean2"), device=cuda,
                           generator=torch.Generator().manual_seed(0))
    x = torch.from_numpy(np.random.RandomState(5).randn(graph.n_node, 24).astype(np.float32))
    x = x.to(cuda)
    params = model.state_dict()
    served = load_forward(export_node_classifier(model, params, x, graph))
    before = _launches()
    with torch.no_grad():
        got = served(params, x, graph)
        torch.cuda.synchronize()
        after = _launches()
        assert torch.equal(got, model(x, graph))
    assert (after["segment_sum"] - before["segment_sum"],
            after["edge_program_lean"] - before["edge_program_lean"]) == (2, 1)
    with pytest.raises(ValueError, match="serves on 'cuda'"):
        served({k: v.cpu() for k, v in params.items()}, x.cpu(), graph.to("cpu"))

    ds = load_zinc("val", subset_size=8)
    net = ZincNet(("min", "max"), ("identity", "amplification", "linear"),
                  {"lin": 2.1, "log": 1.05, "exp": 9.3}, num_layers=2, towers=5, device=cuda,
                  generator=torch.Generator().manual_seed(1))
    batch = next(ds.batches(4, n_node=160, n_edge=400, device=cuda))
    buffers = {k for k, _ in net.named_buffers()}
    weights = net.state_dict()
    p = {k: v for k, v in weights.items() if k not in buffers}
    s = {k: v for k, v in weights.items() if k in buffers}
    served = load_forward(export_zinc_predictor(net, p, s, batch))
    before = _launches()
    with torch.no_grad():
        got = served(p, s, batch)
        torch.cuda.synchronize()
        after = _launches()
        assert torch.equal(got, net(batch))
    assert (after["minmax_prog"] - before["minmax_prog"],
            after["segment_sum"] - before["segment_sum"]) == (2, 1)


def test_checkpoints_restore_to_the_target_device(cuda, tmp_path):
    from mma_tpu_torch.train.checkpoint import restore_checkpoint, save_checkpoint

    gen = torch.Generator(device=cuda).manual_seed(3)
    payload = {"w": torch.randn(4, 3, device=cuda), "key": gen.get_state()}
    save_checkpoint(str(tmp_path), 1, payload)
    _, same = restore_checkpoint(str(tmp_path))
    assert same["w"].device.type == "cuda" and torch.equal(same["w"], payload["w"])
    _, cpu = restore_checkpoint(str(tmp_path), target={"w": torch.zeros(4, 3),
                                                       "key": gen.get_state()})
    assert cpu["w"].device.type == "cpu" and torch.equal(cpu["w"], payload["w"].cpu())
    again = torch.Generator(device=cuda)
    again.set_state(same["key"])
    assert torch.equal(torch.rand(5, generator=again, device=cuda),
                       torch.rand(5, generator=gen, device=cuda))

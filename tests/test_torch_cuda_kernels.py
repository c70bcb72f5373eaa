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
    before = fused_mma.LAUNCHES["edge_program_lean"]
    got = fused_mma.edge_program_lean(*args)
    torch.cuda.synchronize()
    assert fused_mma.LAUNCHES["edge_program_lean"] == before + 1
    _close(got, fused_mma.edge_program_lean_reference(*args))
    assert torch.equal(got, fused_mma.edge_program_lean(*args))  # deterministic
    assert (got[260:300] == 0).all()


def test_kernels_reject_what_they_do_not_take(cuda, graph):
    data = torch.zeros(graph.n_edge, 8, device=cuda)
    with pytest.raises(ValueError, match="float32"):
        fused_mma.segment_sum_csr(data.double(), graph.row_ptr)
    with pytest.raises(ValueError, match="contiguous"):
        fused_mma.segment_sum_csr(data.t(), graph.row_ptr)
    with pytest.raises(NotImplementedError, match="training slice"):
        fused_mma.segment_sum_csr(data.requires_grad_(), graph.row_ptr)
    f = 132  # above the kernel's F limit
    h = torch.zeros(graph.n_node, f, device=cuda)
    with pytest.raises(ValueError, match="F <= 128"):
        fused_mma.edge_program_lean(torch.zeros(graph.n_node, f, device=cuda),
                                    torch.zeros(f, f, device=cuda), h,
                                    torch.zeros(f, device=cuda), graph.src, graph.row_ptr)


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

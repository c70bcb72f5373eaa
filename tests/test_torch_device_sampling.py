"""The neighbour sampler's draws on the device (``data/device_sampling.py``,
``csrc/sampler.cu``), held against the host sampler's bit for bit. The
card's cases carry the ``gpu`` marker.

This file imports neither JAX nor ``mma_tpu``.
"""

import numpy as np
import pytest
import torch

from mma_tpu_torch.data.device_sampling import DeviceSampler, sample_picks
from mma_tpu_torch.data.sampling import NeighborSampler
from mma_tpu_torch.graph import native
from mma_tpu_torch.train.sampled import DeviceTableAssembler, sampled_batch_producer

needs_native = pytest.mark.skipif(not native.available(), reason="no native graph library")


def _graph(n, m, seed, hub=0):
    """A random multigraph with both directions of each pair, plus ``hub``
    extra in-edges of node 0 (a reservoir far longer than any fan-out)."""
    rs = np.random.RandomState(seed)
    a, b = rs.randint(0, n, m), rs.randint(0, n, m)
    keep = a != b
    src = np.concatenate([a[keep], b[keep], rs.randint(1, n, hub)]).astype(np.int32)
    dst = np.concatenate([b[keep], a[keep], np.zeros(hub, np.int64)]).astype(np.int32)
    return src, dst


# (nodes, pairs, hub edges, fan-outs, seeds, repeated seeds)
CASES = [(3000, 20000, 5000, (15, 10, 5), 64, False), (20000, 30000, 0, (4, 3), 300, True),
         (500, 3000, 800, (64, 2), 20, True), (200, 300, 0, (3,), 50, True),
         (50, 0, 0, (2, 2), 8, True)]  # no edges at all: the frontiers empty out


def _pair(case, device="cpu", threads=3):
    n, m, hub, fanouts, n_seeds, repeats = case
    src, dst = _graph(n, m, 1, hub)
    mk = lambda: NeighborSampler.from_host_arrays(src, dst, n, fanouts, seed=7,  # noqa: E731
                                                  n_threads=threads, device=device)
    host = mk()
    pads = dict(n_node_pad=host._structural_node_bound(n_seeds) + 5,
                n_edge_pad=host._structural_edge_bound(n_seeds) + 3)
    rs = np.random.RandomState(3)
    seeds = [(rs.randint(0, n, n_seeds) if repeats else rs.choice(n, n_seeds, replace=False))
             for _ in range(3)]
    return host, mk(), pads, seeds


def _assert_same(host_ar, dev_ar):
    for f in ("src", "dst", "node_ids"):
        want, got = getattr(host_ar, f), getattr(dev_ar, f).cpu().numpy()
        assert got.dtype == want.dtype and np.array_equal(got, want), f
    assert int(dev_ar.num_edges) == host_ar.num_edges
    assert int(dev_ar.num_nodes) == host_ar.num_nodes
    assert dev_ar.num_seeds == host_ar.num_seeds


@needs_native
@pytest.mark.parametrize("case", CASES, ids=lambda c: f"n{c[0]}-fanouts{len(c[3])}")
def test_device_sampler_draws_the_host_samplers_subgraphs(case):
    host, other, pads, seeds = _pair(case)
    dev = DeviceSampler(other)
    for s in seeds:
        _assert_same(host.sample_arrays(s, emit_csc=False, **pads), dev.sample_arrays(s, **pads))
        # Its tables are as they came, spare entry included.
        assert (dev._row_of == -1).all() and (dev._first == torch.iinfo(torch.int32).max).all()
    assert host.rs.randint(0, 2**31) == other.rs.randint(0, 2**31)  # one draw a batch each


@needs_native
def test_device_sampler_refusals():
    host, _, pads, seeds = _pair(CASES[0])
    dev = DeviceSampler(host)
    with pytest.raises(ValueError, match="structural bounds"):
        dev.sample_arrays(seeds[0], n_node_pad=pads["n_node_pad"] - 6,
                          n_edge_pad=pads["n_edge_pad"])
    with pytest.raises(ValueError, match="node ids"):
        dev.sample_arrays(np.array([0, host.num_nodes]), **pads)
    wide = NeighborSampler.from_csr(host.row_ptr, host.src_sorted, (65,), device="cpu")
    with pytest.raises(ValueError, match="fanouts"):
        DeviceSampler(wide)
    asm = DeviceTableAssembler(np.zeros((host.num_nodes, 2), np.float32),
                               np.zeros(host.num_nodes, np.int64), device="cpu")
    deg = torch.from_numpy(host.true_deg)
    for kw in (dict(device_finish=False), dict(device_finish=True, hop_node_pads=(64, 1, 1, 1))):
        with pytest.raises(ValueError, match="DeviceSampler"):
            next(sampled_batch_producer(dev, iter([seeds[0][None]]), asm, deg_table=deg, **pads,
                                        **kw))


# ------------------------------------------------------------------ the card

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc")
    return torch.device("cuda")


@pytest.mark.gpu
def test_picks_kernel_matches_the_host_picks(cuda):
    n, m, hub = 5000, 40000, 20000
    src, dst = _graph(n, m, 2, hub)
    host = NeighborSampler.from_host_arrays(src, dst, n, (5,), seed=1, device="cpu")
    row_ptr = torch.from_numpy(host.row_ptr).cuda()
    src_sorted = torch.from_numpy(host.src_sorted).cuda()
    rs = np.random.RandomState(0)
    for fanout, hop, slots, real in [(15, 0, 1000, 1000), (5, 2, 4096, 3000), (64, 1, 300, 7),
                                     (1, 0, 64, 0)]:
        frontier = rs.randint(0, n, slots).astype(np.int32)
        frontier[0] = 0  # the hub
        seed = int(rs.randint(0, 2**62))
        picks, count = sample_picks(row_ptr, src_sorted, torch.from_numpy(frontier).cuda(),
                                    torch.tensor(real, device="cuda"), fanout, hop,
                                    torch.tensor([seed], device="cuda"))
        want_p, want_c = native.sample_picks(host.row_ptr, host.src_sorted, frontier, real, fanout,
                                             hop, seed)
        assert np.array_equal(picks.cpu().numpy(), want_p)
        assert np.array_equal(count.cpu().numpy(), want_c)


@pytest.mark.gpu
@pytest.mark.parametrize("case", CASES, ids=lambda c: f"n{c[0]}-fanouts{len(c[3])}")
def test_device_sampler_on_the_card_draws_the_host_samplers_subgraphs(cuda, case):
    host, other, pads, seeds = _pair(case)
    dev = DeviceSampler(other, "cuda")
    for s in seeds:
        _assert_same(host.sample_arrays(s, emit_csc=False, **pads), dev.sample_arrays(s, **pads))
    assert (dev._row_of == -1).all() and (dev._first == torch.iinfo(torch.int32).max).all()


@pytest.mark.gpu
def test_producer_with_a_device_sampler_gives_the_host_producers_graphs(cuda):
    host, other, pads, _ = _pair(CASES[0], device="cuda")
    n = host.num_nodes
    rs = np.random.RandomState(5)
    feats, labels = rs.randn(n, 4).astype(np.float32), rs.randint(0, 3, n)
    asm = DeviceTableAssembler(feats, labels, device="cuda")
    deg = torch.from_numpy(host.true_deg).cuda()
    batches = [rs.choice(n, (1, 64), replace=False) for _ in range(4)]
    want = list(sampled_batch_producer(host, iter(batches), asm, device_finish=True,
                                       deg_table=deg, **pads))
    got = list(sampled_batch_producer(DeviceSampler(other), iter(batches), asm,
                                      device_finish=True, deg_table=deg, **pads))
    for (wx, wg, wy, wsm), (x, g, y, sm) in zip(want, got, strict=True):
        assert torch.equal(wx, x) and torch.equal(wy, y) and torch.equal(wsm, sm)
        for f in ("src", "dst", "edge_mask", "node_mask", "deg", "row_ptr", "src_perm",
                  "col_ptr", "src_csc", "dst_csc"):
            assert torch.equal(getattr(wg, f), getattr(g, f)), f

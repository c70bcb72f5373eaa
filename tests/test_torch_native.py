"""The port's native graph-op binding against the JAX package's, on the CPU.

The port compiles its own copy of the source
(``mma_tpu_torch/csrc/graphops.cpp``) with ``g++`` into
``mma_tpu_torch/_build/``; the JAX package loads ``native/libgraphops.so``.
Every entry point is held bit for bit against ``mma_tpu.graph.native`` on
the same numpy inputs, on the native backend and on the NumPy fallbacks
(both modules' loaders patched to report no library). The layered sampler
is held at 1 and 4 threads with the same ``rng_seed``.
"""

import os

import numpy as np
import pytest

from mma_tpu.graph import native as jnative

from mma_tpu_torch.graph import native


def _edges(seed=0, e=5000, n=300):
    rs = np.random.RandomState(seed)
    return (rs.randint(0, n, e).astype(np.int32), rs.randint(0, n, e).astype(np.int32), n)


@pytest.fixture(params=["native", "numpy"])
def backend(request, monkeypatch):
    if request.param == "numpy":
        monkeypatch.setattr(native, "_load", lambda: None)
        monkeypatch.setattr(jnative, "_load", lambda: None)
    else:
        assert native.available() and jnative.available()
    return request.param


def test_library_builds_from_the_ports_source():
    """The library is the port's own build, named by the hash of its source
    and flags, under the port's build directory."""
    assert native.available()
    path = native.library_path()
    assert os.path.exists(path)
    assert os.path.dirname(path) == native.BUILD_DIR
    assert native.BUILD_DIR.endswith(os.path.join("mma_tpu_torch", "_build"))
    assert native.SOURCE.endswith(os.path.join("mma_tpu_torch", "csrc", "graphops.cpp"))


def _outputs(mod, name):
    src, dst, n = _edges()
    if name == "sort_edges":
        return mod.sort_edges(src, dst, n)
    if name == "build_row_ptr":
        return (mod.build_row_ptr(np.sort(dst), n),)
    if name == "degrees":
        return (mod.degrees(dst, n),)
    if name == "symmetrize":
        return mod.symmetrize(src, dst, n)
    d_sorted = np.sort(dst)
    row_ptr = np.zeros(n + 1, np.int64)
    np.cumsum(np.bincount(d_sorted, minlength=n), out=row_ptr[1:])
    if name == "balanced_row_cuts":
        return (mod.balanced_row_cuts(row_ptr.astype(np.int32), 4),)
    # partition_ldg over a symmetric CSR.
    ss, dd = jnative.symmetrize(src, dst, n)
    rp = np.zeros(n + 1, np.int64)
    np.cumsum(np.bincount(dd, minlength=n), out=rp[1:])
    return (mod.partition_ldg(rp, ss, 4),)


@pytest.mark.parametrize("name", ["sort_edges", "build_row_ptr", "degrees", "symmetrize",
                                  "balanced_row_cuts", "partition_ldg"])
def test_entry_points_match_jax_bit_for_bit(backend, name):
    """Exact equality (values and dtypes): both run the same integer code."""
    got, want = _outputs(native, name), _outputs(jnative, name)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        if w is None:  # partition_ldg without the library
            assert g is None and backend == "numpy"
            continue
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)


def _csr(n=2000, m=12000, seed=0):
    rs = np.random.RandomState(seed)
    a = rs.randint(0, n, m).astype(np.int32)
    b = rs.randint(0, n, m).astype(np.int32)
    keep = a != b
    src = np.concatenate([a[keep], b[keep]])
    dst = np.concatenate([b[keep], a[keep]])
    s, d, _ = jnative.sort_edges(src, dst, n)
    row_ptr = jnative.build_row_ptr(d, n).astype(np.int64)
    return row_ptr, s, rs.choice(n, 64, replace=False).astype(np.int32)


@pytest.mark.parametrize("threads", [1, 4])
def test_sample_layered_matches_jax_at_any_thread_count(threads):
    """Same rng_seed → the same nodes, hop counts and local edges as the JAX
    binding (bit for bit), and as the port at one thread."""
    row_ptr, src_sorted, seeds = _csr()
    args = (row_ptr, src_sorted, seeds, (10, 5, 3))
    kw = dict(rng_seed=123456789, node_cap=20000, edge_cap=20000)
    got = native.sample_layered(*args, n_threads=threads, **kw)
    want = jnative.sample_layered(*args, n_threads=threads, **kw)
    one = native.sample_layered(*args, n_threads=1, **kw)
    for g, w, o in zip(got, want, one):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)
        np.testing.assert_array_equal(g, o)
    nodes, hops, src_l, dst_l = got
    assert hops[0] == len(seeds) and hops.sum() == len(nodes)
    assert src_l.max() < len(nodes) and dst_l.max() < len(nodes)


def test_sample_layered_caps_and_wide_fanouts_as_jax():
    """Cap overflows raise ValueError in both; a fanout over 64 returns None
    in both (the sampler then takes its NumPy path)."""
    row_ptr, src_sorted, seeds = _csr()
    for mod in (native, jnative):
        with pytest.raises(ValueError, match="node_cap"):
            mod.sample_layered(row_ptr, src_sorted, seeds, (10, 10), 1, 2, 100, 20000)
        with pytest.raises(ValueError, match="edge_cap"):
            mod.sample_layered(row_ptr, src_sorted, seeds, (10, 10), 1, 2, 20000, 100)
        assert mod.sample_layered(row_ptr, src_sorted, seeds, (65,), 1, 2, 20000, 20000) is None


def test_sample_layered_is_none_without_the_library(monkeypatch):
    row_ptr, src_sorted, seeds = _csr()
    monkeypatch.setattr(native, "_load", lambda: None)
    assert not native.available()
    assert native.sample_layered(row_ptr, src_sorted, seeds, (4,), 1, 2, 20000, 20000) is None


@pytest.mark.parametrize("name", ["sort_edges", "build_row_ptr", "degrees", "sample_layered"])
def test_ids_out_of_range_are_refused(backend, name):
    """The native code indexes by node id: an id outside ``[0, n)`` raises
    ValueError before any pointer is passed, on both backends (the JAX
    binding does not check; its library would write out of bounds).
    Without the library ``sample_layered`` returns None as before."""
    row_ptr, src_sorted, _ = _csr()
    bad = np.array([0, 5, 2000], np.int32)  # n = 2000
    if name == "sample_layered" and backend == "numpy":
        assert native.sample_layered(row_ptr, src_sorted, bad, (4,), 1, 2, 20000, 20000) is None
        return
    with pytest.raises(ValueError, match=r"\[0, 2000\)"):
        if name == "sort_edges":
            native.sort_edges(bad, bad[::-1].copy(), 2000)
        elif name == "build_row_ptr":
            native.build_row_ptr(bad, 2000)
        elif name == "degrees":
            native.degrees(bad, 2000)
        else:
            native.sample_layered(row_ptr, src_sorted, bad, (4,), 1, 2, 20000, 20000)

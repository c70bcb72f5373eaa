"""The port's serving export (``mma_tpu_torch.serve``), mirroring
``tests/test_serving.py``: serialize to bytes, load in a fresh callable,
and serve.

Each served output is held against the port's eager forward (rtol 1e-6;
1e-5 for the degree-exact ZINC batch, as there) and against the JAX
package's ``model.apply`` on the same weights (carried by ``convert.py``)
at the tolerances of ``tests/test_torch_node_classifier.py`` (1e-4 against
the XLA path, 2e-3 against the Pallas path) and
``tests/test_torch_zinc_net.py`` (1e-5 of the largest prediction). The
exported graphs must call the ``mma_tpu_torch::*`` operators of the path.
"""

import dataclasses
import io
import logging
import os
import subprocess
import sys

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from mma_tpu.data import load_zinc as jax_load_zinc
from mma_tpu.data.batching import degree_budgets as jax_degree_budgets
from mma_tpu.models import NodeClassifier as JaxNodeClassifier
from mma_tpu.models import ZincNet as JaxZincNet
from mma_tpu.nn.mma_conv import compute_avg_deg as jax_compute_avg_deg

from helpers import random_symmetric_graph

from mma_tpu_torch import NodeClassifier, graph_from_edges
from mma_tpu_torch.convert import node_classifier_to_numpy, zinc_net_to_numpy
from mma_tpu_torch.data import load_zinc
from mma_tpu_torch.data.batching import degree_budgets
from mma_tpu_torch.models import ZincNet
from mma_tpu_torch.nn.mma_conv import compute_avg_deg
from mma_tpu_torch.ops.cuda import fused_mma
from mma_tpu_torch.ops.ell import max_indegree
from mma_tpu_torch.serve import (
    export_forward,
    export_node_classifier,
    export_zinc_predictor,
    load_forward,
)
from mma_tpu_torch.train.checkpoint import restore_checkpoint, save_checkpoint

TOL = {False: 1e-4, True: 2e-3}  # tests/test_torch_node_classifier.py:35
ZINC_AGGS = (("min", "max"), ("identity", "amplification", "linear"))
PNA_AGGS = (("mean", "min", "max", "std"), ("identity", "amplification", "attenuation"))


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _node_graphs(seed):
    a, _, jg = random_symmetric_graph(30, p=0.2, seed=seed)
    dst, src = np.nonzero(a)
    return jg, graph_from_edges(src.astype(np.int32), dst.astype(np.int32), 30, device="cpu")


def _node_setup(seed=0, compute_dtype="float32"):
    jg, tg = _node_graphs(seed)
    x = np.random.RandomState(seed).randn(jg.n_node, 12).astype(np.float32)
    jmodel = JaxNodeClassifier(n_feat=12, n_hidden=16, n_class=5, aggregators=("mean", "mean2"),
                               dropout_rate=0.5, compute_dtype=compute_dtype)
    model = NodeClassifier(12, 16, 5, ("mean", "mean2"), dropout_rate=0.5,
                           compute_dtype=compute_dtype, device="cpu",
                           generator=torch.Generator().manual_seed(seed))
    return jmodel, model, dict(model.state_dict()), x, jg, tg


def _jax_node(jmodel, model, x, jg, **kw):
    """The JAX eval forward on the port model's weights."""
    fwd = jax.jit(lambda p, x_, g: jmodel.apply(p, x_, g, training=False, **kw))
    return np.asarray(fwd(node_classifier_to_numpy(model), jnp.asarray(x), jg))


def _eager(model, *args):
    with torch.no_grad():
        return model(*args)


def _close(got, want, rtol):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=rtol, atol=rtol * np.abs(want).max())


def _ops(blob):
    program = torch.export.load(io.BytesIO(blob))
    return {str(n.target).split(".")[1] for n in program.graph.nodes
            if str(n.target).startswith("mma_tpu_torch.")}


def test_node_classifier_export_roundtrip():
    jmodel, model, params, x, jg, tg = _node_setup()
    blob = export_node_classifier(model, params, torch.from_numpy(x), tg)
    assert isinstance(blob, bytes) and len(blob) > 0
    assert _ops(blob) == {"segment_sum_csr", "edge_program_lean"}

    got = load_forward(blob)(params, torch.from_numpy(x), tg)
    want = _eager(model, torch.from_numpy(x), tg)
    n = 30
    _close(got[:n], want[:n], 1e-6)
    _close(got[:n], _jax_node(jmodel, model, x, jg)[:n], TOL[False])


def test_export_generalizes_over_same_shape_graphs():
    """One artifact serves any graph with the same padded shapes."""
    _, model, params, x, _, tg = _node_setup(seed=0)
    served = load_forward(export_node_classifier(model, params, torch.from_numpy(x), tg))

    jg2, tg2 = _node_graphs(seed=7)
    assert (tg2.n_node, tg2.n_edge) == (tg.n_node, tg.n_edge)
    assert not torch.equal(tg2.row_ptr, tg.row_ptr)
    x2 = torch.from_numpy(np.random.RandomState(9).randn(tg2.n_node, 12).astype(np.float32))
    _close(served(params, x2, tg2)[:30], _eager(model, x2, tg2)[:30], 1e-6)


def _zinc_setup(aggs, scalers, **kw):
    """The port's ZincNet at its own init, and the JAX ZincNet with the
    same weights (``zinc_net_to_numpy``; the JAX init alone takes seconds)."""
    avg = compute_avg_deg(load_zinc("val", subset_size=8).degree_histogram(), parity=True)
    javg = jax_compute_avg_deg(jnp.asarray(jax_load_zinc("val", subset_size=8).degree_histogram()),
                               parity=True)
    jmodel = JaxZincNet(aggregators=aggs, scalers=scalers, avg_deg=tuple(javg.items()),
                        towers=5, num_layers=2, **kw)
    model = ZincNet(aggs, scalers, avg, towers=5, num_layers=2, device="cpu",
                    generator=torch.Generator().manual_seed(0), **kw)
    jparams, jstate = zinc_net_to_numpy(model)
    buffers = {name for name, _ in model.named_buffers()}
    weights = model.state_dict()
    params = {k: v for k, v in weights.items() if k not in buffers}
    state = {k: v for k, v in weights.items() if k in buffers}
    return jmodel, jparams, jstate, model, params, state


@pytest.mark.parametrize("aggs,scalers,ops", [
    ZINC_AGGS + ({"minmax_edge_program", "segment_sum_csr"},),
    PNA_AGGS + ({"segment_minmax", "segment_sum_csr", "segment_sum_sq_csr"},),
])
def test_zinc_export_roundtrip(aggs, scalers, ops):
    """``min,max`` takes the fused edge program (kernel 6), the PNA set the
    general route (kernels 1, 4 and 8); both pool with kernel 1."""
    jmodel, jparams, jstate, model, params, state = _zinc_setup(aggs, scalers)
    batch = next(load_zinc("val", subset_size=8).batches(4, n_node=160, n_edge=400, device="cpu"))
    blob = export_zinc_predictor(model, params, state, batch)
    assert _ops(blob) == ops

    got = load_forward(blob)(params, state, batch)
    assert got.shape == (4,)
    _close(got, _eager(model, batch), 1e-6)
    jbatch = next(jax_load_zinc("val", subset_size=8).batches(4, n_node=160, n_edge=400))
    want, _ = jax.jit(lambda p, s, b: jmodel.apply(p, s, b, training=False))(
        jparams, jstate, jbatch)
    _close(got, want, 1e-5)


def test_export_restored_checkpoint_params(tmp_path):
    """Checkpoint-restored params feed the served artifact unchanged."""
    _, model, params, x, _, tg = _node_setup()
    save_checkpoint(str(tmp_path), 3, {"params": params})
    step, payload = restore_checkpoint(str(tmp_path), target={"params": params})
    assert step == 3

    served = load_forward(export_node_classifier(model, params, torch.from_numpy(x), tg))
    got = served(payload["params"], torch.from_numpy(x), tg)
    _close(got[:30], _eager(model, torch.from_numpy(x), tg)[:30], 1e-6)


def test_ell_hint_graph_export_roundtrip():
    """The graph's static ``ell_hint`` travels through the JSON context; the
    ELL forward route round-trips, against the JAX package's Pallas path."""
    jmodel, model, params, x, jg, tg = _node_setup(seed=4)
    hint = ((tg.n_node, max_indegree(tg)),)
    t_ell = dataclasses.replace(tg, ell_hint=hint)
    blob = export_node_classifier(model, params, torch.from_numpy(x), t_ell)
    assert "edge_program_lean" not in _ops(blob)  # the ELL route: plain slot sums
    got = load_forward(blob)(params, torch.from_numpy(x), t_ell)
    _close(got[:30], _eager(model, torch.from_numpy(x), t_ell)[:30], 1e-6)
    want = _jax_node(jmodel, model, x, dataclasses.replace(jg, ell_hint=hint), use_pallas=True)
    _close(got[:30], want[:30], TOL[True])
    with pytest.raises(Exception):  # another static layout is another artifact
        load_forward(blob)(params, torch.from_numpy(x), tg)


def test_degree_exact_batch_export_roundtrip():
    """The degree-exact collate's static fields (``ell_hint``, ``ell_exact``,
    ``csc_ell_exact``, ``BatchedGraphs.nodes_grouped``) travel through the
    JSON context; the exact-ELL ZincNet forward round-trips."""
    jmodel, jparams, jstate, model, params, state = _zinc_setup(*ZINC_AGGS, max_degree_hint=4)
    ds, jds = load_zinc("val", subset_size=8), jax_load_zinc("val", subset_size=8)
    idx = list(range(4))
    args = ([int(ds.num_nodes[i]) for i in idx], [ds.edge_dst[i] for i in idx],
            [ds.edge_dst[i] for i in idx], 4)
    budgets = degree_budgets(*args)
    assert tuple(budgets) == tuple(jax_degree_budgets(*args))
    batch = next(ds.batches(4, n_node=256, n_edge=512, ell_degree_budgets=budgets, device="cpu"))
    assert batch.graph.ell_exact and not batch.nodes_grouped

    def fwd(p, b):
        return torch.func.functional_call(model, {**p, **state}, (b,))

    served = load_forward(export_forward(fwd, (params, batch)))
    got = served(params, batch)
    _close(got, _eager(model, batch), 1e-5)
    jbatch = next(jds.batches(4, n_node=256, n_edge=512, ell_degree_budgets=budgets))
    want, _ = jax.jit(lambda p, s, b: jmodel.apply(p, s, b, training=False, use_pallas=True))(
        jparams, jstate, jbatch)
    _close(got, want, 1e-5)


def test_bf16_node_classifier_exports_and_serves():
    """The bf16 edge pipeline exports: kernels 1 and 2 take bf16 operands
    inside the operators. Against the JAX Pallas path at the bf16 layer
    tolerance of ``tests/test_torch_bf16.py`` (1e-2 of the scale)."""
    jmodel, model, params, x, jg, tg = _node_setup(seed=2, compute_dtype="bfloat16")
    blob = export_node_classifier(model, params, torch.from_numpy(x), tg)
    assert _ops(blob) == {"segment_sum_csr", "edge_program_lean"}
    got = load_forward(blob)(params, torch.from_numpy(x), tg)
    assert got.dtype == torch.float32
    _close(got[:30], _eager(model, torch.from_numpy(x), tg)[:30], 1e-6)
    want = _jax_node(jmodel, model, x, jg, use_pallas=True)[:30]
    assert np.abs(got[:30].numpy() - want).max() <= 1e-2 * np.abs(want).max()


@pytest.mark.parametrize("aggs,scalers,ops", [
    ZINC_AGGS + ({"minmax_edge_program", "segment_sum_csr"},),
    PNA_AGGS + ({"segment_minmax", "segment_sum_csr", "segment_sum_sq_csr"},),
])
def test_bf16_zinc_net_exports_and_serves(aggs, scalers, ops):
    """A bf16 ZincNet exports: kernels 4, 6 and 8 (and 1) take bf16 operands
    inside the operators, whose outputs stay float32. Against the JAX
    bf16 Pallas path at the bf16 layer tolerance of
    ``tests/test_torch_zinc_bf16.py`` (1e-2 of the scale)."""
    jmodel, jparams, jstate, model, params, state = _zinc_setup(aggs, scalers,
                                                                compute_dtype="bfloat16")
    batch = next(load_zinc("val", subset_size=8).batches(4, n_node=160, n_edge=400, device="cpu"))
    blob = export_zinc_predictor(model, params, state, batch)
    assert _ops(blob) == ops
    got = load_forward(blob)(params, state, batch)
    assert got.dtype == torch.float32 and got.shape == (4,)
    _close(got, _eager(model, batch), 1e-6)
    jbatch = next(jax_load_zinc("val", subset_size=8).batches(4, n_node=160, n_edge=400))
    want, _ = jax.jit(lambda p, s, b: jmodel.apply(p, s, b, training=False, use_pallas=True))(
        jparams, jstate, jbatch)
    want = np.asarray(want)
    assert np.abs(got.numpy() - want).max() <= 1e-2 * np.abs(want).max()


def test_loading_never_falls_back_to_unsafe_unpickling(caplog):
    """The artifact keeps no pickled containers, so ``torch.export.load``
    never retries with ``weights_only=False``; an artifact that would need
    that retry (its example inputs kept, which pickle the Graph) is refused."""
    _, model, params, x, _, tg = _node_setup()
    with caplog.at_level(logging.WARNING):
        served = load_forward(export_node_classifier(model, params, torch.from_numpy(x), tg))
        served(params, torch.from_numpy(x), tg)
    assert not [r for r in caplog.records if "weights_only" in r.getMessage()]

    def forward(p, x_, g):
        return torch.func.functional_call(model, p, (x_, g))

    with torch.no_grad():
        from mma_tpu_torch.serve import _Forward

        program = torch.export.export(_Forward(forward), (params, torch.from_numpy(x), tg),
                                      strict=False)
    buf = io.BytesIO()
    torch.export.save(program, buf, extra_files={"mma_tpu_torch_serve.json": '{"device": "cpu"}'})
    with pytest.raises(Exception, match="weights_only"):
        load_forward(buf.getvalue())


def test_device_and_platform_checks():
    _, model, params, x, _, tg = _node_setup()
    xt = torch.from_numpy(x)
    with pytest.raises(ValueError, match="cross-lower"):
        export_node_classifier(model, params, xt, tg, platforms=("tpu",))
    with pytest.raises(ValueError, match="cross-lower"):
        export_node_classifier(model, params, xt, tg, platforms=("cuda",))
    blob = export_node_classifier(model, params, xt, tg, platforms=("cpu",), use_pallas=True)
    served = load_forward(blob)
    meta = {k: v.to("meta") for k, v in params.items()}
    with pytest.raises(ValueError, match="serves on 'cpu'"):
        served(meta, xt.to("meta"), tg.to("meta"))
    before = dict(fused_mma.LAUNCHES)
    served(params, xt, tg)
    assert fused_mma.LAUNCHES == before  # the plain versions on the CPU


def test_a_fresh_process_loads_the_artifact(tmp_path):
    """A process that imports only ``mma_tpu_torch.serve`` loads a ZINC
    artifact: loading defines the operators it calls."""
    _, _, _, model, params, state = _zinc_setup(*PNA_AGGS)
    batch = next(load_zinc("val", subset_size=8).batches(4, n_node=160, n_edge=400, device="cpu"))
    path = tmp_path / "zinc.pt2"
    path.write_bytes(export_zinc_predictor(model, params, state, batch))
    code = ("import sys; from mma_tpu_torch.serve import load_forward; "
            "load_forward(open(sys.argv[1], 'rb').read()); print('loaded')")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = subprocess.run([sys.executable, "-c", code, str(path)], capture_output=True, text=True,
                         env={**os.environ, "PYTHONPATH": root}, timeout=300)
    assert out.returncode == 0 and out.stdout.strip() == "loaded", out.stderr

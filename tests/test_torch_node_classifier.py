"""The port's layers and node classifier against the JAX package's eval
forward, with the JAX parameters carried over by ``convert.py``."""

import dataclasses
import subprocess
import sys

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from mma_tpu.data import load_planetoid as jax_load_planetoid
from mma_tpu.graph.build import graph_from_edges as jax_graph_from_edges
from mma_tpu.models import NodeClassifier as JaxNodeClassifier
from mma_tpu.nn.gcn import GraphConvolution as JaxGraphConvolution
from mma_tpu.nn.mma_layer import MMALayer as JaxMMALayer

from mma_tpu_torch import (
    GraphConvolution,
    MMALayer,
    NodeClassifier,
    graph_from_edges,
    load_planetoid,
)
from mma_tpu_torch.convert import node_classifier_from_jax
from mma_tpu_torch.train import NODE_CLS_PRESETS, train_node_classification

# JAX XLA path: f32 with a different summation order; Pallas path: the
# TPU kernels' bf16-split "high" precision (tests/test_graph_and_native.py).
TOL = {False: 1e-4, True: 2e-3}


@pytest.fixture(scope="module")
def small():
    rs = np.random.RandomState(0)
    n = 200
    src = rs.randint(0, n, 1600).astype(np.int32)
    dst = rs.randint(0, n - 20, 1600).astype(np.int32)  # 20 nodes without in-edges
    jg = jax_graph_from_edges(src, dst, n)
    tg = graph_from_edges(src, dst, n, device="cpu")
    x = rs.randn(jg.n_node, 24).astype(np.float32)
    return jg, tg, x, n


def _np_tree(params):
    return jax.tree.map(np.asarray, params)


def _load(module, params):
    with torch.no_grad():
        for name, value in params.items():
            getattr(module, name).copy_(torch.tensor(np.asarray(value)))


@pytest.mark.parametrize("use_pallas", [False, True])
def test_graph_convolution_matches_jax(small, use_pallas):
    jg, tg, x, n = small
    jlayer = JaxGraphConvolution(24, 16)
    params = jlayer.init(jax.random.PRNGKey(0))
    want = np.asarray(jlayer.apply(params, jnp.asarray(x), jg, use_pallas=use_pallas))
    layer = GraphConvolution(24, 16, device="cpu")
    _load(layer, _np_tree(params))
    got = layer(torch.from_numpy(x), tg).detach().numpy()
    np.testing.assert_allclose(got[:n], want[:n], rtol=TOL[use_pallas], atol=TOL[use_pallas])


@pytest.mark.parametrize("use_pallas", [False, True])
@pytest.mark.parametrize("aggs", [("mean", "mean2"), ("sum", "max", "min", "softmax")])
def test_mma_layer_matches_jax(small, use_pallas, aggs):
    jg, tg, x, n = small
    h = x[:, :16]
    jlayer = JaxMMALayer(in_features=16, out_features=8, aggregators=aggs)
    params = jlayer.init(jax.random.PRNGKey(1))
    want = np.asarray(jlayer.apply(params, jnp.asarray(h), jg, use_pallas=use_pallas))
    layer = MMALayer(16, 8, aggs, device="cpu")
    _load(layer, _np_tree(params))
    got = layer(torch.from_numpy(np.ascontiguousarray(h)), tg).detach().numpy()
    np.testing.assert_allclose(got[:n], want[:n], rtol=TOL[use_pallas], atol=TOL[use_pallas])


@pytest.mark.parametrize("use_pallas", [False, True])
def test_node_classifier_matches_jax(small, use_pallas):
    jg, tg, x, n = small
    jmodel = JaxNodeClassifier(n_feat=24, n_hidden=16, n_class=5, aggregators=("mean", "mean2"))
    params = jmodel.init(jax.random.PRNGKey(2))
    want = np.asarray(jmodel.apply(params, jnp.asarray(x), jg, training=False,
                                   use_pallas=use_pallas))
    model = NodeClassifier(24, 16, 5, ("mean", "mean2"), device="cpu")
    node_classifier_from_jax(_np_tree(params), model)
    got = model(torch.from_numpy(x), tg).detach().numpy()
    np.testing.assert_allclose(got[:n], want[:n], rtol=TOL[use_pallas], atol=TOL[use_pallas])


def test_cora_preset_forward_matches_jax_xla():
    """The README preset at full width: 1433 features, hidden 64, mean,mean2."""
    jdata = jax_load_planetoid("cora")
    data = load_planetoid("cora", device="cpu")
    jmodel = JaxNodeClassifier(n_feat=1433, n_hidden=64, n_class=7,
                               aggregators=("mean", "mean2"), dropout_rate=0.75)
    params = jmodel.init(jax.random.PRNGKey(0))
    want = np.asarray(jmodel.apply(params, jnp.asarray(jdata.features), jdata.graph))
    model = NodeClassifier(1433, 64, 7, ("mean", "mean2"), dropout_rate=0.75, device="cpu")
    node_classifier_from_jax(_np_tree(params), model)
    with torch.no_grad():
        got = model(data.features, data.graph).numpy()
    n = data.num_nodes
    np.testing.assert_allclose(got[:n], want[:n], rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(np.exp(got[:n]).sum(axis=1), 1.0, rtol=1e-5)


def test_convert_rejects_mismatched_params(small):
    model = NodeClassifier(24, 16, 5, ("mean", "mean2"), device="cpu")
    params = _np_tree(JaxNodeClassifier(24, 16, 5, ("mean",)).init(jax.random.PRNGKey(0)))
    with pytest.raises(ValueError, match="masks"):
        node_classifier_from_jax(params, model)


def test_unported_requests_raise(small):
    _, tg, x, _ = small
    with pytest.raises(NotImplementedError):
        MMALayer(16, 8, ("mean",), compute_dtype="bfloat16", device="cpu")
    with pytest.raises(NotImplementedError):
        NodeClassifier(24, 16, 5, ("mean",), compute_dtype="auto", device="cpu")
    with pytest.raises(NotImplementedError, match="checkpoint"):
        train_node_classification(
            dataclasses.replace(NODE_CLS_PRESETS["cora"], checkpoint_dir="ckpt"), device="cpu")
    with pytest.raises(NotImplementedError, match="checkpoint"):
        train_node_classification(dataclasses.replace(NODE_CLS_PRESETS["cora"], resume=True),
                                  device="cpu")
    # The moment combines and mask dropout run.
    out = MMALayer(16, 8, ("moment_3",), parity=False, device="cpu")(
        torch.from_numpy(np.ascontiguousarray(x[:, :16])), tg)
    assert torch.isfinite(out[:200]).all()
    model = NodeClassifier(24, 16, 5, ("mean",), device="cpu")
    out = model(torch.from_numpy(x), tg, training=True, generator=torch.Generator().manual_seed(0))
    assert torch.isfinite(out[:200]).all()


def test_port_imports_neither_jax_nor_mma_tpu():
    code = (
        "import pkgutil, importlib, sys, mma_tpu_torch\n"
        "for m in pkgutil.walk_packages(mma_tpu_torch.__path__, 'mma_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = sorted(k for k in sys.modules if k.split('.')[0] in ('jax', 'jaxlib', 'mma_tpu'))\n"
        "assert not bad, bad\n"
        "for name in ('mma_tpu_torch.train.loops', 'mma_tpu_torch.cli.train_node'):\n"
        "    assert name in sys.modules, name\n"
        "print('ok')\n"
    )
    import os

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    res = subprocess.run([sys.executable, "-c", code], cwd=root, capture_output=True,
                         text=True, timeout=120)
    assert res.returncode == 0 and res.stdout.strip() == "ok", res.stderr


def test_model_entry_points_default_to_gpu():
    if torch.cuda.is_available():
        pytest.skip("this host has a GPU: the default device is valid here")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        NodeClassifier(24, 16, 5, ("mean", "mean2"))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        MMALayer(16, 8, ("mean",))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        GraphConvolution(24, 16)

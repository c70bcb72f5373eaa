"""Helpers for the port's multi-process tests (``tests/test_torch_parallel.py``,
``test_torch_dp_edge.py``, ``test_torch_sampled_dp.py``).

A test module's fixture writes its inputs (numpy only) to a pickle, starts a
gloo world of W processes on the CPU with
:func:`mma_tpu_torch.parallel.launch_local`, and each rank runs one of the
module's worker functions over the inputs and writes its results to its own
pickle. The ranks import the test module itself, so a test module imports
neither ``jax`` nor ``mma_tpu`` at its top: the JAX side runs inside the
test functions, in the pytest process. This module imports neither.
"""

from __future__ import annotations

import contextlib
import os
import pickle
from typing import Dict, List, Optional

import numpy as np
import torch
import torch.distributed as dist

from mma_tpu_torch.graph.container import Graph

TESTS_DIR = os.path.dirname(os.path.abspath(__file__))
REPO_DIR = os.path.dirname(TESTS_DIR)
GRAPH_FIELDS = ("src", "dst", "edge_mask", "node_mask", "deg", "row_ptr", "src_perm",
                "col_ptr", "src_csc", "dst_csc")


def run_world(target: str, world_size: int, inputs: dict, workdir: str,
              timeout: float = 300.0) -> List[dict]:
    """Run ``target`` (``"module:function"``, called as ``function(workdir)``)
    in a gloo world of ``world_size`` ranks over ``inputs``; returns each
    rank's results, in rank order."""
    from mma_tpu_torch.parallel import launch_local

    os.makedirs(workdir, exist_ok=True)
    with open(os.path.join(workdir, "inputs.pkl"), "wb") as f:
        pickle.dump(inputs, f)
    path = os.pathsep.join([TESTS_DIR, REPO_DIR, os.environ.get("PYTHONPATH", "")])
    launch_local(target, world_size, [workdir], env={"PYTHONPATH": path}, timeout=timeout)
    out = []
    for rank in range(world_size):
        with open(os.path.join(workdir, f"rank{rank}.pkl"), "rb") as f:
            out.append(pickle.load(f))
    return out


def rank_inputs(workdir: str) -> dict:
    with open(os.path.join(workdir, "inputs.pkl"), "rb") as f:
        return pickle.load(f)


def write_rank_results(workdir: str, results: dict) -> None:
    with open(os.path.join(workdir, f"rank{dist.get_rank()}.pkl"), "wb") as f:
        pickle.dump(results, f)


def graph_arrays(graph) -> Dict[str, Optional[np.ndarray]]:
    """A graph's array fields (of either package) as numpy arrays."""
    return {f: None if getattr(graph, f) is None else np.asarray(getattr(graph, f))
            for f in GRAPH_FIELDS}


def graph_from_arrays(arrays: Dict[str, Optional[np.ndarray]], **static) -> Graph:
    return Graph(**{f: None if arrays[f] is None else torch.from_numpy(np.array(arrays[f]))
                    for f in GRAPH_FIELDS}, **static)


def numpy_tree(tree):
    """A nested dict/list of arrays (a JAX parameter tree) as numpy arrays."""
    if isinstance(tree, dict):
        return {k: numpy_tree(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [numpy_tree(v) for v in tree]
    return np.asarray(tree)


def grads_numpy(model: torch.nn.Module) -> Dict[str, np.ndarray]:
    return {n: p.grad.detach().numpy().copy() for n, p in model.named_parameters()}


def params_numpy(model: torch.nn.Module) -> Dict[str, np.ndarray]:
    return {n: p.detach().numpy().copy() for n, p in model.named_parameters()}


@contextlib.contextmanager
def world_of_one():
    """A gloo process group of this process alone, for the length of the
    block; yields a one-axis mesh ``("edge",)``."""
    from mma_tpu_torch.parallel import initialize_distributed, make_mesh

    saved = {k: os.environ.pop(k) for k in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_PORT")
             if k in os.environ}
    initialize_distributed("cpu")
    try:
        yield make_mesh(("edge",), device_type="cpu")
    finally:
        dist.destroy_process_group()
        os.environ.update(saved)


def bn_fed(name: str) -> bool:
    """A ZincNet conv's bias that only shifts a training BatchNorm's input by
    a constant per channel (its ``lin.b``, its post-NNs' biases): the
    BatchNorm subtracts it again, so its gradient is 0 in exact arithmetic
    and rounding noise in both packages."""
    return name.startswith("conv") and name.endswith(".b") and (
        ".lin." in name or ".post_nns." in name)


def hold_zinc_grads(got: Dict[str, np.ndarray], want: Dict[str, np.ndarray]) -> None:
    """ZincNet gradients (port names) within rtol 2e-4, atol 1e-5; the
    BatchNorm-fed biases on both sides within 1e-5 of the largest gradient
    of the same conv's ``lin.w`` (``tests/test_torch_zinc_net.py``'s rule)."""
    for name, w in want.items():
        if bn_fed(name):
            scale = np.abs(want[name.split(".")[0] + ".lin.w"]).max()
            assert np.abs(got[name]).max() <= 1e-5 * scale, name
            assert np.abs(w).max() <= 1e-5 * scale, name
        else:
            np.testing.assert_allclose(got[name], w, rtol=2e-4, atol=1e-5, err_msg=name)


def hold_adam_params(got: Dict[str, np.ndarray], want: Dict[str, np.ndarray],
                     grads1: Dict[str, np.ndarray], lr: float, steps: int) -> None:
    """Parameters after ``steps`` Adam steps, by ``tests/test_torch_zinc_net.py``'s
    rule with ``tests/test_dp_edge.py``'s tolerance: within rtol 2e-4, atol
    1e-4 where the first step's gradient (``grads1``) exceeds 5e-2 of its
    tensor's largest, and within 2·lr·steps elsewhere. Adam divides by √v,
    so an element whose gradient is a small fraction of its tensor's, or
    rounding noise (the BatchNorm-fed biases), moves by up to ±lr a step on
    a reordered f32 sum: over 4 micro-batches the port's and the JAX
    package's first-step gradients differ by at most 5.2e-6 of their
    tensor's largest, and elements at 0.11-1.6% of it then moved 1.0e-4 to
    2.5e-4 apart in 3 steps. The gradients themselves are held at their own
    tolerance (:func:`hold_zinc_grads`). All names are the port's."""
    for name, w in want.items():
        g1 = np.abs(grads1[name])
        sure = g1 > 5e-2 * g1.max()
        if bn_fed(name):
            sure[:] = False
        diff = np.abs(got[name] - w)
        assert (diff[sure] <= 1e-4 + 2e-4 * np.abs(w[sure])).all(), name
        assert diff.max() <= 2 * lr * steps, name


def summed_shares(model: torch.nn.Module, batches, loss_sum) -> Dict[str, np.ndarray]:
    """The gradient a data-parallel step must give, computed one rank after
    the other in this process: each micro-batch's share (its error sum over
    the global count) backpropagated through its own copy of ``model`` (its
    own BatchNorm statistics), summed. ``loss_sum(model, batch) -> (sum,
    count)``; parameters the loss does not reach get 0."""
    import copy

    models = [copy.deepcopy(model) for _ in batches]
    parts = [loss_sum(m, b) for m, b in zip(models, batches)]
    total = sum(float(c) for _, c in parts)
    out = {n: np.zeros(p.shape, np.float32) for n, p in model.named_parameters()}
    for (s, _), m in zip(parts, models):
        (s / max(total, 1.0)).backward()
        for n, p in m.named_parameters():
            if p.grad is not None:
                out[n] += p.grad.numpy()
    return out


def hold_shares(got: Dict[str, np.ndarray], want: Dict[str, np.ndarray]) -> None:
    """A data-parallel step's summed gradients against :func:`summed_shares`:
    the same sums taken in another order, within 1e-6 of each tensor's
    largest (and rtol 1e-5)."""
    for name, w in want.items():
        np.testing.assert_allclose(got[name], w, rtol=1e-5, atol=1e-6 * np.abs(w).max(),
                                   err_msg=name)

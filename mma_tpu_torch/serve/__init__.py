"""Serving export: an eval-mode forward as a portable, ahead-of-time artifact.

The port of the JAX package's ``mma_tpu/serve/__init__.py`` (``jax.export``
to StableHLO) with the same four functions and signatures, on
``torch.export``: :func:`export_forward` traces a forward into an
``ExportedProgram`` and serializes it to bytes (the ``.pt2`` format),
:func:`load_forward` turns the bytes back into a callable in a process
that holds none of the model's code.

Conventions, as in the JAX package:

- Exports are **eval-mode and deterministic** (no dropout).
- The graph or batch is an *argument* of the exported function, so one
  artifact serves any graph of the same padded shape: ``Graph`` and
  ``BatchedGraphs`` are pytree nodes whose static fields travel as JSON
  (``mma_tpu_torch.graph.container``), and each kernel is one
  ``mma_tpu_torch::*`` operator call in the traced graph
  (``mma_tpu_torch.ops.cuda.library``), whose data-dependent host reads the
  tracer does not see.
- The parameters are an argument too: the model's ``state_dict`` (with a
  ZincNet's BatchNorm buffers as ``state``), applied through
  ``torch.func.functional_call``, where the JAX package passes its
  parameter tree.

Where the port differs:

- **No cross-lowering.** An artifact serves on the device it was exported
  on, with the kernels that device runs (the CUDA kernels on the card,
  their plain versions on the CPU). ``platforms`` may only name that
  device; an artifact called with tensors on another device raises rather
  than move them.
- **The operators must be defined** before an artifact loads:
  :func:`load_forward` imports the kernel modules
  (``mma_tpu_torch.ops.cuda.fused_mma`` and ``segment_minmax``), which
  define them, the counterpart of the Mosaic custom calls that ride along
  inside a JAX artifact. A ``.pt2`` artifact also needs the PyTorch version
  that wrote it.
- **No pickled objects.** The artifact keeps no example inputs (the
  containers would be pickled with them), and :func:`load_forward` refuses
  any artifact that only a ``weights_only=False`` load could read.
- ``use_pallas`` is accepted and ignored: the device picks the kernels.
"""

from __future__ import annotations

import contextlib
import io
import json
import pickle
import threading
from typing import Any, Callable, Optional, Sequence

import torch
import torch.utils._pytree as pytree

from mma_tpu_torch.utils.profiling import trace

_META = "mma_tpu_torch_serve.json"
# Names a caller may give ``platforms``: the JAX package's "gpu" and the
# torch device types.
_PLATFORMS = {"cpu": "cpu", "cuda": "cuda", "gpu": "cuda"}


class _Forward(torch.nn.Module):
    """``fn`` as the module ``torch.export`` takes. ``fn`` is held outside
    the module tree, so a model that it closes over lends the export no
    parameters of its own: the weights come in as arguments."""

    def __init__(self, fn: Callable):
        super().__init__()
        self.__dict__["fn"] = fn

    def forward(self, *args):
        return self.fn(*args)


def _device_type(args) -> str:
    types = {leaf.device.type for leaf in pytree.tree_leaves(args)
             if isinstance(leaf, torch.Tensor)}
    if len(types) != 1:
        raise ValueError(f"the arguments must lie on one device, got {sorted(types)}")
    return types.pop()


def export_forward(fn: Callable, example_args: Sequence[Any], *,
                   platforms: Optional[Sequence[str]] = None) -> bytes:
    """Serialize ``fn`` traced on ``example_args`` (a sequence of tensors,
    ``Graph``\\ s, ``BatchedGraphs`` and dicts, lists or tuples of them).

    Only shapes, dtypes and the containers' static fields are baked into
    the artifact; the trace runs under ``torch.no_grad()``. ``platforms``
    (default: the example arguments' device) may only name that device,
    ``"cuda"`` (or ``"gpu"``) or ``"cpu"``: the port does not cross-lower.
    """
    device = _device_type(example_args)
    if platforms is not None:
        names = [platforms] if isinstance(platforms, str) else list(platforms)
        if len(names) != 1 or _PLATFORMS.get(names[0]) != device:
            raise ValueError(
                f"platforms={names!r}: the port does not cross-lower; an artifact serves on "
                f"the device of its example arguments ({device!r})")
    with torch.no_grad():
        program = torch.export.export(_Forward(fn), tuple(example_args), strict=False)
    program.example_inputs = None  # they would pickle the containers
    buf = io.BytesIO()
    torch.export.save(program, buf, extra_files={_META: json.dumps({"device": device})})
    return buf.getvalue()


@contextlib.contextmanager
def _weights_only_loads():
    """Make every ``torch.load`` of the block refuse ``weights_only=False``.

    ``torch.export.load`` retries a pickle that fails a ``weights_only``
    load with ``weights_only=False``, which runs whatever the pickle names;
    here the retry raises instead. The patch is process-wide for the block:
    load artifacts from one thread."""
    real = torch.load

    def load(*args, **kwargs):
        if kwargs.get("weights_only") is False:
            raise pickle.UnpicklingError(
                "the artifact holds objects that only a weights_only=False load builds; "
                "mma_tpu_torch.serve does not load it")
        return real(*args, **kwargs)

    torch.load = load
    try:
        yield
    finally:
        torch.load = real


def load_forward(blob: bytes) -> Callable:
    """Deserialize an :func:`export_forward` artifact into a callable.

    The callable takes the argument structure of the export (same shapes,
    dtypes and static container fields, on the export's device) and
    returns the forward's output. Loading imports the kernel modules, which
    define the ``mma_tpu_torch::*`` operators the artifact calls. While a
    ``torch.profiler`` records, a call is the span ``serve.call`` with
    ``serve.check``, ``serve.inputs`` and ``serve.graph`` inside
    (:func:`_graph_starts`).
    """
    from mma_tpu_torch.ops.cuda import fused_mma, segment_minmax  # noqa: F401  (the operators)

    extra = {_META: ""}
    with _weights_only_loads():
        program = torch.export.load(io.BytesIO(blob), extra_files=extra)
    device = json.loads(extra[_META])["device"]
    module = program.module()
    _mark_graph_start(module)

    def served(*args):
        with trace("serve.call"):
            with trace("serve.check"):
                got = _device_type(args)
            if got != device:
                raise ValueError(f"this artifact serves on {device!r} and was called with "
                                 f"tensors on {got!r}")
            _part.span = trace("serve.inputs")
            _part.span.__enter__()
            try:
                return module(*args)
            finally:
                _part.span.__exit__(None, None, None)
                _part.span = None

    return served


# The open part of a served call on this thread: ``serve.inputs`` from the
# device check to the graph's first node, then ``serve.graph``.
_part = threading.local()


def _graph_starts() -> None:
    """The first node of a loaded module's graph: ends the served call's
    ``serve.inputs`` span (the module's pre-hooks, its input checks and the
    pytree flatten) and opens ``serve.graph`` (the graph's nodes and the
    unflatten)."""
    span = getattr(_part, "span", None)
    if span is not None:
        span.__exit__(None, None, None)
        _part.span = trace("serve.graph")
        _part.span.__enter__()


def _mark_graph_start(module: torch.fx.GraphModule) -> None:
    """Insert a call of :func:`_graph_starts` after the loaded module's
    placeholders, where ``torch.export`` puts its own ``_guards_fn`` call
    when an artifact keeps example inputs (these keep none). The node
    computes nothing: the outputs stay those of the artifact."""
    graph = module.graph
    with graph.inserting_after(graph.find_nodes(op="placeholder")[-1]):
        graph.call_function(_graph_starts)
    module.recompile()


def export_node_classifier(model, params, x, graph, *, use_pallas: bool = False,
                           platforms: Optional[Sequence[str]] = None) -> bytes:
    """Export the node-classification eval forward → per-node log-probs.

    The exported signature is ``(params, x, graph) -> (N_pad, n_class)``,
    ``params`` a :class:`~mma_tpu_torch.models.NodeClassifier`'s
    ``state_dict``; any graph padded to the same (n_node, n_edge) with the
    same static fields works. ``use_pallas`` is ignored.
    """
    def forward(p, x_, g):
        return torch.func.functional_call(model, p, (x_, g), {"training": False})

    return export_forward(forward, (params, x, graph), platforms=platforms)


def export_zinc_predictor(model, params, state, batch, *,
                          platforms: Optional[Sequence[str]] = None) -> bytes:
    """Export the ZINC regression eval forward → per-graph predictions.

    Signature: ``(params, state, batch) -> (n_graphs,)``, ``params`` the
    :class:`~mma_tpu_torch.models.ZincNet`'s parameters and ``state`` its
    BatchNorm buffers (together its ``state_dict``); any batch padded to
    the same (n_node, n_edge, n_graphs) with the same static fields works.
    """
    def forward(p, s, b):
        return torch.func.functional_call(model, {**p, **s}, (b,), {"training": False})

    return export_forward(forward, (params, state, batch), platforms=platforms)

"""Differentiable collectives over a mesh axis, named after ``jax.lax``'s.

The JAX package runs its multi-device regimes as one program under
``shard_map`` and gets exact gradients by differentiating through the
collectives there (``mma_tpu/parallel/edge_parallel.py:190-195``,
``dp_edge.py:12-13``). The port runs one process per rank, each with its
own autograd graph, so it fixes one gradient rule and keeps to it in every
regime:

1. **Each rank backpropagates its share of the global loss.** An
   edge-sharded regime computes the same (replicated) loss on every rank of
   the edge axis and backpropagates ``loss / edge_size``. A data-parallel
   regime backpropagates its local error sum over the global count, the
   count all-reduced without a gradient (JAX's ``psum(err) /
   max(psum(cnt), 1)``, ``mma_tpu/parallel/data_parallel.py:57``). The 2-D
   regime divides by both.
2. **In-graph collectives differentiate as sums.** :func:`psum` is an
   all-reduce whose backward all-reduces the cotangent; :func:`all_gather`'s
   backward reduce-scatters it. Backpropagation is linear in the cotangent,
   so after rule 1 the cotangents of a replicated tensor summed over the
   ranks are its true cotangent, and the all-reduce hands that sum to every
   rank where edge-local work consumes it.
3. **After the backward, every parameter gradient is summed over the whole
   mesh once** (:func:`psum_grads`: one all-reduce of one flat buffer), and
   every rank runs the same optimizer step.

The parameters stay replicated bit for bit, since every rank applies the
same summed gradient.

The node-sharded regime (:mod:`.node_sharded`) reads the rules so. Its
loss is ``psum(lsum) / psum(lcnt)``, so every rank holds the same global
loss, and each rank backpropagates ``loss / S`` over the node axis's size
``S`` (rule 1). ``psum``'s backward all-reduces that cotangent, so each
rank's error sum gets the global loss's own; :func:`all_to_all`'s backward
is the reverse exchange, which routes each halo row's cotangent home to
the rank that owns the row (rule 2); and :func:`psum_grads` sums the
parameter gradients once (rule 3). ``axis_name`` (here and in the ops, layers and
models) keeps the JAX name; in the port it is the mesh axis's process
group, ``mesh.get_group("edge")``. ``None`` means no axis: every function
here is then the identity (:func:`psum`, :func:`pmean`, :func:`all_to_all`)
or a one-member stack (:func:`all_gather`).

The JAX sites these stand for: ``jax.lax.psum`` in
``mma_tpu/ops/spmm.py:129-130``, ``:140-141``,
``mma_tpu/ops/masked_aggregate.py:316-317``, ``:328-329``, ``:363-364`` and
``mma_tpu/nn/mma_conv.py:457``; ``jax.lax.all_gather`` in
``mma_tpu/nn/mma_conv.py:478-486``; ``jax.lax.pmean`` in
``mma_tpu/parallel/data_parallel.py:58`` and ``dp_edge.py:185``;
``jax.lax.axis_index`` in ``dp_edge.py:176-179``; ``jax.lax.all_to_all`` in
``mma_tpu/parallel/node_sharded.py:333``.

``STATS`` counts the calls and the bytes each rank hands to each
collective, so that a run can report its traffic per step.
"""

from __future__ import annotations

from typing import Dict, Iterable, Optional

import torch
import torch.distributed as dist

AxisName = Optional[dist.ProcessGroup]

STATS: Dict[str, int] = {f"{op}_{unit}": 0 for op in ("all_reduce", "all_gather",
                                                       "reduce_scatter", "all_to_all")
                         for unit in ("calls", "bytes")}


def reset_stats() -> None:
    for key in STATS:
        STATS[key] = 0


def _count(op: str, t: torch.Tensor) -> None:
    STATS[f"{op}_calls"] += 1
    STATS[f"{op}_bytes"] += t.numel() * t.element_size()


def axis_size(axis_name: AxisName) -> int:
    return 1 if axis_name is None else dist.get_world_size(axis_name)


def axis_index(axis_name: AxisName) -> int:
    """This rank's index along the axis (``jax.lax.axis_index``)."""
    return 0 if axis_name is None else dist.get_rank(axis_name)


def _all_reduce(x: torch.Tensor, group) -> torch.Tensor:
    out = x.contiguous().clone()
    _count("all_reduce", out)
    dist.all_reduce(out, group=group)
    return out


class _Psum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _all_reduce(x, group)

    @staticmethod
    def backward(ctx, ct):
        return _all_reduce(ct, ctx.group), None


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        x = x.contiguous()
        size = dist.get_world_size(group)
        # The ranks' blocks concatenated along dim 0 (gloo takes no stacked
        # output), then viewed as a stack.
        out = x.new_empty((size * x.shape[0],) + tuple(x.shape[1:]))
        _count("all_gather", x)
        dist.all_gather_into_tensor(out, x, group=group)
        return out.view((size,) + tuple(x.shape))

    @staticmethod
    def backward(ctx, ct):
        ct = ct.contiguous()
        out = ct.new_empty(ct.shape[1:])
        _count("reduce_scatter", ct)
        dist.reduce_scatter_tensor(out, ct.view((-1,) + tuple(ct.shape[2:])), group=ctx.group)
        return out, None


def _exchange(x: torch.Tensor, group, async_op: bool = False):
    """``(out, work)``: ``x``'s (contiguous) equal dim-0 blocks sent one to
    each rank of ``group`` in rank order, ``out`` the blocks received, in
    the senders' order (``work`` None unless ``async_op``)."""
    out = torch.empty_like(x)
    _count("all_to_all", x)
    return out, dist.all_to_all_single(out, x, group=group, async_op=async_op)


class _AllToAllDone(torch.autograd.Function):
    """The end of an exchange started by :func:`all_to_all_start`: the
    forward waits for it; the backward is the reverse exchange (rule 2)."""

    @staticmethod
    def forward(ctx, x, pending):
        ctx.group = pending.group
        if pending.work is not None:
            pending.work.wait()
        return pending.out

    @staticmethod
    def backward(ctx, ct):
        return _exchange(ct.contiguous(), ctx.group)[0], None


class PendingAllToAll:
    """An exchange in flight (:func:`all_to_all_start`); :meth:`wait` gives
    its result. It keeps the sent buffer alive until then."""

    def __init__(self, x: torch.Tensor, axis_name: AxisName):
        self.x, self.group = x, axis_name
        self.out = self.work = None
        if axis_name is not None:
            self.sent = x.detach().contiguous()
            self.out, self.work = _exchange(self.sent, axis_name, async_op=True)

    def wait(self) -> torch.Tensor:
        if self.group is None:
            return self.x
        return _AllToAllDone.apply(self.x, self)


def all_to_all_start(x: torch.Tensor, axis_name: AxisName) -> PendingAllToAll:
    """Start :func:`all_to_all` without waiting for it, so that work which
    does not read its result overlaps the exchange (the JAX package leaves
    that to XLA's scheduler, ``mma_tpu/parallel/node_sharded.py:15-21``).
    The exchange runs on the backend's own stream; ``wait()`` orders the
    current stream after it."""
    return PendingAllToAll(x, axis_name)


def all_to_all(x: torch.Tensor, axis_name: AxisName) -> torch.Tensor:
    """``jax.lax.all_to_all(x, axis, split_axis=0, concat_axis=0)``: ``x``
    (``size · m, ...``) is cut along dim 0 into ``size`` equal blocks, block
    ``q`` goes to rank ``q``, and the result holds the blocks the ranks sent
    this one, in rank order. Its backward is the same exchange of the
    cotangent, the reverse route (rule 2). The identity when ``axis_name``
    is None."""
    return all_to_all_start(x, axis_name).wait()


def psum(x: torch.Tensor, axis_name: AxisName) -> torch.Tensor:
    """Sum over the axis; the backward sums the cotangents (rule 2)."""
    return x if axis_name is None else _Psum.apply(x, axis_name)


def pmean(x: torch.Tensor, axis_name: AxisName) -> torch.Tensor:
    """Mean over the axis: :func:`psum` over its size."""
    return x if axis_name is None else psum(x, axis_name) / axis_size(axis_name)


def all_gather(x: torch.Tensor, axis_name: AxisName) -> torch.Tensor:
    """Every rank's ``x`` stacked in rank order, ``(size, *x.shape)``; the
    backward reduce-scatters the cotangent back to its rank (rule 2)."""
    return x[None] if axis_name is None else _AllGather.apply(x, axis_name)


@torch.no_grad()
def psum_no_grad(x: torch.Tensor, axis_name: AxisName) -> torch.Tensor:
    """:func:`psum` of a value that takes no gradient (counts, statistics)."""
    return x.detach() if axis_name is None else _all_reduce(x.detach(), axis_name)


@torch.no_grad()
def _flat_all_reduce(tensors, group, scale: Optional[float] = None) -> None:
    """All-reduce ``tensors`` in place as one flat buffer, times ``scale``."""
    tensors = list(tensors)
    if not tensors:
        return
    flat = _all_reduce(torch.cat([t.reshape(-1) for t in tensors]), group)
    if scale is not None:
        flat = flat * scale
    offset = 0
    for t in tensors:
        t.copy_(flat[offset:offset + t.numel()].view_as(t))
        offset += t.numel()


def psum_grads(parameters: Iterable[torch.nn.Parameter], group=None) -> None:
    """Rule 3: sum every parameter gradient over ``group`` (default: the
    whole world, which every mesh of :func:`~mma_tpu_torch.parallel.make_mesh`
    spans) in one all-reduce. A parameter without a gradient gets a zero one
    first, as the training steps give every parameter an update (weight
    decay still moves the detached pre-NNs of parity mode)."""
    params = list(parameters)
    for p in params:
        if p.grad is None:
            p.grad = torch.zeros_like(p)
    _flat_all_reduce([p.grad for p in params], group)


def pmean_buffers(buffers: Iterable[torch.Tensor], axis_name: AxisName) -> None:
    """Average floating buffers (BatchNorm running statistics) over the axis,
    in place, in one all-reduce (JAX's ``pmean(new_state)``)."""
    if axis_name is None:
        return
    _flat_all_reduce([b for b in buffers if b.is_floating_point()], axis_name,
                     1.0 / axis_size(axis_name))

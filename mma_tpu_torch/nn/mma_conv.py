"""MultiMaskConv — the graph-regression MMA convolution.

The port of the JAX package's ``mma_tpu/nn/mma_conv.py`` (itself a
re-design of the reference's PyG ``MessagePassing`` conv,
``graph_regression/mma_conv.py:20-201``) on its CSR routes:

- Messages decompose: the reference's per-edge pre-NN
  ``Linear([x_i ‖ x_j ‖ e])`` splits into ``x @ W_dst`` and ``x @ W_src``
  once per node and tower, plus ``e @ W_edge`` per edge, gathered per edge
  (:func:`~mma_tpu_torch.ops.gather.gather_by_dst` /
  :func:`~mma_tpu_torch.ops.gather.gather_by_src`, whose VJPs are kernel 1).
- **Fused min/max edge program** (aggregators ⊆ {min, max}, one pre-NN
  layer): ``hg = p_src[src] + b0 + e @ W_edge`` per edge, then kernel 6
  adds the dst projection, applies the N2 dropout mask and reduces; kernel
  7 is its backward. The JAX package also requires ``use_pallas`` and a
  ``chunk_hint``; the port's ``Graph`` has no ``chunk_hint``, so the route
  is keyed on ``not graph.ell_exact``, and CPU tensors take the kernels'
  plain versions.
- **General CSR route** (anything else): materialised (E, T·F) messages,
  ``torch.Generator`` dropout, min/max through kernels 4-5 (one paired
  pass when parity shares the messages), sum/mean through kernel 1 and
  var/std through kernel 8 (``[Σx ‖ Σx²]`` in one pass, as the JAX
  package's ``use_pallas`` route, ``mma_tpu/nn/mma_conv.py:501-517``),
  all over ``Graph.real_row_ptr``.

Parity knobs (SURVEY §5), as in the JAX package:

- **N6**: ``parity=True`` feeds every aggregator the LAST aggregator's
  pre-NN messages; ``parity=False`` gives each its own.
- **N7**: ``parity=True`` detaches the pre-NN parameters (they stay at
  init in the reference; the training loop gives them zero gradients so
  that weight decay still moves them, as the JAX optimizer does).
- **N9**: ``parity=True`` compounds the scalers (``[m, m·amp, m·amp·lin]``).
- **N2**: message dropout (0.5) whenever the caller asks for it.
- Empty rows give 0 for every reduce (``torch_scatter``'s fill).

Not ported yet (raise ``NotImplementedError``): ``edge_format="ell"`` and
degree-exact graphs (the ELL slice), ``compute_dtype`` other than float32,
and ``axis_name``.
"""

from __future__ import annotations

from typing import Dict, List, Mapping, Optional, Sequence, Union

import numpy as np
import torch
from torch import nn

from mma_tpu_torch.device import DeviceLike, check_compute_dtype, resolve_device
from mma_tpu_torch.graph.container import Graph
from mma_tpu_torch.nn.layers import Dense, dropout
from mma_tpu_torch.ops.cuda.fused_mma import segment_sum_csr, segment_sum_sq_csr
from mma_tpu_torch.ops.cuda.segment_minmax import (
    fused_minmax_edge_program,
    fused_segment_minmax,
)
from mma_tpu_torch.ops.gather import gather_by_dst, gather_by_src

GR_AGGREGATORS = ("sum", "mean", "min", "max", "var", "std")
GR_SCALERS = ("identity", "amplification", "attenuation", "linear", "inverse_linear")
_ELL_SLICE = "the ELL / degree-exact slice of the port"

Seed = Union[int, Sequence[int], torch.Tensor]


def compute_avg_deg(deg_hist, *, parity: bool = True) -> Dict[str, float]:
    """Degree statistics feeding the scalers.

    ``parity=True`` replicates the reference's statistics over the
    histogram *counts* (``mma_conv.py:73-78``); ``parity=False`` computes
    them over the node degree distribution. float32, as the JAX package.
    """
    h = np.asarray(deg_hist, np.float32)
    with np.errstate(over="ignore"):  # "exp" overflows to inf, as in float32 JAX
        return _avg_deg(h, parity)


def _avg_deg(h: np.ndarray, parity: bool) -> Dict[str, float]:
    if parity:
        return {
            "lin": float(h.mean(dtype=np.float32)),
            "log": float(np.log(h + np.float32(1)).mean(dtype=np.float32)),
            "exp": float(np.exp(h).mean(dtype=np.float32)),
        }
    degrees = np.arange(h.shape[0], dtype=np.float32)
    n = np.maximum(h.sum(dtype=np.float32), np.float32(1.0))
    return {
        "lin": float((degrees * h).sum(dtype=np.float32) / n),
        "log": float((np.log(degrees + np.float32(1)) * h).sum(dtype=np.float32) / n),
        "exp": float((np.exp(degrees) * h).sum(dtype=np.float32) / n),
    }


class MultiMaskConv(nn.Module):
    """x (N, in_channels) → (N, out_channels).

    Parameters, named as the JAX package's tree: ``edge_encoder`` (Dense
    edge_dim→F, when ``edge_dim``), ``pre_nns[k][t][l]`` (K aggregators × T
    towers × pre_layers Dense; the first (msg_in, F)), ``post_nns[t][l]``
    and ``lin``.
    """

    def __init__(
        self,
        in_channels: int,
        out_channels: int,
        aggregators: Sequence[str],
        scalers: Sequence[str],
        avg_deg: Union[Mapping[str, float], Sequence],
        edge_dim: Optional[int] = None,
        towers: int = 1,
        pre_layers: int = 1,
        post_layers: int = 1,
        divide_input: bool = False,
        dropout_rate: float = 0.5,  # hardcoded in the reference (mma_conv.py:67)
        parity: bool = True,
        compute_dtype: str = "float32",
        edge_format: str = "auto",
        *,
        device: DeviceLike = None,
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        dev = resolve_device(device)
        self.aggregators = tuple(aggregators)
        self.scalers = tuple(scalers)
        for a in self.aggregators:
            if a not in GR_AGGREGATORS:
                raise ValueError(f'Unknown aggregator "{a}".')
        for s in self.scalers:
            if s not in GR_SCALERS:
                raise ValueError(f'Unknown scaler "{s}".')
        if edge_format not in ("auto", "csr", "ell"):
            raise ValueError(f'Unknown edge_format "{edge_format}".')
        if edge_format == "ell":
            raise NotImplementedError(f"edge_format='ell' is not ported yet ({_ELL_SLICE})")
        check_compute_dtype(compute_dtype)
        if divide_input and in_channels % towers:
            raise ValueError(f"in_channels={in_channels} must divide by towers={towers}")
        if out_channels % towers:
            raise ValueError(f"out_channels={out_channels} must divide by towers={towers}")
        self.in_channels, self.out_channels = in_channels, out_channels
        self.avg_deg = dict(avg_deg)
        self.edge_dim, self.towers = edge_dim, towers
        self.pre_layers, self.post_layers = pre_layers, post_layers
        self.divide_input, self.dropout_rate, self.parity = divide_input, dropout_rate, parity
        self.compute_dtype, self.edge_format = compute_dtype, edge_format

        t, f, k = towers, self.f_in, len(self.aggregators)
        kw = dict(device=dev, generator=generator)
        if edge_dim is not None:
            self.edge_encoder = Dense(edge_dim, f, **kw)
        msg_in = (3 if edge_dim is not None else 2) * f
        self.pre_nns = nn.ModuleList(
            nn.ModuleList(
                nn.ModuleList([Dense(msg_in, f, **kw)]
                              + [Dense(f, f, **kw) for _ in range(1, pre_layers)])
                for _ in range(t))
            for _ in range(k))
        post_in = (k * len(self.scalers) + 1) * f
        self.post_nns = nn.ModuleList(
            nn.ModuleList([Dense(post_in, self.f_out, **kw)]
                          + [Dense(self.f_out, self.f_out, **kw) for _ in range(1, post_layers)])
            for _ in range(t))
        self.lin = Dense(out_channels, out_channels, **kw)

    @property
    def f_in(self) -> int:
        return self.in_channels // self.towers if self.divide_input else self.in_channels

    @property
    def f_out(self) -> int:
        return self.out_channels // self.towers

    # ---- messages ------------------------------------------------------

    def _first_layer(self, k: int):
        """Aggregator ``k``'s first pre-NN layer over all towers: weights
        (T, msg_in, F) and bias (T·F,), detached under parity (N7)."""
        w0 = torch.stack([tower[0].w for tower in self.pre_nns[k]])
        b0 = torch.cat([tower[0].b for tower in self.pre_nns[k]])
        if self.parity:
            w0, b0 = w0.detach(), b0.detach()
        return w0, b0

    def _projections(self, w0, x_flat):
        """``(p_dst, p_src)`` (N, T·F): the dst and src blocks of the first
        layer applied per node."""
        f, t = self.f_in, self.towers
        if self.divide_input:
            xt = x_flat.reshape(-1, t, f)
            p_dst = torch.einsum("ntf,tfg->ntg", xt, w0[:, :f, :]).reshape(-1, t * f)
            p_src = torch.einsum("ntf,tfg->ntg", xt, w0[:, f:2 * f, :]).reshape(-1, t * f)
        else:
            x1 = x_flat[:, :f]  # towers share features
            p_dst = x1 @ w0[:, :f, :].permute(1, 0, 2).reshape(f, t * f)
            p_src = x1 @ w0[:, f:2 * f, :].permute(1, 0, 2).reshape(f, t * f)
        return p_dst, p_src

    def _edge_term(self, w0, e_feat):
        f, t = self.f_in, self.towers
        return e_feat @ w0[:, 2 * f:, :].permute(1, 0, 2).reshape(f, t * f)

    def _messages_for_aggregator(self, k, x_flat, e_feat, graph: Graph):
        """Aggregator ``k``'s messages, flat (E, T·F), tower-major lanes."""
        w0, b0 = self._first_layer(k)
        p_dst, p_src = self._projections(w0, x_flat)
        msg = gather_by_dst(p_dst, graph) + gather_by_src(p_src, graph) + b0
        if self.edge_dim is not None:
            msg = msg + self._edge_term(w0, e_feat)
        if self.pre_layers > 1:
            msg = self._deep_pre(k, msg)
        return msg

    def _message_parts(self, k, x_flat, e_feat, graph: Graph):
        """Split message build for the fused edge program: ``(p_dst, hg)``
        with ``msg_e = p_dst[dst_e] + hg_e``; the dst projection stays
        node-level. Needs ``pre_layers == 1``."""
        w0, b0 = self._first_layer(k)
        p_dst, p_src = self._projections(w0, x_flat)
        hg = gather_by_src(p_src, graph) + b0
        if self.edge_dim is not None:
            hg = hg + self._edge_term(w0, e_feat)
        return p_dst, hg

    def _deep_pre(self, k, msg):
        # Deeper pre-NNs are per tower (rare; the reference uses 1 layer).
        f = self.f_in
        parts = []
        for ti, tower in enumerate(self.pre_nns[k]):
            m = msg[:, ti * f:(ti + 1) * f]
            for layer in tower[1:]:
                w, b = layer.w, layer.b
                if self.parity:
                    w, b = w.detach(), b.detach()
                m = torch.relu(m) @ w + b
            parts.append(m)
        return torch.cat(parts, dim=1)

    # ---- aggregation ---------------------------------------------------

    def _reduce(self, name, msgs, graph: Graph, deg):
        """One reduce over the real in-edges → (N, T·F); empty rows give 0."""
        if name == "sum":
            return segment_sum_csr(msgs, graph.real_row_ptr)
        if name == "mean":
            return segment_sum_csr(msgs, graph.real_row_ptr) / deg  # deg clamped ≥ 1
        if name in ("var", "std"):
            c = msgs.shape[1]
            both = segment_sum_sq_csr(msgs, graph.real_row_ptr)
            mean, mean_sq = both[:, :c] / deg, both[:, c:] / deg
            out = mean_sq - mean * mean
            return torch.sqrt(torch.relu(out) + 1e-5) if name == "std" else out
        return fused_segment_minmax(msgs, graph, (name,))

    def _reduce_all(self, per_agg, graph: Graph, deg, shared_messages: bool):
        """All K reduces; min and max over the SAME messages (parity's
        shared messages, N6) run as one paired kernel pass."""
        paired = {}
        minmax = tuple(a for a in self.aggregators if a in ("min", "max"))
        if shared_messages and len(minmax) >= 2:
            msgs = per_agg[minmax[0]]
            fused = fused_segment_minmax(msgs, graph, minmax)
            c = msgs.shape[1]
            for pi, a in enumerate(minmax):
                paired[a] = fused[:, pi * c:(pi + 1) * c]
        return [paired[a] if a in paired else self._reduce(a, per_agg[a], graph, deg)
                for a in self.aggregators]

    def _scale(self, agg, deg):
        """Per-scaler copies of ``agg``, in scaler order; parity compounds (N9)."""
        avg = self.avg_deg
        outs = []
        cur = agg
        for scaler in self.scalers:
            if scaler == "identity":
                fac = None
            elif scaler == "amplification":
                fac = torch.log(deg + 1) / avg["log"]
            elif scaler == "attenuation":
                fac = avg["log"] / torch.log(deg + 1)
            elif scaler == "linear":
                fac = deg / avg["lin"]
            else:  # inverse_linear
                fac = avg["lin"] / deg
            if self.parity:
                if fac is not None:
                    cur = cur * fac
                outs.append(cur)
            else:
                outs.append(agg if fac is None else agg * fac)
        return outs

    # ---- forward -------------------------------------------------------

    def _fused_route(self, graph: Graph) -> bool:
        return (self.pre_layers == 1
                and all(a in ("min", "max") for a in self.aggregators)
                and not graph.ell_exact)

    def _seeds(self, count: int, generator, seed, device) -> List[Optional[torch.Tensor]]:
        """``count`` (1,) int32 hash seeds for the fused route: ``seed`` as
        given, else drawn from ``generator`` in ``[0, 2³¹ - 1)`` (the JAX
        package's ``randint`` range); ``None`` each without dropout."""
        if self.dropout_rate <= 0.0 or (seed is None and generator is None):
            return [None] * count
        if seed is None:
            seed = torch.randint(0, 2**31 - 1, (count,), generator=generator,
                                 device=generator.device, dtype=torch.int32)
        seed = torch.as_tensor(seed, dtype=torch.int32).to(device).reshape(-1)
        if seed.shape[0] != count:
            raise ValueError(f"expected {count} dropout seed(s), got {seed.shape[0]}")
        return [seed[i:i + 1] for i in range(count)]

    def forward(
        self,
        x: torch.Tensor,
        graph: Graph,
        edge_attr: Optional[torch.Tensor] = None,
        *,
        generator: Optional[torch.Generator] = None,
        seed: Optional[Seed] = None,
        axis_name: Optional[str] = None,
    ) -> torch.Tensor:
        """Message dropout (N2) is on when ``generator`` or ``seed`` is
        given. The fused route's mask is the position hash of one seed per
        message set (one under parity, one per aggregator otherwise):
        ``seed`` gives them (an int or a sequence, so that a test can feed
        the JAX package's seeds), else they are drawn from ``generator``.
        The general route draws its mask from ``generator``."""
        if axis_name is not None:
            raise NotImplementedError("edge-sharded convs (axis_name) are not ported yet")
        if graph.ell_exact:
            raise NotImplementedError(f"degree-exact graphs are not ported yet ({_ELL_SLICE})")
        n = x.shape[0]
        t, f = self.towers, self.f_in
        x_flat = x.reshape(n, t * f) if self.divide_input else x.repeat(1, t)
        e_feat = None
        if self.edge_dim is not None:
            if edge_attr is None:
                raise ValueError("this conv has edge_dim set and needs edge_attr")
            e_feat = self.edge_encoder(edge_attr)
        deg = torch.clamp(graph.deg, min=1.0)[:, None]

        k = len(self.aggregators)
        if self._fused_route(graph):
            seeds = self._seeds(1 if self.parity else k, generator, seed, x.device)
            runs = ([(k - 1, self.aggregators, seeds[0])] if self.parity  # N6
                    else [(ki, (a,), seeds[ki]) for ki, a in enumerate(self.aggregators)])
            reds = []
            for ki, ops, sd in runs:
                p_dst, hg = self._message_parts(ki, x_flat, e_feat, graph)
                fused = fused_minmax_edge_program(p_dst, hg, graph, ops, seed=sd,
                                                  rate=self.dropout_rate)
                c = hg.shape[1]
                reds += [fused[:, pi * c:(pi + 1) * c] for pi in range(len(ops))]
            return self._post(x_flat, reds, deg)

        if self.parity:
            # N6: every aggregator consumes the LAST aggregator's messages.
            msgs = self._messages_for_aggregator(k - 1, x_flat, e_feat, graph)
            msgs = dropout(msgs, self.dropout_rate, generator)
            per_agg = {a: msgs for a in self.aggregators}
        else:
            per_agg = {a: dropout(self._messages_for_aggregator(ki, x_flat, e_feat, graph),
                                  self.dropout_rate, generator)
                       for ki, a in enumerate(self.aggregators)}
        reds = self._reduce_all(per_agg, graph, deg, shared_messages=self.parity)
        return self._post(x_flat, reds, deg)

    def _post(self, x_flat, reds, deg):
        """Scalers, the per-tower post-NNs and the final ``lin``.

        Tower ``t`` sees ``[x_t ‖ (for s in scalers: for k in aggs:
        red_skt)]``, the reference's feature order; all towers go through
        one batched product per post-NN layer."""
        t, f = self.towers, self.f_in
        scaled = [self._scale(r, deg) for r in reds]
        pieces = [x_flat] + [scaled[ki][si] for si in range(len(self.scalers))
                             for ki in range(len(self.aggregators))]
        n = x_flat.shape[0]
        # (P, N, T·F) → (T, N, P·F): per tower, the pieces' F-blocks in order.
        tower_in = (torch.stack(pieces).reshape(len(pieces), n, t, f)
                    .permute(2, 1, 0, 3).reshape(t, n, len(pieces) * f))
        out = tower_in
        for li in range(self.post_layers):
            if li:
                out = torch.relu(out)
            w = torch.stack([tower[li].w for tower in self.post_nns])
            b = torch.stack([tower[li].b for tower in self.post_nns])
            out = torch.baddbmm(b[:, None, :], out, w)
        out = out.permute(1, 0, 2).reshape(n, t * self.f_out)
        return self.lin(out)

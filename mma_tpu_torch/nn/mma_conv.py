"""MultiMaskConv — the graph-regression MMA convolution.

The port of the JAX package's ``mma_tpu/nn/mma_conv.py`` (itself a
re-design of the reference's PyG ``MessagePassing`` conv,
``graph_regression/mma_conv.py:20-201``). Messages decompose: the
reference's per-edge pre-NN ``Linear([x_i ‖ x_j ‖ e])`` splits into
``x @ W_dst`` and ``x @ W_src`` once per node and tower, plus
``e @ W_edge`` per edge. Three routes, chosen as the JAX package chooses
them with ``use_pallas=True`` (the port has no other mode: CUDA tensors
take the kernels, CPU tensors their plain versions):

- **ELL** (``mma_tpu_torch.ops.ell``; one pre-NN layer, ``edge_format``
  not ``"csr"``, and a slot layout: the graph's ``ell_hint``, which the
  degree-exact collate sets, or ``edge_format="ell"`` with
  ``max_degree_hint``, a single width over all rows). ``hg = p_src[src] +
  b0 + e @ W_edge`` per edge is laid out in neighbour slots ``(rows,
  W·C)`` (a reshape on degree-exact graphs, a gather otherwise), the dst
  projection is tiled over each bucket's slots, the N2 dropout is the
  position hash of kernel 6 keyed on (row, slot lane), and every reduce
  is a masked reduce over the slot axis in plain PyTorch: min/max with
  first-hit routing, sums slot by slot. No kernel runs but kernel 1 in
  ``gather_by_src``'s VJP when the CSC order is not degree-exact. The JAX
  package also skips this route on a graph without ``chunk_hint`` (its
  sharded slices); the port's ``chunk_hint`` is always None, so the route
  is keyed on the slot layout alone, and on ``axis_name`` being None.
- **Fused min/max edge program** (aggregators ⊆ {min, max}, one pre-NN
  layer, no slot layout): kernel 6 adds the dst projection to ``hg``,
  applies the N2 dropout mask and reduces; kernel 7 is its backward.
- **General CSR route** (anything else): materialised (E, T·F) messages,
  ``torch.Generator`` dropout, min/max through kernels 4-5 (one paired
  pass when parity shares the messages), sum/mean through kernel 1 and
  var/std through kernel 8 (``[Σx ‖ Σx²]`` in one pass, as the JAX
  package's ``use_pallas`` route, ``mma_tpu/nn/mma_conv.py:501-517``),
  all over ``Graph.real_row_ptr``.

On a degree-exact graph the bucket-padding rows carry masked self-loops,
which every route reduces like real edges; their rows' aggregates are
zeroed by one node-mask select before the scalers, as the JAX package's
exact ELL path does (``mma_tpu/nn/mma_conv.py:425-432``). The rows' values
then reach no real row and their cotangents are 0, so the synthetic edges
move no gradient.

Parity knobs (SURVEY §5), as in the JAX package:

- **N6**: ``parity=True`` feeds every aggregator the LAST aggregator's
  pre-NN messages; ``parity=False`` gives each its own.
- **N7**: ``parity=True`` detaches the pre-NN parameters (they stay at
  init in the reference; the training loop gives them zero gradients so
  that weight decay still moves them, as the JAX optimizer does).
- **N9**: ``parity=True`` compounds the scalers (``[m, m·amp, m·amp·lin]``).
- **N2**: message dropout (0.5) whenever the caller asks for it.
- Empty rows give 0 for every reduce (``torch_scatter``'s fill).

``axis_name`` (a mesh axis's process group; ``mma_tpu_torch.parallel``)
runs the conv on an edge shard, as the JAX package's
``mma_tpu/nn/mma_conv.py:452-518``: the ELL and fused routes are off, the
general route reduces the shard's edges over its own CSR, and the partials
combine with each reduction's monoid before the degree normalisation.
Sum, mean, var and std are ``psum``-ed (var and std as ``[Σx ‖ Σx²]``).
Max and min reduce locally (kernel 4, paired under parity's shared
messages), give the ±inf neutral to rows the shard leaves empty, and take
``torch.amax``/``amin`` over the ``all_gather``-ed partials, whose backward
splits ties equally among the shards that hold the extreme, as
``jnp.max``'s does (``:478-486``). ``deg`` is replicated, so the combined
result equals the unsharded one.

``compute_dtype`` (``"float32"``, ``"bfloat16"`` or ``"auto"``, resolved by
:func:`mma_tpu_torch.autotune.resolve_compute_dtype` on the conv's device:
``"auto"`` is float32 off a TPU) is the edge pipeline's dtype, cast where
the JAX package's conv casts (``mma_tpu/nn/mma_conv.py:200-210``,
``:246-252``, ``:266``, ``:276``): the node features, the edge features and
the pre-NNs' weights and biases, so that the projections, the messages and
their dropout are in that dtype. The reduces read bf16 messages and give
float32 (kernels 1, 4 and 8 on the general route, kernel 6 on the fused
one; the ELL route's slot sums, its min/max outputs cast up), and the
scalers, post-NNs and ``lin`` stay float32. The ELL route rounds where the
JAX function rounds (``:339-352``, ``:383``): each slot message after the
dst tile is added, the hashed dropout's keep factor, and the slot squares of
``var``/``std``. The fused kernel adds and masks in float32 and does not
round the message. Parameters stay float32.
"""

from __future__ import annotations

from typing import Dict, List, Mapping, Optional, Sequence, Union

import numpy as np
import torch
from torch import nn

from mma_tpu_torch.autotune import torch_compute_dtype
from mma_tpu_torch.device import DeviceLike, resolve_device
from mma_tpu_torch.graph.container import Graph
from mma_tpu_torch.nn.layers import Dense, dropout
from mma_tpu_torch.ops.cuda.fused_mma import segment_sum_csr, segment_sum_sq_csr
from mma_tpu_torch.ops.cuda.segment_minmax import (
    dropout_keep,
    fused_minmax_edge_program,
    fused_segment_minmax,
)
from mma_tpu_torch.ops.ell import (
    EllSpec,
    ell_expand,
    ell_expand_exact,
    ell_valid,
    masked_minmax_firsthit,
    masked_slot_sum,
    pad_rows,
    single_width_spec,
)
from mma_tpu_torch.ops.gather import gather_by_dst, gather_by_src
from mma_tpu_torch.parallel.collectives import AxisName, all_gather, psum

GR_AGGREGATORS = ("sum", "mean", "min", "max", "var", "std")
GR_SCALERS = ("identity", "amplification", "attenuation", "linear", "inverse_linear")

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
    and ``lin``. ``max_degree_hint`` (a static bound on in-degree, ZINC ≤ 4)
    sets the slot width of ``edge_format="ell"`` on graphs without an
    ``ell_hint``; the CUDA kernels need no scan bound.
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
        max_degree_hint: Optional[int] = None,
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
        self.edge_dtype = torch_compute_dtype(compute_dtype, dev)
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
        self.max_degree_hint = max_degree_hint

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
        (T, msg_in, F) and bias (T·F,) in the edge dtype, detached under
        parity (N7)."""
        w0 = torch.stack([tower[0].w for tower in self.pre_nns[k]])
        b0 = torch.cat([tower[0].b for tower in self.pre_nns[k]])
        if self.parity:
            w0, b0 = w0.detach(), b0.detach()
        return w0.to(self.edge_dtype), b0.to(self.edge_dtype)

    def _projections(self, w0, x_flat):
        """``(p_dst, p_src)`` (N, T·F): the dst and src blocks of the first
        layer applied per node, in the edge dtype."""
        f, t = self.f_in, self.towers
        x_flat = x_flat.to(self.edge_dtype)
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
        return e_feat.to(self.edge_dtype) @ w0[:, 2 * f:, :].permute(1, 0, 2).reshape(f, t * f)

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
                m = torch.relu(m) @ w.to(self.edge_dtype) + b.to(self.edge_dtype)
            parts.append(m)
        return torch.cat(parts, dim=1)

    # ---- aggregation ---------------------------------------------------

    def _reduce(self, name, msgs, graph: Graph, deg, axis_name: AxisName = None):
        """One reduce over the real in-edges → (N, T·F); empty rows give 0.
        ``axis_name`` combines an edge shard's partials (module docstring)."""
        if name == "sum":
            return psum(segment_sum_csr(msgs, graph.real_row_ptr), axis_name)
        if name == "mean":  # deg clamped ≥ 1
            return psum(segment_sum_csr(msgs, graph.real_row_ptr), axis_name) / deg
        if name in ("var", "std"):
            c = msgs.shape[1]
            both = psum(segment_sum_sq_csr(msgs, graph.real_row_ptr), axis_name)
            mean, mean_sq = both[:, :c] / deg, both[:, c:] / deg
            out = mean_sq - mean * mean
            return torch.sqrt(torch.relu(out) + 1e-5) if name == "std" else out
        return _cross_shard_minmax(fused_segment_minmax(msgs, graph, (name,)), (name,),
                                   graph, axis_name)

    def _reduce_all(self, per_agg, graph: Graph, deg, shared_messages: bool,
                    axis_name: AxisName = None):
        """All K reduces; min and max over the SAME messages (parity's
        shared messages, N6) run as one paired kernel pass."""
        paired = {}
        minmax = tuple(a for a in self.aggregators if a in ("min", "max"))
        if shared_messages and len(minmax) >= 2:
            msgs = per_agg[minmax[0]]
            fused = _cross_shard_minmax(fused_segment_minmax(msgs, graph, minmax), minmax,
                                        graph, axis_name)
            c = msgs.shape[1]
            for pi, a in enumerate(minmax):
                paired[a] = fused[:, pi * c:(pi + 1) * c]
        return [paired[a] if a in paired
                else self._reduce(a, per_agg[a], graph, deg, axis_name)
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

    def _fused_route(self) -> bool:
        return self.pre_layers == 1 and all(a in ("min", "max") for a in self.aggregators)

    def _ell_spec(self, graph: Graph) -> Optional[EllSpec]:
        """The slot layout of the ELL route for this graph, or None for the
        CSR routes (see the module docstring)."""
        if self.pre_layers != 1 or self.edge_format == "csr":
            return None
        if graph.ell_hint is not None:
            return EllSpec.from_hint(graph.ell_hint)
        if self.edge_format == "ell" and self.max_degree_hint is not None:
            return single_width_spec(graph.n_node, self.max_degree_hint)
        return None

    def _seeds(self, count: int, generator, seed, device) -> List[Optional[torch.Tensor]]:
        """``count`` (1,) int32 hash seeds for the hashed dropout: ``seed`` as
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
        axis_name: AxisName = None,
    ) -> torch.Tensor:
        """Message dropout (N2) is on when ``generator`` or ``seed`` is
        given. The ELL and fused routes' masks are position hashes of one
        seed per message set (one under parity, one per aggregator
        otherwise): ``seed`` gives them (an int or a sequence, so that a
        test can feed the JAX package's seeds), else they are drawn from
        ``generator``. The general route draws its mask from
        ``generator``. ``axis_name`` runs the conv on an edge shard (module
        docstring)."""
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
        spec = self._ell_spec(graph) if axis_name is None else None
        fused_route = axis_name is None and self._fused_route()
        if spec is not None or fused_route:
            seeds = self._seeds(1 if self.parity else k, generator, seed, x.device)
            runs = ([(k - 1, self.aggregators, seeds[0])] if self.parity  # N6
                    else [(ki, (a,), seeds[ki]) for ki, a in enumerate(self.aggregators)])
        if spec is not None:
            valids = None if graph.ell_exact else ell_valid(graph, spec)
            reds = []
            for ki, aggs, sd in runs:
                xs = self._ell_messages(ki, x_flat, e_feat, graph, spec, sd)
                reds += self._ell_reduce(xs, graph, spec, valids, deg, aggs)
        elif fused_route:
            reds = []
            for ki, ops, sd in runs:
                p_dst, hg = self._message_parts(ki, x_flat, e_feat, graph)
                fused = fused_minmax_edge_program(p_dst, hg, graph, ops, seed=sd,
                                                  rate=self.dropout_rate)
                c = hg.shape[1]
                reds += [fused[:, pi * c:(pi + 1) * c] for pi in range(len(ops))]
        else:
            if self.parity:
                # N6: every aggregator consumes the LAST aggregator's messages.
                msgs = self._messages_for_aggregator(k - 1, x_flat, e_feat, graph)
                msgs = dropout(msgs, self.dropout_rate, generator)
                per_agg = {a: msgs for a in self.aggregators}
            else:
                per_agg = {a: dropout(self._messages_for_aggregator(ki, x_flat, e_feat, graph),
                                      self.dropout_rate, generator)
                           for ki, a in enumerate(self.aggregators)}
            reds = self._reduce_all(per_agg, graph, deg, shared_messages=self.parity,
                                    axis_name=axis_name)
        if graph.ell_exact:
            # The bucket-padding rows' synthetic self-loops (module docstring).
            reds = [torch.where(graph.node_mask[:, None], r, 0.0) for r in reds]
        return self._post(x_flat, reds, deg)

    # ---- ELL route -----------------------------------------------------

    def _ell_messages(self, k, x_flat, e_feat, graph: Graph, spec: EllSpec, seed):
        """Aggregator ``k``'s messages as per-bucket slot blocks ``(R_b,
        W_b·T·F)`` in the edge dtype, N2 dropout applied: the JAX package's
        hash of (seed, row, slot lane), bit for bit."""
        p_dst, hg = self._message_parts(k, x_flat, e_feat, graph)
        parts = ell_expand_exact(hg, spec) if graph.ell_exact else ell_expand(hg, graph, spec)
        xs = []
        for part, s, b, w in zip(parts, spec.starts, spec.bounds, spec.widths):
            xb = part + p_dst[s:b].repeat(1, w)
            if seed is not None:
                rows = torch.arange(s, b, device=xb.device)[:, None]
                lanes = torch.arange(xb.shape[1], device=xb.device)[None, :]
                xb = xb * dropout_keep(seed, rows, lanes, self.dropout_rate).to(xb.dtype)
            xs.append(xb)
        return xs

    def _ell_reduce(self, xs, graph: Graph, spec: EllSpec, valids, deg, wanted):
        """The reduces ``wanted`` of one message set as ``(N, T·F)`` float32
        each: masked reduces over each bucket's slot axis, concatenated and
        zero-padded past the buckets (degree-0 and padding rows)."""
        need = set()
        for a in wanted:
            need.update({a} if a in ("min", "max") else {"s1"} if a in ("sum", "mean")
                        else {"s1", "s2"})
        raw = {key: [] for key in need}
        minmax = tuple(a for a in ("min", "max") if a in need)
        for bi, (xb, w) in enumerate(zip(xs, spec.widths)):
            vb = None if valids is None else valids[bi]
            if minmax:
                for a, r in zip(minmax, masked_minmax_firsthit(xb, vb, minmax, w)):
                    raw[a].append(r)
            if "s1" in need:
                raw["s1"].append(masked_slot_sum(xb, vb, w))
            if "s2" in need:
                raw["s2"].append(masked_slot_sum(xb * xb, vb, w))
        n = graph.n_node
        # The sums are float32 already; min/max select edge-dtype values.
        cat = {key: pad_rows(torch.cat(v, dim=0), n).float() for key, v in raw.items()}
        if minmax and valids is not None:
            # Rows without a valid slot hold the ±inf neutral: select on the
            # slots themselves, not on deg (a sampled layout's deg holds
            # full-graph degrees).
            row_has_slot = pad_rows(torch.cat([v.any(dim=1, keepdim=True) for v in valids])
                                    .float(), n) > 0
        outs = []
        for a in wanted:
            if a in ("min", "max"):
                outs.append(cat[a] if valids is None else torch.where(row_has_slot, cat[a], 0.0))
            elif a == "sum":
                outs.append(cat["s1"])
            elif a == "mean":
                outs.append(cat["s1"] / deg)
            else:
                mean = cat["s1"] / deg
                var = cat["s2"] / deg - mean * mean
                outs.append(var if a == "var" else torch.sqrt(torch.relu(var) + 1e-5))
        return outs

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


def _cross_shard_minmax(local: torch.Tensor, ops, graph: Graph, axis_name: AxisName
                        ) -> torch.Tensor:
    """Combine an edge shard's min/max partials ``[op_0 ‖ op_1 ‖ ...]`` (the
    kernel's, 0 on rows the shard leaves empty) over ``axis_name``: those
    rows take each op's neutral, one ``all_gather`` stacks every shard's
    partials, ``amax``/``amin`` reduce them, and rows without an in-edge
    anywhere give 0. Unsharded (``axis_name`` None) it returns ``local``."""
    if axis_name is None:
        return local
    rp = graph.real_row_ptr
    has_edge = (rp[1:] > rp[:-1])[:, None]
    c = local.shape[1] // len(ops)
    neutral = torch.cat([local.new_full((1, c), float("-inf") if op == "max" else float("inf"))
                         for op in ops], dim=1)
    stacked = all_gather(torch.where(has_edge, local, neutral), axis_name)
    out = torch.cat([(torch.amax if op == "max" else torch.amin)(
        stacked[:, :, i * c:(i + 1) * c], dim=0) for i, op in enumerate(ops)], dim=1)
    return torch.where(graph.deg[:, None] > 0, out, 0.0)

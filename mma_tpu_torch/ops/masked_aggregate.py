"""K-way masked aggregation, the core of the MMA layer.

For every center node ``i`` and neighbor ``j`` the reference computes
``mask_ij = act([h_i ‖ h_j] @ W_k)`` and sums ``mask_ij ⊙ h_j`` over ``j``.
As in the JAX package, ``[h_i ‖ h_j] @ W = h_i @ W_top + h_j @ W_bot``, and
all K aggregators share one flat ``(N, K·F)`` layout; aggregator ``k``
owns lanes ``[k·F, (k+1)·F)``. Four routes, chosen as the JAX package
chooses (``mma_tpu/ops/masked_aggregate.py:236-294``):

- **Fused lean** (the default): ``c = h @ W_top`` is one per-node matmul,
  and the lean edge program
  (``mma_tpu_torch.ops.cuda.fused_mma.edge_program_lean``) does the
  per-edge work (``h[src] @ W_bot``, the activation, the product with
  ``tile(h[src], K)`` and the sum over each destination's edges) without
  storing per-edge tensors, forward and backward. Mask dropout (N2) is an
  operand of the same program (**lean, keep-aware**): the keep is drawn as
  the half-fused route draws it, ``torch.rand((E, K·F), generator) >=
  rate``, and the kernels read it, so autograd saves one bool (E, K·F)
  tensor in place of the logits, masks and messages. float32 on one device
  only: a bf16 ``compute_dtype`` with mask dropout keeps the half-fused
  route, whose bf16 logits, masks and messages are the JAX package's bf16
  function, and so does mask dropout on an edge shard (``axis_name``).
- **Fused wide** (an explicit ``pallas_bwd_mode``): both projections ``c,
  d`` are per-node matmuls, and the wide edge program
  (``mma_tpu_torch.ops.cuda.fused_mma.edge_program``) gathers ``d[src]``
  and ``h[src]`` per edge; ``pallas_bwd_mode`` chooses its src-keyed
  backward (``"payload_permute"`` or ``"csc_gather"``).
- **Half-fused**: the ``std``/``moment_3`` combines need the per-edge
  messages, so they materialise ``(E, K·F)`` logits ``c[dst] + d[src]``,
  mask and messages, and reduce them with kernel 1 over the CSR; so does
  mask dropout where the lean program does not run (a bf16 pipeline, an
  edge shard, an explicit ``pallas_bwd_mode``, a graph without its CSC).
- **ELL** (graphs with ``Graph.ell_hint``: the sampler's hopped layout,
  every row's in-degree bounded by its bucket's width): one gather of the
  ``[d ‖ h]`` node table per neighbour slot, then masked slot sums in
  plain PyTorch, as the JAX package's ``_ell_masked_aggregate``
  (``mma_tpu/ops/masked_aggregate.py:96-185``), which is XLA there with no
  Pallas kernel. It covers mask dropout and the ``std``/``moment_3``
  combines itself. The gather's VJP is kernel 1 over the CSC. The JAX
  package also asks for a TPU chunk hint, which the port's graphs never
  carry; the port's gate is the ELL hint alone. The degree-exact ZINC
  layout (``Graph.ell_exact``) is ``MultiMaskConv``'s and raises here.

Every route reduces over the real edges only (``Graph.real_row_ptr``).
Each call counts its route on the innermost open span of the port's
tracing (``mma.route.<lean|lean_keep|wide|half_fused|ell>``), so a traced
step shows which program ran.

``axis_name`` (a mesh axis's process group; ``mma_tpu_torch.parallel``)
runs the aggregation on an edge shard, as the JAX package does under
``shard_map``: the partial sums ``S`` (and ``std``'s squares and
``moment_3``'s cubes) are ``psum``-combined before the center combine
(``mma_tpu/ops/masked_aggregate.py:316-317``, ``:328-329``, ``:363-364``).
The ELL route is off under an axis (``:243``). The lean and wide routes need
the graph's CSC view and stay on for a shard that carries one
(``src_perm``, ``:236-237``); a graph without one takes the half-fused
route, whose src-keyed backward derives the CSC order on the device. Mask
dropout on a shard takes the half-fused route too, as the JAX package's
does (``:237``).

``compute_dtype=torch.bfloat16`` runs the edge pipeline on bf16 operands,
as the JAX package's Pallas path does (``mma_tpu/ops/masked_aggregate.py:
218-316``): ``h`` and the mask weights enter as bf16, the lean route's
``c = h @ W_top`` is a bf16 product handed to kernels 2-3 as float32 (with
``W_bot``), the wide route's ``c, d`` are bf16 products that kernels 9-11
read with the bf16 ``h`` (``c`` as float32) and sum without rounding a
message, the half-fused route's logits, masks and messages are bf16 and
kernel 1 sums them in float32, and the ELL route gathers a bf16 ``[d ‖ h]``
table and computes its slot messages in float32. The lean and the wide
route round differently, as the JAX package's do: the lean kernels round
each message to bf16 before they sum it, the wide ones do not. The
combines use the float32 ``h``.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch

from mma_tpu_torch.graph.container import Graph
from mma_tpu_torch.ops.aggregators import AggSpec
from mma_tpu_torch.ops.cuda.fused_mma import (
    EDGE_BWD_MODES,
    edge_program,
    edge_program_lean,
    segment_sum_csr,
)
from mma_tpu_torch.ops.ell import EllSpec, ell_gather_nodes_by_src, ell_valid, pad_rows
from mma_tpu_torch.ops.gather import gather_by_dst, gather_by_src
from mma_tpu_torch.parallel.collectives import AxisName, psum
from mma_tpu_torch.utils.profiling import count, trace

_EPS = 1e-5


def _flat_lanes(w: torch.Tensor) -> torch.Tensor:
    """``(K, F, F)`` per-aggregator blocks → ``(F, K·F)``, aggregator-major lanes."""
    k, f, _ = w.shape
    return w.permute(1, 0, 2).reshape(f, k * f)


def mma_mask_projections(h: torch.Tensor, mask_weights: torch.Tensor):
    """Per-node mask projections ``c, d``: each ``(N, K·F)`` flat.

    ``mask_weights``: ``(K, 2F, F)`` — one ``[W_top; W_bot]`` per
    aggregator. Per-edge logits are ``c[dst] + d[src]``.
    """
    f = mask_weights.shape[2]
    c = h @ _flat_lanes(mask_weights[:, :f, :])
    d = h @ _flat_lanes(mask_weights[:, f:, :])
    return c, d


def mma_mask_logits(h: torch.Tensor, mask_weights: torch.Tensor, graph: Graph) -> torch.Tensor:
    """Per-edge mask logits for K aggregators, ``c[dst] + d[src]``: ``(E, K·F)``
    flat, padding edges included."""
    c, d = mma_mask_projections(h, mask_weights)
    return gather_by_dst(c, graph) + gather_by_src(d, graph)


def sigmoid_lane_pattern(specs: Sequence[AggSpec], activation: str,
                         parity: bool, f: int, device) -> torch.Tensor:
    """(K·F,) float 0/1: which flat lanes get the sigmoid (N1 table)."""
    pat = torch.tensor(
        [float(s.applies_sigmoid(activation, parity)) for s in specs],
        dtype=torch.float32,
    )
    pat = pat.repeat_interleave(f)
    with trace("sync.lane_pattern"):  # a host-to-card copy: the host waits for it
        return pat.to(device)


def _edge_messages(h, graph, mask_weights, pat, rate, generator):
    """The half-fused route's ``(E, K·F)`` messages ``mask ⊙ tile(h[src], K)``.

    With a generator, mask dropout (N2) keeps each mask entry with
    probability ``1 - rate`` and scales it by ``1 / (1 - rate)``; the keep
    draws come from ``generator`` on the tensors' device."""
    k = mask_weights.shape[0]
    logits = mma_mask_logits(h, mask_weights, graph)
    mask = torch.where(pat.bool(), torch.sigmoid(logits), logits)
    if generator is not None:
        keep = torch.rand(mask.shape, generator=generator, device=mask.device) >= rate
        mask = torch.where(keep, mask / (1.0 - rate), 0.0)
    return mask * gather_by_src(h, graph).repeat(1, k)


def _ell_masked_aggregate(h, mask_weights, pat, graph, spec, generator, rate, need_s2):
    """K-way masked sums over the ELL slot layout.

    Per slot: ``msg = act(c[dst] + d[src]) ⊙ tile(h[src], K)``, then a
    masked sum over the slot axis, in slot order. The only random access is
    one gather of the ``[d ‖ h]`` node table per slot. With a generator,
    mask dropout draws once per bucket (``(R_b, W_b·K·F)``, in bucket
    order) and slices per slot, as the JAX package draws.

    Returns ``(s, s2, cent3)``: the K masked sums ``(N, K·F)``; their
    masked sums of squares (or None); and ``cent3(idx, mean)``, the sum of
    ``(msg_idx − mean[dst])³`` over each row's slots, for ``moment_3``.
    Rows past the last bucket (the last hop's leaves, padding) give 0.
    """
    n, f = h.shape
    k = mask_weights.shape[0]
    kf = k * f
    t_w = kf + f  # a slot's lanes in the gathered [d ‖ h] table
    c, d = mma_mask_projections(h, mask_weights)
    parts = ell_gather_nodes_by_src(torch.cat([d, h], dim=1), graph, spec)
    c = c.float()  # bf16 projections: the slot messages are float32
    valids = ell_valid(graph, spec)
    ranges = list(zip(spec.starts, spec.bounds))
    sig = pat.bool()
    keeps = None
    if generator is not None:
        keeps = [torch.rand((p.shape[0], w * kf), generator=generator, device=h.device) >= rate
                 for p, w in zip(parts, spec.widths)]

    def slot_msg(bi, di):
        """Slot ``di`` of bucket ``bi``: the ``(R_b, K·F)`` masked message."""
        s_, b_ = ranges[bi]
        td = parts[bi][:, di * t_w:(di + 1) * t_w].float()
        logits = c[s_:b_] + td[:, :kf]
        mask = torch.where(sig, torch.sigmoid(logits), logits)
        if keeps is not None:
            mask = torch.where(keeps[bi][:, di * kf:(di + 1) * kf], mask / (1.0 - rate), 0.0)
        return mask * td[:, kf:].repeat(1, k)

    s1_parts, s2_parts = [], []
    for bi, w in enumerate(spec.widths):
        s1 = s2 = None
        for di in range(w):
            msg = slot_msg(bi, di)
            vd = valids[bi][:, di:di + 1]
            term = torch.where(vd, msg, 0.0)
            s1 = term if s1 is None else s1 + term
            if need_s2:
                t2 = torch.where(vd, msg * msg, 0.0)
                s2 = t2 if s2 is None else s2 + t2
        s1_parts.append(s1)
        s2_parts.append(s2)
    s = pad_rows(torch.cat(s1_parts, dim=0), n)
    s2 = pad_rows(torch.cat(s2_parts, dim=0), n) if need_s2 else None

    def cent3(idx, mean):
        outs = []
        for bi, ((s_, b_), w) in enumerate(zip(ranges, spec.widths)):
            acc = None
            for di in range(w):
                msg_k = slot_msg(bi, di)[:, idx * f:(idx + 1) * f]
                cent = torch.where(valids[bi][:, di:di + 1], (msg_k - mean[s_:b_]) ** 3, 0.0)
                acc = cent if acc is None else acc + cent
            outs.append(acc)
        return pad_rows(torch.cat(outs, dim=0), n)

    return s, s2, cent3


def masked_multi_aggregate(
    h: torch.Tensor,
    graph: Graph,
    mask_weights: torch.Tensor,
    specs: Sequence[AggSpec],
    *,
    activation: str = "new_sigmoid",
    parity: bool = True,
    mask_dropout_rate: float = 0.0,
    generator: Optional[torch.Generator] = None,
    pallas_bwd_mode: Optional[str] = None,
    compute_dtype: torch.dtype = torch.float32,
    axis_name: AxisName = None,
) -> torch.Tensor:
    """K-way masked aggregation: returns ``(N, K, F)`` combined outputs.

    For each aggregator ``k``:
    ``S_k[i] = Σ_{e: dst(e)=i} act_k(logits_k[e]) ⊙ h[src(e)]``, then the
    spec's center combine. Rows of padding nodes are unspecified.
    ``generator`` with a positive ``mask_dropout_rate`` turns on mask
    dropout, drawn from that generator (it must live on ``h``'s device):
    one ``(E, K·F)`` draw a call, whichever route runs it.
    ``pallas_bwd_mode`` (``"payload_permute"`` or ``"csc_gather"``) takes
    the wide edge program with that backward where the lean one would run
    (no mask dropout, no ``std``/``moment_3``, no ELL layout); None keeps
    the lean one. The name is the JAX package's. A graph with an
    ``ell_hint`` takes the ELL route (module docstring). ``compute_dtype``
    (``torch.float32`` or ``torch.bfloat16``) is the edge pipeline's dtype
    (module docstring); sums and the result stay float32. ``axis_name``
    combines an edge shard's partial sums over that axis (module docstring).
    """
    n, f = h.shape
    k = len(specs)
    if mask_weights.shape != (k, 2 * f, f):
        raise ValueError(f"mask_weights {tuple(mask_weights.shape)} != {(k, 2 * f, f)}")
    if pallas_bwd_mode is not None and pallas_bwd_mode not in EDGE_BWD_MODES:
        raise ValueError(f"pallas_bwd_mode must be None or one of {EDGE_BWD_MODES}, "
                         f"got {pallas_bwd_mode!r}")
    if graph.ell_exact:
        raise ValueError("masked_multi_aggregate does not take the degree-exact ZINC "
                         "layout (Graph.ell_exact); MultiMaskConv does")
    if compute_dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"compute_dtype must be torch.float32 or torch.bfloat16, "
                         f"got {compute_dtype}")
    dropout_on = generator is not None and mask_dropout_rate > 0.0
    need_moments = any(s.combine in ("std", "moment_3") for s in specs)
    pat = sigmoid_lane_pattern(specs, activation, parity, f, h.device)
    row_ptr = graph.real_row_ptr
    # The edge pipeline's operands; the combines below use the float32 h.
    h_c, mw = h.to(compute_dtype), mask_weights.to(compute_dtype)

    # The lean program's calls: a CSC, no moments, no explicit wide backward;
    # with mask dropout also a float32 pipeline on one device (an edge
    # shard's dropout keeps the half-fused route).
    lean = not need_moments and graph.src_perm is not None and pallas_bwd_mode is None
    keep_ok = compute_dtype == torch.float32 and axis_name is None
    msgs = ell_ctx = None
    if graph.ell_hint is not None and axis_name is None:
        route = "ell"
        s, s2_ell, cent3 = _ell_masked_aggregate(
            h_c, mw, pat, graph, EllSpec.from_hint(graph.ell_hint),
            generator if dropout_on else None, mask_dropout_rate,
            need_s2=any(sp.combine == "std" for sp in specs))
        ell_ctx = (s2_ell, cent3)
    elif lean and (not dropout_on or keep_ok):
        # c = h_c @ W_top is a product in the pipeline's dtype; kernels 2-3
        # take it and W_bot as float32 copies, and read h_c as it is.
        w_top = _flat_lanes(mw[:, :f, :])
        w_bot = _flat_lanes(mw[:, f:, :]).contiguous()
        c = (h_c @ w_top).float()
        keep = None
        if dropout_on:
            # The half-fused route's draw, shape and place in the order.
            keep = torch.rand((graph.n_edge, k * f), generator=generator,
                              device=h.device) >= mask_dropout_rate
        route = "lean" if keep is None else "lean_keep"
        s = edge_program_lean(c, w_bot.float(), h_c.contiguous(), pat, graph.src, row_ptr,
                              graph.real_col_ptr, graph.dst_csc, keep=keep,
                              rate=mask_dropout_rate, src_perm=graph.src_perm)
    elif dropout_on or need_moments or graph.src_perm is None:
        route = "half_fused"
        msgs = _edge_messages(h_c, graph, mw, pat, mask_dropout_rate,
                              generator if dropout_on else None)
        s = segment_sum_csr(msgs, row_ptr)
    else:
        route = "wide"
        # c and d are products in the pipeline's dtype; kernels 9-11 take c
        # as float32 and read d and h_c as they are.
        c, d = mma_mask_projections(h_c, mw)
        s = edge_program(c, d, h_c.contiguous(), pat, graph.src, row_ptr, graph.real_col_ptr,
                         graph.src_perm, graph.dst_csc, pallas_bwd_mode)
    count(f"mma.route.{route}")
    s = psum(s, axis_name).reshape(n, k, f)

    deg = torch.clamp(graph.deg, min=1.0)[:, None]  # (N, 1)
    if any(sp.combine == "std" for sp in specs):
        s2 = ell_ctx[0] if ell_ctx is not None else segment_sum_csr(msgs * msgs, row_ptr)
        s2 = psum(s2, axis_name).reshape(n, k, f)
    outs = []
    for idx, sp in enumerate(specs):
        sk = s[:, idx, :]
        if sp.combine == "sum":
            out = h + sk
        elif sp.combine == "mean":
            out = (h + sk) / deg
        elif sp.combine == "max":
            out = torch.maximum(h, sk)
        elif sp.combine == "min":
            out = torch.minimum(h, sk)
        elif sp.combine == "passthrough":
            out = sk
        elif sp.combine == "std":
            mean = sk / deg
            mean_sq = s2[:, idx, :] / deg
            out = torch.sqrt(torch.relu(mean_sq - mean * mean) + _EPS)
        elif sp.combine == "normalized_mean":
            out = sk * torch.rsqrt(deg)
        elif sp.combine == "moment_3":
            # Two-pass central moment E[(x − μ)³], and a signed cube root
            # that is linear at 0, as in the JAX package
            # (masked_aggregate.py:350-369): the one-pass raw-moment form
            # cancels catastrophically and sign(m)·|m|^(1/3) jumps on
            # rounding noise.
            mean = sk / deg
            if ell_ctx is not None:
                s3 = ell_ctx[1](idx, mean)
            else:
                msgs_k = msgs[:, idx * f:(idx + 1) * f]
                s3 = segment_sum_csr((msgs_k - gather_by_dst(mean, graph)) ** 3, row_ptr)
                s3 = psum(s3, axis_name)
            m3 = s3 / deg
            out = m3 * (m3 * m3 + _EPS) ** (-1.0 / 3.0)
        else:
            raise ValueError(f"unknown combine {sp.combine!r}")
        outs.append(out)
    return torch.stack(outs, dim=1)  # (N, K, F)

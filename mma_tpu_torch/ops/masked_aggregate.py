"""K-way masked aggregation, the core of the MMA layer.

For every center node ``i`` and neighbor ``j`` the reference computes
``mask_ij = act([h_i ‖ h_j] @ W_k)`` and sums ``mask_ij ⊙ h_j`` over ``j``.
As in the JAX package, ``[h_i ‖ h_j] @ W = h_i @ W_top + h_j @ W_bot``, and
all K aggregators share one flat ``(N, K·F)`` layout; aggregator ``k``
owns lanes ``[k·F, (k+1)·F)``. Three routes, chosen as the JAX package
chooses (``mma_tpu/ops/masked_aggregate.py:236-294``):

- **Fused lean** (the default): ``c = h @ W_top`` is one per-node matmul,
  and the lean edge program
  (``mma_tpu_torch.ops.cuda.fused_mma.edge_program_lean``) does the
  per-edge work (``h[src] @ W_bot``, the activation, the product with
  ``tile(h[src], K)`` and the sum over each destination's edges) without
  storing per-edge tensors, forward and backward.
- **Fused wide** (an explicit ``pallas_bwd_mode``): both projections ``c,
  d`` are per-node matmuls, and the wide edge program
  (``mma_tpu_torch.ops.cuda.fused_mma.edge_program``) gathers ``d[src]``
  and ``h[src]`` per edge; ``pallas_bwd_mode`` chooses its src-keyed
  backward (``"payload_permute"`` or ``"csc_gather"``).
- **Half-fused**: mask dropout (N2) and the ``std``/``moment_3`` combines
  need the per-edge masks and messages, so they materialise ``(E, K·F)``
  logits ``c[dst] + d[src]``, mask and messages, and reduce them with
  kernel 1 over the CSR.

Every route reduces over the real edges only (``Graph.real_row_ptr``).
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
from mma_tpu_torch.ops.gather import gather_by_dst, gather_by_src

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


def sigmoid_lane_pattern(specs: Sequence[AggSpec], activation: str,
                         parity: bool, f: int, device) -> torch.Tensor:
    """(K·F,) float 0/1: which flat lanes get the sigmoid (N1 table)."""
    pat = torch.tensor(
        [float(s.applies_sigmoid(activation, parity)) for s in specs],
        dtype=torch.float32,
    )
    return pat.repeat_interleave(f).to(device)


def _edge_messages(h, graph, mask_weights, pat, rate, generator):
    """The half-fused route's ``(E, K·F)`` messages ``mask ⊙ tile(h[src], K)``.

    With a generator, mask dropout (N2) keeps each mask entry with
    probability ``1 - rate`` and scales it by ``1 / (1 - rate)``; the keep
    draws come from ``generator`` on the tensors' device."""
    k = mask_weights.shape[0]
    c, d = mma_mask_projections(h, mask_weights)
    logits = gather_by_dst(c, graph) + gather_by_src(d, graph)
    mask = torch.where(pat.bool(), torch.sigmoid(logits), logits)
    if generator is not None:
        keep = torch.rand(mask.shape, generator=generator, device=mask.device) >= rate
        mask = torch.where(keep, mask / (1.0 - rate), 0.0)
    return mask * gather_by_src(h, graph).repeat(1, k)


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
) -> torch.Tensor:
    """K-way masked aggregation: returns ``(N, K, F)`` combined outputs.

    For each aggregator ``k``:
    ``S_k[i] = Σ_{e: dst(e)=i} act_k(logits_k[e]) ⊙ h[src(e)]``, then the
    spec's center combine. Rows of padding nodes are unspecified.
    ``generator`` with a positive ``mask_dropout_rate`` turns on mask
    dropout, drawn from that generator (it must live on ``h``'s device).
    ``pallas_bwd_mode`` (``"payload_permute"`` or ``"csc_gather"``) takes
    the wide edge program with that backward where the lean one would run
    (no mask dropout, no ``std``/``moment_3``); None keeps the lean one.
    The name is the JAX package's.
    """
    n, f = h.shape
    k = len(specs)
    if mask_weights.shape != (k, 2 * f, f):
        raise ValueError(f"mask_weights {tuple(mask_weights.shape)} != {(k, 2 * f, f)}")
    if pallas_bwd_mode is not None and pallas_bwd_mode not in EDGE_BWD_MODES:
        raise ValueError(f"pallas_bwd_mode must be None or one of {EDGE_BWD_MODES}, "
                         f"got {pallas_bwd_mode!r}")
    dropout_on = generator is not None and mask_dropout_rate > 0.0
    need_moments = any(s.combine in ("std", "moment_3") for s in specs)
    pat = sigmoid_lane_pattern(specs, activation, parity, f, h.device)
    row_ptr = graph.real_row_ptr

    msgs = None
    if dropout_on or need_moments:
        msgs = _edge_messages(h, graph, mask_weights, pat, mask_dropout_rate,
                              generator if dropout_on else None)
        s = segment_sum_csr(msgs, row_ptr)
    elif pallas_bwd_mode is not None:
        c, d = mma_mask_projections(h, mask_weights)
        s = edge_program(c, d, h.contiguous(), pat, graph.src, row_ptr, graph.real_col_ptr,
                         graph.src_perm, graph.dst_csc, pallas_bwd_mode)
    else:
        w_top = _flat_lanes(mask_weights[:, :f, :])
        w_bot = _flat_lanes(mask_weights[:, f:, :]).contiguous()
        s = edge_program_lean(h @ w_top, w_bot, h.contiguous(), pat, graph.src, row_ptr,
                              graph.real_col_ptr, graph.dst_csc)
    s = s.reshape(n, k, f)

    deg = torch.clamp(graph.deg, min=1.0)[:, None]  # (N, 1)
    if any(sp.combine == "std" for sp in specs):
        s2 = segment_sum_csr(msgs * msgs, row_ptr).reshape(n, k, f)
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
            msgs_k = msgs[:, idx * f:(idx + 1) * f]
            s3 = segment_sum_csr((msgs_k - gather_by_dst(mean, graph)) ** 3, row_ptr)
            m3 = s3 / deg
            out = m3 * (m3 * m3 + _EPS) ** (-1.0 / 3.0)
        else:
            raise ValueError(f"unknown combine {sp.combine!r}")
        outs.append(out)
    return torch.stack(outs, dim=1)  # (N, K, F)

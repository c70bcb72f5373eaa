"""Plain segment reductions over destination ids.

Plain PyTorch reductions: ``segment_sum`` is an ``index_add_`` into an f32
zero table, ``segment_min``/``segment_max`` a ``scatter_reduce``, and
``segment_mean``/``segment_softmax_denom`` are built on them, as the JAX
package builds them on XLA's (no kernel computes them there either). The
hot paths reach the sorted-CSR kernels in ``mma_tpu_torch.ops.cuda``
instead. The ids need not be sorted, so the JAX ``sorted`` keyword has no
counterpart.
"""

from __future__ import annotations

import torch


def segment_sum(data: torch.Tensor, segment_ids: torch.Tensor,
                num_segments: int) -> torch.Tensor:
    """``out[s] = Σ_{e: ids[e]=s} data[e]``; empty segments give 0."""
    out = torch.zeros((num_segments,) + tuple(data.shape[1:]),
                      dtype=data.dtype, device=data.device)
    return out.index_add_(0, segment_ids.long(), data)


def _segment_extremum(data, segment_ids, num_segments, reduce):
    out = torch.zeros((num_segments,) + tuple(data.shape[1:]),
                      dtype=data.dtype, device=data.device)
    ids = segment_ids.long().reshape((-1,) + (1,) * (data.ndim - 1)).expand_as(data)
    return out.scatter_reduce_(0, ids, data, reduce, include_self=False)


def segment_max(data: torch.Tensor, segment_ids: torch.Tensor,
                num_segments: int) -> torch.Tensor:
    """``out[s] = max_{e: ids[e]=s} data[e]``; empty segments give 0 (the
    reference's ``torch_scatter`` fill)."""
    return _segment_extremum(data, segment_ids, num_segments, "amax")


def segment_min(data: torch.Tensor, segment_ids: torch.Tensor,
                num_segments: int) -> torch.Tensor:
    """``out[s] = min_{e: ids[e]=s} data[e]``; empty segments give 0."""
    return _segment_extremum(data, segment_ids, num_segments, "amin")


def segment_mean(data: torch.Tensor, segment_ids: torch.Tensor,
                 num_segments: int) -> torch.Tensor:
    """Segment mean; empty segments give 0 (the count is clamped to 1)."""
    total = segment_sum(data, segment_ids, num_segments)
    count = torch.clamp(segment_sum(data.new_ones(data.shape[:1]), segment_ids, num_segments),
                        min=1.0)
    return total / count.reshape((num_segments,) + (1,) * (data.ndim - 1))


def segment_softmax_denom(scores: torch.Tensor, segment_ids: torch.Tensor,
                          num_segments: int):
    """Per-segment softmax normalizer: ``(max, Σ exp(s − max))`` per segment.
    An empty segment gives ``(0, 0)``: :func:`segment_max` fills it with 0
    where the JAX package's gives ``-inf``."""
    seg_max = segment_max(scores, segment_ids, num_segments)
    shifted = scores - seg_max[segment_ids.long()]
    seg_sum = segment_sum(torch.exp(shifted), segment_ids, num_segments)
    return seg_max, seg_sum

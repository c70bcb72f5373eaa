"""Plain segment reductions over destination ids.

Plain PyTorch reductions: ``segment_sum`` is an ``index_add_`` into an f32
zero table, ``segment_min``/``segment_max`` a ``scatter_reduce``. The hot
paths reach the sorted-CSR kernels in ``mma_tpu_torch.ops.cuda`` instead.
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

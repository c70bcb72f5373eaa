"""Plain segment reductions over destination ids.

``segment_sum`` is the plain PyTorch reduction (``index_add_`` into an
f32 zero table). The hot paths reach the sorted-CSR kernel in
``mma_tpu_torch.ops.cuda.fused_mma`` instead.
"""

from __future__ import annotations

import torch


def segment_sum(data: torch.Tensor, segment_ids: torch.Tensor,
                num_segments: int) -> torch.Tensor:
    """``out[s] = Σ_{e: ids[e]=s} data[e]``; empty segments give 0."""
    out = torch.zeros((num_segments,) + tuple(data.shape[1:]),
                      dtype=data.dtype, device=data.device)
    return out.index_add_(0, segment_ids.long(), data)

"""Basic building blocks."""

from __future__ import annotations

from typing import Optional

import torch


def dropout(x: torch.Tensor, rate: float,
            generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Inverted dropout; the identity when ``generator is None`` or
    ``rate == 0`` (eval). ``generator`` must live on ``x``'s device."""
    if generator is None or rate <= 0.0:
        return x
    keep = torch.rand(x.shape, generator=generator, device=x.device) >= rate
    return torch.where(keep, x / (1.0 - rate), 0.0)

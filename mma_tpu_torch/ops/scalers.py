"""PNA-style degree scalers of the node-classification stack.

In parity mode the reference's three scalers are degenerate (every
"degree" is N, so amplification/attenuation are the identity — N3), and
the concat-then-tiled-weight algebra reduces the stage to the scalar
factor ``len(scalers)``. In fixed mode the scalers use true in-degrees.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch

SCALER_NAMES = ("identity", "amplification", "attenuation")


def scaler_factors(
    name: str,
    deg: torch.Tensor,
    node_mask: torch.Tensor,
    avg_log_deg: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Per-node scale factor ``(N,)`` for one scaler over true degrees."""
    if name == "identity":
        return torch.ones_like(deg)
    log_deg = torch.log(deg + 1.0)
    if avg_log_deg is None:
        denom = torch.clamp(node_mask.to(deg.dtype).sum(), min=1.0)
        avg_log_deg = torch.where(node_mask, log_deg, 0.0).sum() / denom
    if name == "amplification":
        return log_deg / avg_log_deg
    if name == "attenuation":
        return avg_log_deg / torch.clamp(log_deg, min=1e-12)
    raise ValueError(f"unknown scaler {name!r}; valid: {SCALER_NAMES}")


def apply_scalers(
    m: torch.Tensor,
    deg: torch.Tensor,
    node_mask: torch.Tensor,
    scalers: Sequence[str] = SCALER_NAMES,
    *,
    parity: bool = True,
    avg_log_deg: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """``Σ_s scale_s ⊙ m``; ``parity=True`` gives ``len(scalers) · m`` (N3)."""
    if parity:
        return float(len(scalers)) * m
    total = torch.zeros_like(m)
    for name in scalers:
        fac = scaler_factors(name, deg, node_mask, avg_log_deg)
        total = total + fac.reshape((-1,) + (1,) * (m.ndim - 1)) * m
    return total

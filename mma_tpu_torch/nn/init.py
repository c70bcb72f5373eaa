"""Parameter initializers matching the reference's conventions.

- pygcn ``GraphConvolution``: ``stdv = 1/√fan_out``
  (``node_classification/layers.py:32-36``).
- MMA output weight and mask matrices: ``stdv = 1/√in``
  (``layers.py:145-168``).
- torch Linear: ``U(±1/√fan_in)``; torch Embedding: ``N(0, 1)``.

Draws come from a CPU ``torch.Generator`` so that one seed gives the same
weights whatever device the module lives on. They differ from the JAX
package's draws; tests carry weights across instead (``convert.py``).
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import torch


def uniform(shape: Sequence[int], bound: float,
            generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """``U(-bound, bound)`` float32 on the CPU."""
    u = torch.rand(tuple(shape), generator=generator, dtype=torch.float32)
    return (2.0 * u - 1.0) * bound


def uniform_fan_in(shape: Sequence[int],
                   generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """torch.nn.Linear-style: ``U(±1/√fan_in)`` (fan_in = shape[0] for (in, out))."""
    return uniform(shape, 1.0 / math.sqrt(shape[0]), generator)


def uniform_fan_out(shape: Sequence[int],
                    generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """pygcn-style: ``U(±1/√fan_out)`` (fan_out = shape[-1])."""
    return uniform(shape, 1.0 / math.sqrt(shape[-1]), generator)


def normal(shape: Sequence[int], generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """torch.nn.Embedding default: ``N(0, 1)`` float32 on the CPU."""
    return torch.randn(tuple(shape), generator=generator, dtype=torch.float32)

"""Basic building blocks: dropout and the dense modules of the ZINC stack.

``Dense``, ``Embedding``, ``BatchNorm`` and ``MLP`` are the JAX package's
modules (``mma_tpu/nn/layers.py``) as ``nn.Module``s, with the same
parameter names and layouts (weights ``(in, out)``), so that
``mma_tpu_torch.convert`` carries parameters across by name. Initial
draws come from a CPU ``torch.Generator`` (``nn/init.py``).
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
from torch import nn

from mma_tpu_torch.device import DeviceLike, resolve_device
from mma_tpu_torch.nn import init as inits
from mma_tpu_torch.ops.gather import gather_rows


def dropout(x: torch.Tensor, rate: float,
            generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Inverted dropout; the identity when ``generator is None`` or
    ``rate == 0`` (eval). ``generator`` must live on ``x``'s device."""
    if generator is None or rate <= 0.0:
        return x
    keep = torch.rand(x.shape, generator=generator, device=x.device) >= rate
    return torch.where(keep, x / (1.0 - rate), 0.0)


class Dense(nn.Module):
    """torch-Linear-equivalent affine layer, ``w`` ``(in, out)`` and ``b``
    ``(out,)``, both ``U(±1/√in)`` (kaiming-uniform with a=√5)."""

    def __init__(self, in_features: int, out_features: int, bias: bool = True, *,
                 device: DeviceLike = None, generator: Optional[torch.Generator] = None):
        super().__init__()
        dev = resolve_device(device)
        bound = 1.0 / math.sqrt(in_features)
        self.w = nn.Parameter(inits.uniform((in_features, out_features), bound, generator).to(dev))
        self.b = (nn.Parameter(inits.uniform((out_features,), bound, generator).to(dev))
                  if bias else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = x @ self.w
        return y if self.b is None else y + self.b


class Embedding(nn.Module):
    """Lookup table ``table`` ``(num, features)``, ``N(0, 1)`` init (the
    torch.nn.Embedding default). Its gradient is a one-hot product
    (:func:`~mma_tpu_torch.ops.gather.gather_rows`), not an atomic scatter,
    so a training step is the same on the card run to run."""

    def __init__(self, num_embeddings: int, features: int, *, device: DeviceLike = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        dev = resolve_device(device)
        table = torch.randn((num_embeddings, features), generator=generator)
        self.table = nn.Parameter(table.to(dev))

    def forward(self, idx: torch.Tensor) -> torch.Tensor:
        return gather_rows(self.table, idx)


class BatchNorm(nn.Module):
    """BatchNorm1d over a masked node set (torch defaults: eps 1e-5,
    momentum 0.1), parameters ``scale``/``bias`` and running ``mean``/``var``
    buffers.

    Training statistics exclude the rows where ``mask`` is False (the
    padding nodes), which ``nn.BatchNorm1d`` cannot do. The running
    variance takes the unbiased batch variance, as torch's does. A
    training forward updates the buffers in place (the JAX package returns
    the new state instead).
    """

    def __init__(self, features: int, eps: float = 1e-5, momentum: float = 0.1, *,
                 device: DeviceLike = None):
        super().__init__()
        dev = resolve_device(device)
        self.eps, self.momentum = eps, momentum
        self.scale = nn.Parameter(torch.ones(features, device=dev))
        self.bias = nn.Parameter(torch.zeros(features, device=dev))
        self.register_buffer("mean", torch.zeros(features, device=dev))
        self.register_buffer("var", torch.ones(features, device=dev))

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None, *,
                training: bool) -> torch.Tensor:
        if training:
            if mask is None:
                count = torch.tensor(float(x.shape[0]), device=x.device)
                mean = x.mean(dim=0)
                var = ((x - mean) ** 2).mean(dim=0)
            else:
                m = mask.to(x.dtype)[:, None]
                count = torch.clamp(m.sum(), min=1.0)
                mean = (x * m).sum(dim=0) / count
                var = (((x - mean) ** 2) * m).sum(dim=0) / count
            with torch.no_grad():
                unbiased = var * (count / torch.clamp(count - 1.0, min=1.0))
                self.mean.copy_((1 - self.momentum) * self.mean + self.momentum * mean)
                self.var.copy_((1 - self.momentum) * self.var + self.momentum * unbiased)
        else:
            mean, var = self.mean, self.var
        y = (x - mean) * torch.rsqrt(var + self.eps)
        return y * self.scale + self.bias


class MLP(nn.Module):
    """ReLU MLP ``layer0 … layer{L-1}`` (Dense, ReLU between): the
    reference's ``Sequential`` heads."""

    def __init__(self, sizes: Sequence[int], *, device: DeviceLike = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if len(sizes) < 2:
            raise ValueError(f"an MLP needs at least two sizes, got {tuple(sizes)}")
        self.n_layers = len(sizes) - 1
        for i in range(self.n_layers):
            self.add_module(f"layer{i}", Dense(sizes[i], sizes[i + 1], device=device,
                                               generator=generator))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i in range(self.n_layers):
            x = getattr(self, f"layer{i}")(x)
            if i + 1 < self.n_layers:
                x = torch.relu(x)
        return x

"""Device resolution for the port's entry points.

Entry points run on the card unless the caller names another device:
``device=None`` means ``"cuda"``, and a host without a usable GPU raises
instead of continuing on the CPU.
"""

from __future__ import annotations

from typing import Union

import torch

DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike = None) -> torch.device:
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "plain PyTorch versions on the CPU"
        )
    return dev


def check_compute_dtype(requested: str) -> None:
    """Validate the edge-pipeline compute dtype of a layer's config.

    Only ``"float32"`` is ported. ``"bfloat16"`` and ``"auto"`` raise: the
    JAX package's ``auto`` rule was measured on a TPU and does not carry
    over to the GPU.
    """
    if requested == "float32":
        return
    if requested in ("bfloat16", "auto"):
        raise NotImplementedError(
            f"compute_dtype={requested!r} is not ported yet; use 'float32'"
        )
    raise ValueError(f"unknown compute_dtype {requested!r}")

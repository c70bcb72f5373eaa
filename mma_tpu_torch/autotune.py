"""The edge pipeline's compute dtype, as the JAX package resolves it.

Only ``resolve_compute_dtype`` is ported (``mma_tpu/autotune.py:46-57``):
``"auto"`` is ``"bfloat16"`` on a TPU and ``"float32"`` anywhere else, so
on ``cuda`` and ``cpu`` it is ``"float32"``. The JAX package measured its
rule on a TPU; the port keeps the rule as written, and ``PERF.md`` holds
the H100's bf16 and f32 times that a change of the rule would argue from.
``choose_blocks`` (``mma_tpu/autotune.py:60-90``) needs no counterpart:
it picks the tiles of the TPU's Pallas grid, whose values are bit-identical
whatever the tiles (``:26-31``), and the port's kernels take no block
sizes: each derives its partition from the edge count, the node count and
the widths.
"""

from __future__ import annotations

from typing import Optional, Union

import torch

COMPUTE_DTYPES = ("float32", "bfloat16", "auto")
_TORCH_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def resolve_compute_dtype(requested: str,
                          platform: Optional[Union[str, torch.device]] = None) -> str:
    """Resolve a layer's ``compute_dtype``, honouring ``"auto"``.

    ``platform`` is a platform name or a ``torch.device`` (its type is the
    platform); None means the port's default device, ``cuda``. ``"auto"``
    gives ``"bfloat16"`` only on a TPU, ``"float32"`` elsewhere; the other
    names come back as they are. An unknown name raises ``ValueError``.
    """
    if requested not in COMPUTE_DTYPES:
        raise ValueError(f"unknown compute_dtype {requested!r}; expected one of {COMPUTE_DTYPES}")
    if requested != "auto":
        return requested
    if platform is None:
        platform = "cuda"
    plat = platform.type if isinstance(platform, torch.device) else str(platform)
    return "bfloat16" if plat == "tpu" else "float32"


def torch_compute_dtype(requested: str,
                        platform: Optional[Union[str, torch.device]] = None) -> torch.dtype:
    """The ``torch.dtype`` of :func:`resolve_compute_dtype`'s answer."""
    return _TORCH_DTYPES[resolve_compute_dtype(requested, platform)]

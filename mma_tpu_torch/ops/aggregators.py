"""Aggregator semantics table for the node-classification MMA layer.

A copy of the JAX package's table (``mma_tpu/ops/aggregators.py``), which
reads the reference's 21 ``learnable_*`` aggregators as one masked
neighbor **sum** that differs in three knobs:

1. ``combine`` — how the masked neighbor sum ``S_i`` meets the center
   feature ``h_i``: ``sum`` (``h_i + S_i``), ``mean`` (``(h_i + S_i) /
   deg_i``), ``max``/``min`` (elementwise with ``h_i``), ``passthrough``
   (``S_i``; softmax/softmin over a singleton dimension collapse to it).
2. ``sigmoid_under_new_sigmoid`` — under the reference's default
   ``new_sigmoid`` activation, seven aggregators discard the sigmoid and
   use the raw logits as the mask (N1). With ``parity=False`` sigmoid is
   always applied.
3. ``reference_usable`` — ``std`` / ``normalized_mean`` / ``moment_3``
   crash in the reference (N5) and exist only in fixed (non-parity) form.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

# Aggregators whose `new_sigmoid` branch discards the activation (mask =
# raw logits) in the reference — N1.
_RAW_LOGITS_UNDER_NEW_SIGMOID = frozenset(
    {"mean3", "max", "min", "softmax", "softmin", "std", "normalized_mean"}
)

_BROKEN_IN_REFERENCE = frozenset({"std", "normalized_mean", "moment_3"})


@dataclasses.dataclass(frozen=True)
class AggSpec:
    name: str
    combine: str  # sum | mean | max | min | passthrough | std | normalized_mean | moment_3
    sigmoid_under_new_sigmoid: bool
    reference_usable: bool

    def applies_sigmoid(self, activation: str, parity: bool) -> bool:
        """Whether σ is applied to the mask logits for this aggregator."""
        if not parity:
            return True
        if activation == "new_sigmoid":
            return self.sigmoid_under_new_sigmoid
        return True


def _combine_of(name: str) -> str:
    for family in ("sum", "mean", "max", "min"):
        if name in (family, family + "2", family + "3", family + "4"):
            return family
    if name in ("softmax", "softmin"):
        return "passthrough"
    return name  # std, normalized_mean, moment_3


NODE_CLS_AGGREGATOR_NAMES: Tuple[str, ...] = (
    "moment_3",
    "sum", "sum2", "sum3", "sum4",
    "mean", "mean2", "mean3", "mean4",
    "max", "max2", "max3", "max4",
    "min", "min2", "min3", "min4",
    "softmax", "softmin",
    "std", "normalized_mean",
)

NODE_CLS_AGGREGATORS = {
    name: AggSpec(
        name=name,
        combine=_combine_of(name),
        sigmoid_under_new_sigmoid=name not in _RAW_LOGITS_UNDER_NEW_SIGMOID,
        reference_usable=name not in _BROKEN_IN_REFERENCE,
    )
    for name in NODE_CLS_AGGREGATOR_NAMES
}


def get_agg_spec(name: str) -> AggSpec:
    try:
        return NODE_CLS_AGGREGATORS[name]
    except KeyError:
        raise ValueError(
            f"Unknown aggregator {name!r}; valid: {sorted(NODE_CLS_AGGREGATORS)}"
        ) from None

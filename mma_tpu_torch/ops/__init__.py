from mma_tpu_torch.ops.aggregators import NODE_CLS_AGGREGATORS, AggSpec, get_agg_spec
from mma_tpu_torch.ops.cuda.fused_mma import fused_masked_aggregate
from mma_tpu_torch.ops.ell import (
    EllSpec,
    ell_expand,
    ell_gather_nodes_by_src,
    masked_minmax_firsthit,
    masked_slot_sum,
    single_width_spec,
)
from mma_tpu_torch.ops.gather import gather_by_dst, gather_by_src
from mma_tpu_torch.ops.masked_aggregate import masked_multi_aggregate, mma_mask_logits
from mma_tpu_torch.ops.scalers import SCALER_NAMES, apply_scalers
from mma_tpu_torch.ops.segment import (
    segment_max,
    segment_mean,
    segment_min,
    segment_softmax_denom,
    segment_sum,
)
from mma_tpu_torch.ops.spmm import binary_spmm

__all__ = [
    "AggSpec",
    "EllSpec",
    "NODE_CLS_AGGREGATORS",
    "SCALER_NAMES",
    "apply_scalers",
    "binary_spmm",
    "ell_expand",
    "ell_gather_nodes_by_src",
    "fused_masked_aggregate",
    "gather_by_dst",
    "gather_by_src",
    "get_agg_spec",
    "masked_minmax_firsthit",
    "masked_multi_aggregate",
    "masked_slot_sum",
    "mma_mask_logits",
    "segment_max",
    "segment_mean",
    "segment_min",
    "segment_softmax_denom",
    "segment_sum",
    "single_width_spec",
]

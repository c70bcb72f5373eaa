from mma_tpu_torch.ops.aggregators import AggSpec, get_agg_spec
from mma_tpu_torch.ops.masked_aggregate import masked_multi_aggregate
from mma_tpu_torch.ops.scalers import apply_scalers
from mma_tpu_torch.ops.segment import segment_sum
from mma_tpu_torch.ops.spmm import binary_spmm

__all__ = [
    "AggSpec",
    "apply_scalers",
    "binary_spmm",
    "get_agg_spec",
    "masked_multi_aggregate",
    "segment_sum",
]

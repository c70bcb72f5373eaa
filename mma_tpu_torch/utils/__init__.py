"""Utilities: tracing and profiling."""

from mma_tpu_torch.utils.profiling import annotate_fn, profile_to, trace

__all__ = ["annotate_fn", "profile_to", "trace"]

"""Host time a training step blocks on the sampled pipeline's queue, waiting
for the producer's next batch: the port's ``sampled.wait`` spans (ms,
traced stretch)."""

from h100_bench.pipeline_spans import pipeline


def read(ctx):
    p = pipeline(ctx)
    return None if p is None else p.wait_ms()

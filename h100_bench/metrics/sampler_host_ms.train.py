"""Host time the producer thread spends sampling a batch: the port's
``sampled.sample`` spans (``sample_arrays``: on the host the draw itself,
with a device sampler the launches of its draw), over the producer's
batches that closed inside the traced stretch (ms)."""

from h100_bench.pipeline_spans import pipeline


def read(ctx):
    p = pipeline(ctx)
    return None if p is None else p.part_ms("sampled.sample")

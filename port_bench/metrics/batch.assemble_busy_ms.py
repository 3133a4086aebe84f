"""Device busy ms (the union of their intervals) of the kernels launched
inside the ``batch.assemble`` spans, per solve (batch assembly)."""

from port_bench.harness import spans


def read(ctx):
    return spans.busy_ms(ctx, "batch.assemble")

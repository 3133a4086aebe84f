"""Host ms of the ``batch.assemble`` spans (one an LM iteration) per solve
(batch assembly): from the unprofiled phase where it ran solves, else the
CUDA-only traced one."""

from port_bench.harness import spans


def read(ctx):
    return spans.host_ms(ctx, "batch.assemble")

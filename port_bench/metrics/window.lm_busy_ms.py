"""Device busy ms (the union of their intervals) of the kernels launched
inside the ``window.lm`` spans, per keyframe (sliding-window LM)."""

from port_bench.harness import spans


def read(ctx):
    return spans.busy_ms(ctx, "window.lm")

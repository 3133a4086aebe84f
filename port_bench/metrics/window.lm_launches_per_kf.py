"""Kernels launched inside the ``window.lm`` spans of the traced window per
keyframe (sliding-window LM)."""

from port_bench.harness import spans


def read(ctx):
    return spans.launches(ctx, "window.lm")

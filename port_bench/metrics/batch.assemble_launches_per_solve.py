"""Kernels launched inside the ``batch.assemble`` spans of the traced window
per solve (batch assembly)."""

from port_bench.harness import spans


def read(ctx):
    return spans.launches(ctx, "batch.assemble")

"""Host ms of the window LM (``window.lm`` spans) per keyframe (sliding-window
LM): from the unprofiled phase where it ran keyframes, else the CUDA-only
traced one."""

from port_bench.harness import spans


def read(ctx):
    return spans.host_ms(ctx, "window.lm")

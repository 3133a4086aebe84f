"""Host ms of the ``batch.linear_solve`` spans (the step of each LM iteration)
per solve (batch linear solve): from the unprofiled phase where it ran
solves, else the CUDA-only traced one."""

from port_bench.harness import spans


def read(ctx):
    return spans.host_ms(ctx, "batch.linear_solve")

"""The kNN kernel's share of its roofline, % (kNN kernel), with the work taken
from the op's own counter (``glio_tpu_torch.ops.knn.knn_work``, the traced
phase's calls) and not from ``drivers/window.py``'s wrapper:
``knn_roofline``'s formula (``roofline.least_time_s`` of each call, summed,
over the ``knn_kernel`` launches' summed device time)."""

from port_bench.harness import spans


def read(ctx):
    work = getattr(ctx, "knn_work", None)
    return spans.knn_kernel_roofline(work, ctx.trace.kernels(spans.KNN_KERNEL)) if work else None

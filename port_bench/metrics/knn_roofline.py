"""The kNN kernel's share of its roofline, % (kNN kernel).

Each ``knn`` call of the traced window is paired, in order, with the
``knn_kernel`` launch it made; the least time of each (``roofline``: the
larger of its FP32 operations over 67 TFLOP/s and its bytes over
3.35 TB/s, counted from the call's query and map masks) is summed and
divided by the kernels' summed device time.
"""

from port_bench import roofline
from port_bench.drivers.window import knn_counts

KERNEL = "knn_kernel"


def read(ctx):
    calls = getattr(ctx.driver, "knn_calls", None)
    kernels = ctx.trace.kernels(KERNEL)
    if not calls or len(kernels) != len(calls):
        return None
    least = sum(roofline.least_time_s(*roofline.knn_work(q, qv, n, nv))
                for q, qv, n, nv in knn_counts(calls))
    spent = sum(t - s for s, t, _ in kernels) * 1e-9
    return 100.0 * least / spent if spent > 0 else None

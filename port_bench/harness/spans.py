"""The device's kernels attributed to the program's spans.

The program marks its phases with ``glio_tpu_torch.utils.profiling.span``
on the clock of ``torch.profiler``'s events. A kernel runs after the host
call that launched it returns, often after its span has closed, so a kernel
is not placed by its own interval: the profiler gives each device operation
the correlation id of the CUDA runtime or driver call that launched it, and
the kernel goes to the innermost span that holds the start of that call.

``attribute`` gives, for each span name, the kernels launched inside its
spans or their children; ``table`` turns that into wall, self, launches and
busy time per unit (a unit is a root span: one ``window.step``, one
``batch.solve``).
Busy time is the union of the kernels' intervals, as ``trace.Trace`` takes it.

A traced run hands the readers under ``metrics/`` what the spans give as
``ctx`` fields (``ctx_fields``): ``host_spans``, the records of the
unprofiled phase; ``spans``, those of the traced phase; ``attribution``, the
traced phase's kernels attributed to them; and ``knn_work``, the kNN op's
counter over the traced phase. ``recorded`` runs a phase with the recorder
on. Each field is None where the program records nothing, and a reader then
returns None.
"""

import collections
from typing import NamedTuple

import numpy as np
import torch

from .. import roofline

CUDA = torch.autograd.DeviceType.CUDA
KNN_KERNEL = "knn_kernel"


class Op(NamedTuple):
    start_ns: int
    end_ns: int
    name: str
    correlation: int


def kernels(events) -> list:
    """The kernels among the profiler's events, in start order."""
    out = [Op(e.start_ns(), e.start_ns() + e.duration_ns(), e.name(), e.correlation_id())
           for e in events if e.device_type() == CUDA
           and not e.name().startswith(("Memcpy", "Memset"))]
    return sorted(out)


def launch_calls(events) -> dict:
    """Correlation id → start (ns) of each host call of the CUDA runtime or
    driver (``cudaLaunchKernel``, ``cuLaunchKernel``, ...) in the events."""
    return {e.correlation_id(): e.start_ns() for e in events
            if e.device_type() != CUDA and e.correlation_id() and e.name().startswith("cu")}


def innermost(spans, times) -> list:
    """For each time, the index in ``spans`` (records in order of start,
    properly nested) of the innermost span with start <= time < end, or -1."""
    out = [-1] * len(times)
    stack, k = [], 0
    for i in np.argsort(np.asarray(times, np.int64), kind="stable"):
        t = times[i]
        while k < len(spans) and spans[k].start_ns <= t:
            while stack and spans[stack[-1]].end_ns <= spans[k].start_ns:
                stack.pop()
            stack.append(k)
            k += 1
        while stack and spans[stack[-1]].end_ns <= t:
            stack.pop()
        out[i] = stack[-1] if stack else -1
    return out


class Attribution(NamedTuple):
    inclusive: dict       # span name -> [Op] launched in its spans or their children
    roots: dict           # root span name -> [Op] of its units
    outside: list         # [Op] whose launch lies in no span
    unmatched: list       # [Op] whose launching host call is not in the trace


def attribute(spans, ops, calls) -> Attribution:
    """``spans``: the program's records (``profiling.records()``) of the
    traced window; ``ops``: ``kernels(events)``; ``calls``:
    ``launch_calls(events)``."""
    index = {s.id: i for i, s in enumerate(spans)}
    matched = [op for op in ops if op.correlation in calls]
    unmatched = [op for op in ops if op.correlation not in calls]
    where = innermost(spans, [calls[op.correlation] for op in matched])
    inclusive, roots, outside = collections.defaultdict(list), collections.defaultdict(list), []
    for op, i in zip(matched, where):
        if i < 0:
            outside.append(op)
            continue
        seen = set()
        while i >= 0:
            s = spans[i]
            if s.name not in seen:
                inclusive[s.name].append(op)
                seen.add(s.name)
            if s.parent < 0:
                roots[s.name].append(op)
            i = index.get(s.parent, -1)
    return Attribution(dict(inclusive), dict(roots), outside, unmatched)


def busy_ns(ops) -> int:
    """The union of the operations' intervals, ns."""
    total, end = 0, None
    for s, t, *_ in sorted(ops):
        if end is None or s > end:
            total += t - s
            end = t
        elif t > end:
            total += t - end
            end = t
    return total


UNIT_ROOTS = ("window.step", "batch.solve")


def units(spans) -> int:
    """Root spans among the records: the units they cover."""
    return sum(1 for s in spans if s.parent < 0 and s.name in UNIT_ROOTS)


def table(spans, attr: Attribution = None) -> dict:
    """Per span name: ``count`` of spans a unit, ``wall_ms``, ``self_ms``
    (host, a unit), and with ``attr`` ``launches`` and ``busy_ms`` (its
    spans' kernels and their children's, a unit)."""
    from glio_tpu_torch.utils.profiling import self_ns
    n = units(spans)
    if not n:
        return {}
    own = self_ns(spans)
    out = {}
    for s, self_t in zip(spans, own):
        row = out.setdefault(s.name, {"count": 0, "wall_ms": 0.0, "self_ms": 0.0})
        row["count"] += 1 / n
        row["wall_ms"] += (s.end_ns - s.start_ns) * 1e-6 / n
        row["self_ms"] += self_t * 1e-6 / n
    if attr is not None:
        for name, row in out.items():
            ops = attr.inclusive.get(name, [])
            row["launches"] = len(ops) / n
            row["busy_ms"] = busy_ns(ops) * 1e-6 / n
    return out


def wall_ms(spans, name: str):
    """Host milliseconds of ``name``'s spans a unit; None where there are none."""
    n = units(spans)
    walls = [s.end_ns - s.start_ns for s in spans if s.name == name]
    return sum(walls) * 1e-6 / n if n and walls else None


def knn_kernel_roofline(work, ops):
    """The kNN kernel's share of its roofline, %, with the work taken from
    the op's counter (``ops.knn.knn_work()``: (Q, valid queries, N, valid
    points) a call) and the time from the ``knn_kernel`` launches among
    ``ops`` ((start_ns, end_ns, name, ...) each, as ``kernels`` or
    ``trace.Trace.kernels`` give them); None where the counts and the
    launches do not pair."""
    spent = [op for op in ops if KNN_KERNEL in op[2]]
    if not work or len(spent) != len(work):
        return None
    least = sum(roofline.least_time_s(*roofline.knn_work(q, qv, n, nv))
                for q, qv, n, nv in work)
    t = sum(op[1] - op[0] for op in spent) * 1e-9
    return 100.0 * least / t if t > 0 else None


# -- what a traced run hands the readers ---------------------------------------------

def recorded(fn, *args, **kwargs):
    """``fn(*args, **kwargs)`` with the program's span recorder on, from no
    records: (its result, the spans). The kNN counter keeps the phase's
    calls until the next ``recorded``; ``ctx_fields`` reads it, after the
    profile has closed (its read sums masks on the device). Where the
    program has no recorder: (its result, None)."""
    try:
        from glio_tpu_torch.utils.profiling import disable, enable, records, reset
    except ImportError:
        return fn(*args, **kwargs), None
    reset()
    enable()
    try:
        out = fn(*args, **kwargs)
    finally:
        disable()
    return out, records()


def ctx_fields(host_spans, spans, events) -> dict:
    """The readers' ``ctx`` fields of a traced run from ``recorded``'s spans
    of its unprofiled phase (``host_spans``) and traced phase (``spans``),
    the traced phase's profiler ``events``, and the kNN counter, which the
    traced phase, recorded last, left."""
    if spans is None:
        return {"host_spans": host_spans, "spans": None, "attribution": None,
                "knn_work": None}
    from glio_tpu_torch.ops.knn import knn_work
    return {"host_spans": host_spans, "spans": spans,
            "attribution": attribute(spans, kernels(events), launch_calls(events)),
            "knn_work": knn_work()}


def host_ms(ctx, name: str):
    """Host ms of ``name``'s spans a unit, from the unprofiled phase where it
    ran units, else from the traced phase; None where there are none."""
    recs = getattr(ctx, "host_spans", None)
    if not recs or not units(recs):
        recs = getattr(ctx, "spans", None)
    return wall_ms(recs, name) if recs else None


def _traced_ops(ctx, name: str):
    """(units, kernels launched inside ``name``'s spans) of the traced phase;
    None where none ran."""
    recs, attr = getattr(ctx, "spans", None), getattr(ctx, "attribution", None)
    n = units(recs) if recs else 0
    ops = attr.inclusive.get(name) if n and attr else None
    return (n, ops) if ops else None


def launches(ctx, name: str):
    """Kernels launched inside ``name``'s spans of the traced phase, a unit."""
    got = _traced_ops(ctx, name)
    return len(got[1]) / got[0] if got else None


def busy_ms(ctx, name: str):
    """Device busy ms of the kernels launched inside ``name``'s spans of the
    traced phase, a unit."""
    got = _traced_ops(ctx, name)
    return busy_ns(got[1]) * 1e-6 / got[0] if got else None

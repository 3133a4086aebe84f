"""Kernels attributed to the program's spans by correlation id
(``harness/spans.py``), the ``ctx`` fields a traced run hands the readers,
and the span metrics' readers under ``metrics/``, on synthetic events and
records; ``phases.py``'s two phases on the CPU."""

import types

import pytest
import torch

from glio_tpu_torch.utils import profiling
from glio_tpu_torch.utils.profiling import Span
from port_bench.harness import cells, spans, trace

CUDA, CPU = torch.autograd.DeviceType.CUDA, torch.autograd.DeviceType.CPU


class Event:
    def __init__(self, name, start, dur, device, corr=0):
        self._n, self._s, self._d, self._dev, self._c = name, start, dur, device, corr

    def name(self):
        return self._n

    def start_ns(self):
        return self._s

    def duration_ns(self):
        return self._d

    def device_type(self):
        return self._dev

    def correlation_id(self):
        return self._c


# Two units of a step: root [0, 1000) with an "lm" child [100, 600) and a
# "lm.inner" grandchild [200, 300); root [2000, 3000) with "lm" [2100, 2500).
STEP = "window.step"
RECORDS = [Span(STEP, 0, 1000, 0, -1, 0), Span("lm", 100, 600, 1, 0, 0),
           Span("lm.inner", 200, 300, 2, 1, 0), Span(STEP, 2000, 3000, 3, -1, 1),
           Span("lm", 2100, 2500, 4, 3, 1)]


def events():
    """Kernels run after the calls that launched them: kernel 1's call lies
    in lm.inner, 2's in lm, 3's in the first root only, 4's in the second
    lm (its kernel runs after that lm has closed), 5's in no span, and 6's
    call is missing from the trace."""
    return [
        Event("cudaLaunchKernel", 250, 5, CPU, 1), Event("k_a", 700, 100, CUDA, 1),
        Event("cudaLaunchKernel", 400, 5, CPU, 2), Event("k_b", 750, 100, CUDA, 2),
        Event("cuLaunchKernel", 650, 5, CPU, 3), Event("gemm", 900, 50, CUDA, 3),
        Event("cudaLaunchKernelExC", 2400, 5, CPU, 4),
        Event("knn_kernel<5>", 2600, 200, CUDA, 4),
        Event("cudaLaunchKernel", 1500, 5, CPU, 5), Event("k_c", 1600, 10, CUDA, 5),
        Event("k_d", 3100, 10, CUDA, 6),
        Event("Memcpy HtoD (Pageable -> Device)", 120, 30, CUDA, 7),
        Event("cudaMemcpyAsync", 110, 5, CPU, 7),
        Event("aten::mul", 105, 5, CPU, 0)]


def attribution():
    ev = events()
    return spans.attribute(RECORDS, spans.kernels(ev), spans.launch_calls(ev))


def test_kernels_and_calls_by_correlation():
    ev = events()
    assert [k.name for k in spans.kernels(ev)] == ["k_a", "k_b", "gemm", "k_c",
                                                  "knn_kernel<5>", "k_d"]
    assert spans.launch_calls(ev) == {1: 250, 2: 400, 3: 650, 4: 2400, 5: 1500, 7: 110}


def test_innermost_span_of_each_time():
    got = spans.innermost(RECORDS, [250, 400, 650, 2400, 1500, 0, 999, 1000, 2099, 2100])
    assert got == [2, 1, 0, 4, -1, 0, 0, -1, 3, 4]


def test_attribution_inclusive_and_roots():
    a = attribution()
    names = {k: [op.name for op in v] for k, v in a.inclusive.items()}
    assert names == {STEP: ["k_a", "k_b", "gemm", "knn_kernel<5>"],
                     "lm": ["k_a", "k_b", "knn_kernel<5>"], "lm.inner": ["k_a"]}
    assert {k: len(v) for k, v in a.roots.items()} == {STEP: 4}
    assert [op.name for op in a.outside] == ["k_c"]
    assert [op.name for op in a.unmatched] == ["k_d"]


def test_busy_is_the_union_of_intervals():
    assert spans.busy_ns([(0, 100), (50, 150), (300, 400), (310, 320)]) == 250
    assert spans.busy_ns([]) == 0


def test_table_per_unit():
    a = attribution()
    t = spans.table(RECORDS, a)
    assert t[STEP] == {"count": 1.0, "wall_ms": pytest.approx(1000e-6),
                         "self_ms": pytest.approx((1000 - 500 + 1000 - 400) * 1e-6 / 2),
                         "launches": 2.0, "busy_ms": pytest.approx((150 + 50 + 200) * 1e-6 / 2)}
    assert t["lm"]["count"] == 1.0
    assert t["lm"]["self_ms"] == pytest.approx((400 + 400) * 1e-6 / 2)
    assert t["lm.inner"]["count"] == 0.5
    assert spans.table(RECORDS[:0], a) == {}


def test_readings_per_unit():
    recs = RECORDS
    ctx = types.SimpleNamespace(host_spans=[], spans=recs, attribution=attribution())
    assert spans.units(recs) == 2
    assert spans.units([r._replace(name="step") for r in recs]) == 0   # not a unit's root
    assert spans.wall_ms(recs, "lm") == pytest.approx((500 + 400) * 1e-6 / 2)
    assert spans.host_ms(ctx, "lm") == pytest.approx((500 + 400) * 1e-6 / 2)
    assert spans.launches(ctx, "lm") == 1.5
    assert spans.busy_ms(ctx, "lm") == pytest.approx((150 + 200) * 1e-6 / 2)
    assert spans.wall_ms(recs, "absent") is None
    assert spans.host_ms(ctx, "absent") is None
    assert spans.launches(ctx, "absent") is None
    assert spans.busy_ms(ctx, "absent") is None


def test_knn_kernel_roofline_from_the_counter():
    ops = spans.kernels(events())
    least = 8 * 5120 * 16384 / 67e12
    work = [(5120, 5120, 16384, 16384)]
    assert spans.knn_kernel_roofline(work, ops) == pytest.approx(100.0 * least / 200e-9)
    assert spans.knn_kernel_roofline([], ops) is None
    assert spans.knn_kernel_roofline(work * 2, ops) is None


def _batch_ctx(host_scale=2):
    """A traced batch run's ctx: one solve with an assembly [10, 110) and a
    linear solve [120, 170) in the traced phase, each launching one kernel;
    the unprofiled phase's spans ``host_scale`` times as long."""
    recs = [Span("batch.solve", 0, 1000, 0, -1, 0), Span("batch.assemble", 10, 110, 1, 0, 0),
            Span("batch.linear_solve", 120, 170, 2, 0, 0)]
    ev = [Event("cudaLaunchKernel", 20, 5, CPU, 1), Event("k", 200, 10, CUDA, 1),
          Event("cudaLaunchKernel", 130, 5, CPU, 2), Event("cr", 220, 30, CUDA, 2)]
    host = [r._replace(end_ns=r.start_ns + host_scale * (r.end_ns - r.start_ns)) for r in recs]
    return _ctx(host, recs, ev, [])


def _ctx(host, recs, ev, work=None, units=1):
    """A traced run's ctx over the synthetic events, with ``work`` as the kNN
    counter's reading."""
    ctx = types.SimpleNamespace(trace=trace.Trace(ev, 1e-6), units=units, driver=None,
                                **spans.ctx_fields(host, recs, ev))
    ctx.knn_work = work
    return ctx


def _read(metric, ctx):
    return cells.load_reader(metric).read(ctx)


def test_batch_span_readers_take_host_times_where_a_phase_has_units():
    ctx = _batch_ctx()
    assert _read("batch.assemble_ms", ctx) == pytest.approx(200e-6)
    assert _read("batch.linear_solve_ms", ctx) == pytest.approx(100e-6)
    assert _read("batch.assemble_launches_per_solve", ctx) == 1.0
    assert _read("batch.assemble_busy_ms", ctx) == pytest.approx(10e-6)
    ctx.host_spans = []                           # no unprofiled units: the traced phase's
    assert _read("batch.assemble_ms", ctx) == pytest.approx(100e-6)
    assert _read("batch.linear_solve_ms", ctx) == pytest.approx(50e-6)


def test_window_span_readers_per_keyframe():
    ev = events()
    ctx = _ctx([], RECORDS, ev, [], units=2)
    for metric in ("window.lm_ms", "window.lm_launches_per_kf", "window.lm_busy_ms"):
        assert _read(metric, ctx) is None         # no span of that name
    recs = [r._replace(name="window.lm") if r.name == "lm" else r for r in RECORDS]
    ctx = _ctx([], recs, ev, [], units=2)
    assert _read("window.lm_ms", ctx) == pytest.approx((500 + 400) * 1e-6 / 2)
    assert _read("window.lm_launches_per_kf", ctx) == 1.5
    assert _read("window.lm_busy_ms", ctx) == pytest.approx((150 + 200) * 1e-6 / 2)


def test_knn_kernel_roofline_reader_takes_the_ops_counter():
    ev = events()
    work = [(5120, 5120, 16384, 16384)]
    ctx = _ctx([], RECORDS, ev, work, units=2)
    least = 8 * 5120 * 16384 / 67e12
    assert _read("knn_kernel_roofline", ctx) == pytest.approx(100.0 * least / 200e-9)
    ctx.knn_work = []
    assert _read("knn_kernel_roofline", ctx) is None


SPAN_METRICS = ["batch.assemble_busy_ms", "batch.assemble_launches_per_solve",
                "batch.assemble_ms", "batch.linear_solve_ms", "knn_kernel_roofline",
                "window.lm_busy_ms", "window.lm_launches_per_kf", "window.lm_ms"]


@pytest.mark.parametrize("metric", SPAN_METRICS)
def test_span_readers_read_nothing_without_spans(metric):
    """A ctx as the runner builds it now (no span fields), or from a program
    without the recorder (fields None): every span reader returns None."""
    ev = events()
    bare = types.SimpleNamespace(trace=trace.Trace(ev, 1e-6), units=2, driver=None)
    assert _read(metric, bare) is None
    none = types.SimpleNamespace(trace=trace.Trace(ev, 1e-6), units=2, driver=None,
                                 **spans.ctx_fields(None, None, ev))
    assert none.attribution is None
    assert _read(metric, none) is None


def test_recorded_runs_a_phase_with_the_recorder_on(monkeypatch):
    """The phase's spans come back with its result; the kNN counter is read
    by ``ctx_fields`` alone, after the phase (its read sums masks on the
    device, which inside a profiled phase would add kernels to the trace)."""
    from glio_tpu_torch.ops import knn as knn_mod
    g = torch.Generator().manual_seed(5)
    q, qv = torch.rand(24, 3, generator=g), torch.rand(24, generator=g) < 0.7
    pts, pv = torch.rand(200, 3, generator=g), torch.rand(200, generator=g) < 0.4

    def phase(x):
        with profiling.span("window.step"):
            with profiling.span("window.associate"):
                knn_mod.knn(q, qv, pts, pv)
        return x + 1
    reads = []
    monkeypatch.setattr(knn_mod, "knn_work", lambda f=knn_mod.knn_work: reads.append(1) or f())
    out, recs = spans.recorded(phase, 1)
    assert out == 2 and [r.name for r in recs] == ["window.step", "window.associate"]
    assert not profiling.recording() and reads == []
    got = spans.ctx_fields([], recs, events())
    assert got["knn_work"] == [(24, int(qv.sum()), 200, int(pv.sum()))] and reads == [1]
    monkeypatch.delattr(profiling, "enable")      # a program without the recorder
    assert spans.recorded(phase, 1) == (2, None)


def test_phases_on_the_cpu_at_the_test_sizes():
    """The batch cell at its CPU test size: both phases recorded, the
    unprofiled one's host times read through the reader files, the traced
    one attributed (no kernels on the CPU)."""
    from port_bench import control, phases
    cell = cells.load_cell("batch.l0", overrides=control.small_overrides("batch"))
    drv = cells.load_driver("batch").Driver(cell, 2**31 + 11, torch.device("cpu"))
    drv.setup()
    ctx, events = phases.span_phases(drv, cell, 30.0, torch.device("cpu"))
    out = phases.report(ctx, events, cell)
    assert out["units"] == {"host": 1, "trace": 1}
    assert out["tables"]["host"]["batch.assemble"]["count"] == 40
    assert out["tables"]["trace"]["batch.stage"]["count"] == 4
    assert set(out["spans"]) == {"batch.assemble_ms", "batch.linear_solve_ms"}
    assert out["spans"]["batch.assemble_ms"] == pytest.approx(
        spans.wall_ms(ctx.host_spans, "batch.assemble"))
    assert set(out["accepted"]) <= {m["name"] for m in cell.per_layer}
    assert out["kernels"] == 0 and out["n_outside"] == 0
    cost = phases.cost_turns(drv, 1, 1, torch.device("cpu"), first=2)
    assert len(cost["on"]) == len(cost["off"]) == 1

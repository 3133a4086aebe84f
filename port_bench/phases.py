"""The program's phase spans in one cell: the readings of the span metrics,
host time, launches and busy time per span, and what recording costs.

    python3 port_bench/phases.py --workload <cell> --seed <n> [--seconds <s>] [--clock]
        [--cost <turns> --units <k>]

Set-up as ``run.py`` makes it (the drive from the seed, the warm units).
``span_phases`` then runs the first two phases of a traced run, as
``harness/runner.py`` makes them, with the program's span recorder on
(``harness/spans.py::recorded``): ``host_units`` units unprofiled, then
``trace_units`` under the CUDA-only profile of ``harness/trace.py``. It
builds the ``ctx`` a traced run hands the readers, with the spans' fields
beside the accepted ones (``spans.ctx_fields``: every kernel attributed to
the innermost span that launched it). ``report`` reads every reader under
``metrics/`` from it: the cell's per-layer metrics of ``BENCHMARK.json``
("accepted") and the readers the manifest does not list yet ("spans"). It
prints one JSON line with both, each phase's table (per span name and unit:
spans, wall and self ms on the host, launches and busy ms of its kernels),
the kernels no span holds and the launch calls whose kernel the trace lacks
(a dropped record). With ``--clock`` it first checks, under a CPU and CUDA
profile, that the spans lie on the profiler's clock (a ``record_function``
and a launch inside one span, 2 ms of sleep on each side of them, and
between two spans that close and open next to it) and times one empty span
with the recorder off and on.

With ``--cost`` it then runs that many turns of ``--units`` units each with
the recorder off and on, in turns (off, on, on, off, ...), from the same
set-up, each turn closed by a device sync, and adds each turn's ms a unit:
what recording costs the end-to-end metric. Runs on a CUDA device.
"""

import argparse
import json
import statistics
import sys
import time
import types
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from port_bench.run import STARTED  # noqa: E402,F401  (first: one thread for the CPU libraries)

import torch  # noqa: E402

from port_bench.harness import cells, device as device_mod, runner  # noqa: E402
from port_bench.harness import spans as spans_mod, trace as trace_mod  # noqa: E402

SLEEP_NS = 2_000_000     # the clock check's sleep on each side of the inner event


def clock_check(device) -> dict:
    """Where a ``record_function`` and a kernel's launch call lie on the
    spans' clock, read on the profiler's, in ns (negative: outside):
    ``record_function`` and ``launch``, their margins inside the span around
    them, with ``SLEEP_NS`` of sleep on each side; ``neighbours``, the
    ``record_function``'s margins from the end of a span closed just before
    it and the start of one opened just after it. With the true gaps at
    least the sleep and at least 0, the profiler clock's lead over the
    spans' lies within ``offset_bound_ns`` (from the sleeps) and
    ``offset_tight_ns`` (from the neighbours)."""
    from glio_tpu_torch.utils import profiling
    x = torch.zeros(16, device=device)
    x.add_(1)
    runner._sync(device)

    def bracket():
        with trace_mod.profile(cpu=True) as prof:
            with torch.profiler.record_function("clock.warm"):
                x.add_(1)
            with profiling.span("clock"):
                time.sleep(SLEEP_NS * 1e-9)
                with profiling.span("clock.before"):
                    pass
                with torch.profiler.record_function("clock.inner"):
                    x.add_(1)
                with profiling.span("clock.after"):
                    pass
                time.sleep(SLEEP_NS * 1e-9)
            runner._sync(device)
        return prof
    prof, recs = spans_mod.recorded(bracket)
    s, before, after = recs
    events = prof.profiler.kineto_results.events()
    out = {}
    for e in events:
        if e.name() == "clock.inner":
            start, end = e.start_ns(), e.start_ns() + e.duration_ns()
            a, b = start - s.start_ns, s.end_ns - end
            out["record_function"] = [a, b]
            out["offset_bound_ns"] = [SLEEP_NS - b, a - SLEEP_NS]
            a, b = start - before.end_ns, after.start_ns - end
            out["neighbours"] = [a, b]
            out["offset_tight_ns"] = [-b, a]
    calls = spans_mod.launch_calls(events)
    for op in spans_mod.kernels(events):
        if op.correlation in calls and s.start_ns <= calls[op.correlation] < s.end_ns:
            out["launch"] = [calls[op.correlation] - s.start_ns, s.end_ns - calls[op.correlation]]
    out["span_ns"] = span_cost_ns()
    return out


def span_cost_ns(n: int = 200_000) -> dict:
    """Host ns of one empty span, recorder off and on (the median of five
    loops of ``n``), less an empty loop's."""
    from glio_tpu_torch.utils import profiling

    def loop(on: bool) -> float:
        profiling.reset()
        (profiling.enable if on else profiling.disable)()
        t0 = time.perf_counter_ns()
        for _ in range(n):
            with profiling.span("x"):
                pass
        t = time.perf_counter_ns() - t0
        profiling.disable()
        return t / n

    def empty() -> float:
        t0 = time.perf_counter_ns()
        for _ in range(n):
            pass
        return (time.perf_counter_ns() - t0) / n
    base = statistics.median(empty() for _ in range(5))
    got = {key: statistics.median(loop(on) for _ in range(5)) - base
           for key, on in (("off", False), ("on", True))}
    profiling.reset()
    return got


def span_phases(drv, cell, seconds: float, device):
    """A traced run's host and CUDA-only phases (``runner.run_cell``), each
    with the recorder on: (the readers' ``ctx``, the traced phase's events)."""
    drv.host_begin()
    (_, h), host_spans = spans_mod.recorded(runner.window, drv, seconds, device,
                                            cap=cell.run["host_units"])
    drv.trace_begin()
    prof = trace_mod.profile(cpu=False)
    with prof:
        (window_s, n), recs = spans_mod.recorded(
            runner.window, drv, seconds, device, cap=cell.run["trace_units"], first=h)
    drv.trace_end()
    events = prof.profiler.kineto_results.events()
    ctx = types.SimpleNamespace(trace=trace_mod.Trace(events, window_s), units=n, driver=drv,
                                **spans_mod.ctx_fields(host_spans, recs, events))
    return ctx, events


def read_all(ctx, cell) -> dict:
    """Every reader under ``metrics/`` on ``ctx``: the cell's per-layer
    metrics ("accepted") and the readers ``BENCHMARK.json`` does not list
    ("spans"), each where it reads a number."""
    listed = {m["name"] for m in cells.load_manifest()["per_layer"]}
    names = {"accepted": [m["name"] for m in cell.per_layer],
             "spans": sorted(p.stem for p in (cells.BENCH_DIR / "metrics").glob("*.py")
                             if p.stem not in listed)}
    out = {}
    for group, metrics in names.items():
        got = out[group] = {}
        for name in metrics:
            v = cells.load_reader(name).read(ctx)
            if v is not None:
                got[name] = v
    return out


def report(ctx, events, cell) -> dict:
    attr = ctx.attribution
    ran = {e.correlation_id() for e in events if e.device_type() == spans_mod.CUDA}
    orphans = sum(1 for e in events if e.device_type() != spans_mod.CUDA
                  and "LaunchKernel" in e.name() and e.correlation_id() not in ran)
    res = {"units": {"host": spans_mod.units(ctx.host_spans), "trace": ctx.units},
           "tables": {"host": spans_mod.table(ctx.host_spans),
                      "trace": spans_mod.table(ctx.spans, attr)},
           "kernels": ctx.trace.launches(),
           "by_root": {k: len(v) for k, v in attr.roots.items()},
           "outside": [op.name[:120] for op in attr.outside][:20],
           "n_outside": len(attr.outside), "unmatched": len(attr.unmatched),
           "unmatched_names": sorted({op.name[:120] for op in attr.unmatched})[:20],
           "launch_calls_without_kernel": orphans}
    res.update(read_all(ctx, cell))
    return res


def cost_turns(drv, turns: int, k: int, device, first: int = 0) -> dict:
    """``turns`` pairs of ``k``-unit windows, recorder off and on in turns
    (off, on, on, off, ...): ms a unit of each."""
    got = {"off": [], "on": []}
    i = first
    for t in range(turns):
        for on in ((False, True) if t % 2 == 0 else (True, False)):
            if on:
                (wall, n), _ = spans_mod.recorded(runner.window, drv, float("inf"), device,
                                                  cap=k, first=i)
            else:
                wall, n = runner.window(drv, float("inf"), device, cap=k, first=i)
            i += n
            if n:
                got["on" if on else "off"].append(1e3 * wall / n)
    got["median"] = {key: statistics.median(v) for key, v in got.items() if v}
    return got


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=51.0)
    ap.add_argument("--cost", type=int, default=0, help="turns of the cost comparison")
    ap.add_argument("--units", type=int, default=4, help="units a turn")
    ap.add_argument("--clock", action="store_true")
    args = ap.parse_args(argv)
    torch.set_num_threads(1)
    cell = cells.load_cell(args.workload)
    device_mod.require_cuda(cell.entry["chips"])
    device = torch.device("cuda:0")
    out = {"workload": args.workload, "seed": args.seed, "card": device_mod.power_limit()}
    if args.clock:
        out["clock"] = clock_check(device)
    drv = cells.load_driver(cell.run["driver"]).Driver(cell, args.seed % (1 << 64), device)
    t0 = time.perf_counter()
    drv.setup()
    runner._sync(device)
    out["setup_s"] = time.perf_counter() - t0
    ctx, events = span_phases(drv, cell, args.seconds, device)
    out.update(report(ctx, events, cell))
    if args.cost:
        done = spans_mod.units(ctx.host_spans) + ctx.units
        out["cost_ms_per_unit"] = cost_turns(drv, args.cost, args.units, device, done)
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()

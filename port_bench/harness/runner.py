"""One run of one cell: set-up, the measured window, the check, the result line."""

import json
import math
import sys
import time
import types

import torch

from . import cells, checks, device as device_mod, nojax, trace as trace_mod


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def window(drv, seconds: float, device, cap: int = None, ends: list = None,
           first: int = 0) -> tuple:
    """Runs units ``first``, ``first`` + 1, ... until ``seconds`` have passed
    at the end of one (or the traffic or ``cap`` ends), then syncs the
    device: (wall seconds, units). ``ends`` receives the host clock's
    reading at each unit's return."""
    n = 0
    ends = [] if ends is None else ends
    t0 = time.perf_counter()
    while (cap is None or n < cap) and drv.step(first + n):
        n += 1
        ends.append(time.perf_counter() - t0)
        if ends[-1] >= seconds:
            break
    _sync(device)
    return time.perf_counter() - t0, n


def _aggregate(per_unit: list, limits: dict) -> tuple:
    """(largest value of each number over the units, units that failed one)."""
    worst, failed = {}, 0
    for values in per_unit:
        bad = False
        for name, limit in limits.items():
            v = float(values.get(name, math.nan))
            bad |= not checks.passes(v, limit)
            w = worst.get(name, -math.inf)
            worst[name] = v if (math.isnan(v) or math.isnan(w)) else max(w, v)
        failed += bad
    return worst, failed


def run_cell(name: str, seed: int, seconds: float, trace: bool, *, started: float,
             device=None, overrides: dict = None, manifest: dict = None,
             after=None) -> dict:
    """The result of one run. ``device`` None: the cell's CUDA devices, or
    exit without a result. Tests pass a device and ``overrides``;
    ``after(driver)``, where given, runs once the check has (``control.py``
    reads its witness and control there)."""
    cell = cells.load_cell(name, manifest, overrides)
    seed %= 1 << 64          # numpy's generators take whole numbers from 0 up
    chips = cell.entry["chips"]
    if device is None:
        device_mod.require_cuda(chips)
        device = torch.device("cuda:0")
    drv = cells.load_driver(cell.run["driver"]).Driver(cell, seed, device)
    drv.setup()
    _sync(device)
    setup_s = time.time() - started

    if trace:
        # Three phases, each over its own units: the host clock alone (the
        # per-layer host times), the CUDA activity alone (launches, busy and
        # idle time, the kNN's work), then CPU and CUDA activity for the
        # breakdown, whose host events double a unit's host time.
        drv.host_begin()
        _, h = window(drv, seconds, device, cap=cell.run["host_units"])
        drv.trace_begin()
        prof = trace_mod.profile(cpu=False)
        with prof:
            window_s, n = window(drv, seconds, device, cap=cell.run["trace_units"], first=h)
        drv.trace_end()
        tr = trace_mod.from_profiler(prof, window_s)
        prof = trace_mod.profile(cpu=True)
        with prof:
            bd_s, _ = window(drv, seconds, device, cap=cell.run["breakdown_units"],
                             first=h + n)
        bd = trace_mod.from_profiler(prof, bd_s)
    else:
        ends = []
        window_s, n = window(drv, seconds, device, ends=ends)
    dev = device_mod.record(device, chips)

    drv.release()
    limits = cell.run["limits"]
    worst, failed = _aggregate(drv.check(), limits)
    compared = checks.gather(limits, worst)
    correct = checks.report(compared) and n > 0

    if trace:
        ctx = types.SimpleNamespace(trace=tr, units=n, driver=drv)
        metrics = {}
        for m in cell.per_layer:
            v = cells.load_reader(m["name"]).read(ctx)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
        dev["busy_s"] = tr.busy_s()
        dev["window_s"] = window_s
    else:
        e2e = drv.metrics(window_s, n)
        e2e["setup_s"] = setup_s
        metrics = {m["name"]: {"value": e2e[m["name"]], "unit": m["unit"]}
                   for m in cell.end_to_end if m["name"] in e2e}
    result = {"correct": bool(correct), "attempted": n, "failed": failed,
              "metrics": metrics, "device": dev}
    if trace:
        result["breakdown"] = {"device_ops": tr.device_ops(), "idle_gaps": bd.idle_gaps()}
    result["card"] = device_mod.power_limit() if device.type == "cuda" else "cpu"
    result["window_s"] = window_s
    if not trace:
        # Each unit's host seconds (no sync between units): how steady the
        # window was; the driver reads the metrics alone.
        result["unit_s"] = [b - a for a, b in zip([0.0] + ends, ends)]
    result["checks"] = compared
    if after is not None:
        after(drv)
    return result


def finish(result: dict) -> int:
    """Refuses a process that loaded JAX or the JAX package; otherwise
    prints the result as the last line of standard output."""
    bad = nojax.loaded_forbidden()
    if bad:
        print(f"port_bench: the run loaded {', '.join(bad)}; no result", file=sys.stderr)
        return 4
    print(json.dumps(result), flush=True)
    return 0

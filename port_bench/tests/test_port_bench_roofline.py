"""The count functions and the trace arithmetic on hand-worked cases."""

import types

import pytest
import torch

from port_bench import roofline
from port_bench.harness import trace


def test_knn_work_small():
    # 3 valid of 4 queries, 8 valid of 10 points: 24 pairs × 8 operations;
    # coordinates of the 11 valid entries, 14 mask bytes, 4 × 5 × (4 + 8) out.
    assert roofline.knn_work(4, 3, 10, 8) == (192, 12 * 11 + 14 + 240)


def test_knn_window_shape_is_bound_by_operations():
    flops, nbytes = roofline.knn_work(5120, 5120, 16384, 16384)
    assert flops == 8 * 5120 * 16384
    assert nbytes == 12 * (5120 + 16384) + 5120 + 16384 + 5120 * 60
    assert roofline.least_time_s(flops, nbytes) == pytest.approx(flops / 67e12)


def test_least_time_bound_by_bytes():
    assert roofline.least_time_s(1.0, 3.35e12) == pytest.approx(1.0)


class Event:
    def __init__(self, name, start, dur, device):
        self._n, self._s, self._d, self._dev = name, start, dur, device

    def name(self):
        return self._n

    def start_ns(self):
        return self._s

    def duration_ns(self):
        return self._d

    def device_type(self):
        return self._dev


CUDA, CPU = torch.autograd.DeviceType.CUDA, torch.autograd.DeviceType.CPU


def make_trace():
    ev = [Event("a", 0, 100, CUDA),
          Event("b", 50, 100, CUDA),      # overlaps a: union 0-150
          Event("Memcpy HtoD (Pageable -> Device)", 300, 100, CUDA),
          Event("knn_kernel<5>", 600, 200, CUDA),
          Event("aten::mul", 140, 200, CPU),
          Event("aten::cat", 450, 100, CPU)]
    return trace.Trace(ev, window_s=1000e-9)


def test_busy_is_the_union():
    t = make_trace()
    assert t.busy_s() == pytest.approx(450e-9)
    assert t.idle_pct() == pytest.approx(55.0)
    assert t.launches() == 3
    assert [k[2] for k in t.kernels("knn_kernel")] == ["knn_kernel<5>"]


def test_idle_gaps_by_host_operator():
    gaps = dict(make_trace().idle_gaps())
    # gap 150-300 (mid 225: aten::mul), gap 400-600 (mid 500: aten::cat)
    assert gaps == {"aten::mul": pytest.approx(150e-9), "aten::cat": pytest.approx(200e-9)}


def test_device_ops_sum_by_name():
    ops = dict(make_trace().device_ops())
    assert ops["knn_kernel<5>"] == pytest.approx(200e-9)
    assert len(ops) == 4


def test_knn_reader_pairs_calls_with_kernels():
    from port_bench.harness import cells
    reader = cells.load_reader("knn_roofline")
    qv = torch.ones(5120, dtype=torch.bool)
    pv = torch.ones(16384, dtype=torch.bool)
    drv = types.SimpleNamespace(knn_calls=[(5120, 16384, qv, pv)])
    ctx = types.SimpleNamespace(trace=make_trace(), units=1, driver=drv)
    least = 8 * 5120 * 16384 / 67e12
    assert reader.read(ctx) == pytest.approx(100.0 * least / 200e-9)
    ctx.driver = types.SimpleNamespace(knn_calls=[])
    assert reader.read(ctx) is None

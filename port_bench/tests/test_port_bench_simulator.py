"""The frozen simulator makes the port's drives bit for bit, and its prefixes."""

import dataclasses

import numpy as np
import pytest

from glio_tpu_torch.config import GlioConfig
from glio_tpu_torch.data import simulator as port_sim
from port_bench.reference.frozen.data import simulator as frozen_sim
from port_bench.harness import cells
from port_bench.traffic import generate

INIT = GlioConfig().initialization
ANCHOR, STATION = np.asarray(INIT.anc_ecef), np.asarray(INIT.station_ecef)


def assert_same(a, b):
    for f in dataclasses.fields(a):
        x, y = getattr(a, f.name), getattr(b, f.name)
        if x is None or y is None:
            assert x is None and y is None, f.name
        elif dataclasses.is_dataclass(x):
            assert_same(x, y)
        else:
            np.testing.assert_array_equal(np.asarray(x), np.asarray(y), err_msg=f.name)


def test_episode_bit_identical():
    kw = dict(n_keyframes=14, scan_points=64, seed=3)
    assert_same(frozen_sim.simulate_episode(**kw), port_sim.simulate_episode(**kw))


@pytest.mark.parametrize("stride", [1, 3])
def test_gnss_bit_identical(stride):
    ep = port_sim.simulate_episode(n_keyframes=14, scan_points=32, seed=3)
    kw = dict(n_sats=20, psr_noise=0.5, epoch_stride=stride, seed=2**31 + 9)
    assert_same(frozen_sim.simulate_gnss_epochs(ep.gt_p, ep.kf_time, ANCHOR, STATION, **kw),
                port_sim.simulate_gnss_epochs(ep.gt_p, ep.kf_time, ANCHOR, STATION, **kw))


def test_drifted_trajectory_identical():
    for a, b in zip(frozen_sim.drifted_trajectory(50, 6.0), port_sim.drifted_trajectory(50, 6.0)):
        np.testing.assert_array_equal(a, b)


def test_generator_is_seeded():
    params = dict(cells.load_cell("window.tc").traffic, n_keyframes=30, scan_points=32)
    a = generate.generate(params, 2**31 + 11, ANCHOR, STATION)
    b = generate.generate(params, 2**31 + 11, ANCHOR, STATION)
    assert a.gnss.time.shape == (30,) and a.scan.shape == (30, 32, 3)
    assert_same(a, b)
    drives = generate.generate(dict(cells.load_cell("batch.l0").traffic, n_keyframes=40),
                               2**31 + 11, ANCHOR, STATION)
    assert len(drives) == 4
    assert not np.array_equal(drives[0].gnss.psr_rov, drives[1].gnss.psr_rov)

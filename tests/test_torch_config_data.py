"""The port's copies of the config and the simulator stay equal to the JAX
package's, and the port imports no jax.

``glio_tpu_torch`` cannot import ``glio_tpu`` (its ``__init__`` imports jax,
which the GPU machine does not have), so it carries copies; these tests are
what keeps the copies honest. Equality is exact: the simulator is the same
numpy code on the same seeds.
"""

import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest

from glio_tpu import config as jcfg
from glio_tpu.data.simulator import simulate_episode as jax_simulate
from glio_tpu_torch import config as tcfg
from glio_tpu_torch import convert
from glio_tpu_torch.data.simulator import simulate_episode as port_simulate

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SECTIONS = [f.name for f in dataclasses.fields(jcfg.GlioConfig)]


@pytest.mark.parametrize("section", SECTIONS)
def test_config_defaults_equal(section):
    j = getattr(jcfg.GlioConfig(), section)
    t = getattr(tcfg.GlioConfig(), section)
    assert type(t).__name__ == type(j).__name__
    assert [(f.name, f.type) for f in dataclasses.fields(t)] == \
        [(f.name, f.type) for f in dataclasses.fields(j)]
    assert dataclasses.asdict(t) == dataclasses.asdict(j)


def test_config_from_glio_carries_every_field():
    cfg = jcfg.GlioConfig().replace(
        shapes=jcfg.ShapeConfig(scan_points=256, map_points=2048),
        estimator=jcfg.EstimatorConfig(local_map_width=8, sw_max_iter=4,
                                       tl2b=(0.1, 0.0, 0.3)))
    assert dataclasses.asdict(convert.config_from_glio(cfg)) == dataclasses.asdict(cfg)


@pytest.mark.parametrize("seed", [0, 7])
def test_simulator_bit_identical(seed):
    kw = dict(n_keyframes=5, scan_points=300, seed=seed)
    j, t = jax_simulate(**kw), port_simulate(**kw)
    for f in dataclasses.fields(t):
        a, b = getattr(t, f.name), getattr(j, f.name)
        if b is None:                    # GNSS, georeference, dense frames
            assert a is None, f.name
            continue
        assert a.dtype == b.dtype, f.name
        np.testing.assert_array_equal(a, b, err_msg=f.name)


@pytest.mark.parametrize("options", [
    dict(circle_omega=2 * np.pi / 10.0),
    dict(dense_frames=3, dense_noise=0.005),
    dict(circle_omega=0.3, dense_frames=2, return_dense_gt=True),
], ids=["circle", "dense", "circle_dense_gt"])
def test_simulator_options_bit_identical(options):
    kw = dict(n_keyframes=6, scan_points=200, seed=17, **options)
    j, t = jax_simulate(**kw), port_simulate(**kw)
    if options.get("return_dense_gt"):
        (j, gt_j), (t, gt_t) = j, t
        assert sorted(gt_t) == sorted(gt_j)
        for key in ("t", "p", "q", "kf_idx"):
            np.testing.assert_array_equal(gt_t[key], gt_j[key], err_msg=key)
        np.testing.assert_array_equal(gt_t["world"].centers, gt_j["world"].centers)
    for f in dataclasses.fields(t):
        a, b = getattr(t, f.name), getattr(j, f.name)
        if b is None:
            assert a is None, f.name
            continue
        np.testing.assert_array_equal(a, b, err_msg=f.name)
    assert (t.dense_rel_dp is not None) == ("dense_frames" in options)


def test_range_image_helpers_bit_identical():
    """``corridor_world``, ``raycast_scan`` and ``to_range_image``: the port's
    copies make the JAX package's worlds and range images, bit for bit."""
    from glio_tpu.data import simulator as jsim
    from glio_tpu_torch.data import simulator as tsim
    ep = jax_simulate(n_keyframes=4, kf_dt=0.1, scan_points=300, seed=8, circle_omega=0.12)
    wj = jsim.corridor_world(ep.gt_p, n_walls=60, seed=8)
    wt = tsim.corridor_world(ep.gt_p, n_walls=60, seed=8)
    for attr in ("centers", "normals", "half", "t1", "t2"):
        np.testing.assert_array_equal(getattr(wt, attr), getattr(wj, attr), err_msg=attr)
    R = jsim._quat_rotmat(ep.gt_q[2])
    kw = dict(n_rings=16, n_cols=240, elev_lo=-0.4, elev_hi=0.2, max_range=70.0)
    img_j, v_j = jsim.raycast_scan(wj, ep.gt_p[2], R, rng=np.random.default_rng(3), **kw)
    img_t, v_t = tsim.raycast_scan(wt, ep.gt_p[2], R, rng=np.random.default_rng(3), **kw)
    np.testing.assert_array_equal(img_t, img_j)
    np.testing.assert_array_equal(v_t, v_j)
    assert v_t.sum() > 1000
    for a, b in zip(tsim.to_range_image(ep.scan[0], ep.scan_valid[0]),
                    jsim.to_range_image(ep.scan[0], ep.scan_valid[0])):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("name", ["GnssEpochs", "Episode"])
def test_episode_field_lists_equal(name):
    """``GnssEpochs`` and ``Episode`` carry the JAX package's fields, in its
    order, so ``save`` / ``load`` files and ``convert.gnss_from_numpy`` pass
    between the two."""
    from glio_tpu.data import episode as jep
    from glio_tpu_torch.data import episode as tep
    names = lambda cls: [(f.name, f.default is dataclasses.MISSING)
                         for f in dataclasses.fields(cls)]
    assert names(getattr(tep, name)) == names(getattr(jep, name))


def test_episode_to_inputs_dtypes():
    import torch
    inp = port_simulate(n_keyframes=3, scan_points=64, seed=1).to_inputs("cpu")
    assert inp.scan.dtype == torch.float32 and inp.imu_acc.dtype == torch.float64
    assert inp.imu_valid.dtype == torch.bool and inp.scan.shape == (3, 64, 3)
    assert inp.gnss.whiten.shape == (3, 4, 32, 32) and not inp.gnss.valid.any()


def test_port_imports_no_jax():
    code = ("import importlib, pkgutil, sys\n"
            "import glio_tpu_torch\n"
            "names = [m.name for m in pkgutil.walk_packages(glio_tpu_torch.__path__,"
            " 'glio_tpu_torch.')]\n"
            "for n in names: importlib.import_module(n)\n"
            "assert len(names) > 15, names\n"
            "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith(('jax.', 'glio_tpu.')))\n"
            "assert not bad, bad\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr

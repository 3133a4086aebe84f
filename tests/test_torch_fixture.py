"""The JAX trajectory fixture that ``chip_smoke.py`` reads is current.

``scripts/make_torch_port_fixture.py`` regenerates it here (the 30-keyframe
bench-shape replay, ~15 s on the CPU) and the stored file must agree:
n_lidar_factors exactly, positions to 1e-3 m. The positions are not held
bit for bit because the replay amplifies rounding: a 1e-9 m nudge of its
start moves keyframe 30 by 3.8e-4 m, so another CPU's instruction set may
move it by as much.
"""

import importlib.util
import json
import os

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _script():
    path = os.path.join(ROOT, "scripts", "make_torch_port_fixture.py")
    spec = importlib.util.spec_from_file_location("make_torch_port_fixture", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_fixture_is_current():
    mod = _script()
    stored = np.load(mod.OUT)
    fresh = mod.make_fixture()
    assert json.loads(str(stored["config_json"])) == json.loads(str(fresh["config_json"]))
    np.testing.assert_array_equal(stored["n_lidar_factors"], fresh["n_lidar_factors"])
    np.testing.assert_allclose(stored["p"], fresh["p"], rtol=0, atol=1e-3)
    np.testing.assert_allclose(stored["q"], fresh["q"], rtol=0, atol=1e-4)
    assert stored["p"].shape == (30, 3)

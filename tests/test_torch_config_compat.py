"""Port parity: the reference-YAML loader (``config_compat.py``) and
``config.load_config`` / ``load_config_file``.

The YAML here is written in the reference's own spelling (the sections and
keys of ``GLIO/config/config_urban_hk.yaml``): camelCase renames, the
``anc_ecef_*`` / ``Euler_*`` / ``lever_arm_*`` / ``station_*_`` /
``ql2b_*`` / ``tl2b_*`` groups, ROS-only keys, a partial group and an unknown
key. The port's loader must give the JAX package's configuration, field for
field, with the same warnings in the same order.
"""

import dataclasses
import json
import warnings

import pytest

from glio_tpu import config as jcfg
from glio_tpu import config_compat as jcc
from glio_tpu_torch import config as tcfg
from glio_tpu_torch import config_compat as tcc

REFERENCE_STYLE = """\
common:
  frame_id: "GLIO"
  data_set: "UrbanNav-HK-Data20190428"
IMU:
  imu_topic: "/imu/data"
  acc_n: 3.9939570888238808e-03
  gyr_n: 1.5636343949698187e-03
  acc_w: 6.4356659353532566e-05
  gyr_w: 3.5640318696367613e-05
  gravity: 9.80511
lidar_odometry:
  lidar_topic: "/velodyne_points"
  line_num: 32
  edgeThreshold: 1.0
  surfThreshold: 0.1
  max_num_iter: 12
initialization:
  anc_ecef_x: -2419233.42
  anc_ecef_y: 5385473.13
  anc_ecef_z: 2405341.30
  yaw_enu_local: 0.0
  Euler_r: 0.6825
  Euler_p: 0.098
  Euler_y: 60.8
  lever_arm_x: 0.0
  lever_arm_y: 0.0
  lever_arm_z: 0.0
  station_x_: -2414266.9200
  station_y_: 5386768.9870
  station_z_: 2407460.0310
  timeshift: 18.0
Estimator:
  enable_batch_fusion: 1
  sms_fusion_level: 0
  search_range: 6
  slide_window_width: 5
  local_map_width: 50
  edgeDSRange: 0.4
  surfDSRange: 0.9
  gnssCovThreshold: 5
  poseCovThreshold: 10
  ql2b_w: 1.0
  ql2b_x: 0.0
  ql2b_y: 0.0
  ql2b_z: 0.0
  tl2b_x: 0.0
  tl2b_y: 0.0
  tl2b_z: 0.28
feature_selection:
  feature_res_num: 100
  batch_rand_set_num: 400
visualization:
  GTinLocal: 1
  RTKinLocal: 1
  LCinLocal: 0
"""

# Oddities on top: a partial group, an unknown key, an unknown section, a
# non-section key.
ODD = REFERENCE_STYLE.replace("  tl2b_z: 0.28\n", "  tl2b_zz: 0.28\n  not_a_real_key: 3\n") \
    + "mystery_section:\n  a: 1\nstray: 5\n"


def _load_both(path):
    with warnings.catch_warnings(record=True) as wj:
        warnings.simplefilter("always")
        cj = jcc.load_reference_yaml(path)
    with warnings.catch_warnings(record=True) as wt:
        warnings.simplefilter("always")
        ct = tcc.load_reference_yaml(path)
    return cj, ct, [str(w.message) for w in wj], [str(w.message) for w in wt]


@pytest.mark.parametrize("text", [REFERENCE_STYLE, ODD], ids=["reference", "odd_keys"])
def test_load_reference_yaml_matches_jax(tmp_path, text):
    path = tmp_path / "config.yaml"
    path.write_text(text)
    cj, ct, wj, wt = _load_both(str(path))
    assert type(ct) is tcfg.GlioConfig
    assert dataclasses.asdict(ct) == dataclasses.asdict(cj)
    assert wt == wj
    if text is REFERENCE_STYLE:
        assert wt == []
        assert ct.initialization.station_ecef == (-2414266.92, 5386768.987, 2407460.031)
        assert ct.estimator.gnss_cov_threshold == 5 and ct.estimator.tl2b == (0.0, 0.0, 0.28)
        assert ct.lidar_odometry.edge_threshold == 1.0
    else:
        assert any("incomplete group Estimator.tl2b" in m for m in wt)
        assert any("not_a_real_key" in m for m in wt)
        assert any("unknown section mystery_section" in m for m in wt)
        assert any("non-section key stray" in m for m in wt)
        assert ct.estimator.tl2b == tcfg.EstimatorConfig().tl2b       # the group's default


@pytest.mark.parametrize("data", [
    {"Estimator": {"slide_window_width": 7, "not_a_real_key": 3}},
    {"initialization": {"anc_ecef_x": 1.0, "anc_ecef_y": 2.0, "anc_ecef_zz": 3.0}},
    {"common": {"frame_id": "GLIO"}, "visualization": {"GTinLocal": True},
     "IMU": {"imu_topic": "/imu/data", "gravity": 9.8}},
    None,
], ids=["unknown_key", "partial_group", "ros_only", "empty"])
def test_reference_yaml_to_dict_matches_jax(data):
    with warnings.catch_warnings(record=True) as wj:
        warnings.simplefilter("always")
        dj = jcc.reference_yaml_to_dict(data)
        cj = jcfg.load_config(dj)
    with warnings.catch_warnings(record=True) as wt:
        warnings.simplefilter("always")
        dt = tcc.reference_yaml_to_dict(data)
        ct = tcfg.load_config(dt)
    assert dt == dj
    assert dataclasses.asdict(ct) == dataclasses.asdict(cj)
    assert [str(w.message) for w in wt] == [str(w.message) for w in wj]


def test_load_config_file_matches_jax(tmp_path):
    data = {"estimator": {"gnss_in_sliding_window": True, "batch_solver": "chol_pcg",
                          "bogus": 1},
            "shapes": {"max_imu_per_interval": 40}}
    path = tmp_path / "cfg.json"
    path.write_text(json.dumps(data))
    with pytest.warns(UserWarning, match="estimator.bogus"):
        ct = tcfg.load_config_file(str(path))
    with pytest.warns(UserWarning, match="estimator.bogus"):
        cj = jcfg.load_config_file(str(path))
    assert dataclasses.asdict(ct) == dataclasses.asdict(cj)
    assert ct.estimator.batch_solver == "chol_pcg" and ct.shapes.max_imu_per_interval == 40

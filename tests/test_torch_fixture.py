"""The JAX fixtures that ``chip_smoke.py`` reads are current.

``scripts/make_torch_port_fixture.py`` regenerates it here (the 30-keyframe
bench-shape replay, ~15 s on the CPU) and the stored file must agree:
n_lidar_factors exactly, positions to 1e-3 m. The positions are not held
bit for bit because the replay amplifies rounding: a 1e-9 m nudge of its
start moves keyframe 30 by 3.8e-4 m, so another CPU's instruction set may
move it by as much.

The batch and pipeline fixtures of ``scripts/make_torch_batch_fixture.py``
take two minutes of JAX to make, so they are not remade here: the port
rebuilds the batch problem and must reproduce its stored checksums, and
both files' configurations and layouts are checked.
"""

import dataclasses
import importlib.util
import json
import os

import numpy as np
import pytest

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


def _batch_script():
    path = os.path.join(ROOT, "scripts", "make_torch_batch_fixture.py")
    spec = importlib.util.spec_from_file_location("make_torch_batch_fixture", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_batch_fixture_is_the_ports_problem():
    """The port's simulator and ``build_problem`` rebuild the problem the
    stored JAX solves were made from (checksums to 1e-12 relative), so
    ``chip_smoke.py`` can hold the port's solve on the card against them;
    and the stored solves are the ones its tolerances assume."""
    from glio_tpu_torch.config import GlioConfig
    from glio_tpu_torch.data.simulator import simulate_gnss_epochs
    from glio_tpu_torch.models import batch

    mod = _batch_script()
    assert os.path.getsize(mod.BATCH_OUT) < 1 << 20
    fx = np.load(mod.BATCH_OUT)
    cfg = GlioConfig()
    assert json.loads(str(fx["config_json"])) == json.loads(
        json.dumps(dataclasses.asdict(cfg)))
    sc = json.loads(str(fx["scenario_json"]))
    kf_time, p_true, q_true, p_odo, anchor, station = mod.batch_scenario(cfg)
    gnss = simulate_gnss_epochs(p_true, kf_time, anchor, station, psr_noise=sc["psr_noise"],
                                epoch_stride=sc["epoch_stride"], seed=sc["seed"])
    prob = batch.build_problem(cfg, p_odo, q_true, kf_time, gnss, anchor, 0.0, station,
                               device="cpu")
    sums = mod.problem_checksums(prob.p_odo, prob.psr_rov, prob.whiten, prob.ep_valid)
    np.testing.assert_allclose(sums, fx["checksums"], rtol=1e-12, atol=0)
    assert fx["p_f64"].shape == fx["p_mixed"].shape == (3493, 3)
    assert fx["cov_diag"].shape == (3493, 6) and bool(fx["calibrated"])
    rmse = np.sqrt(np.mean(np.sum((fx["p_f64"] - p_true) ** 2, -1)))
    assert rmse < 0.5
    # JAX's own mixed-versus-f64 distance, below the 5e-3 m tolerance.
    assert np.abs(fx["p_mixed"] - fx["p_f64"]).max() < 2e-3


def test_pipeline_fixture_layout():
    mod = _batch_script()
    assert os.path.getsize(mod.PIPE_OUT) < 1 << 20
    fx = np.load(mod.PIPE_OUT)
    assert json.loads(str(fx["config_json"])) == json.loads(
        json.dumps(dataclasses.asdict(mod.pipeline_config())))
    n = json.loads(str(fx["scenario_json"]))["n_keyframes"]
    for key in ("tc_sw_result", "tc_batch_result", "tc_batch_result_f64"):
        assert fx[key].shape == (n, 12), key
        assert np.isfinite(fx[key]).all()
    for key in ("tc_batch_cov", "tc_batch_cov_f64"):
        assert fx[key].shape == (n, 10), key
    assert fx["n_lidar_factors"].shape == (n,) and fx["n_lidar_factors"][-1] > 100
    _check_lc_rows(fx, n)


def _check_lc_rows(fx, n):
    """Stage 3's rows and the spread and gain its gates are made from."""
    assert fx["lc_result"].shape == (n, 12) and np.isfinite(fx["lc_result"]).all()
    np.testing.assert_array_equal(fx["lc_result"][:, 0], fx["tc_sw_result"][:, 0])
    assert 0 < float(fx["lc_nudge_dp"]) < 1e-6 and 0 < float(fx["lc_gain_p_per_m"]) < 10


def test_pipeline_sms1_fixture_has_stage3():
    path = os.path.join(ROOT, "tests", "data", "pipeline_sms1_seed0.npz")
    fx = np.load(path)
    _check_lc_rows(fx, json.loads(str(fx["scenario_json"]))["n_keyframes"])


STAGE3_FIXTURES = {   # file: keys every chip_smoke.py phase reads
    "lc_T3493_seed4.npz": ("fixes", "ok", "gnss_valid", "p_lc", "q_lc", "nudge_fix",
                           "nudge_dp", "nudge_dq"),
    "backend_fusion_w50_seed21.npz": ("p_gated", "lines_gated", "nudge_dp", "decisions_stable"),
    "backend_fusion_small_seed21.npz": ("p_gated", "p_off", "lines_gated", "lines_off",
                                        "nudge_dp", "decisions_stable"),
    "loop_closure_seed17.npz": ("cands", "icp_p", "icp_accepted", "p", "q", "n_edges",
                                "nudge_dp", "nudge_f32_dp"),
    "dense_pcd_seed19.npz": ("p_dense", "q_dense", "dense_valid", "pcd_points",
                             "world_checksum"),
}


@pytest.mark.parametrize("name", sorted(STAGE3_FIXTURES))
def test_stage3_fixture_layout(name):
    """Each file of ``scripts/make_torch_stage3_fixture.py`` holds what
    ``chip_smoke.py`` reads, finite, under 1 MB, with the JAX spreads its
    tolerances come from."""
    path = os.path.join(ROOT, "tests", "data", name)
    assert os.path.getsize(path) < 1 << 20
    fx = np.load(path)
    json.loads(str(fx["scenario_json"]))
    for key in STAGE3_FIXTURES[name]:
        a = fx[key]
        if a.dtype.kind == "f":
            assert np.isfinite(a).all(), key
    if "decisions_stable" in fx.files:
        from glio_tpu_torch.testing import reset_decisions
        assert reset_decisions(json.loads(str(fx["lines_gated"]))), "no reset in JAX's run"


def test_frontend_fixture_layout():
    """``tests/data/frontend_hdl32_seed8.npz`` (``scripts/make_torch_frontend_fixture.py``,
    ~2 min of JAX, not remade here) was made with the raw-input configuration
    and drive ``chip_smoke.py`` reads, and its episode is its front end's."""
    from glio_tpu import config as jcfg
    from glio_tpu_torch.testing import RAW_DRIVE, raw_config
    fx = np.load(os.path.join(ROOT, "tests", "data", "frontend_hdl32_seed8.npz"))
    assert json.loads(str(fx["config_json"])) == json.loads(
        json.dumps(dataclasses.asdict(raw_config(jcfg))))
    assert json.loads(str(fx["scenario_json"])) == RAW_DRIVE
    n, S = RAW_DRIVE["n_frames"], RAW_DRIVE["scan_points"]
    assert fx["surf"].shape == (n, S, 3) and fx["surf_valid"].shape == (n, S)
    kf = fx["is_keyframe"]
    T = int(kf.sum())
    assert fx["ep_imu_acc"].shape[0] == T and fx["tc_sw_result"].shape == (T, 12)
    assert fx["n_lidar_factors"].shape == (T,) and fx["nudge_n_matches"].shape == (4, n)
    assert float(fx["odo_nudge9_dp"]) < float(fx["odo_nudge5_dp"]) < 1e-2

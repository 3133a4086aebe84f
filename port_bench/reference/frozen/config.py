"""Typed configuration, copied field for field from ``glio_tpu.config``.

A copy and not an import: importing anything under ``glio_tpu`` runs
``glio_tpu/__init__.py``, which imports jax, and the machine the port runs
on has no jax. ``tests/test_torch_config_data.py`` holds every default
here equal to the JAX package's, so the two cannot drift apart.
"""

import warnings
from dataclasses import dataclass, field, fields, replace
from typing import Tuple


@dataclass(frozen=True)
class ImuConfig:
    """IMU noise model (config_urban_hk.yaml IMU section)."""
    acc_n: float = 3.9939570888238808e-03
    gyr_n: float = 1.5636343949698187e-03
    acc_w: float = 6.4356659353532566e-05
    gyr_w: float = 3.5640318696367613e-05
    gravity: float = 9.80511


@dataclass(frozen=True)
class LidarOdometryConfig:
    """Frontend scan-matching parameters (lidar_odometry section)."""
    ds_rate: int = 1
    line_num: int = 32
    edge_threshold: float = 1.0
    surf_threshold: float = 0.1
    max_num_iter: int = 12
    scan_match_cnt: int = 1
    if_to_deskew: bool = False
    local_map_frames: int = 20       # LidarOdometry.cpp:268 localMapWindowSize
    keyframe_dist_thresh: float = 0.2   # :566-578
    keyframe_angle_thresh: float = 0.1
    voxel_size: float = 0.2          # :306-314


@dataclass(frozen=True)
class InitializationConfig:
    """Anchor / extrinsic initialization (initialization section)."""
    anc_ecef: Tuple[float, float, float] = (-2419233.42, 5385473.13, 2405341.30)
    yaw_enu_local: float = 0.0
    euler_rpy_deg: Tuple[float, float, float] = (0.6825, 0.098, 60.8)
    lever_arm: Tuple[float, float, float] = (0.0, 0.0, 0.0)
    timeshift: float = 18.0          # GPS-UTC leap seconds for 2021
    station_ecef: Tuple[float, float, float] = (-2414266.9200, 5386768.9870, 2407460.0310)


@dataclass(frozen=True)
class EstimatorConfig:
    """Sliding-window / batch fusion parameters (Estimator section)."""
    enable_batch_fusion: bool = True
    sms_fusion_level: int = 0
    search_range: int = 6
    max_num_iter: int = 100
    slide_window_width: int = 5
    local_map_width: int = 50
    edge_ds_range: float = 0.4
    surf_ds_range: float = 0.9
    lidar_const: float = 7.5
    surf_dist_thres: float = 0.18
    kd_max_radius: float = 1.5
    gnss_cov_threshold: float = 5.0
    pose_cov_threshold: float = 10.0
    # Robust per-epoch DD fix options (rtk.solve_epoch_dd): IRLS Huber
    # threshold in sigma multiples and hard NLOS trim in metres; None =
    # plain WLS (the RTKLIB default path). Measured on real Whampoa:
    # huber=3/trim=30 passes ~50% more fixes through the covariance gate
    # at slightly lower scatter (scripts/lc_whampoa.py).
    rtk_fix_huber: float | None = None
    rtk_fix_trim: float | None = None
    loop_closure_on: bool = False
    lc_search_radius: float = 25.0
    lc_map_width: int = 25
    lc_icp_thres: float = 0.2
    lc_time_thres: float = 30.0
    save_pcd: bool = False
    mapping_interval: int = 3
    # lidar→body extrinsic (q wxyz, t).
    ql2b: Tuple[float, float, float, float] = (1.0, 0.0, 0.0, 0.0)
    tl2b: Tuple[float, float, float] = (0.0, 0.0, 0.28)
    # Sliding-window solver iteration budget (Estimator.cpp:2430: 15).
    sw_max_iter: int = 15
    # Whether GNSS factors join the sliding window. The released reference
    # compiles them out (`#if 0`, Estimator.cpp:2255); default matches.
    gnss_in_sliding_window: bool = False
    # DD outlier down-weight threshold (m) for the in-window factors
    # (batch anneals {1e9,10,8,6}; the window uses one fixed stage).
    window_dd_threshold: float = 10.0
    # Doppler + receiver-clock-drift factors in the window (active only
    # with gnss_in_sliding_window; the reference carries tcdopplerFactor +
    # constantClockDriftFactor in the same compiled-out block,
    # Estimator.cpp:2290-2345, dopp_factor.hpp:19-103).
    doppler_in_window: bool = True
    # Debug switch: disable the marginalization prior (anchor instead).
    enable_marginalization: bool = True
    # Doppler factors in the batch stage (the reference ships them
    # compiled out, `#if 0` Estimator.cpp:3146-3195; off matches).
    doppler_in_batch: bool = False
    # Batch linear solver: "direct" = exact f64 block CYCLIC REDUCTION
    # (log-depth batched elimination — 18x the sequential banded Cholesky
    # on TPU, identical on CPU), "chol_pcg" = f32-factor-preconditioned
    # CG (~1e-5 step accuracy), "pcg" = block-Jacobi PCG (the multi-chip
    # shardable path).
    batch_solver: str = "direct"
    # --- Divergence-recovery gates (run_pipeline's guarded window reset;
    # the ROS reference has no equivalent — its loose per-frame gates let
    # an INS runaway persist, recovered only by operator restart).
    # Window-vs-fused-trajectory distance (m) beyond which the window
    # states snap back to the fused estimate.
    reset_drift_threshold: float = 20.0
    # A fused tail implying faster motion than this (m/s) is itself
    # implausible — snap to it would inject garbage; fall through to the
    # RTK re-anchor instead. Also clamps the finite-difference velocity
    # seeds after a snap.
    reset_max_speed: float = 30.0
    # Disagreement (m) between the fused tail and an INDEPENDENT per-epoch
    # RTK DD fix beyond which the fused trajectory itself is deemed broken
    # (the robust batch locked out the true GNSS positions as outliers):
    # triggers a reset even below reset_drift_threshold, and routes it to
    # the direct-fix re-anchor instead of snapping to the compromised
    # fused tail. The fix carries metre-level noise, so this sits well
    # above the DD floor but far below reset_drift_threshold.
    reset_fix_disagree: float = 8.0
    # --- Gauss-Markov zenith atmospheric-bias chain (batch variant
    # optimize_batch_atm): correlation time (s), stationary sigma (m of
    # zenith delay), and the weak absolute prior sigma fixing the gauge.
    # Models the rover-side atmosphere a SYNTHESIZED base station cannot
    # cancel (no real hksc1410.21o in the reference repo).
    atm_tau: float = 600.0
    atm_sigma: float = 2.0
    atm_abs_sigma: float = 5.0


@dataclass(frozen=True)
class FeatureSelectionConfig:
    """feature_selection section."""
    feature_res_num: int = 100
    rand_set_num: int = 300
    batch_feature_res_num: int = 25
    batch_rand_set_num: int = 400
    random_select: bool = True
    # Window selection mode (round 5; no reference counterpart — the
    # reference picks a uniform random subset). False: deterministic
    # global top-F by fit weight (picks the most confident fits;
    # measured best on corner-rich content — noise-free sim tracks
    # <0.1 m). True: half global / half spread over 3 dominant-normal
    # axes × 6 azimuth sextants (constrains every axis + yaw lever
    # arms; measured 19.6 → ~4 m over 60 keyframes on ground-dominated
    # HDL-32E raycast frames where the global mode picks ~100% ground).
    diverse_select: bool = False


@dataclass(frozen=True)
class ShapeConfig:
    """Static tensor shapes for the TPU pipeline (padding budgets).

    These have no reference counterpart — the reference uses dynamic
    containers; TPU programs need fixed shapes.  Sizes chosen to cover the
    UrbanNav sequences with headroom.
    """
    max_imu_per_interval: int = 64   # IMU samples between keyframes (100 Hz / ~3 Hz)
    scan_points: int = 1024          # downsampled surf points kept per keyframe
    map_points: int = 16384          # voxel-downsampled local map size
    max_sats: int = 20               # matches psr_size_20 (dd_psr_factor.hpp:12)


@dataclass(frozen=True)
class GlioConfig:
    imu: ImuConfig = field(default_factory=ImuConfig)
    lidar_odometry: LidarOdometryConfig = field(default_factory=LidarOdometryConfig)
    initialization: InitializationConfig = field(default_factory=InitializationConfig)
    estimator: EstimatorConfig = field(default_factory=EstimatorConfig)
    feature_selection: FeatureSelectionConfig = field(default_factory=FeatureSelectionConfig)
    shapes: ShapeConfig = field(default_factory=ShapeConfig)

    def replace(self, **kw):
        return replace(self, **kw)


def _update_dataclass(dc, values: dict, path: str):
    known = {f.name for f in fields(dc)}
    kwargs = {}
    for k, v in values.items():
        if k not in known:
            warnings.warn(f"config: unknown key {path}.{k} ignored (using defaults "
                          f"for the rest) — matching getParameter fallback")
            continue
        kwargs[k] = v
    return replace(dc, **kwargs)


def load_config(data: dict) -> GlioConfig:
    """Build a GlioConfig from a nested dict (parsed YAML/JSON).

    Unknown keys warn and fall back to defaults, mirroring the reference's
    ``getParameter`` warn-and-default behavior.
    """
    cfg = GlioConfig()
    sections = {
        "imu": cfg.imu, "lidar_odometry": cfg.lidar_odometry,
        "initialization": cfg.initialization, "estimator": cfg.estimator,
        "feature_selection": cfg.feature_selection, "shapes": cfg.shapes,
    }
    out = {}
    for name, sub in sections.items():
        out[name] = _update_dataclass(sub, data.get(name, {}), name)
    return GlioConfig(**out)

"""Load the reference's ROS YAML config files verbatim (a copy of ``glio_tpu/config_compat.py``).

A GLIO user carries ``config_urban_hk.yaml`` (GLIO/config/) over
unchanged: :func:`load_reference_yaml` consumes the reference's exact
key spelling (camelCase thresholds, ``anc_ecef_x/y/z`` scalar triplets,
``ql2b_w`` quaternion components, ``Euler_r/p/y``) and returns a
:class:`~glio_tpu_torch.config.GlioConfig`.

ROS-only keys (topics, frame ids, rviz visualization toggles) have no
headless equivalent and are skipped silently; genuinely unknown keys
warn and fall back to defaults, mirroring the reference's
``getParameter`` behavior (``GLIO/include/utils/common.h:108-132``).
The dataset/RTKLIB paths the reference passes through its launch file
(``GLIO/launch/run_urban_hk.launch:31-34``) are not config — pass them
to :mod:`glio_tpu_torch.gnss.converter` directly (see docs/MIGRATION.md).
``yaml`` is imported inside :func:`load_reference_yaml` only.
"""

import warnings

from .config import GlioConfig, load_config

# Reference key -> (section, field) for keys whose spelling differs from
# the dataclass field. Identically-named keys pass straight through.
_RENAME = {
    ("lidar_odometry", "edgeThreshold"): "edge_threshold",
    ("lidar_odometry", "surfThreshold"): "surf_threshold",
    ("Estimator", "edgeDSRange"): "edge_ds_range",
    ("Estimator", "surfDSRange"): "surf_ds_range",
    ("Estimator", "gnssCovThreshold"): "gnss_cov_threshold",
    ("Estimator", "poseCovThreshold"): "pose_cov_threshold",
}

# Scalar-triplet (and quaternion) groups the reference spells as
# suffixed scalars; collected into tuple fields in declaration order.
_GROUPS = {
    ("initialization", "anc_ecef"): ("anc_ecef_x", "anc_ecef_y", "anc_ecef_z"),
    ("initialization", "euler_rpy_deg"): ("Euler_r", "Euler_p", "Euler_y"),
    ("initialization", "lever_arm"): ("lever_arm_x", "lever_arm_y", "lever_arm_z"),
    ("initialization", "station_ecef"): ("station_x_", "station_y_", "station_z_"),
    ("Estimator", "ql2b"): ("ql2b_w", "ql2b_x", "ql2b_y", "ql2b_z"),
    ("Estimator", "tl2b"): ("tl2b_x", "tl2b_y", "tl2b_z"),
}

# ROS plumbing with no headless counterpart: skip without warning.
_ROS_ONLY = {
    ("common", "frame_id"), ("common", "data_set"),
    ("IMU", "imu_topic"), ("lidar_odometry", "lidar_topic"),
    ("visualization", "GTinLocal"), ("visualization", "RTKinLocal"),
    ("visualization", "LCinLocal"),
}

_SECTION = {"IMU": "imu", "lidar_odometry": "lidar_odometry",
            "initialization": "initialization", "Estimator": "estimator",
            "feature_selection": "feature_selection", "shapes": "shapes"}


def reference_yaml_to_dict(data: dict) -> dict:
    """Translate a parsed reference-YAML dict to load_config's schema."""
    out = {}
    for ref_sec, values in (data or {}).items():
        if not isinstance(values, dict):
            warnings.warn(f"config: non-section key {ref_sec} ignored")
            continue
        sec = _SECTION.get(ref_sec)
        if sec is None and ref_sec not in ("common", "visualization"):
            warnings.warn(f"config: unknown section {ref_sec} ignored")
            continue
        values = dict(values)
        dst = out.setdefault(sec, {}) if sec else None
        for (gsec, gfield), members in _GROUPS.items():
            if gsec != ref_sec or dst is None:
                continue
            present = [m for m in members if m in values]
            if len(present) == len(members):
                dst[gfield] = tuple(float(values.pop(m)) for m in members)
            elif present:
                # Partial triplet/quaternion group (e.g. a typo in one of
                # anc_ecef_x/y/z): name the incomplete group explicitly
                # instead of letting the present members degrade to
                # generic unknown-key warnings; the whole group falls
                # back to defaults.
                missing = [m for m in members if m not in values]
                warnings.warn(
                    f"config: incomplete group {ref_sec}.{gfield} — "
                    f"missing {missing}; ignoring {present} and using "
                    f"defaults")
                for m in present:
                    values.pop(m)
        for k, v in values.items():
            if (ref_sec, k) in _ROS_ONLY:
                continue
            if dst is None:
                warnings.warn(f"config: unknown key {ref_sec}.{k} ignored")
                continue
            dst[_RENAME.get((ref_sec, k), k)] = v
    return {k: v for k, v in out.items() if k is not None}


def load_reference_yaml(path: str) -> GlioConfig:
    """Parse a reference-format YAML file into a GlioConfig."""
    import yaml
    with open(path) as f:
        data = yaml.safe_load(f)
    return load_config(reference_yaml_to_dict(data))

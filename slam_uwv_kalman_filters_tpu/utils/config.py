"""Configuration schema — the ``PoseUKFConfig.hpp`` struct tree as frozen
dataclasses, loadable from YAML/JSON.

Mirrors ``/root/reference/src/PoseUKFConfig.hpp`` field-for-field:
``WaterVelocityParameters`` (:20-48), ``InertialNoiseParameters`` (:50-63),
``DynamicModelNoiseParameters`` (:65-97), ``LocationConfiguration`` (:99-109),
``VisualLandmark`` (:111-123), ``CameraConfiguration`` (:125-131),
``VisualLandmarkConfiguration`` (:133-143), ``HydrostaticConfiguration``
(:145-157) and the top-level ``PoseUKFConfig`` (:159-194).

The reference bound these from ROCK/typelib property files outside the repo;
here :func:`load_config`/:func:`save_config` provide YAML/JSON round-trips and
:func:`default_pose_ukf_config` gives a physically-plausible AUV configuration
(used by tests and benchmarks).
"""

from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass, field
from pathlib import Path
from typing import List, Sequence

import numpy as np

__all__ = [
    "WaterVelocityParameters",
    "InertialNoiseParameters",
    "DynamicModelNoiseParameters",
    "LocationConfiguration",
    "VisualLandmark",
    "CameraConfiguration",
    "VisualLandmarkConfiguration",
    "HydrostaticConfiguration",
    "PoseUKFConfig",
    "default_pose_ukf_config",
    "landmark_by_id",
    "landmark_feature_positions",
    "landmark_pose",
    "landmark_pose_cov",
    "feature_pixel_cov",
    "load_config",
    "save_config",
    "config_to_dict",
    "config_from_dict",
]


@dataclass(frozen=True)
class WaterVelocityParameters:
    """``PoseUKFConfig.hpp:20-48``."""

    tau: float = 60.0  # time scale for water current change [s]
    limits: float = 0.3  # 1σ bound of temporal current change [m/s]
    measurement_std: tuple = (0.1, 0.1, 0.1)  # ADCP std [(m/s)/√Hz]
    scale: float = 0.001  # spatial rate of current change [(m/s)/m]
    cell_size: float = 1.0  # ADCP cell size [m]
    first_cell_blank: float = 1.0  # blanking distance [m]
    minimum_correlation: float = 0.0
    adcp_bias_tau: float = 600.0
    adcp_bias_limits: float = 0.05


@dataclass(frozen=True)
class InertialNoiseParameters:
    """``PoseUKFConfig.hpp:50-63``."""

    randomwalk: tuple = (1e-3, 1e-3, 1e-3)  # [(m/s²)/√Hz] or [(rad/s)/√Hz]
    bias_offset: tuple = (0.0, 0.0, 0.0)
    bias_instability: tuple = (1e-4, 1e-4, 1e-4)
    bias_tau: float = 3600.0


@dataclass(frozen=True)
class DynamicModelNoiseParameters:
    """``PoseUKFConfig.hpp:65-97``. Instabilities map to the 9 (x,y,ψ)
    components in column-major order (src/PoseState.hpp:37-39)."""

    body_efforts_std: tuple = (1.0, 1.0, 1.0, 0.5, 0.5, 0.5)
    inertia_instability: tuple = (1.0,) * 9
    lin_damping_instability: tuple = (0.5,) * 9
    quad_damping_instability: tuple = (0.5,) * 9
    inertia_tau: float = 3600.0
    lin_damping_tau: float = 3600.0
    quad_damping_tau: float = 3600.0


@dataclass(frozen=True)
class LocationConfiguration:
    """``PoseUKFConfig.hpp:99-109``. Angles in radians, altitude in metres."""

    latitude: float = 0.822  # ~47.1°N
    longitude: float = 0.153
    altitude: float = 0.0


@dataclass(frozen=True)
class VisualLandmark:
    """``PoseUKFConfig.hpp:111-123``."""

    marker_id: str = ""
    marker_size: float = 0.2
    marker_position: tuple = (0.0, 0.0, 0.0)
    marker_euler_orientation: tuple = (0.0, 0.0, 0.0)
    marker_pose_std: tuple = (0.01,) * 6


@dataclass(frozen=True)
class CameraConfiguration:
    """Pinhole intrinsics, ``PoseUKFConfig.hpp:125-131``."""

    fx: float = 500.0
    fy: float = 500.0
    cx: float = 320.0
    cy: float = 240.0


@dataclass(frozen=True)
class VisualLandmarkConfiguration:
    """``PoseUKFConfig.hpp:133-143``."""

    camera_config: CameraConfiguration = field(default_factory=CameraConfiguration)
    feature_std: tuple = (1.0, 1.0)
    unit_feature_positions: tuple = ((-1, -1, 0), (1, -1, 0), (1, 1, 0), (-1, 1, 0))
    landmarks: tuple = ()


@dataclass(frozen=True)
class HydrostaticConfiguration:
    """``PoseUKFConfig.hpp:145-157``."""

    water_density: float = 1025.0  # [kg/m³]
    water_density_limits: float = 5.0
    water_density_tau: float = 3600.0
    atmospheric_pressure: float = 101325.0  # [Pa]
    pressure_std: float = 100.0


@dataclass(frozen=True)
class PoseUKFConfig:
    """Top-level filter configuration, ``PoseUKFConfig.hpp:159-194``."""

    acceleration: InertialNoiseParameters = field(default_factory=InertialNoiseParameters)
    rotation_rate: InertialNoiseParameters = field(default_factory=InertialNoiseParameters)
    model_noise_parameters: DynamicModelNoiseParameters = field(
        default_factory=DynamicModelNoiseParameters
    )
    water_velocity: WaterVelocityParameters = field(default_factory=WaterVelocityParameters)
    location: LocationConfiguration = field(default_factory=LocationConfiguration)
    visual_landmarks: VisualLandmarkConfiguration = field(
        default_factory=VisualLandmarkConfiguration
    )
    hydrostatics: HydrostaticConfiguration = field(default_factory=HydrostaticConfiguration)
    max_jerk: tuple = (1.0, 1.0, 1.0)  # [m/s³]
    max_effort: tuple = (100.0, 100.0, 100.0, 50.0, 50.0, 50.0)
    dynamic_model_min_depth: float = 0.5


def default_pose_ukf_config() -> PoseUKFConfig:
    """A plausible FOG-IMU AUV configuration (ICRA'18-style: gyros good enough
    to sense earth rotation — bias instability well below EARTHW)."""
    return PoseUKFConfig(
        acceleration=InertialNoiseParameters(
            randomwalk=(2e-3, 2e-3, 2e-3),
            bias_offset=(0.0, 0.0, 0.0),
            bias_instability=(5e-4, 5e-4, 5e-4),
            bias_tau=3600.0,
        ),
        rotation_rate=InertialNoiseParameters(
            randomwalk=(3e-5, 3e-5, 3e-5),
            bias_offset=(0.0, 0.0, 0.0),
            bias_instability=(5e-6, 5e-6, 5e-6),
            bias_tau=3600.0,
        ),
    )


# ---------------------------------------------------------------------------
# dict / file round-trips
# ---------------------------------------------------------------------------


# ---------------------------------------------------------------------------
# Visual-landmark helpers: turn the config schema into the arrays the marker
# updates consume (reference semantics: unit feature positions are scaled by
# half the marker size, PoseUKFConfig.hpp:139-140).
# ---------------------------------------------------------------------------


def landmark_by_id(cfg: VisualLandmarkConfiguration, marker_id: str) -> VisualLandmark:
    for lm in cfg.landmarks:
        if lm.marker_id == marker_id:
            return lm
    raise KeyError(f"unknown landmark {marker_id!r}")


def landmark_feature_positions(cfg: VisualLandmarkConfiguration, landmark: VisualLandmark):
    """(K,3) feature positions in the marker frame: unit positions × size/2."""
    return np.asarray(cfg.unit_feature_positions, float) * (landmark.marker_size / 2.0)


def landmark_pose(landmark: VisualLandmark):
    """(position (3,), quaternion [w,x,y,z]) of the marker in the nav frame;
    euler convention per ``ops.manifolds.quat_from_euler_zyx``."""
    from ..ops.manifolds import quat_from_euler_zyx

    r, p, y = landmark.marker_euler_orientation
    return np.asarray(landmark.marker_position, float), np.asarray(
        quat_from_euler_zyx(r, p, y)
    )


def landmark_pose_cov(landmark: VisualLandmark):
    """(6,6) diagonal covariance from the configured pose std."""
    return np.diag(np.asarray(landmark.marker_pose_std, float) ** 2)


def feature_pixel_cov(cfg: VisualLandmarkConfiguration):
    """(2,2) pixel covariance from the configured feature std."""
    return np.diag(np.asarray(cfg.feature_std, float) ** 2)


def config_to_dict(cfg) -> dict:
    def conv(obj):
        if dataclasses.is_dataclass(obj):
            return {f.name: conv(getattr(obj, f.name)) for f in dataclasses.fields(obj)}
        if isinstance(obj, (list, tuple)):
            return [conv(o) for o in obj]
        if isinstance(obj, np.ndarray):
            return obj.tolist()
        return obj

    return conv(cfg)


_NESTED = {
    "acceleration": InertialNoiseParameters,
    "rotation_rate": InertialNoiseParameters,
    "model_noise_parameters": DynamicModelNoiseParameters,
    "water_velocity": WaterVelocityParameters,
    "location": LocationConfiguration,
    "visual_landmarks": VisualLandmarkConfiguration,
    "hydrostatics": HydrostaticConfiguration,
    "camera_config": CameraConfiguration,
}


def config_from_dict(data: dict) -> PoseUKFConfig:
    def build(cls, d):
        kwargs = {}
        for f in dataclasses.fields(cls):
            if f.name not in d:
                continue
            v = d[f.name]
            if f.name in _NESTED and isinstance(v, dict):
                kwargs[f.name] = build(_NESTED[f.name], v)
            elif f.name == "landmarks":
                kwargs[f.name] = tuple(build(VisualLandmark, x) for x in v)
            elif isinstance(v, list):
                kwargs[f.name] = tuple(tuple(x) if isinstance(x, list) else x for x in v)
            else:
                kwargs[f.name] = v
        return cls(**kwargs)

    return build(PoseUKFConfig, data)


def save_config(cfg: PoseUKFConfig, path: str | Path) -> None:
    path = Path(path)
    data = config_to_dict(cfg)
    if path.suffix in (".yml", ".yaml"):
        try:
            import yaml
        except ImportError as e:  # pragma: no cover
            raise RuntimeError(
                "YAML configs need PyYAML (the optional 'yaml' extra); use a .json path"
            ) from e
        path.write_text(yaml.safe_dump(data))
    else:
        path.write_text(json.dumps(data, indent=2))


def load_config(path: str | Path) -> PoseUKFConfig:
    path = Path(path)
    text = path.read_text()
    if path.suffix in (".yml", ".yaml"):
        try:
            import yaml
        except ImportError as e:  # pragma: no cover
            raise RuntimeError(
                "YAML configs need PyYAML (the optional 'yaml' extra); use a .json path"
            ) from e
        data = yaml.safe_load(text)
    else:
        data = json.loads(text)
    return config_from_dict(data)

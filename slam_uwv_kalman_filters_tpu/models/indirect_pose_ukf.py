"""IndirectPoseUKF — error-state pose corrector.

Re-implements the reference ``IndirectPoseUKF``
(``/root/reference/src/IndirectPoseUKF.hpp``, ``src/IndirectPoseUKF.cpp``):
a 6-DOF error-state UKF over {position_error ℝ³, orientation_error SO(3)}
estimating the bias between an external pose reference and visual-marker
observations. The orientation error decays toward identity with time constant
tau (``IndirectPoseUKF.cpp:6-20``); the corrected pose is
reference ∘ error (``IndirectPoseUKF.cpp:137-142``).

The visual-marker update augments the filter state with the marker pose
(6 extra DOF → 12-DOF temporary filter, ``IndirectPoseUKF.cpp:26-33,94-135``)
so marker-pose uncertainty is consumed exactly; under jit this is simply a
second fixed-shape update path (shapes are static), after which the filter
block is marginalized back out. This de-risks PoseUKF's 59-DOF augmentation
(SURVEY.md §7 step 6).
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..ops import manifolds as mf
from ..ops.linalg_small import mm
from ..ops import ukf
from ..utils.config import CameraConfiguration
from ..utils.validation import check_measurement

__all__ = [
    "PoseErrorState",
    "ERROR_MANIFOLD",
    "PoseErrorStateWithMarker",
    "MARKER_MANIFOLD",
    "IndirectPoseUKFState",
    "IndirectPoseUKFParams",
    "init",
    "predict",
    "predict_bank",
    "update_markers",
    "update_markers_bank",
    "update_pose_reference",
    "corrected_pose",
    "pixel_to_s2",
    "pixel_cov_to_s2",
    "IndirectPoseUKF",
]


class PoseErrorState(NamedTuple):
    """``MTK_BUILD_MANIFOLD(PoseErrorState, ...)`` (``IndirectPoseUKF.hpp:19-22``)."""

    position_error: jax.Array  # (3,)
    orientation_error: jax.Array  # (4,) quaternion


ERROR_MANIFOLD = mf.make_manifold(
    mf.Field("position_error", "vec", 3),
    mf.Field("orientation_error", "so3"),
)  # DOF = 6 → 13 sigma points


class PoseErrorStateWithMarker(NamedTuple):
    """``MTK_BUILD_MANIFOLD(FilterStateWithMarker, ...)``
    (``IndirectPoseUKF.cpp:26-30``), flattened: product manifolds compose by
    field concatenation, so nesting the sub-manifold is layout-identical."""

    position_error: jax.Array
    orientation_error: jax.Array
    marker_position: jax.Array  # (3,)
    marker_orientation: jax.Array  # (4,)


MARKER_MANIFOLD = mf.make_manifold(
    mf.Field("position_error", "vec", 3),
    mf.Field("orientation_error", "so3"),
    mf.Field("marker_position", "vec", 3),
    mf.Field("marker_orientation", "so3"),
)  # DOF = 12 → 25 sigma points


class IndirectPoseUKFParams(NamedTuple):
    orientation_error_tau: jax.Array  # scalar [s]
    process_noise: jax.Array  # (6,6)


class IndirectPoseUKFState(NamedTuple):
    mu: PoseErrorState
    cov: jax.Array  # (6,6)
    pose_ref_position: jax.Array  # (3,) body-in-world reference pose
    pose_ref_orientation: jax.Array  # (4,)


def init(
    position_error_std,
    orientation_error_std,
    orientation_error_tau: float,
    initial_position_error=None,
    initial_position_error_std=None,
    dtype=jnp.float64,
) -> tuple[IndirectPoseUKFState, IndirectPoseUKFParams]:
    """Constructor semantics of ``IndirectPoseUKF.cpp:53-78``: initial cov from
    the *initial* stds, process noise from the per-step stds."""
    pes = jnp.asarray(position_error_std, dtype=dtype)
    oes = jnp.asarray(orientation_error_std, dtype=dtype)
    ipe = (
        jnp.zeros(3, dtype=dtype)
        if initial_position_error is None
        else jnp.asarray(initial_position_error, dtype=dtype)
    )
    ipes = (
        jnp.ones(3, dtype=dtype)
        if initial_position_error_std is None
        else jnp.asarray(initial_position_error_std, dtype=dtype)
    )

    cov = jnp.zeros((6, 6), dtype=dtype)
    cov = cov.at[:3, :3].set(jnp.diag(ipes**2))
    cov = cov.at[3:, 3:].set(jnp.diag(oes**2))

    q = jnp.zeros((6, 6), dtype=dtype)
    q = q.at[:3, :3].set(jnp.diag(pes**2))
    q = q.at[3:, 3:].set(jnp.diag(oes**2))

    state = IndirectPoseUKFState(
        mu=PoseErrorState(position_error=ipe, orientation_error=mf.quat_identity(dtype)),
        cov=cov,
        pose_ref_position=jnp.zeros(3, dtype=dtype),
        pose_ref_orientation=mf.quat_identity(dtype),
    )
    return state, IndirectPoseUKFParams(
        orientation_error_tau=jnp.asarray(orientation_error_tau, dtype=dtype), process_noise=q
    )


def predict(state: IndirectPoseUKFState, params: IndirectPoseUKFParams, dt) -> IndirectPoseUKFState:
    """``IndirectPoseUKF::predictionStepImpl`` (``IndirectPoseUKF.cpp:80-92``):
    orientation-error noise is Markov-scaled 2/(τ·dt), rotated into the error
    frame, then the whole Q scaled by dt²; the process model decays the
    orientation error through its log (position error is a random walk)."""
    rot = mf.quat_to_matrix(state.mu.orientation_error)
    q = params.process_noise
    q_orient = mm(rot, (2.0 / (params.orientation_error_tau * dt)) * q[3:, 3:], rot.T)
    q = q.at[3:, 3:].set(q_orient)
    q = dt**2 * q

    tau = params.orientation_error_tau

    def f(chi: PoseErrorState) -> PoseErrorState:
        delta = (-1.0 / tau) * mf.quat_log(chi.orientation_error)
        return chi._replace(orientation_error=mf.so3_boxplus(chi.orientation_error, delta, dt))

    mu, cov = ukf.predict(ERROR_MANIFOLD, state.mu, state.cov, f, q)
    return state._replace(mu=mu, cov=cov)


def pixel_to_s2(pixel: jax.Array, cam: CameraConfiguration) -> jax.Array:
    """Undistorted pixel → S² bearing via the pinhole model
    (``IndirectPoseUKF.cpp:119-121``, identically ``src/PoseUKF.cpp:638-640``)."""
    v = jnp.stack(
        [
            (pixel[0] - cam.cx) / cam.fx,
            (pixel[1] - cam.cy) / cam.fy,
            jnp.ones((), dtype=pixel.dtype),
        ]
    )
    return mf.s2_normalize(v)


def pixel_cov_to_s2(pixel_cov: jax.Array, cam: CameraConfiguration) -> jax.Array:
    """Pixel covariance → tangent covariance scaling (``IndirectPoseUKF.cpp:122-124``):
    divide by fx², fy², fx·fy."""
    scale = jnp.asarray(
        [[cam.fx * cam.fx, cam.fx * cam.fy], [cam.fx * cam.fy, cam.fy * cam.fy]],
        dtype=pixel_cov.dtype,
    )
    return pixel_cov / scale


def _visual_landmark_measurement(
    chi: PoseErrorStateWithMarker,
    feature_pos: jax.Array,
    cam_q: jax.Array,
    cam_p: jax.Array,
    ref_q: jax.Array,
    ref_p: jax.Array,
) -> jax.Array:
    """``measurementVisualLandmark`` (``IndirectPoseUKF.cpp:38-50``):
    feature → nav → camera frame → S² bearing, with the pose error composed
    between the reference pose and the camera extrinsics."""
    body_q, body_p = mf.affine_mul(ref_q, ref_p, chi.orientation_error, chi.position_error)
    cam_in_nav_q, cam_in_nav_p = mf.affine_mul(body_q, body_p, cam_q, cam_p)
    nav_in_cam_q, nav_in_cam_p = mf.affine_inv(cam_in_nav_q, cam_in_nav_p)
    feature_in_nav = mf.affine_apply(chi.marker_orientation, chi.marker_position, feature_pos)
    feature_in_cam = mf.affine_apply(nav_in_cam_q, nav_in_cam_p, feature_in_nav)
    return mf.s2_normalize(feature_in_cam)


def update_markers(
    state: IndirectPoseUKFState,
    marker_features: jax.Array,  # (K,2) pixel coordinates
    feature_covs: jax.Array,  # (K,2,2) pixel covariances
    feature_positions: jax.Array,  # (K,3) in the marker frame
    marker_position: jax.Array,  # (3,) marker pose in nav/world frame
    marker_orientation: jax.Array,  # (4,)
    cov_marker_pose: jax.Array,  # (6,6)
    camera: CameraConfiguration,
    camera_in_body_position: jax.Array,
    camera_in_body_orientation: jax.Array,
) -> tuple[IndirectPoseUKFState, ukf.UpdateInfo]:
    """Visual-marker update with state augmentation
    (``IndirectPoseUKF.cpp:94-135``): augment with the marker pose (12-DOF
    fixed-shape filter), apply one S² update per feature, marginalize back.
    Returns the per-feature ``UpdateInfo`` stacked along a leading (K,) axis
    so an outlier corner stays visible in the NIS record."""
    k = marker_features.shape[0]
    if k == 0:
        raise ValueError("update_markers needs at least one feature")
    if feature_positions.shape[0] != k or feature_covs.shape[0] != k:
        # JAX would silently CLAMP an out-of-range feature_positions[i] to the
        # last row, matching features against the wrong 3D corner — fail loudly
        raise ValueError(
            f"{k} marker_features but {feature_positions.shape[0]} feature_positions "
            f"/ {feature_covs.shape[0]} feature_covs"
        )
    aug_mu = PoseErrorStateWithMarker(
        position_error=state.mu.position_error,
        orientation_error=state.mu.orientation_error,
        marker_position=marker_position,
        marker_orientation=marker_orientation,
    )
    n = MARKER_MANIFOLD.dof
    aug_cov = jnp.zeros((n, n), dtype=state.cov.dtype)
    aug_cov = aug_cov.at[:6, :6].set(state.cov)
    aug_cov = aug_cov.at[6:, 6:].set(cov_marker_pose)

    infos = []
    for i in range(k):  # K is static (typically 4 corners) — unrolled under jit
        z = pixel_to_s2(marker_features[i], camera)
        r = pixel_cov_to_s2(feature_covs[i], camera)

        def h(chi, fp=feature_positions[i]):
            return _visual_landmark_measurement(
                chi,
                fp,
                camera_in_body_orientation,
                camera_in_body_position,
                state.pose_ref_orientation,
                state.pose_ref_position,
            )

        aug_mu, aug_cov, info = ukf.update(
            MARKER_MANIFOLD, aug_mu, aug_cov, z, h, r, meas_manifold=mf.S2_MANIFOLD
        )
        infos.append(info)

    # marginalize the marker block back out (IndirectPoseUKF.cpp:134)
    new_mu = PoseErrorState(
        position_error=aug_mu.position_error, orientation_error=aug_mu.orientation_error
    )
    info_all = jax.tree_util.tree_map(lambda *xs: jnp.stack(xs), *infos)
    return state._replace(mu=new_mu, cov=aug_cov[:6, :6]), info_all


# ---------------------------------------------------------------------------
# Bank-level entry points. ``update_pose_reference`` already works bankwide
# (pure _replace).
# ---------------------------------------------------------------------------


def predict_bank(
    bstate: IndirectPoseUKFState,
    params: IndirectPoseUKFParams,
    dt,
) -> IndirectPoseUKFState:
    """Bank-level prediction, ``vmap(predict)``. Banked parameters (leading
    bank axis on ``process_noise`` or a per-instance
    ``orientation_error_tau`` — Monte-Carlo sweeps) are vmapped alongside."""
    banked = params.process_noise.ndim == 3 or params.orientation_error_tau.ndim == 1
    if banked:
        nb = bstate.cov.shape[0]
        pb = IndirectPoseUKFParams(
            orientation_error_tau=jnp.broadcast_to(params.orientation_error_tau, (nb,)),
            process_noise=jnp.broadcast_to(
                params.process_noise, (nb, *params.process_noise.shape[-2:])
            ),
        )
        return jax.vmap(lambda s, p: predict(s, p, dt))(bstate, pb)
    return jax.vmap(lambda s: predict(s, params, dt))(bstate)


def update_markers_bank(
    bstate: IndirectPoseUKFState,
    marker_features,
    feature_covs,
    feature_positions,
    marker_position,
    marker_orientation,
    cov_marker_pose,
    camera: CameraConfiguration,
    camera_in_body_position,
    camera_in_body_orientation,
):
    """Bank-level visual-marker update. ``marker_features``/``feature_covs``
    may be shared ``(K, ...)`` or per-instance ``(B, K, ...)``, and so may the
    marker-pose prior mean (``(3,)``/``(4,)`` or ``(B, ·)``)."""
    nb = bstate.cov.shape[0]
    dtype = bstate.cov.dtype
    feats = jnp.asarray(marker_features, dtype)
    if feats.ndim == 2:
        feats = jnp.broadcast_to(feats[None], (nb, *feats.shape))
    k = feats.shape[1]
    fcovs = jnp.broadcast_to(jnp.asarray(feature_covs, dtype), (nb, k, 2, 2))
    mpos = jnp.broadcast_to(jnp.asarray(marker_position, dtype), (nb, 3))
    mrot = jnp.broadcast_to(jnp.asarray(marker_orientation, dtype), (nb, 4))

    def one(s, f, fc, mp, mr):
        return update_markers(
            s, f, fc, jnp.asarray(feature_positions, dtype), mp, mr,
            jnp.asarray(cov_marker_pose, dtype), camera,
            jnp.asarray(camera_in_body_position, dtype),
            jnp.asarray(camera_in_body_orientation, dtype),
        )

    return jax.vmap(one)(bstate, feats, fcovs, mpos, mrot)


def update_pose_reference(
    state: IndirectPoseUKFState, position: jax.Array, orientation: jax.Array
) -> IndirectPoseUKFState:
    """``updatePoseReference`` (``IndirectPoseUKF.cpp:144-147``)."""
    return state._replace(pose_ref_position=position, pose_ref_orientation=orientation)


def corrected_pose(state: IndirectPoseUKFState) -> tuple[jax.Array, jax.Array]:
    """``getCorrectedPose`` (``IndirectPoseUKF.cpp:137-142``):
    corrected = reference ∘ error. Returns (orientation, position)."""
    q, p = mf.affine_mul(
        state.pose_ref_orientation,
        state.pose_ref_position,
        state.mu.orientation_error,
        state.mu.position_error,
    )
    return q, p


class IndirectPoseUKF:
    """Object-style wrapper mirroring ``IndirectPoseUKF.hpp:29-83``."""

    def __init__(
        self,
        position_error_std,
        orientation_error_std,
        orientation_error_tau,
        initial_position_error=None,
        initial_position_error_std=None,
    ):
        self.state, self.params = init(
            position_error_std,
            orientation_error_std,
            orientation_error_tau,
            initial_position_error,
            initial_position_error_std,
        )

    def prediction_step(self, dt: float) -> None:
        self.state = predict(self.state, self.params, dt)

    def set_process_noise_covariance(self, q) -> None:
        """Raw-Q setter of the filter base class (``setProcessNoiseCovariance``)."""
        self.params = self.params._replace(process_noise=jnp.asarray(q))

    def update_pose_reference(self, position, orientation) -> None:
        self.state = update_pose_reference(
            self.state, jnp.asarray(position), jnp.asarray(orientation)
        )

    def integrate_marker_measurement(
        self,
        marker_features,
        feature_covs,
        feature_positions,
        marker_position,
        marker_orientation,
        cov_marker_pose,
        camera: CameraConfiguration,
        camera_in_body_position,
        camera_in_body_orientation,
    ) -> ukf.UpdateInfo:
        for i in range(len(marker_features)):
            check_measurement(marker_features[i], feature_covs[i])
        self.state, info = update_markers(
            self.state,
            jnp.asarray(marker_features),
            jnp.asarray(feature_covs),
            jnp.asarray(feature_positions),
            jnp.asarray(marker_position),
            jnp.asarray(marker_orientation),
            jnp.asarray(cov_marker_pose),
            camera,
            jnp.asarray(camera_in_body_position),
            jnp.asarray(camera_in_body_orientation),
        )
        return info

    def get_corrected_pose(self):
        return corrected_pose(self.state)

    @property
    def mu(self) -> PoseErrorState:
        return self.state.mu

    @property
    def sigma(self) -> jax.Array:
        return self.state.cov

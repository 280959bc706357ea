"""Manifold algebra for banked unscented Kalman filtering in JAX.

This module is the JAX equivalent of the MTK manifold layer used by
the reference C++ library (``mtk/types/SOn.hpp``, ``mtk/types/S2.hpp``,
``mtk/types/vect.hpp``, ``mtk/build_manifold.hpp``; consumed by the reference at
``/root/reference/src/PoseState.hpp:4-10`` and ``src/BottomUKF.hpp:7-10``).

Conventions (pinned by oracle tests in ``tests/test_manifolds.py``):

* Quaternions are stored as ``[w, x, y, z]`` arrays of shape ``(4,)``.
* SO(3): ``q ⊞ δ = q ⊗ Exp(δ·scale)`` (right/local perturbation) and
  ``a ⊟ b = Log(b⁻¹ ⊗ a)``, matching MTK's ``SOn::boxplus`` /
  ``SOn::boxminus`` semantics exercised throughout the reference
  (e.g. ``src/PoseUKF.cpp:25,32,35``, ``src/IndirectPoseUKF.cpp:15``).
* S²: points are unit 3-vectors. ``x ⊞ δ`` follows the sphere exponential map
  in an orthonormal tangent basis ``B(x)``; ``y ⊟ x = B(x)ᵀ·Log_x(y)``.
  The reference uses ``MTK::S2<double>`` for the seafloor normal
  (``src/BottomUKF.hpp:16``) and for visual-feature bearings
  (``src/PoseUKF.cpp:231-243``).
* Flat fields (``MTK::vect<N>``): ``⊞`` is addition, ``⊟`` subtraction.
* 3×3 matrix fields (``MTK::matrix<3,3>``): 9-DOF with *column-major*
  vectorization, matching the covariance layout documented at
  ``src/PoseState.hpp:37-39`` and the ``Eigen::Map`` of ``.data()`` at
  ``src/PoseUKF.cpp:45-55``.
* Product manifolds concatenate per-field tangent vectors in declaration
  order, reproducing ``MTK_BUILD_MANIFOLD``'s covariance block layout
  (``src/PoseState.hpp:29-45``) so that ``MTK::subblock`` offsets carry over.

Everything here is pure, jittable, vmappable and dtype-polymorphic (f64 for
bit-accuracy oracles on CPU, f32 for accelerator throughput).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Sequence

import jax
import jax.numpy as jnp

from .linalg_small import mm

__all__ = [
    "quat_identity",
    "quat_normalize",
    "quat_mul",
    "quat_conj",
    "quat_rotate",
    "quat_rotate_inv",
    "quat_exp",
    "quat_log",
    "quat_to_matrix",
    "quat_from_matrix",
    "so3_boxplus",
    "so3_boxminus",
    "s2_normalize",
    "s2_tangent_basis",
    "s2_boxplus",
    "s2_boxminus",
    "Field",
    "ProductManifold",
    "make_manifold",
]

# ---------------------------------------------------------------------------
# Quaternion / SO(3) algebra. Layout: q = [w, x, y, z].
# ---------------------------------------------------------------------------


def quat_identity(dtype=jnp.float64) -> jax.Array:
    return jnp.array([1.0, 0.0, 0.0, 0.0], dtype=dtype)


def quat_normalize(q: jax.Array) -> jax.Array:
    return q / jnp.linalg.norm(q)


def quat_mul(q: jax.Array, p: jax.Array) -> jax.Array:
    """Hamilton product q ⊗ p (both [w,x,y,z])."""
    qw, qx, qy, qz = q[0], q[1], q[2], q[3]
    pw, px, py, pz = p[0], p[1], p[2], p[3]
    return jnp.stack(
        [
            qw * pw - qx * px - qy * py - qz * pz,
            qw * px + qx * pw + qy * pz - qz * py,
            qw * py - qx * pz + qy * pw + qz * px,
            qw * pz + qx * py - qy * px + qz * pw,
        ]
    )


def quat_conj(q: jax.Array) -> jax.Array:
    """Conjugate == inverse for unit quaternions."""
    return q * jnp.array([1.0, -1.0, -1.0, -1.0], dtype=q.dtype)


def quat_rotate(q: jax.Array, v: jax.Array) -> jax.Array:
    """Rotate vector v by quaternion q: R(q)·v.

    Uses the expanded Rodrigues form (no intermediate quaternion products),
    which XLA fuses into a handful of FMAs on the VPU.
    """
    w, u = q[0], q[1:4]
    t = 2.0 * jnp.cross(u, v)
    return v + w * t + jnp.cross(u, t)


def quat_rotate_inv(q: jax.Array, v: jax.Array) -> jax.Array:
    """R(q)⁻¹·v == R(q⁻¹)·v."""
    return quat_rotate(quat_conj(q), v)


def _sinc_half(theta2: jax.Array) -> jax.Array:
    """sin(θ/2)/θ with a Taylor fallback for small θ (θ² given)."""
    theta = jnp.sqrt(theta2)
    small = theta2 < 1e-12
    # Taylor: sin(θ/2)/θ = 1/2 − θ²/48 + O(θ⁴)
    taylor = 0.5 - theta2 / 48.0
    # Guard the division so both branches are NaN-free under jnp.where.
    safe_theta = jnp.where(small, jnp.ones_like(theta), theta)
    exact = jnp.sin(0.5 * safe_theta) / safe_theta
    return jnp.where(small, taylor, exact)


def quat_exp(v: jax.Array) -> jax.Array:
    """Exponential map: rotation vector (3,) → unit quaternion.

    Exp(v) = [cos(|v|/2), sin(|v|/2)·v/|v|], Taylor-expanded near |v|=0.
    Matches MTK's ``SOn::exp`` half-angle convention.
    """
    theta2 = mm(v, v)
    w = jnp.cos(0.5 * jnp.sqrt(theta2))
    xyz = _sinc_half(theta2) * v
    return jnp.concatenate([w[None], xyz])


def quat_log(q: jax.Array) -> jax.Array:
    """Log map: unit quaternion → rotation vector (3,), |result| ≤ π.

    Sign-canonicalizes to the hemisphere w ≥ 0 first (shortest arc), the same
    convention MTK's ``SOn::log`` uses.
    """
    q = jnp.where(q[0] < 0.0, -q, q)
    w = jnp.clip(q[0], -1.0, 1.0)
    xyz = q[1:4]
    n2 = mm(xyz, xyz)
    n = jnp.sqrt(n2)
    theta = 2.0 * jnp.arctan2(n, w)
    small = n2 < 1e-24
    safe_n = jnp.where(small, jnp.ones_like(n), n)
    # θ/|xyz| → 2/w as |xyz| → 0
    scale = jnp.where(small, 2.0 / jnp.maximum(w, 1e-6), theta / safe_n)
    return scale * xyz


def quat_to_matrix(q: jax.Array) -> jax.Array:
    """Unit quaternion → 3×3 rotation matrix."""
    w, x, y, z = q[0], q[1], q[2], q[3]
    xx, yy, zz = x * x, y * y, z * z
    xy, xz, yz = x * y, x * z, y * z
    wx, wy, wz = w * x, w * y, w * z
    return jnp.array(
        [
            [1 - 2 * (yy + zz), 2 * (xy - wz), 2 * (xz + wy)],
            [2 * (xy + wz), 1 - 2 * (xx + zz), 2 * (yz - wx)],
            [2 * (xz - wy), 2 * (yz + wx), 1 - 2 * (xx + yy)],
        ]
    )


def quat_from_matrix(m: jax.Array) -> jax.Array:
    """3×3 rotation matrix → unit quaternion [w,x,y,z] (branch-free).

    Computes all four Shepperd candidates and selects the best-conditioned
    one with ``where`` masks (jit/vmap friendly, no data-dependent branches).
    """
    m00, m01, m02 = m[0, 0], m[0, 1], m[0, 2]
    m10, m11, m12 = m[1, 0], m[1, 1], m[1, 2]
    m20, m21, m22 = m[2, 0], m[2, 1], m[2, 2]
    tr = m00 + m11 + m22

    def safe_sqrt(x):
        return jnp.sqrt(jnp.maximum(x, 1e-30))

    # candidate 0: trace-dominant
    s0 = safe_sqrt(1.0 + tr) * 2.0
    q0 = jnp.stack([0.25 * s0, (m21 - m12) / s0, (m02 - m20) / s0, (m10 - m01) / s0])
    # candidate 1: m00 dominant
    s1 = safe_sqrt(1.0 + m00 - m11 - m22) * 2.0
    q1 = jnp.stack([(m21 - m12) / s1, 0.25 * s1, (m01 + m10) / s1, (m02 + m20) / s1])
    # candidate 2: m11 dominant
    s2 = safe_sqrt(1.0 - m00 + m11 - m22) * 2.0
    q2 = jnp.stack([(m02 - m20) / s2, (m01 + m10) / s2, 0.25 * s2, (m12 + m21) / s2])
    # candidate 3: m22 dominant
    s3 = safe_sqrt(1.0 - m00 - m11 + m22) * 2.0
    q3 = jnp.stack([(m10 - m01) / s3, (m02 + m20) / s3, (m12 + m21) / s3, 0.25 * s3])

    scores = jnp.stack([tr, m00 - m11 - m22, m11 - m00 - m22, m22 - m00 - m11])
    idx = jnp.argmax(scores)
    q = jnp.stack([q0, q1, q2, q3])[idx]
    q = jnp.where(q[0] < 0, -q, q)
    return quat_normalize(q)


def so3_boxplus(q: jax.Array, delta: jax.Array, scale=1.0) -> jax.Array:
    """q ⊞ δ = q ⊗ Exp(δ·scale); re-normalized for numerical hygiene.

    Matches MTK ``SOn::boxplus`` (right multiplication, local perturbation)
    as invoked with an explicit scale at e.g. ``src/PoseUKF.cpp:32``.
    """
    return quat_normalize(quat_mul(q, quat_exp(delta * scale)))


def so3_boxminus(qa: jax.Array, qb: jax.Array) -> jax.Array:
    """a ⊟ b = Log(b⁻¹ ⊗ a); exact inverse of so3_boxplus."""
    return quat_log(quat_mul(quat_conj(qb), qa))


# ---------------------------------------------------------------------------
# S² unit-sphere manifold (2 DOF), stored as a unit 3-vector.
# ---------------------------------------------------------------------------


def s2_normalize(x: jax.Array) -> jax.Array:
    return x / jnp.linalg.norm(x)


def s2_tangent_basis(x: jax.Array) -> jax.Array:
    """Orthonormal tangent basis B(x) ∈ R^{3×2} at unit vector x.

    Built from the Householder reflection H mapping e₃ → ±x (sign chosen by
    the dominant hemisphere so the construction is smooth away from a single
    measure-zero set): the first two columns of H span the tangent plane.
    Deterministic, branch-free, jit/vmap friendly.
    """
    sign = jnp.where(x[2] >= 0.0, 1.0, -1.0).astype(x.dtype)
    e3 = jnp.array([0.0, 0.0, 1.0], dtype=x.dtype)
    # v = x_s − e₃ with x_s = sign·x;   H = I − 2 vvᵀ/|v|² maps e₃ → x_s.
    # The sign stabilizes the reflection (|v| stays away from 0 ⇔ x_s·e₃ ≥ 0).
    xs = sign * x
    v = xs - e3
    v2 = mm(v, v)
    safe_v2 = jnp.where(v2 < 1e-24, jnp.ones_like(v2), v2)
    H = jnp.eye(3, dtype=x.dtype) - 2.0 * jnp.outer(v, v) / safe_v2
    H = jnp.where(v2 < 1e-24, jnp.eye(3, dtype=x.dtype), H)
    # Columns 0,1 of the orthogonal H are orthonormal and ⟂ H·e₃ = x_s = ±x,
    # hence an orthonormal basis of the tangent plane at x. Handedness is
    # irrelevant: boxplus/boxminus always use the same basis at the same x.
    return H[:, :2]


def s2_boxplus(x: jax.Array, delta: jax.Array, scale=1.0) -> jax.Array:
    """Sphere exponential map: x ⊞ δ = cos(|v|)·x + sin(|v|)·v/|v|, v = B(x)·δ·scale."""
    v = mm(s2_tangent_basis(x), delta * scale)
    theta2 = mm(v, v)
    theta = jnp.sqrt(theta2)
    small = theta2 < 1e-24
    safe_theta = jnp.where(small, jnp.ones_like(theta), theta)
    # sin(θ)/θ with Taylor fallback
    sinc = jnp.where(small, 1.0 - theta2 / 6.0, jnp.sin(safe_theta) / safe_theta)
    y = jnp.cos(theta) * x + sinc * v
    return s2_normalize(y)


def s2_boxminus(y: jax.Array, x: jax.Array) -> jax.Array:
    """y ⊟ x = B(x)ᵀ·Log_x(y) ∈ R², exact inverse of s2_boxplus for θ < π.

    Log_x(y) = θ·u where θ = atan2(|x×y|, x·y) and u is the unit tangent at x
    toward y. At the antipode (θ = π) the direction is ill-defined; we return
    a fixed tangent direction of magnitude π there.
    """
    c = jnp.cross(x, y)
    s = jnp.linalg.norm(c)
    d = mm(x, y)
    theta = jnp.arctan2(s, d)
    # tangential component of y at x
    t = y - d * x
    tn = jnp.linalg.norm(t)
    small = tn < 1e-12
    safe_tn = jnp.where(small, jnp.ones_like(tn), tn)
    u = t / safe_tn
    # near θ=0: delta → 0. near θ=π: pick B(x)[:,0] as the direction.
    b = s2_tangent_basis(x)
    u = jnp.where(small, jnp.where(d > 0.0, jnp.zeros_like(x), b[:, 0]), u)
    v = theta * u
    return mm(b.T, v)


# ---------------------------------------------------------------------------
# Product manifolds (the MTK_BUILD_MANIFOLD equivalent).
# ---------------------------------------------------------------------------

_KIND_VEC = "vec"
_KIND_SO3 = "so3"
_KIND_S2 = "s2"
_KIND_MAT33 = "mat33"

_VALID_KINDS = (_KIND_VEC, _KIND_SO3, _KIND_S2, _KIND_MAT33)


@dataclasses.dataclass(frozen=True)
class Field:
    """One component of a product manifold.

    kind:
      * ``vec``   — flat ℝᵈⁱᵐ (``MTK::vect<dim>``); array shape ``(dim,)``
      * ``so3``   — rotation, 3 DOF; array = quaternion ``(4,)`` [w,x,y,z]
      * ``s2``    — unit sphere, 2 DOF; array = unit vector ``(3,)``
      * ``mat33`` — 3×3 matrix, 9 DOF *column-major* (``MTK::matrix<3,3>``,
                    layout per ``src/PoseState.hpp:37-39``); array ``(3,3)``
    """

    name: str
    kind: str
    dim: int = 0

    def __post_init__(self):
        if self.kind not in _VALID_KINDS:
            raise ValueError(f"unknown manifold field kind: {self.kind!r}")
        dof = {"so3": 3, "s2": 2, "mat33": 9}.get(self.kind, self.dim)
        if self.kind == _KIND_VEC and self.dim <= 0:
            raise ValueError(f"vec field {self.name!r} needs dim > 0")
        object.__setattr__(self, "dim", dof)


def _field_boxplus(field: Field, value, delta, scale):
    if field.kind == _KIND_VEC:
        return value + scale * delta
    if field.kind == _KIND_SO3:
        return so3_boxplus(value, delta, scale)
    if field.kind == _KIND_S2:
        return s2_boxplus(value, delta, scale)
    if field.kind == _KIND_MAT33:
        # column-major vectorization: reshape(3,3).T maps δ[3*c+r] onto (r,c)
        return value + scale * delta.reshape(3, 3).T
    raise AssertionError(field.kind)


def _field_boxminus(field: Field, a, b):
    if field.kind == _KIND_VEC:
        return a - b
    if field.kind == _KIND_SO3:
        return so3_boxminus(a, b)
    if field.kind == _KIND_S2:
        return s2_boxminus(a, b)
    if field.kind == _KIND_MAT33:
        return (a - b).T.reshape(9)
    raise AssertionError(field.kind)


class ProductManifold:
    """Product manifold over the fields of a NamedTuple-like pytree.

    The state pytree must expose one attribute per field (``getattr``) and a
    ``_replace(**kw)`` method — any ``typing.NamedTuple`` qualifies. Tangent
    vectors are flat ``(dof,)`` arrays with per-field slices in declaration
    order, reproducing ``MTK_BUILD_MANIFOLD``'s covariance layout so that the
    reference's ``MTK::subblock`` offsets (``src/PoseUKF.cpp:323-342``) map
    directly to slices of our covariance matrices.
    """

    def __init__(self, fields: Sequence[Field]):
        self.fields = tuple(fields)
        self.slices: list[tuple[int, int]] = []
        off = 0
        for f in self.fields:
            self.slices.append((off, f.dim))
            off += f.dim
        self.dof = off
        self.is_euclidean = all(f.kind in (_KIND_VEC, _KIND_MAT33) for f in self.fields)

    # -- core ops -----------------------------------------------------------

    def boxplus(self, x: Any, delta: jax.Array, scale=1.0) -> Any:
        """x ⊞ (scale·δ) with δ of shape (dof,)."""
        updates = {}
        for f, (start, dim) in zip(self.fields, self.slices):
            updates[f.name] = _field_boxplus(
                f, getattr(x, f.name), delta[start : start + dim], scale
            )
        return x._replace(**updates)

    def boxminus(self, a: Any, b: Any) -> jax.Array:
        """a ⊟ b → (dof,) tangent vector at b."""
        parts = [
            _field_boxminus(f, getattr(a, f.name), getattr(b, f.name)) for f in self.fields
        ]
        return jnp.concatenate([jnp.ravel(p) for p in parts])

    def block(self, name: str) -> slice:
        """Covariance slice of a field — the ``MTK::subblock`` equivalent."""
        for f, (start, dim) in zip(self.fields, self.slices):
            if f.name == name:
                return slice(start, start + dim)
        raise KeyError(name)

    # -- manifold mean (ukfom's iterative sigma-point mean) ------------------

    def mean(self, points: Any, *, max_iters: int = 64, tol: float = 1e-12) -> Any:
        """Equal-weight manifold mean of points stacked on a leading axis.

        Reproduces ukfom's iterative boxminus mean: start from points[0],
        repeat ``m ← m ⊞ avgᵢ(pᵢ ⊟ m)`` until the correction norm drops below
        ``tol`` (or ``max_iters``). Euclidean fields converge in one step and
        are averaged in closed form; only curved fields (SO(3), S²) iterate —
        per-field iteration is exactly equivalent to ukfom's joint iteration
        because product-manifold ⊞/⊟ act field-wise.
        """
        updates = {}
        for f in self.fields:
            vals = getattr(points, f.name)
            if f.kind in (_KIND_VEC, _KIND_MAT33):
                updates[f.name] = jnp.mean(vals, axis=0)
            elif f.kind == _KIND_SO3:
                updates[f.name] = _iterative_mean(
                    vals, so3_boxplus, so3_boxminus, max_iters=max_iters, tol=tol
                )
            elif f.kind == _KIND_S2:
                updates[f.name] = _iterative_mean(
                    vals, s2_boxplus, s2_boxminus, max_iters=max_iters, tol=tol
                )
        return points._replace(**updates) if hasattr(points, "_replace") else updates


def _iterative_mean(vals, boxplus, boxminus, *, max_iters: int, tol: float):
    """Iterative Karcher-style mean on a single curved field.

    vals: (K, ...) stacked points. Returns the manifold mean starting from
    vals[0] (ukfom convention).
    """
    v0 = vals[0]

    def cond(carry):
        _, delta_norm, it = carry
        return jnp.logical_and(delta_norm > tol, it < max_iters)

    def body(carry):
        m, _, it = carry
        deltas = jax.vmap(lambda v: boxminus(v, m))(vals)
        delta = jnp.mean(deltas, axis=0)
        m2 = boxplus(m, delta)
        return m2, jnp.linalg.norm(delta), it + 1

    init = (v0, jnp.array(jnp.inf, dtype=vals.dtype), jnp.array(0, dtype=jnp.int32))
    m, _, _ = jax.lax.while_loop(cond, body, init)
    return m


def make_manifold(*fields: Field) -> ProductManifold:
    return ProductManifold(fields)


# ---------------------------------------------------------------------------
# Rigid transforms (quaternion, translation) — the Eigen::Affine3d idiom of
# the reference's marker updates (src/PoseUKF.cpp:237-241,
# src/IndirectPoseUKF.cpp:42-47) without matrix round-trips.
# ---------------------------------------------------------------------------


def quat_from_euler_zyx(roll, pitch, yaw) -> jax.Array:
    """(roll, pitch, yaw) → quaternion, R = Rz(yaw)·Ry(pitch)·Rx(roll).

    The intrinsic ZYX (yaw-pitch-roll) convention used by ROCK's base types
    for e.g. ``VisualLandmark::marker_euler_orientation``
    (``src/PoseUKFConfig.hpp:119-120``).
    """
    hr, hp, hy = 0.5 * jnp.asarray(roll), 0.5 * jnp.asarray(pitch), 0.5 * jnp.asarray(yaw)
    cr, sr = jnp.cos(hr), jnp.sin(hr)
    cp, sp = jnp.cos(hp), jnp.sin(hp)
    cy, sy = jnp.cos(hy), jnp.sin(hy)
    return jnp.stack(
        [
            cy * cp * cr + sy * sp * sr,
            cy * cp * sr - sy * sp * cr,
            cy * sp * cr + sy * cp * sr,
            sy * cp * cr - cy * sp * sr,
        ]
    )


def affine_mul(qa: jax.Array, pa: jax.Array, qb: jax.Array, pb: jax.Array):
    """(qa,pa) ∘ (qb,pb): compose rigid transforms a·b."""
    return quat_mul(qa, qb), pa + quat_rotate(qa, pb)


def affine_inv(q: jax.Array, p: jax.Array):
    """(q,p)⁻¹."""
    qi = quat_conj(q)
    return qi, -quat_rotate(qi, p)


def affine_apply(q: jax.Array, p: jax.Array, v: jax.Array) -> jax.Array:
    """(q,p)·v = R(q)v + p."""
    return quat_rotate(q, v) + p


class S2Direct:
    """Measurement-manifold adapter for bare S² unit vectors (no pytree).

    The reference passes S² values directly as measurements — the seafloor
    normal (``src/BottomUKF.cpp:63-67``) and pixel-bearing visual features
    (``src/PoseUKF.cpp:638-648``). This exposes the subset of the
    ProductManifold interface that ``ops.ukf.update`` needs for such values.
    """

    dof = 2

    @staticmethod
    def boxminus(a: jax.Array, b: jax.Array) -> jax.Array:
        return s2_boxminus(a, b)

    @staticmethod
    def boxplus(x: jax.Array, delta: jax.Array, scale=1.0) -> jax.Array:
        return s2_boxplus(x, delta, scale)

    @staticmethod
    def mean(points: jax.Array, *, max_iters: int = 64, tol: float = 1e-12) -> jax.Array:
        return _iterative_mean(points, s2_boxplus, s2_boxminus, max_iters=max_iters, tol=tol)


S2_MANIFOLD = S2Direct()

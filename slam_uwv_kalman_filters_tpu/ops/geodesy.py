"""Geodesy and earth models — the ``pose_estimation`` geographic layer, in JAX.

JAX replacements for the external components the reference pulls from
``pose_estimation`` (rock-slam):

* ``GeographicProjection(lat0, lon0)`` with ``navToWorld``/``worldToNav``
  (called *inside* the PoseUKF process model, ``/root/reference/src/PoseUKF.cpp:29,573,696``,
  so it must be jittable) — implemented as a local-tangent-plane (NWU:
  x=North, y=West, z=Up) projection on the WGS-84 ellipsoid using the
  meridional/normal curvature radii at the anchor latitude. Within the few-km
  operating envelope of an AUV filter this agrees with the reference's
  projection library to sub-metre precision, and the process model is only
  sensitive to it through cos/sin of latitude (earth-rate terms).
* ``GravitationalModel::WGS_84(lat, alt)`` (``src/PoseUKF.cpp:301``) —
  Somigliana normal gravity with free-air altitude correction.
* ``pose_estimation::EARTHW`` (``src/PoseUKF.cpp:30,697``) — WGS-84 earth
  rotation rate.

All functions are pure and dtype-polymorphic.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

__all__ = [
    "EARTHW",
    "WGS84_A",
    "WGS84_E2",
    "wgs84_gravity",
    "earth_rotation_nav",
    "GeographicProjection",
    "make_projection",
    "nav_to_world",
    "world_to_nav",
]

# WGS-84 defining constants
WGS84_A = 6378137.0  # semi-major axis [m]
WGS84_F = 1.0 / 298.257223563  # flattening
WGS84_E2 = WGS84_F * (2.0 - WGS84_F)  # first eccentricity squared
EARTHW = 7.292115e-5  # earth rotation rate [rad/s] (pose_estimation::EARTHW)

# Somigliana constants (WGS-84 ellipsoidal gravity formula)
_GAMMA_E = 9.7803253359  # gravity at the equator [m/s²]
_SOMIG_K = 1.931852652458e-3
_FREE_AIR = 3.0877e-6  # free-air gradient [s⁻²]
_FREE_AIR_LAT = 4.4e-9  # latitude correction of the gradient [s⁻²]
_FREE_AIR_H2 = 7.2115e-13  # second-order altitude term 3γₑ/a² [1/(m²·s²)]


def wgs84_gravity(latitude: jax.Array, altitude: jax.Array = 0.0) -> jax.Array:
    """Normal gravity on the WGS-84 ellipsoid at (latitude [rad], altitude [m]).

    Somigliana closed form with second-order free-air correction — the
    ``pose_estimation::GravitationalModel::WGS_84`` equivalent
    (``src/PoseUKF.cpp:301``).
    """
    s2 = jnp.sin(latitude) ** 2
    g0 = _GAMMA_E * (1.0 + _SOMIG_K * s2) / jnp.sqrt(1.0 - WGS84_E2 * s2)
    return g0 - (_FREE_AIR - _FREE_AIR_LAT * s2) * altitude + _FREE_AIR_H2 * altitude**2


def earth_rotation_nav(latitude: jax.Array, dtype=None) -> jax.Array:
    """Earth rotation rate vector in the NWU navigation frame.

    ω_e(φ) = Ω·[cos φ, 0, sin φ] — exactly the expression the reference builds
    inline at ``src/PoseUKF.cpp:30`` and ``src/PoseUKF.cpp:697``.
    """
    c, s = jnp.cos(latitude), jnp.sin(latitude)
    zero = jnp.zeros_like(c)
    out = jnp.stack([EARTHW * c, zero, EARTHW * s])
    return out.astype(dtype) if dtype is not None else out


class GeographicProjection(NamedTuple):
    """Anchor of the local NWU tangent-plane projection (a tiny pytree, so it
    can ride inside filter-parameter pytrees and be swept under ``vmap``).

    Fields are the anchor latitude/longitude [rad] and the precomputed
    curvature radii there: ``m_rad`` (meridional) and ``n_rad_cos``
    (normal radius × cos φ₀ = metres per radian of longitude).
    """

    lat0: jax.Array
    lon0: jax.Array
    m_rad: jax.Array
    n_rad_cos: jax.Array


def make_projection(latitude: float, longitude: float, dtype=jnp.float64) -> GeographicProjection:
    """Build the projection anchored at (latitude, longitude) in radians —
    the ``new GeographicProjection(lat0, lon0)`` of ``src/PoseUKF.cpp:356``."""
    lat0 = jnp.asarray(latitude, dtype=dtype)
    lon0 = jnp.asarray(longitude, dtype=dtype)
    s2 = jnp.sin(lat0) ** 2
    w = jnp.sqrt(1.0 - WGS84_E2 * s2)
    m_rad = WGS84_A * (1.0 - WGS84_E2) / w**3  # meridional radius of curvature
    n_rad = WGS84_A / w  # prime-vertical radius of curvature
    return GeographicProjection(lat0=lat0, lon0=lon0, m_rad=m_rad, n_rad_cos=n_rad * jnp.cos(lat0))


def nav_to_world(proj: GeographicProjection, x: jax.Array, y: jax.Array):
    """NWU nav position (x north, y west, metres) → (latitude, longitude) [rad].

    The ``projection->navToWorld`` call of the process model
    (``src/PoseUKF.cpp:29``).
    """
    lat = proj.lat0 + x / proj.m_rad
    lon = proj.lon0 - y / proj.n_rad_cos  # +west ⇒ −east ⇒ decreasing longitude
    return lat, lon


def world_to_nav(proj: GeographicProjection, lat: jax.Array, lon: jax.Array):
    """(latitude, longitude) [rad] → NWU nav position (x north, y west) [m].

    The ``projection->worldToNav`` call of the GPS update
    (``src/PoseUKF.cpp:573``).
    """
    x = (lat - proj.lat0) * proj.m_rad
    y = -(lon - proj.lon0) * proj.n_rad_cos
    return x, y

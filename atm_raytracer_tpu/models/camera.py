"""Camera models: pixel → (elevation, azimuth) ray parameters.

Fast camera (separable): reference src/generator/generators/fast.rs:111-125 —
azimuth depends only on the pixel column, elevation only on the row
(distortion-free near the horizontal for small FoV, README.md:273-279).

Rectilinear camera (true pinhole): reference rectilinear.rs:78-100 /
interpolating_rectilinear.rs:429-451 — per-pixel direction from the
Euler-rotated camera basis; nalgebra's ``from_euler_angles(roll=0,
pitch=-tilt, yaw=direction)`` is R_z(yaw)·R_y(pitch)·R_x(roll) applied to the
camera-frame vector [forward=z_focal, right=x, down→-y].
"""

from __future__ import annotations

from typing import Tuple

import numpy as np


def fast_ray_elevations(width: int, height: int, fov: float, tilt: float) -> np.ndarray:
    """Per-row elevation angle, degrees (fast.rs:111-118). [H] f64."""
    aspect = width / height
    y = (np.arange(height) - height // 2) / height
    return tilt - y * fov / aspect


def fast_ray_azimuths(width: int, height: int, fov: float, direction: float) -> np.ndarray:
    """Per-column azimuth, degrees, NOT wrapped to [0,360) (fast.rs:120-125)."""
    x = (np.arange(width) - width // 2) / width
    return direction + x * fov


def wrap_azimuth_deg(az):
    """Normalize to [0, 360) like fast.rs:67-72."""
    az = np.asarray(az)
    return np.where(az < 0.0, az + 360.0, np.where(az >= 360.0, az - 360.0, az))


def rectilinear_column_azimuths(
    width: int, fov: float, direction: float
) -> np.ndarray:
    """Per-COLUMN azimuth of the tilt-0 pinhole, degrees ([W] f64).

    At pitch 0 the per-pixel direction (rectilinear.rs:78-100) reduces to
    ``direction + atan2(x_off, z_focal)`` — constant down each image column.
    Single source for the fused tilt-0 Rectilinear and its row-sharded
    multi-chip twin, which must stay bit-identical.
    """
    x = (np.arange(width) - width // 2).astype(np.float64)
    z = width / 2.0 / np.tan(np.deg2rad(fov) / 2.0)
    return direction + np.rad2deg(np.arctan2(x, z))


def _euler_zyx(yaw: float, pitch: float) -> np.ndarray:
    """R_z(yaw) @ R_y(pitch) (roll = 0), matching nalgebra from_euler_angles."""
    cy, sy = np.cos(yaw), np.sin(yaw)
    cp, sp = np.cos(pitch), np.sin(pitch)
    rz = np.array([[cy, -sy, 0.0], [sy, cy, 0.0], [0.0, 0.0, 1.0]])
    ry = np.array([[cp, 0.0, sp], [0.0, 1.0, 0.0], [-sp, 0.0, cp]])
    return rz @ ry


import functools


@functools.lru_cache(maxsize=8)
def rectilinear_ray_params(
    width: int, height: int, fov: float, tilt: float, direction: float
) -> Tuple[np.ndarray, np.ndarray]:
    """Per-pixel (elevation_rad [H,W], direction_rad [H,W]) — rectilinear.rs:78-100.

    z = focal length in pixels = (W/2) / tan(fov/2); camera vector
    [z, x_off, -y_off] in [forward, right, up]; rotated by yaw=direction,
    pitch=-tilt; elevation = asin(z'), direction = atan2(y', x').

    Memoized (the camera args are plain floats): ~150 ms of host f64 trig
    per 1080p call otherwise dominates repeat-render walls. Callers must
    not mutate the returned arrays.
    """
    x = (np.arange(width) - width // 2).astype(np.float64)
    y = (np.arange(height) - height // 2).astype(np.float64)
    z = width / 2.0 / np.tan(np.deg2rad(fov) / 2.0)
    rot = _euler_zyx(np.deg2rad(direction), -np.deg2rad(tilt))
    # vector v = (z, x, -y) broadcast over the grid
    vx = np.full((height, width), z)
    vy = np.broadcast_to(x[None, :], (height, width))
    vz = np.broadcast_to(-y[:, None], (height, width))
    v = np.stack([vx, vy, vz], axis=-1)
    v = v / np.linalg.norm(v, axis=-1, keepdims=True)
    d = v @ rot.T
    elevation = np.arcsin(np.clip(d[..., 2], -1.0, 1.0))
    direction_r = np.arctan2(d[..., 1], d[..., 0])
    return elevation, direction_r


def rectilinear_ray_params_device(
    width: int, height: int, fov: float, tilt: float, direction: float
):
    """Device (jnp, f32) twin of ``rectilinear_ray_params``.

    All camera parameters are static Python floats, so this traces into any
    jit for free — renderers use it to derive per-pixel angle grids ON
    device instead of uploading [H, W] arrays from the host (~8 MB per
    grid at 1080p).
    """
    import math as _math

    import jax.numpy as jnp

    x = jnp.arange(width, dtype=jnp.float32) - (width // 2)  # [W]
    y = jnp.arange(height, dtype=jnp.float32) - (height // 2)  # [H]
    z = width / 2.0 / _math.tan(_math.radians(fov) / 2.0)
    yaw = _math.radians(direction)
    pitch = -_math.radians(tilt)
    cy, sy = _math.cos(yaw), _math.sin(yaw)
    cp, sp = _math.cos(pitch), _math.sin(pitch)
    # v = (z, x, -y); d = R_z(yaw) @ R_y(pitch) @ v
    v0 = jnp.float32(z)
    v1 = x[None, :]
    v2 = -y[:, None]
    n = jnp.sqrt(v0 * v0 + v1 * v1 + v2 * v2)  # [H, W]
    a0 = cp * v0 + sp * v2
    a2 = -sp * v0 + cp * v2
    d0 = cy * a0 - sy * v1
    d1 = sy * a0 + cy * v1
    elevation = jnp.arcsin(jnp.clip(a2 / n, -1.0, 1.0))
    direction_r = jnp.arctan2(d1, d0)
    return elevation, direction_r

"""Batched camera models: Pinhole (+ radial-tangential) and Kannala-Brandt8.

JAX-native replacement for the reference's ``src/CameraModels/``
(``GeometricCamera`` interface at
``/root/reference/include/CameraModels/GeometricCamera.h:61-86``:
project / unproject / projectJac / epipolarConstrain / triangulate).

Design: no virtual dispatch — a camera is a small parameter struct plus a
static integer ``kind``; all functions are pure, natively batched over both
cameras and points, and differentiable (analytic jacobians are provided for
the solver hot path, autodiff works everywhere else).

Calibration layout (``Camera.params``, padded to 8 floats):
  * PINHOLE:         [fx, fy, cx, cy, k1, k2, p1, p2]  (k/p optional distortion)
  * KANNALA_BRANDT8: [fx, fy, cx, cy, k1, k2, k3, k4]  (equidistant quartic,
    reference: ``src/CameraModels/KannalaBrandt8.cpp``)
"""

from __future__ import annotations

from typing import NamedTuple

import jax.numpy as jnp

PINHOLE = 0
KANNALA_BRANDT8 = 1

_Z_EPS = 1e-6


class Camera(NamedTuple):
    """Camera intrinsics; a pytree. ``kind`` is static (python int)."""

    params: jnp.ndarray  # [..., 8]
    kind: int = PINHOLE

    @property
    def fx(self):
        return self.params[..., 0]

    @property
    def fy(self):
        return self.params[..., 1]

    @property
    def cx(self):
        return self.params[..., 2]

    @property
    def cy(self):
        return self.params[..., 3]

    def K(self) -> jnp.ndarray:
        """[..., 3, 3] calibration matrix (no distortion)."""
        z = jnp.zeros_like(self.fx)
        o = jnp.ones_like(self.fx)
        k = jnp.stack(
            [self.fx, z, self.cx, z, self.fy, self.cy, z, z, o], axis=-1
        )
        return k.reshape(self.params.shape[:-1] + (3, 3))


def make_pinhole(fx, fy, cx, cy, dist=(0.0, 0.0, 0.0, 0.0)) -> Camera:
    p = jnp.asarray([fx, fy, cx, cy, *dist], jnp.float32)
    return Camera(p, PINHOLE)


def make_kb8(fx, fy, cx, cy, k1, k2, k3, k4) -> Camera:
    p = jnp.asarray([fx, fy, cx, cy, k1, k2, k3, k4], jnp.float32)
    return Camera(p, KANNALA_BRANDT8)


# ---------------------------------------------------------------------------
# projection
# ---------------------------------------------------------------------------

def _project_pinhole(cam: Camera, xc: jnp.ndarray) -> jnp.ndarray:
    z = jnp.where(jnp.abs(xc[..., 2]) < _Z_EPS, _Z_EPS, xc[..., 2])
    x = xc[..., 0] / z
    y = xc[..., 1] / z
    k1, k2 = cam.params[..., 4], cam.params[..., 5]
    p1, p2 = cam.params[..., 6], cam.params[..., 7]
    r2 = x * x + y * y
    radial = 1.0 + k1 * r2 + k2 * r2 * r2
    xd = x * radial + 2.0 * p1 * x * y + p2 * (r2 + 2.0 * x * x)
    yd = y * radial + p1 * (r2 + 2.0 * y * y) + 2.0 * p2 * x * y
    u = cam.fx * xd + cam.cx
    v = cam.fy * yd + cam.cy
    return jnp.stack([u, v], axis=-1)


def _project_kb8(cam: Camera, xc: jnp.ndarray) -> jnp.ndarray:
    # equidistant model: theta = atan2(r, z); d(theta) = th + k1 th^3 + ... k4 th^9
    x, y, z = xc[..., 0], xc[..., 1], xc[..., 2]
    r = jnp.sqrt(jnp.maximum(x * x + y * y, 1e-18))
    theta = jnp.arctan2(r, z)
    t2 = theta * theta
    k1, k2 = cam.params[..., 4], cam.params[..., 5]
    k3, k4 = cam.params[..., 6], cam.params[..., 7]
    d = theta * (1.0 + t2 * (k1 + t2 * (k2 + t2 * (k3 + t2 * k4))))
    scale = d / r
    u = cam.fx * scale * x + cam.cx
    v = cam.fy * scale * y + cam.cy
    return jnp.stack([u, v], axis=-1)


def project(cam: Camera, xc: jnp.ndarray) -> jnp.ndarray:
    """Camera-frame 3D points ``[..., 3]`` -> pixels ``[..., 2]``."""
    if cam.kind == PINHOLE:
        return _project_pinhole(cam, xc)
    return _project_kb8(cam, xc)


# ---------------------------------------------------------------------------
# unprojection (pixel -> unit-depth ray in camera frame)
# ---------------------------------------------------------------------------

def _unproject_pinhole(cam: Camera, uv: jnp.ndarray) -> jnp.ndarray:
    xd = (uv[..., 0] - cam.cx) / cam.fx
    yd = (uv[..., 1] - cam.cy) / cam.fy
    k1, k2 = cam.params[..., 4], cam.params[..., 5]
    p1, p2 = cam.params[..., 6], cam.params[..., 7]

    # Newton undistortion with analytic 2x2 jacobian (robust at EuRoC-level
    # distortion where plain fixed-point iteration stalls).
    x, y = xd, yd
    for _ in range(8):
        r2 = x * x + y * y
        radial = 1.0 + k1 * r2 + k2 * r2 * r2
        fx_ = x * radial + 2.0 * p1 * x * y + p2 * (r2 + 2.0 * x * x) - xd
        fy_ = y * radial + p1 * (r2 + 2.0 * y * y) + 2.0 * p2 * x * y - yd
        dr_dr2 = k1 + 2.0 * k2 * r2
        j00 = radial + 2.0 * x * x * dr_dr2 + 2.0 * p1 * y + 6.0 * p2 * x
        j01 = 2.0 * x * y * dr_dr2 + 2.0 * p1 * x + 2.0 * p2 * y
        j10 = 2.0 * x * y * dr_dr2 + 2.0 * p1 * x + 2.0 * p2 * y
        j11 = radial + 2.0 * y * y * dr_dr2 + 6.0 * p1 * y + 2.0 * p2 * x
        det = j00 * j11 - j01 * j10
        det = jnp.where(jnp.abs(det) < 1e-9, 1e-9, det)
        x = x - (j11 * fx_ - j01 * fy_) / det
        y = y - (-j10 * fx_ + j00 * fy_) / det
    return jnp.stack([x, y, jnp.ones_like(x)], axis=-1)


def _unproject_kb8(cam: Camera, uv: jnp.ndarray) -> jnp.ndarray:
    mx = (uv[..., 0] - cam.cx) / cam.fx
    my = (uv[..., 1] - cam.cy) / cam.fy
    d = jnp.sqrt(jnp.maximum(mx * mx + my * my, 1e-18))
    k1, k2 = cam.params[..., 4], cam.params[..., 5]
    k3, k4 = cam.params[..., 6], cam.params[..., 7]

    # Newton solve d(theta) = d for theta (reference uses the same scheme,
    # KannalaBrandt8::unprojectEig); 10 iters is ample at f32.
    theta = d
    for _ in range(10):
        t2 = theta * theta
        f = theta * (1.0 + t2 * (k1 + t2 * (k2 + t2 * (k3 + t2 * k4)))) - d
        fp = 1.0 + t2 * (3.0 * k1 + t2 * (5.0 * k2 + t2 * (7.0 * k3 + 9.0 * k4 * t2)))
        theta = theta - f / jnp.where(jnp.abs(fp) < 1e-8, 1e-8, fp)
    scale = jnp.tan(theta) / d
    return jnp.stack([mx * scale, my * scale, jnp.ones_like(mx)], axis=-1)


def unproject(cam: Camera, uv: jnp.ndarray) -> jnp.ndarray:
    """Pixels ``[..., 2]`` -> rays ``[..., 3]`` with z=1."""
    if cam.kind == PINHOLE:
        return _unproject_pinhole(cam, uv)
    return _unproject_kb8(cam, uv)


def undistort_points(cam: Camera, uv: jnp.ndarray) -> jnp.ndarray:
    """Distorted pixels -> ideal-pinhole pixels (K applied to undistorted ray).

    Replaces ``Frame::UndistortKeyPoints`` (reference ``src/Frame.cc``): all
    downstream grid/matching geometry runs on undistorted coordinates.
    """
    ray = unproject(cam, uv)
    u = cam.fx * ray[..., 0] + cam.cx
    v = cam.fy * ray[..., 1] + cam.cy
    return jnp.stack([u, v], axis=-1)


# ---------------------------------------------------------------------------
# analytic projection jacobian wrt camera-frame point (solver hot path)
# ---------------------------------------------------------------------------

def _project_jac_pinhole_nodist(cam: Camera, xc: jnp.ndarray) -> jnp.ndarray:
    x, y = xc[..., 0], xc[..., 1]
    z = jnp.where(jnp.abs(xc[..., 2]) < _Z_EPS, _Z_EPS, xc[..., 2])
    iz = 1.0 / z
    iz2 = iz * iz
    fx, fy = cam.fx, cam.fy
    zero = jnp.zeros_like(x)
    j = jnp.stack(
        [fx * iz, zero, -fx * x * iz2,
         zero, fy * iz, -fy * y * iz2],
        axis=-1,
    )
    return j.reshape(xc.shape[:-1] + (2, 3))


def _project_jac_kb8(cam: Camera, xc: jnp.ndarray) -> jnp.ndarray:
    # Mirrors KannalaBrandt8::projectJac (reference
    # src/CameraModels/KannalaBrandt8.cpp) in batched form.
    x, y, z = xc[..., 0], xc[..., 1], xc[..., 2]
    r2 = jnp.maximum(x * x + y * y, 1e-18)
    r = jnp.sqrt(r2)
    theta = jnp.arctan2(r, z)
    t2 = theta * theta
    k1, k2 = cam.params[..., 4], cam.params[..., 5]
    k3, k4 = cam.params[..., 6], cam.params[..., 7]
    d = theta * (1.0 + t2 * (k1 + t2 * (k2 + t2 * (k3 + t2 * k4))))
    dd_dth = 1.0 + t2 * (3.0 * k1 + t2 * (5.0 * k2 + t2 * (7.0 * k3 + 9.0 * k4 * t2)))
    rho2 = r2 + z * z
    dth_dx = x * z / (rho2 * r)      # d theta / dx
    dth_dy = y * z / (rho2 * r)
    dth_dz = -r / rho2
    s = d / r
    # u = fx * d * x / r + cx
    ds_dx = (dd_dth * dth_dx * r - d * (x / r)) / r2
    ds_dy = (dd_dth * dth_dy * r - d * (y / r)) / r2
    ds_dz = dd_dth * dth_dz / r
    fx, fy = cam.fx, cam.fy
    j = jnp.stack(
        [
            fx * (s + x * ds_dx), fx * x * ds_dy, fx * x * ds_dz,
            fy * y * ds_dx, fy * (s + y * ds_dy), fy * y * ds_dz,
        ],
        axis=-1,
    )
    return j.reshape(xc.shape[:-1] + (2, 3))


def project_jac(cam: Camera, xc: jnp.ndarray) -> jnp.ndarray:
    """d(pixel)/d(camera-frame point): ``[..., 2, 3]``.

    For PINHOLE the jacobian ignores distortion terms — the SLAM pipeline
    optimizes against *undistorted* keypoints (reference does the same: BA
    edges use fx/fy/cx/cy only after Frame undistortion).
    """
    if cam.kind == PINHOLE:
        return _project_jac_pinhole_nodist(cam, xc)
    return _project_jac_kb8(cam, xc)


def project_ideal(cam: Camera, xc: jnp.ndarray) -> jnp.ndarray:
    """Project WITHOUT distortion (pinhole K only) — pairs with
    undistorted keypoints in BA / matching for PINHOLE cameras.
    For KB8 the full model is the match space, so this is full projection."""
    if cam.kind == PINHOLE:
        z = jnp.where(jnp.abs(xc[..., 2]) < _Z_EPS, _Z_EPS, xc[..., 2])
        u = cam.fx * xc[..., 0] / z + cam.cx
        v = cam.fy * xc[..., 1] / z + cam.cy
        return jnp.stack([u, v], axis=-1)
    return _project_kb8(cam, xc)

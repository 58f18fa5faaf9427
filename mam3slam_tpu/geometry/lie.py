"""Batched Lie-group operations: SO(3), SE(3), Sim(3).

JAX-native replacement for the reference's Sophus layer
(``/root/reference/Thirdparty/Sophus/sophus/{so3,se3,sim3}.hpp`` — SURVEY.md §1
layer 1).  Every pose field in the reference is a ``Sophus::SE3f`` /
``Sophus::Sim3f``; here poses are flat arrays with arbitrary leading batch
dimensions so that whole keyframe tables transform in one fused XLA op.

Conventions
-----------
* Quaternions are Hamilton ``(w, x, y, z)``, unit norm, shape ``[..., 4]``.
* SE(3) tangents are ``[rho(3), phi(3)]`` (translation part first, matching
  Sophus), Sim(3) tangents are ``[rho(3), phi(3), sigma(1)]``.
* All functions are natively batched over leading dimensions and are safe to
  ``jit`` / ``vmap`` / differentiate; small-angle branches use masked-safe
  ``where`` arithmetic (no NaN gradients).
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

# Small-angle cutoff. f32 sqrt(eps) ~ 3.45e-4; squared-angle comparisons below
# use _EPS on theta^2 so the Taylor branch covers the ill-conditioned region.
_EPS = 1e-8
# the small 3x3 products below stay full float32 on every device (a TF32
# product keeps about three decimal digits)
_HI = jax.lax.Precision.HIGHEST


# ---------------------------------------------------------------------------
# quaternions
# ---------------------------------------------------------------------------

def quat_identity(shape=(), dtype=jnp.float32) -> jnp.ndarray:
    q = jnp.zeros(tuple(shape) + (4,), dtype)
    return q.at[..., 0].set(1.0)


def quat_normalize(q: jnp.ndarray) -> jnp.ndarray:
    n = jnp.linalg.norm(q, axis=-1, keepdims=True)
    return q / jnp.maximum(n, _EPS)


def quat_conj(q: jnp.ndarray) -> jnp.ndarray:
    return q * jnp.asarray([1.0, -1.0, -1.0, -1.0], q.dtype)


def quat_mul(a: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    aw, ax, ay, az = a[..., 0], a[..., 1], a[..., 2], a[..., 3]
    bw, bx, by, bz = b[..., 0], b[..., 1], b[..., 2], b[..., 3]
    return jnp.stack(
        [
            aw * bw - ax * bx - ay * by - az * bz,
            aw * bx + ax * bw + ay * bz - az * by,
            aw * by - ax * bz + ay * bw + az * bx,
            aw * bz + ax * by - ay * bx + az * bw,
        ],
        axis=-1,
    )


def quat_rotate(q: jnp.ndarray, v: jnp.ndarray) -> jnp.ndarray:
    """Rotate vectors ``v [..., 3]`` by unit quaternions ``q [..., 4]``."""
    w = q[..., :1]
    u = q[..., 1:]
    uv = jnp.cross(u, v)
    return v + 2.0 * (w * uv + jnp.cross(u, uv))


def quat_to_matrix(q: jnp.ndarray) -> jnp.ndarray:
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    xx, yy, zz = x * x, y * y, z * z
    xy, xz, yz = x * y, x * z, y * z
    wx, wy, wz = w * x, w * y, w * z
    r = jnp.stack(
        [
            1 - 2 * (yy + zz), 2 * (xy - wz), 2 * (xz + wy),
            2 * (xy + wz), 1 - 2 * (xx + zz), 2 * (yz - wx),
            2 * (xz - wy), 2 * (yz + wx), 1 - 2 * (xx + yy),
        ],
        axis=-1,
    )
    return r.reshape(q.shape[:-1] + (3, 3))


def quat_from_matrix(m: jnp.ndarray) -> jnp.ndarray:
    """Rotation matrix ``[..., 3, 3]`` -> unit quaternion, branch-free.

    Uses the four-candidate construction (Shepperd's method expressed with
    ``where`` selects) so it is jit/vmap-safe and stable for all traces.
    """
    m00, m01, m02 = m[..., 0, 0], m[..., 0, 1], m[..., 0, 2]
    m10, m11, m12 = m[..., 1, 0], m[..., 1, 1], m[..., 1, 2]
    m20, m21, m22 = m[..., 2, 0], m[..., 2, 1], m[..., 2, 2]

    tr = m00 + m11 + m22
    # Four candidate 4*q_i^2 values.
    qw2 = 1.0 + tr
    qx2 = 1.0 + m00 - m11 - m22
    qy2 = 1.0 - m00 + m11 - m22
    qz2 = 1.0 - m00 - m11 + m22

    # Candidate quaternions (unnormalized), one per dominant component.
    cw = jnp.stack([qw2, m21 - m12, m02 - m20, m10 - m01], axis=-1)
    cx = jnp.stack([m21 - m12, qx2, m01 + m10, m02 + m20], axis=-1)
    cy = jnp.stack([m02 - m20, m01 + m10, qy2, m12 + m21], axis=-1)
    cz = jnp.stack([m10 - m01, m02 + m20, m12 + m21, qz2], axis=-1)

    mags = jnp.stack([qw2, qx2, qy2, qz2], axis=-1)
    idx = jnp.argmax(mags, axis=-1)
    cands = jnp.stack([cw, cx, cy, cz], axis=-2)  # [..., 4cand, 4]
    q = jnp.take_along_axis(cands, idx[..., None, None].astype(jnp.int32), axis=-2)
    q = q[..., 0, :]
    q = quat_normalize(q)
    # Canonicalize sign (w >= 0).
    return q * jnp.where(q[..., :1] < 0, -1.0, 1.0)


# ---------------------------------------------------------------------------
# SO(3)
# ---------------------------------------------------------------------------

def hat(phi: jnp.ndarray) -> jnp.ndarray:
    """so(3) hat operator: ``[..., 3] -> [..., 3, 3]`` skew matrix."""
    x, y, z = phi[..., 0], phi[..., 1], phi[..., 2]
    zero = jnp.zeros_like(x)
    k = jnp.stack([zero, -z, y, z, zero, -x, -y, x, zero], axis=-1)
    return k.reshape(phi.shape[:-1] + (3, 3))


def vee(K: jnp.ndarray) -> jnp.ndarray:
    return jnp.stack([K[..., 2, 1], K[..., 0, 2], K[..., 1, 0]], axis=-1)


def so3_exp_quat(phi: jnp.ndarray) -> jnp.ndarray:
    """Axis-angle ``[..., 3]`` -> unit quaternion (exact with Taylor guard)."""
    theta_sq = jnp.sum(phi * phi, axis=-1, keepdims=True)
    small = theta_sq < _EPS
    # safe-where: feed the trig branch a benign theta where the Taylor branch
    # is selected, so reverse-mode grads never see d(sqrt)/dx at 0 (NaN leak).
    safe_sq = jnp.where(small, 1.0, theta_sq)
    theta = jnp.sqrt(safe_sq)
    half = 0.5 * theta
    # sin(t/2)/t  with Taylor 0.5 - t^2/48 near zero
    k = jnp.where(small, 0.5 - theta_sq / 48.0, jnp.sin(half) / theta)
    w = jnp.where(small, 1.0 - theta_sq / 8.0, jnp.cos(half))
    return quat_normalize(jnp.concatenate([w, k * phi], axis=-1))


def so3_exp(phi: jnp.ndarray) -> jnp.ndarray:
    """Axis-angle -> rotation matrix (Rodrigues, Taylor-guarded)."""
    theta_sq = jnp.sum(phi * phi, axis=-1)[..., None, None]
    small = theta_sq < _EPS
    safe_sq = jnp.where(small, 1.0, theta_sq)
    theta = jnp.sqrt(safe_sq)
    K = hat(phi)
    K2 = jnp.matmul(K, K, precision=_HI)
    a = jnp.where(small, 1.0 - theta_sq / 6.0, jnp.sin(theta) / theta)
    b = jnp.where(small, 0.5 - theta_sq / 24.0, (1.0 - jnp.cos(theta)) / safe_sq)
    eye = jnp.broadcast_to(jnp.eye(3, dtype=phi.dtype), K.shape)
    return eye + a * K + b * K2


def so3_log_quat(q: jnp.ndarray) -> jnp.ndarray:
    """Unit quaternion -> axis-angle ``[..., 3]``."""
    q = q * jnp.where(q[..., :1] < 0, -1.0, 1.0)  # w >= 0 => theta in [0, pi]
    w = jnp.clip(q[..., :1], -1.0, 1.0)
    vn_sq = jnp.sum(q[..., 1:] * q[..., 1:], axis=-1, keepdims=True)
    small = vn_sq < 1e-12
    vn = jnp.sqrt(jnp.where(small, 1.0, vn_sq))
    theta = 2.0 * jnp.arctan2(vn, w)
    k = jnp.where(small, 2.0 / jnp.maximum(w, 1e-6), theta / vn)
    return k * q[..., 1:]


def so3_log(R: jnp.ndarray) -> jnp.ndarray:
    return so3_log_quat(quat_from_matrix(R))


def so3_left_jacobian(phi: jnp.ndarray) -> jnp.ndarray:
    """J_l(phi): V matrix of SE(3) exp; ``[..., 3] -> [..., 3, 3]``."""
    theta_sq = jnp.sum(phi * phi, axis=-1)[..., None, None]
    small = theta_sq < _EPS
    safe_sq = jnp.where(small, 1.0, theta_sq)
    theta = jnp.sqrt(safe_sq)
    K = hat(phi)
    K2 = jnp.matmul(K, K, precision=_HI)
    b = jnp.where(small, 0.5 - theta_sq / 24.0, (1.0 - jnp.cos(theta)) / safe_sq)
    c = jnp.where(small, 1.0 / 6.0 - theta_sq / 120.0,
                  (theta - jnp.sin(theta)) / (safe_sq * theta))
    eye = jnp.broadcast_to(jnp.eye(3, dtype=phi.dtype), K.shape)
    return eye + b * K + c * K2


def so3_left_jacobian_inv(phi: jnp.ndarray) -> jnp.ndarray:
    theta_sq = jnp.sum(phi * phi, axis=-1)[..., None, None]
    small = theta_sq < _EPS
    safe_sq = jnp.where(small, 1.0, theta_sq)
    theta = jnp.sqrt(safe_sq)
    K = hat(phi)
    K2 = jnp.matmul(K, K, precision=_HI)
    half_theta = 0.5 * theta
    cot_term = jnp.where(
        small,
        1.0 / 12.0 + theta_sq / 720.0,
        (1.0 - 0.5 * theta * jnp.cos(half_theta)
         / jnp.maximum(jnp.sin(half_theta), _EPS)) / safe_sq,
    )
    eye = jnp.broadcast_to(jnp.eye(3, dtype=phi.dtype), K.shape)
    return eye - 0.5 * K + cot_term * K2


# ---------------------------------------------------------------------------
# SE(3)
# ---------------------------------------------------------------------------

class SE3(NamedTuple):
    """Rigid transform as (unit quaternion, translation); a pytree.

    ``x_out = R(q) @ x + t``.  Leading batch dims allowed on both fields.
    """

    q: jnp.ndarray  # [..., 4]
    t: jnp.ndarray  # [..., 3]

    @property
    def batch_shape(self):
        return self.q.shape[:-1]


def se3_identity(shape=(), dtype=jnp.float32) -> SE3:
    return SE3(quat_identity(shape, dtype), jnp.zeros(tuple(shape) + (3,), dtype))


def se3_compose(a: SE3, b: SE3) -> SE3:
    """a * b  (apply b first, then a)."""
    return SE3(quat_normalize(quat_mul(a.q, b.q)), quat_rotate(a.q, b.t) + a.t)


def se3_inverse(a: SE3) -> SE3:
    qi = quat_conj(a.q)
    return SE3(qi, -quat_rotate(qi, a.t))


def se3_apply(a: SE3, pts: jnp.ndarray) -> jnp.ndarray:
    return quat_rotate(a.q, pts) + a.t


def se3_matrix(a: SE3) -> jnp.ndarray:
    """``[..., 4, 4]`` homogeneous matrix."""
    R = quat_to_matrix(a.q)
    top = jnp.concatenate([R, a.t[..., None]], axis=-1)
    bottom = jnp.zeros_like(top[..., :1, :]).at[..., 0, 3].set(1.0)
    return jnp.concatenate([top, bottom], axis=-2)


def se3_from_Rt(R: jnp.ndarray, t: jnp.ndarray) -> SE3:
    return SE3(quat_from_matrix(R), t)


def se3_exp(tangent: jnp.ndarray) -> SE3:
    """Tangent ``[..., 6] = [rho, phi]`` -> SE3."""
    rho, phi = tangent[..., :3], tangent[..., 3:6]
    q = so3_exp_quat(phi)
    V = so3_left_jacobian(phi)
    t = jnp.einsum("...ij,...j->...i", V, rho, precision=_HI)
    return SE3(q, t)


def se3_log(a: SE3) -> jnp.ndarray:
    phi = so3_log_quat(a.q)
    Vinv = so3_left_jacobian_inv(phi)
    rho = jnp.einsum("...ij,...j->...i", Vinv, a.t, precision=_HI)
    return jnp.concatenate([rho, phi], axis=-1)


# ---------------------------------------------------------------------------
# Sim(3)
# ---------------------------------------------------------------------------

class Sim3(NamedTuple):
    """Similarity transform ``x_out = s * R(q) @ x + t``; a pytree.

    Replaces ``g2o::Sim3`` / ``Sophus::Sim3f`` used by the reference's
    loop-closing and merge state (``include/Agent.h:221-240``).
    ``s`` has shape ``[...]`` (no trailing axis).
    """

    q: jnp.ndarray  # [..., 4]
    t: jnp.ndarray  # [..., 3]
    s: jnp.ndarray  # [...]


def sim3_identity(shape=(), dtype=jnp.float32) -> Sim3:
    return Sim3(
        quat_identity(shape, dtype),
        jnp.zeros(tuple(shape) + (3,), dtype),
        jnp.ones(tuple(shape), dtype),
    )


def sim3_from_se3(a: SE3, s=None) -> Sim3:
    scale = jnp.ones(a.q.shape[:-1], a.q.dtype) if s is None else jnp.asarray(s)
    return Sim3(a.q, a.t, jnp.broadcast_to(scale, a.q.shape[:-1]))


def sim3_compose(a: Sim3, b: Sim3) -> Sim3:
    return Sim3(
        quat_normalize(quat_mul(a.q, b.q)),
        a.s[..., None] * quat_rotate(a.q, b.t) + a.t,
        a.s * b.s,
    )


def sim3_inverse(a: Sim3) -> Sim3:
    qi = quat_conj(a.q)
    s_inv = 1.0 / a.s
    return Sim3(qi, -s_inv[..., None] * quat_rotate(qi, a.t), s_inv)


def sim3_apply(a: Sim3, pts: jnp.ndarray) -> jnp.ndarray:
    return a.s[..., None] * quat_rotate(a.q, pts) + a.t


def sim3_matrix(a: Sim3) -> jnp.ndarray:
    R = a.s[..., None, None] * quat_to_matrix(a.q)
    top = jnp.concatenate([R, a.t[..., None]], axis=-1)
    bottom = jnp.zeros_like(top[..., :1, :]).at[..., 0, 3].set(1.0)
    return jnp.concatenate([top, bottom], axis=-2)


def _sim3_W(phi: jnp.ndarray, sigma: jnp.ndarray) -> jnp.ndarray:
    """W(phi, sigma) = \\int_0^1 e^{sigma u} exp(u hat(phi)) du, ``[...,3,3]``.

    Closed form with Taylor guards; validated against numerical quadrature in
    tests/test_lie.py.  This is the translation mixing matrix of Sim(3) exp.
    """
    dtype = phi.dtype
    theta_sq = jnp.sum(phi * phi, axis=-1)
    s = jnp.exp(sigma)
    sigma_sq = sigma * sigma

    small_sigma = jnp.abs(sigma) < 1e-4
    small_theta = theta_sq < 1e-8

    safe_sigma = jnp.where(small_sigma, 1.0, sigma)
    safe_theta_sq = jnp.where(small_theta, 1.0, theta_sq)
    safe_theta = jnp.sqrt(safe_theta_sq)
    theta = jnp.where(small_theta, jnp.sqrt(theta_sq + 1e-24), safe_theta)

    # C = (e^sigma - 1)/sigma
    C = jnp.where(small_sigma, 1.0 + 0.5 * sigma + sigma_sq / 6.0,
                  (s - 1.0) / safe_sigma)

    # sigma ~ 0 branch
    A0 = jnp.where(small_theta, 0.5 - theta_sq / 24.0,
                   (1.0 - jnp.cos(safe_theta)) / safe_theta_sq)
    B0 = jnp.where(small_theta, 1.0 / 6.0 - theta_sq / 120.0,
                   (safe_theta - jnp.sin(safe_theta)) / (safe_theta_sq * safe_theta))

    # sigma != 0, theta ~ 0 branch
    A1 = ((safe_sigma - 1.0) * s + 1.0) / jnp.where(small_sigma, 1.0, sigma_sq)
    B1 = (s * 0.5 * sigma_sq + s - 1.0 - sigma * s) / jnp.where(
        small_sigma, 1.0, sigma_sq * safe_sigma)

    # general branch
    a_ = s * jnp.sin(safe_theta)
    b_ = s * jnp.cos(safe_theta)
    c_ = theta_sq + sigma_sq
    safe_c = jnp.where(c_ < 1e-12, 1.0, c_)
    A2 = (a_ * sigma + (1.0 - b_) * safe_theta) / (safe_theta * safe_c)
    B2 = (C - ((b_ - 1.0) * sigma + a_ * safe_theta) / safe_c) / safe_theta_sq

    A = jnp.where(small_sigma, A0, jnp.where(small_theta, A1, A2))
    B = jnp.where(small_sigma, B0, jnp.where(small_theta, B1, B2))

    K = hat(phi)
    K2 = jnp.matmul(K, K, precision=_HI)
    eye = jnp.broadcast_to(jnp.eye(3, dtype=dtype), K.shape)
    return (A[..., None, None] * K + B[..., None, None] * K2
            + C[..., None, None] * eye)


def sim3_exp(tangent: jnp.ndarray) -> Sim3:
    """Tangent ``[..., 7] = [rho, phi, sigma]`` -> Sim3."""
    rho = tangent[..., :3]
    phi = tangent[..., 3:6]
    sigma = tangent[..., 6]
    q = so3_exp_quat(phi)
    W = _sim3_W(phi, sigma)
    t = jnp.einsum("...ij,...j->...i", W, rho, precision=_HI)
    return Sim3(q, t, jnp.exp(sigma))


def sim3_log(a: Sim3) -> jnp.ndarray:
    phi = so3_log_quat(a.q)
    sigma = jnp.log(a.s)
    W = _sim3_W(phi, sigma)
    rho = jnp.linalg.solve(W, a.t[..., None])[..., 0]
    return jnp.concatenate([rho, phi, sigma[..., None]], axis=-1)

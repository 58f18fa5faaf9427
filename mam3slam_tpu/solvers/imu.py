"""IMU preintegration on manifold (Forster et al. / ORB-SLAM3 style).

JAX-native replacement for the reference's ``src/ImuTypes.cc`` (SURVEY.md
§2.5): ``IntegrateNewMeasurement`` (deltaR/V/P, 15x15 covariance, bias
jacobians), re-integration under new bias estimates, and bias-corrected
delta getters.  The reference plumbs IMU through Tracking but its
multi-agent build exercises the mono-visual path; this module provides the
same capability surface for visual-inertial extensions.

Implemented as one ``lax.scan`` over the measurement batch — the whole
window preintegrates in a single fused device program, and ``vmap`` gives
batched multi-window / multi-agent preintegration for free.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from mam3slam_tpu.geometry import lie

GRAVITY = 9.81


class ImuCalib(NamedTuple):
    """Continuous-time noise densities (same fields as reference
    IMU::Calib): gyro/acc white noise and random-walk sigmas."""

    sigma_g: jnp.ndarray   # rad/s/sqrt(Hz)
    sigma_a: jnp.ndarray   # m/s^2/sqrt(Hz)
    walk_g: jnp.ndarray
    walk_a: jnp.ndarray


class Preintegrated(NamedTuple):
    """Accumulated deltas between two frames (reference IMU::Preintegrated)."""

    dt: jnp.ndarray       # [] total time
    dR: jnp.ndarray       # [3, 3]
    dV: jnp.ndarray       # [3]
    dP: jnp.ndarray       # [3]
    cov: jnp.ndarray      # [15, 15]  (phi, v, p, bg, ba)
    JRg: jnp.ndarray      # [3, 3] d(dR)/d(bias_gyro)
    JVg: jnp.ndarray
    JVa: jnp.ndarray
    JPg: jnp.ndarray
    JPa: jnp.ndarray
    bias_g: jnp.ndarray   # [3] bias used during integration
    bias_a: jnp.ndarray


def _right_jacobian(phi):
    """SO(3) right Jacobian Jr(phi)."""
    theta_sq = jnp.sum(phi * phi)
    small = theta_sq < 1e-8
    safe_sq = jnp.where(small, 1.0, theta_sq)
    theta = jnp.sqrt(safe_sq)
    K = lie.hat(phi)
    K2 = K @ K
    a = jnp.where(small, 0.5 - theta_sq / 24.0,
                  (1.0 - jnp.cos(theta)) / safe_sq)
    b = jnp.where(small, 1.0 / 6.0 - theta_sq / 120.0,
                  (theta - jnp.sin(theta)) / (safe_sq * theta))
    return jnp.eye(3) - a * K + b * K2


def preintegrate(gyro: jnp.ndarray, acc: jnp.ndarray, dts: jnp.ndarray,
                 valid: jnp.ndarray, bias_g: jnp.ndarray,
                 bias_a: jnp.ndarray, calib: ImuCalib) -> Preintegrated:
    """Integrate a window of measurements.

    gyro/acc [N, 3], dts [N], valid [N] (mask for padded windows).
    Mirrors reference ``Preintegrated::IntegrateNewMeasurement``
    (src/ImuTypes.cc:177): position/velocity updated with the OLD dR, then
    rotation; covariance propagated with the (A, B) system; bias jacobians
    accumulated for first-order bias correction.
    """
    Ng2 = calib.sigma_g ** 2
    Na2 = calib.sigma_a ** 2
    Wg2 = calib.walk_g ** 2
    Wa2 = calib.walk_a ** 2

    def step(carry, inp):
        dR, dV, dP, cov, JRg, JVg, JVa, JPg, JPa, T = carry
        w, a, dt, ok = inp
        dt = jnp.where(ok, dt, 0.0)
        wb = w - bias_g
        ab = a - bias_a

        dt2 = dt * dt
        acc_w = dR @ ab

        # position/velocity first (old dR), as in the reference
        nJPa = JPa + JVa * dt - 0.5 * dR * dt2
        nJPg = JPg + JVg * dt - 0.5 * (dR @ lie.hat(ab)) @ JRg * dt2
        nJVa = JVa - dR * dt
        nJVg = JVg - (dR @ lie.hat(ab)) @ JRg * dt

        nP = dP + dV * dt + 0.5 * acc_w * dt2
        nV = dV + acc_w * dt

        # rotation update
        phi = wb * dt
        dRi = lie.so3_exp(phi)
        Jr = _right_jacobian(phi)
        nR = dR @ dRi

        # covariance propagation (9x9 nav block + 6 bias random walk)
        A = jnp.eye(9)
        A = A.at[0:3, 0:3].set(dRi.T)
        A = A.at[3:6, 0:3].set(-dR @ lie.hat(ab) * dt)
        A = A.at[6:9, 0:3].set(-0.5 * dR @ lie.hat(ab) * dt2)
        A = A.at[6:9, 3:6].set(jnp.eye(3) * dt)
        B = jnp.zeros((9, 6))
        B = B.at[0:3, 0:3].set(Jr * dt)
        B = B.at[3:6, 3:6].set(dR * dt)
        B = B.at[6:9, 3:6].set(0.5 * dR * dt2)
        Nmeas = jnp.diag(jnp.concatenate([
            jnp.full(3, Ng2 / jnp.maximum(dt, 1e-9)),
            jnp.full(3, Na2 / jnp.maximum(dt, 1e-9))]))
        cov9 = cov[:9, :9]
        ncov9 = A @ cov9 @ A.T + B @ Nmeas @ B.T
        ncov = cov.at[:9, :9].set(jnp.where(ok, ncov9, cov9))
        ncov = ncov.at[9:12, 9:12].add(
            jnp.where(ok, Wg2 * dt, 0.0) * jnp.eye(3))
        ncov = ncov.at[12:15, 12:15].add(
            jnp.where(ok, Wa2 * dt, 0.0) * jnp.eye(3))

        nJRg = dRi.T @ JRg - Jr * dt

        def pick(new, old):
            return jnp.where(ok, new, old)

        return (pick(nR, dR), pick(nV, dV), pick(nP, dP), ncov,
                pick(nJRg, JRg), pick(nJVg, JVg), pick(nJVa, JVa),
                pick(nJPg, JPg), pick(nJPa, JPa), T + dt), None

    init = (jnp.eye(3), jnp.zeros(3), jnp.zeros(3), jnp.zeros((15, 15)),
            jnp.zeros((3, 3)), jnp.zeros((3, 3)), jnp.zeros((3, 3)),
            jnp.zeros((3, 3)), jnp.zeros((3, 3)), jnp.asarray(0.0))
    (dR, dV, dP, cov, JRg, JVg, JVa, JPg, JPa, T), _ = jax.lax.scan(
        step, init, (gyro, acc, dts, valid))
    return Preintegrated(dt=T, dR=dR, dV=dV, dP=dP, cov=cov, JRg=JRg,
                         JVg=JVg, JVa=JVa, JPg=JPg, JPa=JPa,
                         bias_g=bias_g, bias_a=bias_a)


# bias-corrected getters (reference GetDeltaRotation/Velocity/Position)

def delta_rotation(p: Preintegrated, bias_g):
    db = bias_g - p.bias_g
    return p.dR @ lie.so3_exp(p.JRg @ db)


def delta_velocity(p: Preintegrated, bias_g, bias_a):
    return p.dV + p.JVg @ (bias_g - p.bias_g) + p.JVa @ (bias_a - p.bias_a)


def delta_position(p: Preintegrated, bias_g, bias_a):
    return p.dP + p.JPg @ (bias_g - p.bias_g) + p.JPa @ (bias_a - p.bias_a)


def inertial_residual(p: Preintegrated, R_i, v_i, p_i, R_j, v_j, p_j,
                      bias_g, bias_a, gravity=None):
    """9-DoF preintegration residual between nav states i and j
    (the reference's ``EdgeInertial`` error, include/G2oTypes.h): rotation,
    velocity and position discrepancies vs the bias-corrected deltas.

    States are world-frame (R_wb [3,3], v [3], p [3]).  Differentiable —
    feed to a GN/LM solver with autodiff jacobians for inertial BA.
    """
    g = jnp.asarray([0.0, 0.0, -GRAVITY]) if gravity is None else gravity
    dt = p.dt
    dR = delta_rotation(p, bias_g)
    dV = delta_velocity(p, bias_g, bias_a)
    dP = delta_position(p, bias_g, bias_a)
    er = lie.so3_log(dR.T @ (R_i.T @ R_j))
    ev = R_i.T @ (v_j - v_i - g * dt) - dV
    ep = R_i.T @ (p_j - p_i - v_i * dt - 0.5 * g * dt * dt) - dP
    return jnp.concatenate([er, ev, ep])


def predict_state(p: Preintegrated, R_wb, v_w, p_w, bias_g, bias_a,
                  gravity=None):
    """Propagate a world-frame IMU state through the preintegrated window
    (the navigation-state prediction used by inertial tracking)."""
    g = jnp.asarray([0.0, 0.0, -GRAVITY]) if gravity is None else gravity
    dt = p.dt
    dR = delta_rotation(p, bias_g)
    dV = delta_velocity(p, bias_g, bias_a)
    dP = delta_position(p, bias_g, bias_a)
    R2 = R_wb @ dR
    v2 = v_w + g * dt + R_wb @ dV
    p2 = p_w + v_w * dt + 0.5 * g * dt * dt + R_wb @ dP
    return R2, v2, p2

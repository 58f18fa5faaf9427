"""Absolute pose from 2D-3D correspondences (PnP) with batched RANSAC.

JAX-native replacement for the reference's ``src/MLPnPsolver.cpp``
(maximum-likelihood PnP inside RANSAC, used only by
``Tracking::Relocalization`` — SURVEY.md §2.5).  Hypotheses come from a
batched DLT linear solve (6+ points, all RANSAC samples in one SVD); the
winner is polished by the MLPnP measurement model proper
(``ml_refine``): residuals in the 2D tangent (null) space of each
observed BEARING VECTOR, weighted by the 2x2 information obtained by
propagating per-level pixel noise through the unprojection jacobian —
the reference's nullspace parametrization + Kll covariance
(src/MLPnPsolver.cpp computeResiduals/mlpnp_gn), batched."""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from mam3slam_tpu.geometry import cameras as cam_mod
from mam3slam_tpu.geometry import lie


class PnPResult(NamedTuple):
    ok: jnp.ndarray       # [] bool
    q: jnp.ndarray        # [4] T_cw
    t: jnp.ndarray        # [3]
    inliers: jnp.ndarray  # [N] bool
    n_inliers: jnp.ndarray


def _dlt_pnp(X: jnp.ndarray, xn: jnp.ndarray):
    """Batched DLT camera resection.  X [S, M, 3] world points,
    xn [S, M, 2] normalized image coords.  Returns (R [S,3,3], t [S,3])."""
    S, Mn, _ = X.shape
    zeros = jnp.zeros((S, Mn, 4))
    Xh = jnp.concatenate([X, jnp.ones((S, Mn, 1))], axis=-1)  # [S, M, 4]
    r1 = jnp.concatenate([Xh, jnp.zeros_like(Xh),
                          -xn[..., 0:1] * Xh], axis=-1)  # [S, M, 12]
    r2 = jnp.concatenate([jnp.zeros_like(Xh), Xh,
                          -xn[..., 1:2] * Xh], axis=-1)
    A = jnp.concatenate([r1, r2], axis=-2)  # [S, 2M, 12]
    _, _, vt = jnp.linalg.svd(A, full_matrices=False)
    P = vt[..., -1, :].reshape(S, 3, 4)
    Rraw = P[:, :, :3]  # = lambda * R with unknown signed scale lambda
    u, sv, vt2 = jnp.linalg.svd(Rraw)
    # det(u vt) = sign(lambda); nearest rotation to Rraw/lambda is
    # sign * (u vt) (proper: det(sign*(u vt)) = sign^3 * sign = +1)
    sgn = jnp.sign(jnp.linalg.det(u @ vt2))
    sgn = jnp.where(sgn == 0, 1.0, sgn)
    R = sgn[:, None, None] * (u @ vt2)
    lam = sgn * jnp.mean(sv, axis=-1)
    t = P[:, :, 3] / jnp.where(jnp.abs(lam) < 1e-12, 1e-12, lam)[:, None]
    return R, t


def _bearing_tangent_basis(v):
    """Orthonormal (r, s) spanning the tangent (null) space of unit
    bearings v [N, 3] (reference MLPnPsolver nullspace parametrization)."""
    # pick the axis least aligned with v to seed r
    ref = jnp.where(jnp.abs(v[:, 2:3]) < 0.9,
                    jnp.broadcast_to(jnp.asarray([0.0, 0.0, 1.0]),
                                     v.shape),
                    jnp.broadcast_to(jnp.asarray([1.0, 0.0, 0.0]),
                                     v.shape))
    r = jnp.cross(v, ref)
    r = r / jnp.maximum(jnp.linalg.norm(r, axis=-1, keepdims=True), 1e-12)
    s = jnp.cross(v, r)
    return r, s


def bearing_information(cam: cam_mod.Camera, uv: jnp.ndarray,
                        sigma2_px: jnp.ndarray):
    """Per-observation bearings + 2x2 tangent-plane information from
    pixel noise: Sigma_v = J sigma2 J^T with J = d(normalize(unproject))
    / d(uv) (the reference's Kll propagation, MLPnPsolver.cpp
    computePose cov loop).  Returns (v [N,3], r, s, W [N,2,2])."""
    def unit_ray(uv1):
        ray = cam_mod.unproject(cam, uv1)
        return ray / jnp.maximum(jnp.linalg.norm(ray), 1e-12)

    v = jax.vmap(unit_ray)(uv)
    J = jax.vmap(jax.jacfwd(unit_ray))(uv)                 # [N, 3, 2]
    r, s = _bearing_tangent_basis(v)
    B = jnp.stack([r, s], axis=1)                          # [N, 2, 3]
    JB = B @ J                                             # [N, 2, 2]
    Sigma = (JB @ jnp.swapaxes(JB, -1, -2)
             * sigma2_px[:, None, None])                   # [N, 2, 2]
    a, b = Sigma[:, 0, 0], Sigma[:, 0, 1]
    c, d = Sigma[:, 1, 0], Sigma[:, 1, 1]
    det = jnp.maximum(a * d - b * c, 1e-18)
    W = jnp.stack([jnp.stack([d, -b], -1),
                   jnp.stack([-c, a], -1)], -2) / det[:, None, None]
    return v, r, s, W


def ml_refine(pts, uv, weights_ok, cam: cam_mod.Camera, q0, t0,
              sigma2_px, iters: int = 8):
    """Gauss-Newton on the MLPnP objective: e_i = B_i^T normalize(R p_i
    + t), minimized in the bearing tangent plane under the propagated
    2x2 information W_i.  Batched; jit-able."""
    v, r, s, W = bearing_information(cam, uv, sigma2_px)
    B = jnp.stack([r, s], axis=1)                          # [N, 2, 3]
    wmask = weights_ok.astype(jnp.float32)

    def step(carry, _):
        q, t = carry
        Xc = lie.quat_rotate(q[None], pts) + t[None]
        nrm = jnp.maximum(jnp.linalg.norm(Xc, axis=-1, keepdims=True),
                          1e-12)
        u = Xc / nrm
        e = jnp.einsum("nij,nj->ni", B, u)                 # [N, 2]
        # d(normalize)/dXc = (I - u u^T)/|Xc|
        P = (jnp.eye(3)[None] - u[:, :, None] * u[:, None, :]) / nrm[
            :, :, None]
        # dXc/d[dt, dw] = [I | -hat(Xc)]
        Jx = jnp.concatenate([jnp.broadcast_to(jnp.eye(3)[None],
                                               (pts.shape[0], 3, 3)),
                              -lie.hat(Xc)], axis=-1)      # [N, 3, 6]
        J = B @ P @ Jx                                     # [N, 2, 6]
        WJ = W @ J * wmask[:, None, None]
        H = jnp.einsum("nia,nib->ab", WJ, J)
        g = jnp.einsum("nia,ni->a", WJ, e)
        dx = -jnp.linalg.solve(H + 1e-8 * jnp.eye(6), g)
        dx = jnp.where(jnp.all(jnp.isfinite(dx)), dx, 0.0)
        dT = lie.se3_exp(dx[None])
        q2 = lie.quat_normalize(lie.quat_mul(dT.q[0], q))
        t2 = lie.quat_rotate(dT.q[0], t) + dT.t[0]
        return (q2, t2), None

    (q, t), _ = jax.lax.scan(step, (q0, t0), None, length=iters)
    return q, t


def ransac_pnp(pts: jnp.ndarray, uv: jnp.ndarray, valid: jnp.ndarray,
               cam: cam_mod.Camera, key, inv_sigma2: jnp.ndarray,
               n_iter: int = 128, sample_size: int = 6,
               chi2_th: float = 5.991, min_inliers: int = 15) -> PnPResult:
    """RANSAC DLT-PnP.  pts [N, 3] world, uv [N, 2] observed pixels."""
    n = pts.shape[0]
    order = jnp.argsort(~valid)
    n_valid = jnp.sum(valid.astype(jnp.int32))
    probe = jax.random.uniform(key, (n_iter, sample_size))
    pos = (probe * jnp.maximum(n_valid, sample_size).astype(jnp.float32)
           ).astype(jnp.int32)
    samples = order[pos]  # [S, m]

    # normalized coords for DLT
    rays = cam_mod.unproject(cam, uv)[:, :2]
    R, t = _dlt_pnp(pts[samples], rays[samples])

    Xc = jnp.einsum("sij,nj->sni", R, pts) + t[:, None, :]
    pr = cam_mod.project_ideal(cam, Xc)
    chi2 = jnp.sum((pr - uv[None]) ** 2, axis=-1) * inv_sigma2[None]
    inl = (chi2 < chi2_th) & (Xc[..., 2] > 0.01) & valid[None]
    counts = jnp.sum(inl, axis=-1)
    best = jnp.argmax(counts)
    q = lie.quat_from_matrix(R[best])
    tb = t[best]
    # MLPnP polish: bearing-tangent GN under propagated pixel-noise
    # covariance on the consensus set (src/MLPnPsolver.cpp mlpnp_gn)
    q_r, t_r = ml_refine(pts, uv, inl[best], cam, q, tb,
                         1.0 / jnp.maximum(inv_sigma2, 1e-9))
    # accept the refinement only if it does not lose inliers
    Xc_r = lie.quat_rotate(q_r[None], pts) + t_r[None]
    chi_r = (jnp.sum((cam_mod.project_ideal(cam, Xc_r) - uv) ** 2, -1)
             * inv_sigma2)
    inl_r = (chi_r < chi2_th) & (Xc_r[..., 2] > 0.01) & valid
    better = jnp.sum(inl_r) >= counts[best]
    q = jnp.where(better, q_r, q)
    tb = jnp.where(better, t_r, tb)
    inliers = jnp.where(better, inl_r, inl[best])
    n_in = jnp.maximum(jnp.sum(inl_r), counts[best])
    return PnPResult(ok=n_in >= min_inliers, q=q, t=tb,
                     inliers=inliers,
                     n_inliers=n_in.astype(jnp.int32))

"""Sim3 estimation: Horn closed-form, batched RANSAC, and Sim3 refinement.

JAX-native replacement for the reference's ``src/Sim3Solver.cc`` (Horn-1987
absolute orientation inside RANSAC over 3-point samples) and
``Optimizer::OptimizeSim3`` (src/Optimizer.cc:2115 — bidirectional Sim3
reprojection GN with Huber and inlier pruning).  Used by loop closing and
map merging to align keyframe pairs across maps (monocular => scale free).

Design: all RANSAC hypotheses are computed in one batched closed-form
solve and scored with one fused reduction — no sequential iterate() loop.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from mam3slam_tpu.geometry import cameras as cam_mod
from mam3slam_tpu.geometry import lie


class Sim3Result(NamedTuple):
    ok: jnp.ndarray       # [] bool
    q: jnp.ndarray        # [4] rotation 1<-2
    t: jnp.ndarray        # [3]
    s: jnp.ndarray        # [] scale
    inliers: jnp.ndarray  # [N] bool
    n_inliers: jnp.ndarray


def horn_sim3(p1: jnp.ndarray, p2: jnp.ndarray, w=None, fix_scale=False):
    """Closed-form similarity aligning point sets: p1 ~= s R p2 + t.

    p1, p2: [..., N, 3]; optional weights w [..., N].  Horn's quaternion
    method (the reference's ComputeSim3, src/Sim3Solver.cc:311-370).
    Batched over leading dims.
    """
    if w is None:
        w = jnp.ones(p1.shape[:-1], p1.dtype)
    wsum = jnp.maximum(jnp.sum(w, axis=-1, keepdims=True), 1e-9)
    wn = w / wsum
    c1 = jnp.sum(p1 * wn[..., None], axis=-2)  # [..., 3]
    c2 = jnp.sum(p2 * wn[..., None], axis=-2)
    q1 = p1 - c1[..., None, :]
    q2 = p2 - c2[..., None, :]

    # cross-covariance M = sum w q1 q2^T
    Mm = jnp.einsum("...ni,...nj,...n->...ij", q1, q2, wn,
                    precision=jax.lax.Precision.HIGHEST)
    Sxx, Sxy, Sxz = Mm[..., 0, 0], Mm[..., 0, 1], Mm[..., 0, 2]
    Syx, Syy, Syz = Mm[..., 1, 0], Mm[..., 1, 1], Mm[..., 1, 2]
    Szx, Szy, Szz = Mm[..., 2, 0], Mm[..., 2, 1], Mm[..., 2, 2]
    # Horn's 4x4 N matrix
    N = jnp.stack([
        jnp.stack([Sxx + Syy + Szz, Syz - Szy, Szx - Sxz, Sxy - Syx], -1),
        jnp.stack([Syz - Szy, Sxx - Syy - Szz, Sxy + Syx, Szx + Sxz], -1),
        jnp.stack([Szx - Sxz, Sxy + Syx, -Sxx + Syy - Szz, Syz + Szy], -1),
        jnp.stack([Sxy - Syx, Szx + Sxz, Syz + Szy, -Sxx - Syy + Szz], -1),
    ], axis=-2)
    evals, evecs = jnp.linalg.eigh(N)
    q = evecs[..., :, -1]  # largest eigenvalue -> quaternion (w, x, y, z)
    # Horn's eigenvector is the rotation taking set 1 onto set 2; we want
    # p1 = R p2, i.e. its conjugate.
    q = lie.quat_conj(lie.quat_normalize(
        q * jnp.where(q[..., :1] < 0, -1.0, 1.0)))

    rot_q2 = lie.quat_rotate(q[..., None, :], q2)
    if fix_scale:
        s = jnp.ones(q.shape[:-1], p1.dtype)
    else:
        # Horn symmetric scale: sqrt(sum|q1|^2 / sum|q2|^2) — used by the
        # reference via norm ratio
        num = jnp.sum(jnp.sum(q1 * q1, -1) * wn, -1)
        den = jnp.maximum(jnp.sum(jnp.sum(q2 * q2, -1) * wn, -1), 1e-12)
        dot = jnp.sum(jnp.sum(q1 * rot_q2, -1) * wn, -1)
        s = dot / den  # least-squares scale (D/Sl in Horn)
        s = jnp.maximum(s, 1e-6)
    t = c1 - s[..., None] * lie.quat_rotate(q, c2)
    return q, t, s


def ransac_sim3(p1: jnp.ndarray, p2: jnp.ndarray, valid: jnp.ndarray,
                uv1: jnp.ndarray, uv2: jnp.ndarray,
                cam1: cam_mod.Camera, cam2: cam_mod.Camera,
                q1_cw, t1_cw, q2_cw, t2_cw,
                key, sigma2_1, sigma2_2,
                n_iter: int = 128, chi2_th: float = 9.21,
                min_inliers: int = 20, fix_scale: bool = False
                ) -> Sim3Result:
    """Batched RANSAC Sim3 from 3D-3D correspondences with bidirectional
    reprojection inlier gating (reference Sim3Solver::iterate semantics:
    project p2 through S12 into camera 1 and p1 through S21 into camera 2,
    chi2 on pixel error, th 9.21 = 2-DoF 99%).

    p1/p2: [N, 3] matched map points in WORLD coords of map1/map2;
    uv1/uv2: [N, 2] their observed pixels in KF1/KF2; (q,t)_cw camera poses.
    Estimates S12 in CAMERA frames (reference convention).
    """
    # camera-frame points
    pc1 = lie.quat_rotate(q1_cw[None], p1) + t1_cw[None]
    pc2 = lie.quat_rotate(q2_cw[None], p2) + t2_cw[None]

    n = p1.shape[0]
    order = jnp.argsort(~valid)
    n_valid = jnp.sum(valid.astype(jnp.int32))
    probe = jax.random.uniform(key, (n_iter, 3))
    pos = (probe * jnp.maximum(n_valid, 3).astype(jnp.float32)).astype(
        jnp.int32)
    samples = order[pos]  # [R, 3]

    qh, th, sh = horn_sim3(pc1[samples], pc2[samples],
                           fix_scale=fix_scale)  # [R, ...]

    def score(qh, th, sh):
        # project pc2 through S12 into cam1 pixels
        p12 = sh[:, None, None] * lie.quat_rotate(qh[:, None, :],
                                                  pc2[None]) + th[:, None, :]
        pr1 = cam_mod.project_ideal(cam1, p12)
        e1 = jnp.sum((pr1 - uv1[None]) ** 2, axis=-1) / sigma2_1[None]
        # inverse: S21 = (1/s, R^T, -1/s R^T t)
        qi = lie.quat_conj(qh)
        si = 1.0 / sh
        ti = -si[:, None] * lie.quat_rotate(qi, th)
        p21 = si[:, None, None] * lie.quat_rotate(qi[:, None, :],
                                                  pc1[None]) + ti[:, None, :]
        pr2 = cam_mod.project_ideal(cam2, p21)
        e2 = jnp.sum((pr2 - uv2[None]) ** 2, axis=-1) / sigma2_2[None]
        inl = (e1 < chi2_th) & (e2 < chi2_th) & valid[None]
        return inl

    inl = score(qh, th, sh)  # [R, N]
    counts = jnp.sum(inl, axis=-1)
    best = jnp.argmax(counts)

    # refine on the best hypothesis' inliers with one weighted Horn solve
    w_best = inl[best].astype(p1.dtype)
    qr, tr, sr = horn_sim3(pc1[None], pc2[None], w_best[None],
                           fix_scale=fix_scale)
    qr, tr, sr = qr[0], tr[0], sr[0]
    inl_r = score(qr[None], tr[None], sr[None])[0]
    better = jnp.sum(inl_r) >= counts[best]
    q_f = jnp.where(better, qr, qh[best])
    t_f = jnp.where(better, tr, th[best])
    s_f = jnp.where(better, sr, sh[best])
    inl_f = jnp.where(better, inl_r, inl[best])
    n_in = jnp.sum(inl_f.astype(jnp.int32))
    return Sim3Result(ok=n_in >= min_inliers, q=q_f, t=t_f, s=s_f,
                      inliers=inl_f, n_inliers=n_in)


def optimize_sim3(q12, t12, s12, pc1, pc2, uv1, uv2, valid,
                  cam1: cam_mod.Camera, cam2: cam_mod.Camera,
                  sigma2_1, sigma2_2,
                  iters: int = 20, huber2: float = 100.0,
                  fix_scale: bool = False):
    """GN refinement of S12 with bidirectional reprojection residuals
    (reference Optimizer::OptimizeSim3, Huber delta^2 = 10^2).

    pc1/pc2 are CAMERA-frame points of the two keyframes.  Returns
    (q, t, s, inlier_mask, n_inliers).
    """
    def residuals(params):
        q, t, log_s = params
        s = jnp.exp(log_s)
        p12 = s * lie.quat_rotate(q[None], pc2) + t[None]
        r1 = (cam_mod.project_ideal(cam1, p12) - uv1) / jnp.sqrt(
            sigma2_1)[:, None]
        qi = lie.quat_conj(q)
        p21 = (1.0 / s) * lie.quat_rotate(qi[None], pc1 - t[None])
        r2 = (cam_mod.project_ideal(cam2, p21) - uv2) / jnp.sqrt(
            sigma2_2)[:, None]
        return r1, r2

    def step(carry, _):
        q, t, log_s, active = carry

        def res_tangent(xi):
            # xi = [rho(3), phi(3), dsigma]
            dq = lie.so3_exp_quat(xi[3:6])
            nq = lie.quat_normalize(lie.quat_mul(dq, q))
            nt = t + xi[0:3]
            nls = log_s + (0.0 if fix_scale else xi[6])
            r1, r2 = residuals((nq, nt, nls))
            return jnp.concatenate([r1, r2], axis=0).reshape(-1)

        xi0 = jnp.zeros(7)
        J = jax.jacfwd(res_tangent)(xi0)  # [2N*2, 7]
        r = res_tangent(xi0)
        chi = (r.reshape(-1, 2) ** 2).sum(-1)  # per-observation chi2 halves
        act2 = jnp.concatenate([active, active])
        wh = jnp.where(chi <= huber2, 1.0,
                       jnp.sqrt(huber2 / jnp.maximum(chi, 1e-12)))
        w = jnp.where(act2, wh, 0.0)
        wr = jnp.repeat(w, 2)
        # full float32: the 7x7 solve amplifies TF32 rounding
        H = jnp.matmul(J.T, J * wr[:, None],
                       precision=jax.lax.Precision.HIGHEST)
        g = jnp.matmul(J.T, r * wr, precision=jax.lax.Precision.HIGHEST)
        H = H + 1e-6 * jnp.eye(7)
        if fix_scale:
            H = H.at[6, 6].add(1e6)
        dx = jnp.linalg.solve(H, -g)
        dq = lie.so3_exp_quat(dx[3:6])
        q_n = lie.quat_normalize(lie.quat_mul(dq, q))
        t_n = t + dx[0:3]
        ls_n = log_s + (0.0 if fix_scale else dx[6])
        return (q_n, t_n, ls_n, active), None

    active = valid
    carry = (q12, t12, jnp.log(jnp.maximum(s12, 1e-6)), active)
    carry, _ = jax.lax.scan(step, carry, None, length=iters)
    q, t, log_s, _ = carry
    r1, r2 = residuals((q, t, log_s))
    chi1 = jnp.sum(r1 ** 2, -1)
    chi2_ = jnp.sum(r2 ** 2, -1)
    inl = valid & (chi1 < 9.21) & (chi2_ < 9.21)
    return q, t, jnp.exp(log_s), inl, jnp.sum(inl.astype(jnp.int32))

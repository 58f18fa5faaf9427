"""Batched Gauss-Newton / Levenberg-Marquardt bundle adjustment.

JAX-native replacement for the reference's g2o-based ``src/Optimizer.cc``
(SURVEY.md §2.5): motion-only pose optimization, windowed local BA, and
full-map global BA — all expressed as one fixed-shape, mask-aware LM solver.

Design (SURVEY.md §7 "g2o -> batched GN/LM"):
* The problem is struct-of-arrays: camera poses ``[K]``, points ``[P]``,
  and an observation edge list ``[E]`` with validity masks.  Fixed cameras /
  points are masks, not separate vertex types.
* Each LM iteration assembles residuals + analytic jacobians for every edge
  in parallel (gathers + small dense ops), then solves the normal equations
  by **matrix-free Schur-complement PCG**: the reduced camera system
  ``S = Hcc - W Hpp^-1 W^T`` is never formed — ``S v`` is computed edge-wise
  with two segment-sums, preconditioned by the block-Jacobi of S.  This maps
  to batched small matmuls + XLA scatter-adds and, unlike g2o's sequential
  sparse Cholesky, parallelizes over everything; per-block reductions become
  ``psum`` when sharded (parallel/).
* Robustness follows the reference: Huber(sqrt(5.991)) on the whitened
  residual, outlier re-classification between optimization rounds
  (``Optimizer::PoseOptimization`` 4 rounds x 10 iters, LBA 5+10).
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp

from mam3slam_tpu.geometry import lie
from mam3slam_tpu.geometry import cameras as cam_mod
from mam3slam_tpu.ops import platform

CHI2_MONO = 5.991  # 2-DoF 95% (reference thresholds throughout)


class Obs(NamedTuple):
    """Observation edges; a pytree of [E]-shaped arrays."""

    cam: jnp.ndarray     # [E] i32 camera index
    pt: jnp.ndarray      # [E] i32 point index
    uv: jnp.ndarray      # [E, 2] f32 measured pixel (match space)
    w: jnp.ndarray       # [E] f32 information = 1/sigma^2 (per pyramid level)
    valid: jnp.ndarray   # [E] bool


class BAProblem(NamedTuple):
    cam_q: jnp.ndarray       # [K, 4] T_cw rotation (world -> camera)
    cam_t: jnp.ndarray       # [K, 3]
    cam_params: jnp.ndarray  # [K, 8] intrinsics (cameras.Camera layout)
    pts: jnp.ndarray         # [P, 3] world points
    obs: Obs
    cam_free: jnp.ndarray    # [K] bool — False = fixed (boundary/origin)
    pt_free: jnp.ndarray     # [P] bool


class BAResult(NamedTuple):
    cam_q: jnp.ndarray
    cam_t: jnp.ndarray
    pts: jnp.ndarray
    inlier: jnp.ndarray      # [E] bool — edges surviving chi2 gating
    cost: jnp.ndarray        # [] final robust cost


def _edge_linearize(cam_q, cam_t, cam_params, kind, pts, obs: Obs):
    """Residuals + analytic jacobians for all edges.

    r = pred - uv  [E, 2];  Jc = dr/dxi (left-mult se3 tangent [rho, phi])
    [E, 2, 6];  Jp = dr/dX  [E, 2, 3].
    """
    q = cam_q[obs.cam]
    t = cam_t[obs.cam]
    X = pts[obs.pt]
    Xc = lie.quat_rotate(q, X) + t
    cam = cam_mod.Camera(cam_params[obs.cam], kind)
    pred = cam_mod.project_ideal(cam, Xc)
    r = pred - obs.uv
    dpi = cam_mod.project_jac(cam, Xc)              # [E, 2, 3]
    Jc = jnp.concatenate([dpi, -dpi @ lie.hat(Xc)], axis=-1)  # [E, 2, 6]
    R = lie.quat_to_matrix(q)
    Jp = dpi @ R                                    # [E, 2, 3]
    depth_ok = Xc[..., 2] > 1e-3
    return r, Jc, Jp, depth_ok


def _huber_w(chi2: jnp.ndarray, delta2: float) -> jnp.ndarray:
    """IRLS weight of the Huber kernel on whitened chi2."""
    return jnp.where(chi2 <= delta2, 1.0,
                     jnp.sqrt(delta2 / jnp.maximum(chi2, 1e-12)))


def _segsum(vals: jnp.ndarray, idx: jnp.ndarray, n: int,
            axis_name=None) -> jnp.ndarray:
    """Segment-sum of per-edge values into vertex arrays.  Under shard_map
    with edges sharded along `axis_name`, the partial sums are psum-reduced
    so every device holds the full vertex arrays (the interconnect collective of the
    distributed BA — SURVEY.md §2.6/§2.8 'Schur-block parallelism')."""
    out = jnp.zeros((n,) + vals.shape[1:], vals.dtype).at[idx].add(vals)
    if axis_name is not None:
        out = jax.lax.psum(out, axis_name)
    return out


def _spd_inv3(A: jnp.ndarray, damp: float = 1e-8) -> jnp.ndarray:
    eye = jnp.eye(3, dtype=A.dtype)
    return jnp.linalg.inv(A + damp * eye)


def _spd_inv6(A: jnp.ndarray, damp: float = 1e-8) -> jnp.ndarray:
    eye = jnp.eye(6, dtype=A.dtype)
    return jnp.linalg.inv(A + damp * eye)


def ba_cost_and_inliers(problem: BAProblem, kind: int,
                        chi2_th: float = CHI2_MONO, axis_name=None):
    """Robust cost + chi2 inlier classification at the current estimate."""
    r, _, _, depth_ok = _edge_linearize(
        problem.cam_q, problem.cam_t, problem.cam_params, kind,
        problem.pts, problem.obs)
    chi2 = problem.obs.w * jnp.sum(r * r, axis=-1)
    active = problem.obs.valid & depth_ok
    d2 = chi2_th
    rho = jnp.where(chi2 <= d2, chi2,
                    2.0 * jnp.sqrt(d2 * jnp.maximum(chi2, 1e-12)) - d2)
    cost = jnp.sum(jnp.where(active, rho, 0.0))
    if axis_name is not None:
        cost = jax.lax.psum(cost, axis_name)
    inlier = active & (chi2 < chi2_th)
    return cost, inlier


def _lm_iteration(problem: BAProblem, kind: int, lam: jnp.ndarray,
                  edge_mask: jnp.ndarray, huber_delta2: float,
                  cg_iters: int, robust: bool, axis_name=None):
    """One LM step: linearize, Schur-PCG for camera step, point back-subst.
    Returns (new_q, new_t, new_pts, predicted_ok) — caller accepts/rejects."""
    K = problem.cam_q.shape[0]
    P = problem.pts.shape[0]
    obs = problem.obs

    r, Jc, Jp, depth_ok = _edge_linearize(
        problem.cam_q, problem.cam_t, problem.cam_params, kind,
        problem.pts, obs)
    chi2 = obs.w * jnp.sum(r * r, axis=-1)
    w_rob = _huber_w(chi2, huber_delta2) if robust else jnp.ones_like(chi2)
    w = jnp.where(edge_mask & depth_ok, obs.w * w_rob, 0.0)  # [E]

    # zero jacobians of fixed vertices (their state never moves)
    Jc = jnp.where(problem.cam_free[obs.cam][:, None, None], Jc, 0.0)
    Jp = jnp.where(problem.pt_free[obs.pt][:, None, None], Jp, 0.0)

    wJc = Jc * w[:, None, None]
    wJp = Jp * w[:, None, None]

    # gradient blocks g = J^T W r
    g_c = _segsum(jnp.einsum("eij,ei->ej", wJc, r), obs.cam, K, axis_name)   # [K, 6]
    g_p = _segsum(jnp.einsum("eij,ei->ej", wJp, r), obs.pt, P, axis_name)    # [P, 3]

    # Hessian blocks
    Hcc = _segsum(jnp.einsum("eik,eij->ekj", wJc, Jc), obs.cam, K, axis_name)  # [K,6,6]
    Hpp = _segsum(jnp.einsum("eik,eij->ekj", wJp, Jp), obs.pt, P, axis_name)   # [P,3,3]
    W_e = jnp.einsum("eik,eij->ekj", wJc, Jp)                        # [E,6,3]

    # LM damping (additive, scaled by diagonal as in g2o's Levenberg)
    def damp(H, free, dim):
        diag = jnp.diagonal(H, axis1=-2, axis2=-1)
        add = lam * jnp.maximum(diag, 1e-6) + 1e-8
        H = H + add[..., None] * jnp.eye(dim, dtype=H.dtype)
        # fixed vertices: identity block keeps the system well-posed
        eye = jnp.eye(dim, dtype=H.dtype)
        return jnp.where(free[:, None, None], H, eye)

    Hcc_l = damp(Hcc, problem.cam_free, 6)
    Hpp_l = damp(Hpp, problem.pt_free, 3)
    Hpp_inv = _spd_inv3(Hpp_l)

    # --- matrix-free Schur operator  S v = Hcc_l v - W Hpp_inv W^T v
    def S_mv(v):  # v: [K, 6]
        u = jnp.einsum("ekj,ek->ej", W_e, v[obs.cam])        # [E, 3] W^T v
        y = _segsum(u, obs.pt, P, axis_name)                 # [P, 3]
        z = jnp.einsum("pij,pj->pi", Hpp_inv, y)             # [P, 3]
        back = jnp.einsum("ekj,ej->ek", W_e, z[obs.pt])      # [E, 6] W z
        return (jnp.einsum("kij,kj->ki", Hcc_l, v)
                - _segsum(back, obs.cam, K, axis_name))

    # reduced RHS: b = -g_c + W Hpp_inv g_p
    z0 = jnp.einsum("pij,pj->pi", Hpp_inv, g_p)
    b = -g_c + _segsum(jnp.einsum("ekj,ej->ek", W_e, z0[obs.pt]),
                       obs.cam, K, axis_name)

    # block-Jacobi preconditioner of S
    WHW = jnp.einsum("eik,ekl,ejl->eij", W_e, Hpp_inv[obs.pt], W_e)
    S_diag = Hcc_l - _segsum(WHW, obs.cam, K, axis_name)
    M_inv = _spd_inv6(S_diag)

    def precond(v):
        return jnp.einsum("kij,kj->ki", M_inv, v)

    # --- PCG
    x = jnp.zeros_like(b)
    rr = b - S_mv(x)
    zz = precond(rr)
    p = zz
    rz = jnp.sum(rr * zz)

    def cg_body(_, carry):
        x, rr, p, rz = carry
        Sp = S_mv(p)
        denom = jnp.sum(p * Sp)
        alpha = rz / jnp.where(jnp.abs(denom) < 1e-20, 1e-20, denom)
        x = x + alpha * p
        rr = rr - alpha * Sp
        zz = precond(rr)
        rz_new = jnp.sum(rr * zz)
        beta = rz_new / jnp.where(jnp.abs(rz) < 1e-20, 1e-20, rz)
        p = zz + beta * p
        return x, rr, p, rz_new

    x, rr, p, rz = jax.lax.fori_loop(0, cg_iters, cg_body, (x, rr, p, rz))
    dx_c = jnp.where(problem.cam_free[:, None], x, 0.0)       # [K, 6]

    # point back-substitution: dp = Hpp_inv (-g_p - W^T dx_c)
    u = jnp.einsum("ekj,ek->ej", W_e, dx_c[obs.cam])
    y = _segsum(u, obs.pt, P, axis_name)
    dx_p = jnp.einsum("pij,pj->pi", Hpp_inv, -g_p - y)
    dx_p = jnp.where(problem.pt_free[:, None], dx_p, 0.0)

    # retraction: left-multiplicative se3 update, additive points
    dT = lie.se3_exp(dx_c)
    new_q = lie.quat_normalize(lie.quat_mul(dT.q, problem.cam_q))
    new_t = lie.quat_rotate(dT.q, problem.cam_t) + dT.t
    new_pts = problem.pts + dx_p
    return new_q, new_t, new_pts


def run_ba(problem: BAProblem, kind: int, iters: int = 10,
           cg_iters: int = 30, huber_delta2: float = CHI2_MONO,
           robust: bool = True, chi2_th: float = CHI2_MONO,
           edge_mask: Optional[jnp.ndarray] = None,
           lam0: float = 1e-4, axis_name=None) -> BAResult:
    """LM loop with accept/reject and adaptive damping.  jit-able.

    Semantics of ``Optimizer::BundleAdjustment`` / ``LocalBundleAdjustment``
    (reference src/Optimizer.cc:52/1116): fixed iteration budget, Huber
    robustness, post-hoc chi2 inlier classification in the result.
    """
    obs = problem.obs
    mask0 = obs.valid if edge_mask is None else (obs.valid & edge_mask)

    def cost_at(q, t, p):
        prob = problem._replace(cam_q=q, cam_t=t, pts=p)
        c, _ = ba_cost_and_inliers(prob, kind, chi2_th, axis_name)
        return c

    def body(_, carry):
        q, t, p, lam, cost = carry
        prob = problem._replace(cam_q=q, cam_t=t, pts=p)
        nq, nt, np_ = _lm_iteration(prob, kind, lam, mask0, huber_delta2,
                                    cg_iters, robust, axis_name)
        new_cost = cost_at(nq, nt, np_)
        accept = new_cost < cost
        lam = jnp.where(accept, jnp.maximum(lam * 0.5, 1e-7),
                        jnp.minimum(lam * 4.0, 1e4))
        q = jnp.where(accept, nq, q)
        t = jnp.where(accept, nt, t)
        p = jnp.where(accept, np_, p)
        cost = jnp.where(accept, new_cost, cost)
        return q, t, p, lam, cost

    cost0 = cost_at(problem.cam_q, problem.cam_t, problem.pts)
    q, t, p, lam, cost = jax.lax.fori_loop(
        0, iters, body,
        (problem.cam_q, problem.cam_t, problem.pts,
         jnp.asarray(lam0, jnp.float32), cost0))

    final = problem._replace(cam_q=q, cam_t=t, pts=p)
    _, inlier = ba_cost_and_inliers(final, kind, chi2_th)
    return BAResult(cam_q=q, cam_t=t, pts=p, inlier=inlier & mask0, cost=cost)


# ---------------------------------------------------------------------------
# motion-only pose optimization (reference Optimizer::PoseOptimization :814)
# ---------------------------------------------------------------------------

class PoseOptResult(NamedTuple):
    q: jnp.ndarray        # [4]
    t: jnp.ndarray        # [3]
    inlier: jnp.ndarray   # [N] bool
    n_inliers: jnp.ndarray  # [] i32


@functools.partial(jax.jit,
                   static_argnames=("kind", "rounds", "iters", "use_kernel"))
def pose_optimization(q0, t0, cam_params, kind: int, pts, uv, w, valid,
                      rounds: int = 4, iters: int = 5,
                      use_kernel: bool = True) -> PoseOptResult:
    """Motion-only BA: one SE3 vertex, unary reprojection edges.

    Mirrors the reference's 4 optimization rounds with chi2=5.991
    re-classification between rounds and the Huber kernel dropped in the
    later rounds (src/Optimizer.cc:814-1114).  Points/intrinsics fixed.
    K=1 so the 6x6 normal system is solved directly (no CG).  5 LM
    iterations per round (the reference budgets 10 for g2o, which
    early-terminates; convergence here is complete by ~4 — verified to
    give identical poses on the solver tests).

    With a PINHOLE camera, ``ops.platform`` picks the implementation for
    the device the program is lowered for: the fused Triton kernel
    (ops/pallas_pose.py) on CUDA, the XLA path below elsewhere.
    ``use_kernel=False`` pins the XLA path (the reference for parity
    checks and kernel A/B timings).
    """
    xla = functools.partial(_pose_optimization_xla, kind=kind,
                            rounds=rounds, iters=iters)
    if not use_kernel or kind != cam_mod.PINHOLE:
        return xla(q0, t0, cam_params, pts, uv, w, valid)

    def fused(q0, t0, cam_params, pts, uv, w, valid):
        from mam3slam_tpu.ops import pallas_pose

        R, t, inlier, n = pallas_pose.pose_optimization_pinhole(
            lie.quat_to_matrix(q0), t0, cam_params[:4], pts, uv, w, valid,
            rounds=rounds, iters=iters)
        return PoseOptResult(q=lie.quat_from_matrix(R), t=t,
                             inlier=inlier, n_inliers=n)

    return platform.dispatch("pose", {platform.XLA: xla,
                                      platform.TRITON: fused},
                             q0, t0, cam_params, pts, uv, w, valid)


def _pose_optimization_xla(q0, t0, cam_params, pts, uv, w, valid, *,
                           kind: int, rounds: int,
                           iters: int) -> PoseOptResult:
    """The XLA form of ``pose_optimization``."""
    delta2 = CHI2_MONO

    def linearize(q, t):
        Xc = lie.quat_rotate(q[None, :], pts) + t[None, :]
        cam = cam_mod.Camera(cam_params, kind)
        pred = cam_mod.project_ideal(cam, Xc)
        r = pred - uv
        dpi = cam_mod.project_jac(cam, Xc)
        Jc = jnp.concatenate([dpi, -dpi @ lie.hat(Xc)], axis=-1)  # [N,2,6]
        depth_ok = Xc[:, 2] > 1e-3
        chi2 = w * jnp.sum(r * r, axis=-1)
        return r, Jc, chi2, depth_ok

    def lm_rounds(q, t, active, robust):
        """LM iterations with ONE linearization per iteration: the trial
        point's cost is evaluated at the START of the next iteration (the
        same linearization that would compute its step), halving the
        sequential kernel count vs the classic evaluate-then-accept loop.
        Carry: (best_q, best_t, best_cost, cur_q, cur_t, lam)."""

        def robust_cost(chi2, depth_ok):
            rho = jnp.where(chi2 <= delta2, chi2,
                            2.0 * jnp.sqrt(delta2 * jnp.maximum(chi2, 1e-12))
                            - delta2)
            return jnp.sum(jnp.where(active & depth_ok, rho, 0.0))

        def body(_, carry):
            bq, bt, bcost, q, t, lam = carry
            r, Jc, chi2, depth_ok = linearize(q, t)
            cost = robust_cost(chi2, depth_ok)
            accept = cost < bcost
            lam = jnp.where(accept, jnp.maximum(lam * 0.5, 1e-7),
                            jnp.minimum(lam * 4.0, 1e4))
            bq = jnp.where(accept, q, bq)
            bt = jnp.where(accept, t, bt)
            bcost = jnp.where(accept, cost, bcost)
            # step from the best point, with this linearization if it is
            # the best, else re-using its geometry as an approximation of
            # the best point's (valid: rejected steps are small)
            w_rob = _huber_w(chi2, delta2) if robust else jnp.ones_like(chi2)
            we = jnp.where(active & depth_ok, w * w_rob, 0.0)
            wJ = Jc * we[:, None, None]
            # full float32: a TF32 product would move the 6x6 solve
            H = jnp.einsum("eik,eij->kj", wJ, Jc,
                           precision=jax.lax.Precision.HIGHEST)
            g = jnp.einsum("eij,ei->j", wJ, r,
                           precision=jax.lax.Precision.HIGHEST)
            H = H + (lam * jnp.maximum(jnp.diag(H), 1e-6)
                     + 1e-8) * jnp.eye(6)
            dx = jnp.linalg.solve(H, -g)
            dT = lie.se3_exp(dx)
            base_q = jnp.where(accept, q, bq)
            base_t = jnp.where(accept, t, bt)
            nq = lie.quat_normalize(lie.quat_mul(dT.q, base_q))
            nt = lie.quat_rotate(dT.q, base_t) + dT.t
            return bq, bt, bcost, nq, nt, lam

        big = jnp.asarray(jnp.inf, jnp.float32)
        bq, bt, bcost, q, t, _ = jax.lax.fori_loop(
            0, iters + 1, body,
            (q, t, big, q, t, jnp.asarray(1e-3, jnp.float32)))
        return bq, bt

    q, t = q0, t0
    active = valid
    for rd in range(rounds):
        robust = rd < 2  # reference drops the kernel from round 3
        q, t = lm_rounds(q, t, active, robust)
        _, _, chi2, depth_ok = linearize(q, t)
        active = valid & depth_ok & (chi2 <= delta2)

    return PoseOptResult(q=q, t=t, inlier=active,
                         n_inliers=jnp.sum(active.astype(jnp.int32)))
